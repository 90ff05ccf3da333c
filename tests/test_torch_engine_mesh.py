"""The AE engine's lane mesh (``replication/engine.py``'s ``mesh``) and the
``ae_mesh`` drive, on the CPU (``tests/test_mesh_rules.py:364-440``).

* A one-device lane mesh runs the meshless drive itself: lanes, multi and
  chunked drives bit for bit.
* dp=2 as two spawned gloo ranks: the padded lane drive (its lanes split)
  and the multi drive (its datasets split) bit for bit the meshless
  drives, ChunkStats equal; a kill→resume through the mesh (a
  ``preempt@chunk=1`` drain, then the same call) bit for bit the
  uninterrupted drive; the multi drive fed JAX's draws against JAX's
  ``sweep_autoencoders_multi`` on ``lane_mesh(2)`` over two virtual CPU
  devices, at the engine bars (params atol 1e-5 + rtol 1e-4, losses rtol
  1e-4, stop epochs equal).
* A lane count dp does not divide is refused naming the lane axis, and
  ``lane_mesh`` refuses a lane count the ranks do not divide.
* Health on the dp=2 split grid: training bit for bit; rank 0's gauges
  the meshless health-on drive's (the grad norm and the nonfinite count
  equal, the param norm within rtol 1e-6), rank 1's none; the kill and
  resume bit for bit; a NaN in one rank's lanes trips both ranks at one
  boundary with one whole-grid dump.
* ``run_walkforward`` on a dp=2 lane mesh as two spawned gloo ranks:
  rank 0 alone writes, its outputs byte for byte the meshless drive's,
  every rank's surfaces bit for bit; a drain requested on one rank
  drains both at the same window boundary, and the re-run completes it
  to the same bytes.
* The ``ae_mesh`` fixture writes the ``ae_multi`` fixture's artifact.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu.parallel import rules as jrules
from hfrep_tpu.replication import engine as jax_engine
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.obs import health
from hfrep_tpu_torch.parallel.rules import Mesh, lane_mesh
from hfrep_tpu_torch.replication import engine

ROOT = Path(__file__).resolve().parents[1]
F, LATENTS = 4, [1, 2, 3, 4]
CFG = dict(n_factors=F, latent_dim=4, epochs=6, batch_size=16, patience=2, seed=0,
           chunk_epochs=3)

#: one rank: the drives of the spec file on a dp=2 lane mesh
RANK = r'''
import sys, torch
torch.set_num_threads(1)
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.obs import health
from hfrep_tpu_torch.parallel import initialize_distributed, lane_mesh, shutdown_distributed
from hfrep_tpu_torch.replication import engine
from hfrep_tpu_torch.resilience.faults import FaultPlan
rank, port, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
initialize_distributed("127.0.0.1:" + port, 2, rank, device="cpu")
try:
    cfg = AEConfig(**job["cfg"])
    out = {}
    m = lane_mesh(len(job["latents"]), device="cpu")
    out["padded"] = engine.sweep_autoencoders_padded(3, job["a"], job["a"].shape[0], cfg,
                                                     job["latents"], mesh=m)
    m2 = lane_mesh(2, device="cpu")
    out["multi"] = engine.sweep_autoencoders_multi(5, job["stack"], job["rows"], cfg,
                                                   job["latents"], mesh=m2)
    perms = job["jax_perms"]
    out["jax"] = engine.sweep_autoencoders_multi(
        0, job["stack"], job["rows"], cfg, job["latents"], init_params=job["jax_init"],
        perm_source=lambda pos, n: perms[..., pos:pos + n, :], mesh=m2)
    resilience.install_plan(FaultPlan.parse("preempt@chunk=1"))
    try:
        engine.sweep_autoencoders_multi(5, job["stack"], job["rows"], cfg, job["latents"],
                                        mesh=m2, resume_dir=job["resume"])
        out["preempted"] = False
    except resilience.Preempted:
        out["preempted"] = True
    finally:
        resilience.clear_plan()
    out["resumed"] = engine.sweep_autoencoders_multi(5, job["stack"], job["rows"], cfg,
                                                     job["latents"], mesh=m2,
                                                     resume_dir=job["resume"])
    out["dp"] = (m.shape["dp"], m2.shape["dp"])
    # health on: the padded drive (its gauges in this rank's stream), the
    # multi drive killed after chunk 1 and resumed, then a NaN planted in
    # rank 1's lanes under the armed tripwire
    health.configure(health.HealthConfig())
    with obs_pkg.session(job["obs"] + f"/rank{rank}", command="t"):
        out["padded_health"] = engine.sweep_autoencoders_padded(
            3, job["a"], job["a"].shape[0], cfg, job["latents"], mesh=m)
    resilience.install_plan(FaultPlan.parse("preempt@chunk=1"))
    try:
        engine.sweep_autoencoders_multi(5, job["stack"], job["rows"], cfg, job["latents"],
                                        mesh=m2, resume_dir=job["resume_health"])
        out["preempted_health"] = False
    except resilience.Preempted:
        out["preempted_health"] = True
    finally:
        resilience.clear_plan()
    out["resumed_health"] = engine.sweep_autoencoders_multi(
        5, job["stack"], job["rows"], cfg, job["latents"], mesh=m2,
        resume_dir=job["resume_health"])
    health.configure(health.HealthConfig(abort_on_nonfinite=True, dump_dir=job["dump"]))
    try:
        engine.sweep_autoencoders_padded(3, job["a"], job["a"].shape[0], cfg, job["latents"],
                                         init_params=job["nan_init"], mesh=m)
        out["fault"] = None
    except health.NumericFault as e:
        out["fault"] = {"site": e.site, "epoch": e.epoch, "nonfinite": e.nonfinite,
                        "dump": e.dump}
    health.configure(None)
    torch.save(out, spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''

#: one rank: the walk-forward of the spec file on a dp=2 lane mesh, a
#: drain requested on rank 1 alone, the re-run, then a straight run
WF_RANK = r'''
import os, sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.parallel import initialize_distributed, lane_mesh, shutdown_distributed
from hfrep_tpu_torch.resilience.faults import FaultPlan
from hfrep_tpu_torch.scenario import walkforward
rank, port, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
initialize_distributed("127.0.0.1:" + port, 2, rank, device="cpu")
try:
    out = {}
    try:
        lane_mesh(3, device="cpu")
    except ValueError as e:
        out["refused"] = str(e)
    wspec = walkforward.WalkForwardSpec(**job["spec"])
    m = lane_mesh(wspec.n_windows, device="cpu")
    args = (job["x"], job["y"], job["rf"], wspec, AEConfig(**job["cfg"]), job["latents"])
    if rank == 1:
        resilience.install_plan(FaultPlan.parse("preempt@window=2"))
    try:
        walkforward.run_walkforward(*args, job["drained"], mesh=m)
        out["preempted"] = False
    except resilience.Preempted:
        out["preempted"] = True
    finally:
        resilience.clear_plan()
    out["published"] = sorted(os.listdir(os.path.join(job["drained"], "windows")))
    out["resumed"] = walkforward.run_walkforward(*args, job["drained"], mesh=m)
    out["straight"] = walkforward.run_walkforward(*args, job["straight"], mesh=m)
    out["dp"] = m.shape["dp"]
    torch.save(out, spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data():
    g = np.random.default_rng(3)
    a = torch.from_numpy(g.uniform(0, 1, (36, F)).astype(np.float32))
    stack, rows = engine.stack_padded([a, a[:28]])
    return a, stack, rows


def _spawn_ranks(code: str, spec: str) -> list:
    """Run ``code`` as two gloo ranks on the CPU; each rank's saved doc."""
    port = str(_free_port())
    env = dict({k: v for k, v in os.environ.items() if not k.startswith("HFREP_")},
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), port, spec], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], errs[0][-3000:] + errs[1][-3000:]
    return [torch.load(spec + f".rank{r}", weights_only=False) for r in (0, 1)]


def _equal(x, y) -> bool:
    pairs = [(x.stop_epoch, y.stop_epoch), (x.train_loss, y.train_loss),
             (x.val_loss, y.val_loss)] + [(x.params[k], y.params[k]) for k in x.params]
    return all(torch.equal(torch.nan_to_num(u, nan=7.0), torch.nan_to_num(v, nan=7.0))
               for u, v in pairs)


def _lane_draws(keys, m: int, epochs: int, n_train: int):
    """JAX's draws of each lane key (``tests/test_torch_replication.py``)."""
    enc, dec, perms = [], [], []
    perm = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n_train)))
    for k in keys:
        k, init_key = jax.random.split(k)
        p = JaxAutoencoder(n_features=F, latent_dim=m).init(init_key, jnp.zeros((1, F)))["params"]
        enc.append(np.asarray(p["encoder_kernel"]))
        dec.append(np.asarray(p["decoder_kernel"]))
        perms.append(np.asarray(perm(jax.random.split(k, epochs))).astype(np.int64))
    return {"encoder_kernel": np.stack(enc), "decoder_kernel": np.stack(dec)}, np.stack(perms)


def test_one_device_lane_mesh_is_the_meshless_drive():
    a, stack, rows = _data()
    cfg = AEConfig(**CFG)
    one = lane_mesh(2, device="cpu")
    assert one.shape == {"dp": 1} and one.group is None
    cpu = dict(device="cpu")
    for run in (lambda m: engine.sweep_autoencoders_padded(3, a, 36, cfg, LATENTS, mesh=m, **cpu),
                lambda m: engine.sweep_autoencoders_multi(5, stack, rows, cfg, LATENTS, mesh=m,
                                                          **cpu),
                lambda m: engine.sweep_autoencoders_chunked(4, a, cfg, LATENTS, mesh=m, **cpu)):
        (r0, s0), (r1, s1) = run(None), run(one)
        assert _equal(r0, r1) and s0 == s1


def test_lane_mesh_refusals_name_the_lane_axis():
    a, stack, rows = _data()
    cfg = AEConfig(**CFG)
    dp2 = Mesh(("dp",), (2,), torch.device("cpu"))
    with pytest.raises(ValueError, match="lane axis of size 3 not divisible by the dp=2"):
        engine.sweep_autoencoders_padded(3, a, 36, cfg, [1, 2, 3], mesh=dp2)
    three, rows3 = engine.stack_padded([a, a[:30], a[:24]])
    with pytest.raises(ValueError, match="lane axis of size 3"):
        engine.sweep_autoencoders_multi(5, three, rows3, cfg, LATENTS, mesh=dp2)
    with pytest.raises(ValueError, match="'dp' axis"):
        engine.sweep_autoencoders_multi(5, stack, rows, cfg, LATENTS,
                                        mesh=Mesh(("sp",), (2,), torch.device("cpu")))
    with pytest.raises(RuntimeError, match="needs a process group"):
        engine.sweep_autoencoders_multi(5, stack, rows, cfg, LATENTS, mesh=dp2)
    from hfrep_tpu_torch.experiments.sweep import run_sweep
    with pytest.raises(ValueError, match="mesh requires the chunked drive"):
        run_sweep(a, a[:, :1], a, a[:, :1], a[:, 0], a, cfg=AEConfig(**dict(CFG, chunk_epochs=0)),
                  latent_dims=LATENTS, mesh=lane_mesh(4, device="cpu"), device="cpu")


def test_dp2_lane_mesh_is_the_meshless_drive_bit_for_bit(tmp_path):
    a, stack, rows = _data()
    cfg = AEConfig(**CFG)
    jcfg = JaxAEConfig(**CFG)
    key = jax.random.PRNGKey(5)
    jstack, jrows = jax_engine.stack_padded([jnp.asarray(a.numpy()), jnp.asarray(a[:28].numpy())])
    want_jax, want_jax_stats = jax_engine.sweep_autoencoders_multi(
        key, jstack, jrows, jcfg, LATENTS, mesh=jrules.lane_mesh(2, devices=jax.devices()[:2]))
    keys = [k for dk in jax.random.split(key, 2) for k in jax.random.split(dk, len(LATENTS))]
    init, perms = _lane_draws(keys, max(LATENTS), jcfg.epochs, int(36 * 0.75))
    lead = (2, len(LATENTS))
    spec = str(tmp_path / "job.pt")
    nan_init = engine.keras_init_params(torch.Generator().manual_seed(0), (len(LATENTS),), F,
                                        max(LATENTS), "cpu")
    nan_init["encoder_kernel"][len(LATENTS) - 1, 0, 0] = float("nan")    # rank 1's lanes
    torch.save({"cfg": CFG, "latents": LATENTS, "a": a, "stack": stack, "rows": rows,
                "jax_init": {k: torch.from_numpy(v.reshape(lead + v.shape[1:]))
                             for k, v in init.items()},
                "jax_perms": torch.from_numpy(perms.reshape(lead + perms.shape[1:])),
                "resume": str(tmp_path / "resume"),
                "resume_health": str(tmp_path / "resume_health"), "obs": str(tmp_path / "obs"),
                "dump": str(tmp_path / "dump"), "nan_init": nan_init}, spec)
    ranks = _spawn_ranks(RANK, spec)
    padded = engine.sweep_autoencoders_padded(3, a, 36, cfg, LATENTS, device="cpu")
    multi = engine.sweep_autoencoders_multi(5, stack, rows, cfg, LATENTS, device="cpu")
    for doc in ranks:
        assert doc["dp"] == (2, 2) and doc["preempted"]
        for name, (ref, ref_stats) in (("padded", padded), ("multi", multi),
                                       ("resumed", multi)):
            got, stats = doc[name]
            assert _equal(got, ref), name
            assert stats.lanes == ref_stats.lanes and stats.chunks_dispatched >= 1
        assert doc["padded"][1] == padded[1] and doc["multi"][1] == multi[1]
        got, stats = doc["jax"]
        np.testing.assert_array_equal(got.stop_epoch.numpy(), np.asarray(want_jax.stop_epoch))
        for k in ("encoder_kernel", "decoder_kernel"):
            np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want_jax.params[k]),
                                       atol=1e-5, rtol=1e-4, err_msg=k)
        for k in ("train_loss", "val_loss"):
            g, w = getattr(got, k).numpy(), np.asarray(getattr(want_jax, k))
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        assert stats.chunks_dispatched == want_jax_stats.chunks_dispatched
    assert not (tmp_path / "resume" / "chunk_snapshot").exists()   # cleared after the drive
    _check_split_health(tmp_path, ranks, padded, multi, a, cfg)


def _gauge_records(run_dir) -> list:
    """``(name, value, epoch)`` of every ``health/ae_*`` gauge a stream set,
    in order."""
    recs = [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()
            if line]
    return [(r["name"], r["value"], r["epoch"]) for r in recs
            if r.get("kind") == "gauge" and r["name"].startswith("health/ae_")]


def _check_split_health(tmp_path, ranks, padded, multi, a, cfg) -> None:
    """The dp=2 split grid with health on: training bit for bit the
    health-off meshless drive's; rank 0's gauges at every boundary and the
    drive's end the meshless health-on drive's (grad norm and nonfinite
    count equal, the param norm within rtol 1e-6: JAX's reduction, a
    NaN-ignoring max, a sum, the root of the summed squares), rank 1's
    none; the kill and resume with health on bit for bit; a NaN in rank
    1's lanes raising ``NumericFault`` on both ranks at the same boundary,
    with one dump, rank 0's, holding the whole grid."""
    health.configure(health.HealthConfig())
    try:
        with obs_pkg.session(tmp_path / "meshless_obs", command="t"):
            want, want_stats = engine.sweep_autoencoders_padded(3, a, 36, cfg, LATENTS,
                                                                device="cpu")
    finally:
        health.configure(None)
    assert _equal(want, padded[0])
    ref = _gauge_records(tmp_path / "meshless_obs")
    assert len(ref) >= 6
    got = _gauge_records(tmp_path / "obs" / "rank0")
    assert [(n, e) for n, _, e in got] == [(n, e) for n, _, e in ref]
    for (name, g, _), (_, r, _) in zip(got, ref):
        if name == "health/ae_param_norm":
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=name)
        else:
            assert g == r or (np.isnan(g) and np.isnan(r)), (name, g, r)
    assert _gauge_records(tmp_path / "obs" / "rank1") == []
    faults = []
    for doc in ranks:
        got, stats = doc["padded_health"]
        assert _equal(got, padded[0]) and stats == want_stats
        assert doc["preempted_health"] and _equal(doc["resumed_health"][0], multi[0])
        faults.append(doc["fault"])
    assert [(f["site"], f["epoch"], f["nonfinite"]) for f in faults] == \
        [(faults[0]["site"], faults[0]["epoch"], faults[0]["nonfinite"])] * 2
    assert faults[0]["site"] == "chunk" and faults[0]["nonfinite"] > 0
    assert faults[1]["dump"] is None
    dumps = list((tmp_path / "dump").iterdir())
    assert [str(d) for d in dumps] == [faults[0]["dump"]]
    with np.load(dumps[0] / "carry.npz") as z:
        flat = z["leaf_0"]
    assert flat.shape[:2] == (1, len(LATENTS)) and np.isnan(flat[0, -1]).any()


def test_dp2_walkforward_writes_once_and_drains_every_rank(tmp_path):
    from hfrep_tpu.utils import fixture_data as jax_fixture
    from hfrep_tpu_torch.scenario import walkforward

    x, y, rf = jax_fixture.universe_arrays(0, funds=6, months=64, n_factors=6)
    cfg = dict(n_factors=6, latent_dim=4, epochs=6, batch_size=16, chunk_epochs=3,
               ols_window=6, patience=2)
    spec_kw = dict(start=24, n_windows=4, horizon=10, step=2)
    latents = [1, 2, 4]
    spec = str(tmp_path / "job.pt")
    torch.save({"x": x, "y": y, "rf": rf, "cfg": cfg, "spec": spec_kw, "latents": latents,
                "drained": str(tmp_path / "drained"), "straight": str(tmp_path / "straight")},
               spec)
    ranks = _spawn_ranks(WF_RANK, spec)
    want = walkforward.run_walkforward(x, y, rf, walkforward.WalkForwardSpec(**spec_kw),
                                       AEConfig(**cfg), latents, tmp_path / "meshless",
                                       device="cpu")
    for doc in ranks:
        assert doc["dp"] == 2 and doc["preempted"]
        assert "lane axis of size 3 not divisible by the 2 ranks" in doc["refused"]
        assert doc["published"] == ["w_0000", "w_0001"]   # both stopped at one boundary
        for run in ("resumed", "straight"):
            for k in ("surface_post", "surface_ante"):
                np.testing.assert_array_equal(doc[run][k], want[k])
            assert doc[run]["manifest"] == want["manifest"]
    for run in ("drained", "straight"):
        for name in ("walkforward.csv", "walkforward_ante.csv", "walkforward.json"):
            assert (tmp_path / run / name).read_bytes() == \
                (tmp_path / "meshless" / name).read_bytes(), (run, name)
        assert not (tmp_path / run / "_resume").exists()
        # one writer: no temporary or parked publication left beside the scores
        assert sorted(p.name for p in (tmp_path / run / "windows").iterdir()) == \
            [f"w_{w:04d}" for w in range(4)]


def test_ae_mesh_fixture_publishes_the_ae_multi_artifact(tmp_path):
    from hfrep_tpu_torch.resilience import drive, drive_fixtures

    assert drive.DRIVE_REGISTRY["ae_mesh"].load_fixture() is drive_fixtures.run_ae_mesh
    docs = {}
    for name in ("ae_multi", "ae_mesh"):
        out = tmp_path / name
        for sub in ("artifacts", "scratch"):
            (out / sub).mkdir(parents=True)
        docs[name] = drive.DRIVE_REGISTRY[name].load_fixture()(out, 0, False, "cpu")
    assert docs["ae_mesh"] == docs["ae_multi"]
    with np.load(tmp_path / "ae_multi" / "artifacts" / "multi" / "data.npz") as za, \
            np.load(tmp_path / "ae_mesh" / "artifacts" / "multi" / "data.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])
