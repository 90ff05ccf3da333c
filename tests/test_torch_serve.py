"""The port's serving slice (``hfrep_tpu_torch.serve``) against the JAX
package, plus the port's own rules.

* ``ae_batch_fn`` and ``gen_batch_fn`` against the JAX programs on the
  same operands (padded rows and ``n_rows == 0`` slots included), f32
  atol 1e-5, rtol 1e-4;
* a port server on the CPU and a JAX ``ReplicationServer`` on the same
  bridged AE params and panels: ``replicate`` answers agree at the f32
  bar; ``sample`` answers are well shaped and finite (noise cannot match
  across frameworks, so sample parity is held at the program level);
* the envelope (breaker, shedding, drain, requeue-once) on the port;
* the package imports no ``jax`` and nothing of ``hfrep_tpu``, and an
  entry point called without ``device`` on a machine with no card raises.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from concurrent.futures import wait
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.models.registry import build_gan
from hfrep_tpu.serve import aot as jax_aot
from hfrep_tpu.serve.server import ReplicationServer as JaxServer
from hfrep_tpu.serve.server import ServeConfig as JaxServeConfig
from hfrep_tpu_torch.config import AEConfig, ModelConfig
from hfrep_tpu_torch.serve import aot
from hfrep_tpu_torch.serve.admission import Draining, Overloaded, WorkerFault
from hfrep_tpu_torch.serve.fixture import (fixture_ae_model, fixture_gen_model,
                                           fixture_server, init_ae_model, warm_server)
from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
from hfrep_tpu_torch.serve.server import ReplicationServer, ServeConfig

REPO_ROOT = Path(__file__).resolve().parents[1]
FEATS = 22


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ae_params(feats=FEATS, latent=21, seed=0):
    g = np.random.default_rng(seed)
    lim_e = np.sqrt(6.0 / (feats + latent))
    return {"encoder_kernel": g.uniform(-lim_e, lim_e, (feats, latent)).astype(np.float32),
            "decoder_kernel": g.uniform(-lim_e, lim_e, (latent, feats)).astype(np.float32)}


def _panel(rows, feats=FEATS, seed=0):
    return (np.random.default_rng(seed).normal(size=(rows, feats)) * 0.02
            ).astype(np.float32)


def _cpu_cfg(**kw):
    base = dict(max_batch=4, batch_window_ms=3.0, request_timeout_ms=30000.0,
                max_queue=16, workers=1, row_buckets=(32,), sample_buckets=(4,),
                breaker_failures=2, breaker_cooldown_s=0.25, compile_storm=64)
    base.update(kw)
    return ServeConfig(**base)


# ------------------------------------------------- programs vs the JAX ones
@pytest.mark.parametrize("latent", [21, 5])
def test_ae_batch_fn_matches_jax_with_padding_and_empty_slots(latent):
    params = _ae_params()
    panels = [_panel(30, seed=1), _panel(7, seed=2), _panel(1, seed=3)]
    mask = (np.arange(21) < latent).astype(np.float32)
    x, n = jax_aot.pad_panel_batch(panels, batch=4, rows=32, feats=FEATS)
    jmodel = jax_aot.AEServeModel.create(JaxAEConfig(), params, mask=mask)
    jrecon, jerr = jax_aot.ae_batch_fn(jmodel)(jmodel.params, x, n, jmodel.mask)
    model = aot.AEServeModel.create(AEConfig(), params, mask=mask, device="cpu")
    tx, tn = aot.pad_panel_batch(panels, 4, 32, FEATS, device="cpu")
    recon, err = aot.ae_batch_fn(model)(model.params, tx, tn, model.mask)
    np.testing.assert_allclose(recon.numpy(), np.asarray(jrecon), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-5, rtol=1e-4)
    assert float(err[3]) == 0.0 and float(recon[3].abs().max()) == 0.0   # empty slot
    assert float(recon[1, 7:].abs().max()) == 0.0                        # padded rows
    np.testing.assert_array_equal(model.decoder_host, params["decoder_kernel"])


@pytest.mark.parametrize("family", ["mtss_wgan_gp", "gan"])
def test_gen_batch_fn_matches_jax_on_the_same_noise(family):
    jcfg = JaxModelConfig(family=family, hidden=16, features=5, window=8)
    noise = np.random.default_rng(7).normal(size=(4, 8, 5)).astype(np.float32)
    params = build_gan(jcfg).generator.init(jax.random.PRNGKey(0),
                                            jnp.asarray(noise))["params"]
    jmodel = jax_aot.GenServeModel.create(jcfg, params)
    ref = np.asarray(jax_aot.gen_batch_fn(jmodel)(jmodel.params, jnp.asarray(noise)))
    model = aot.GenServeModel.create(
        ModelConfig(family=family, hidden=16, features=5, window=8),
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    got = aot.gen_batch_fn(model)(model.params, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_buckets_padding_and_program_cache():
    assert aot.bucket_for(1, (32, 64)) == 32 and aot.bucket_for(33, (32, 64)) == 64
    with pytest.raises(aot.BucketError):
        aot.bucket_for(65, (32, 64))
    x, n = aot.pad_panel_batch([_panel(5, 6), _panel(8, 6)], 4, 16, 6, device="cpu")
    assert tuple(x.shape) == (4, 16, 6) and n.tolist() == [5, 8, 0, 0]
    assert float(x[0, 5:].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        aot.pad_panel_batch([_panel(5, 3)], 1, 16, 6, device="cpu")
    with pytest.raises(ValueError):
        aot.pad_panel_batch([_panel(20, 6)], 1, 16, 6, device="cpu")
    compiles = []
    cache = aot.ProgramCache(capacity=2, on_compile=lambda: compiles.append(1))
    for key in ("a", "b", "c"):
        cache.get_or_compile((key,), lambda: (lambda: key))
    assert len(cache) == 2 and cache.evictions == 1 and len(compiles) == 3
    cache.warming = True
    cache.get_or_compile(("d",), lambda: (lambda: "d"))
    assert len(compiles) == 3 and cache.compiles == 4


# -------------------------------------------------- the slice end to end
def test_server_replicate_matches_jax_server_and_samples_are_sound():
    params = _ae_params(seed=5)
    panels = make_panels(3, FEATS, (12, 32, 20), variants=6)
    jax_srv = JaxServer(JaxServeConfig(max_batch=4, workers=1, row_buckets=(32,),
                                       request_timeout_ms=60000.0, compile_storm=64),
                        ae_model=jax_aot.AEServeModel.create(JaxAEConfig(), params)).start()
    try:
        jfuts = [jax_srv.replicate(p, timeout_ms=60000) for p in panels]
        wait(jfuts, timeout=120)
        jres = [f.result().value for f in jfuts]
    finally:
        jax_srv.stop()

    gen = fixture_gen_model("mtss_wgan_gp", device="cpu")
    srv = ReplicationServer(
        _cpu_cfg(workers=2),
        ae_model=aot.AEServeModel.create(AEConfig(), params, device="cpu"),
        gen_model=gen).start()
    try:
        assert srv.warm() == 4
        report = drive_load(srv, 2 * len(panels), panels, sample_every=2,
                            timeout_ms=60000, keep_futures=True)
    finally:
        srv.stop()
    assert report["terminal"] == report["submitted"] == 12
    assert report["results"] == 12 and srv.outcomes.terminal == 12
    futs = report["futures"]
    for j in range(0, len(futs), 2):          # drive_load's replicate slots
        got, ref, p = futs[j].result().value, jres[j % 6], panels[j % 6]
        assert got["reconstruction"].shape == p.shape
        np.testing.assert_allclose(got["reconstruction"], ref["reconstruction"],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got["recon_mse"], ref["recon_mse"],
                                   atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(got["weights"], ref["weights"])
    for j, f in enumerate(futs):
        if j % 2 == 1:
            win = f.result().value["windows"]
            assert win.shape == (1, 48, 35) and np.isfinite(win).all()


def test_sample_noise_is_pure_in_seed_and_sequence():
    def run(seed):
        srv = ReplicationServer(_cpu_cfg(seed=seed),
                                gen_model=fixture_gen_model("mtss_wgan_gp",
                                                            device="cpu")).start()
        try:
            futs = [srv.sample(2, timeout_ms=60000) for _ in range(1)]
            wait(futs, timeout=60)
            return futs[0].result().value["windows"]
        finally:
            srv.stop()
    a, b, c = run(0), run(0), run(1)
    assert a.shape == (2, 48, 35)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ------------------------------------------------------------ the envelope
def test_breaker_degrades_stale_then_recovers():
    srv = ReplicationServer(_cpu_cfg(), ae_model=init_ae_model(device="cpu")).start()
    try:
        ok = srv.replicate(_panel(10), timeout_ms=30000)
        wait([ok], timeout=30)
        assert not ok.result().stale
        real = srv._run_replicate
        srv._run_replicate = lambda batch: (_ for _ in ()).throw(RuntimeError("boom"))
        for _ in range(2):
            f = srv.replicate(_panel(10), timeout_ms=30000)
            wait([f], timeout=30)
            assert isinstance(f.exception(), WorkerFault)
        assert srv.breaker.state == "open"
        stale = srv.replicate(_panel(10), timeout_ms=30000)
        wait([stale], timeout=30)
        assert stale.result().stale
        srv._run_replicate = real
        srv.breaker._clock = lambda: 1e12          # cooldown elapsed
        fresh = srv.replicate(_panel(10), timeout_ms=30000)
        wait([fresh], timeout=30)
        assert not fresh.result().stale and srv.breaker.state == "closed"
    finally:
        srv.stop()
    assert srv.outcomes.terminal == srv.outcomes.submitted


def test_worker_death_requeues_once_then_fails_typed():
    srv = ReplicationServer(_cpu_cfg(), ae_model=init_ae_model(device="cpu"))
    kills = iter([True, False])
    srv._kill_point = lambda: next(kills, False)
    srv.start()
    try:
        f = srv.replicate(_panel(10), timeout_ms=30000)
        wait([f], timeout=30)
        assert f.result().kind == "replicate"
        assert srv.outcomes.requeues == 1 and srv.outcomes.worker_kills == 1
        srv._kill_point = lambda: True
        g = srv.replicate(_panel(10), timeout_ms=30000)
        wait([g], timeout=30)
        assert isinstance(g.exception(), WorkerFault)
    finally:
        srv._kill_point = lambda: False
        srv.stop()
    assert srv.outcomes.terminal == srv.outcomes.submitted


def test_drain_flushes_then_rejects_and_overload_sheds():
    srv = fixture_server(_cpu_cfg(max_queue=2, batch_window_ms=200.0), preset=None,
                         device="cpu", ae_model=init_ae_model(device="cpu"))
    futs = [srv.replicate(_panel(10), timeout_ms=30000) for _ in range(4)]
    shed = [f for f in futs if f.done() and isinstance(f.exception(), Overloaded)]
    assert len(shed) == 2
    bad = srv.replicate(_panel(10, feats=3))
    assert bad.exception().code == "invalid"
    srv.batcher.start_drain("test")
    during = srv.replicate(_panel(10))
    assert isinstance(during.exception(), Draining)
    doc = srv.drain(timeout=30)
    assert doc["flushed"] and doc["terminal"] == doc["submitted"] == 6
    assert all(f.done() for f in futs) and sum(f.exception() is None for f in futs) == 2
    after = srv.replicate(_panel(10))
    assert after.exception().code == "closed"
    assert srv.outcomes.terminal == srv.outcomes.submitted == 7


def test_warm_server_pushes_both_paths():
    srv = fixture_server(_cpu_cfg(workers=2), device="cpu",
                         ae_model=init_ae_model(device="cpu"))
    try:
        assert warm_server(srv, make_panels(0, FEATS, (12,))) == 4
        stats = srv.stats()
        assert stats["results"] == 8 and stats["worker_faults"] == 0
        assert stats["breaker"]["state"] == "closed"
    finally:
        srv.stop()


# ------------------------------------------------------------------ rules
def test_package_imports_no_jax_and_nothing_of_hfrep_tpu():
    code = (
        "import sys, pkgutil, importlib, hfrep_tpu_torch\n"
        "for m in pkgutil.walk_packages(hfrep_tpu_torch.__path__, 'hfrep_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib',"
        " 'flax', 'hfrep_tpu.')) or m == 'hfrep_tpu']\n"
        "print(len([m for m in sys.modules if m.startswith('hfrep_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_package_source_names_no_jax_module():
    root = REPO_ROOT / "hfrep_tpu_torch"
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax", "hfrep_tpu"), \
                    f"{path.relative_to(REPO_ROOT)} imports {n}"
    chip_smoke = REPO_ROOT / "chip_smoke.py"
    for node in ast.walk(ast.parse(chip_smoke.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert not any(m.split(".")[0] in ("jax", "flax", "hfrep_tpu") for m in mods)


def test_entry_points_without_device_raise_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fixture_ae_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_ae_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fixture_gen_model("mtss_wgan_gp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fixture_server(ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aot.GenServeModel.create(ModelConfig(family="gan"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aot.pad_panel_batch([_panel(3)], 1, 32, FEATS)
