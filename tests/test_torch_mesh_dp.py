"""Data parallelism across processes on the CPU (gloo), held to the
port's single-device trajectory and to the JAX package's dp mesh.

* dp=2 against single (``tests/test_parallel.py:161-202``): two spawned
  ranks run a 4-epoch block of ``gan``, ``wgan`` and ``mtss_wgan_gp`` on
  their 8 rows of the global batch of 16, from the same state and the
  global batch's draws; every param and metric lands within atol 1e-5
  of the single-device block, and the two ranks are bit-equal.
* dp=2 against JAX: the ranks fed JAX's init and draws against JAX's
  ``make_gan_multi_step`` on ``MeshSpec(dp=2)`` over two virtual CPU
  devices, at the epoch bars (losses rtol 1e-4, params atol 1e-5 + rtol
  1e-4).
* ``replicate_to_global`` is a broadcast from rank 0.
* The CLI drill (``tests/test_distributed.py:693-714``): ``train-gan
  --coordinator/--process-id`` as two processes exits 0, lands within
  1e-5 of one process, rank 0 alone prints and writes checkpoints, a
  ``--resume`` from ``ckpt_2`` is bit-equal; SIGTERM to one rank drains
  both into exit 75 with a checkpoint.

Spawned ranks run on one thread each, as the pipeline's members do in
``tests/test_torch_orchestrate.py``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.parallel import rules as jrules
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.train import Draws, init_gan_state, make_multi_step, sample_draws
from hfrep_tpu_torch.utils import checkpoint as ckpt
from hfrep_tpu_torch.utils.bridge import gan_state_from_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
H, W, F, B, NC, EPOCHS, N_ROWS = 8, 8, 5, 16, 2, 4, 64
FAMILIES = ("gan", "wgan", "mtss_wgan_gp")

#: one rank: every job of the spec file through a dp=2 mesh, results saved
RANK = r'''
import sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, initialize_distributed,
                                      make_gan_multi_step, replicate_to_global,
                                      shutdown_distributed)
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.train import Draws, init_gan_state
rank, port, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
jobs = torch.load(spec, weights_only=False)
backend = initialize_distributed("127.0.0.1:" + port, 2, rank, device="cpu")
out = {"backend": backend}
try:
    mesh = build_mesh(MeshSpec(dp=2), device="cpu")
    for name, job in jobs.items():
        mcfg, tcfg = ModelConfig(**job["mcfg"]), TrainConfig(**job["tcfg"])
        pair = build_gan(mcfg, device="cpu")
        state = init_gan_state(0, mcfg, "cpu")
        for key in ("generator", "discriminator"):
            if key in job:
                getattr(state, key).load_state_dict(job[key])
        rules.reset_collective_counts()
        fn = make_gan_multi_step(pair, tcfg, job["dataset"], mesh)
        state, m = fn(state, draws=[Draws(*d) for d in job["draws"]])
        out[name] = {"g": {k: v.detach().clone() for k, v in state.generator.state_dict().items()},
                     "d": {k: v.detach().clone() for k, v in state.discriminator.state_dict().items()},
                     "m": m, "step": state.step, "collectives": rules.collective_counts()}
    t = torch.full((3,), float(rank))
    out["replicated"] = replicate_to_global({"t": t}, mesh)["t"]
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


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("HFREP_")}
    return dict(env, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def _spawn(argv_of, n: int = 2) -> list:
    return [subprocess.Popen(argv_of(r), cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for r in range(n)]


def _wait(procs, timeout: float = 240.0) -> list:
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _jax_draws(key):
    """The draws JAX's wgan_gp ``make_train_step`` derives from ``key``
    (``tests/test_torch_train.py::_jax_draws``, at this file's sizes)."""
    ks = [jax.random.split(jax.random.fold_in(key, i), 3) for i in range(NC)]
    idx = jax.numpy.stack([jax.random.randint(k[0], (B,), 0, N_ROWS) for k in ks])
    noises = jax.numpy.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])
    alphas = jax.numpy.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])
    return Draws(idx=_t(idx, torch.long), noises=_t(noises), alphas=_t(alphas))


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The single-device blocks in this process and the same blocks on two
    spawned gloo ranks; plus JAX's dp=2 mesh block and its inputs."""
    ds = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (N_ROWS, W, F))
                          .astype(np.float32))
    tcfg = dict(batch_size=B, n_critic=NC, steps_per_call=EPOCHS)
    jobs, single = {}, {}
    for fam in FAMILIES:
        mcfg = dict(family=fam, features=F, window=W, hidden=H)
        pair = build_gan(ModelConfig(**mcfg), device="cpu")
        g = torch.Generator().manual_seed(1)
        draws = [sample_draws(g, pair, TrainConfig(**tcfg), ds) for _ in range(EPOCHS)]
        state, m = make_multi_step(pair, TrainConfig(**tcfg), ds)(
            init_gan_state(0, ModelConfig(**mcfg), "cpu"), draws=draws)
        single[fam] = (state, m)
        jobs[fam] = {"mcfg": mcfg, "tcfg": tcfg, "dataset": ds,
                     "draws": [(d.idx, d.noises, d.alphas) for d in draws]}
    # JAX's dp=2 mesh block, and its init and draws for the ranks
    jm = JaxModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F)
    jt = JaxTrainConfig(batch_size=B, n_critic=NC, steps_per_call=EPOCHS, lstm_backend="xla")
    key = jax.random.PRNGKey(3)
    jds = jax.numpy.asarray(ds.numpy())
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(key, jm, jt, jpair)
    mesh = jrules.build_mesh(jrules.MeshSpec(dp=2), devices=jax.devices()[:2])
    block_key = jax.random.PRNGKey(9)
    jout = jrules.make_gan_multi_step(jpair, jt, jds, mesh)(jstate, block_key)
    jstate = jax_init_gan_state(key, jm, jt, jpair)      # the launch donated it
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
                     device="cpu")
    start = gan_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate.g_params),
                                jax.tree_util.tree_map(np.asarray, jstate.d_params), pair)
    jobs["jax"] = {"mcfg": dict(family="mtss_wgan_gp", features=F, window=W, hidden=H),
                   "tcfg": tcfg, "dataset": ds,
                   "generator": start.generator.state_dict(),
                   "discriminator": start.discriminator.state_dict(),
                   "draws": [(d.idx, d.noises, d.alphas) for d in
                             (_jax_draws(jax.random.fold_in(block_key, i))
                              for i in range(EPOCHS))]}
    spec = str(tmp_path_factory.mktemp("dp2") / "jobs.pt")
    torch.save(jobs, spec)
    port = str(_free_port())
    runs = _wait(_spawn(lambda r: [sys.executable, "-c", RANK, str(r), port, spec]))
    for rc, o, e in runs:
        assert rc == 0, e[-3000:]
    ranks = [torch.load(spec + f".rank{r}", weights_only=False) for r in (0, 1)]
    return single, ranks, jout


def _params(state) -> dict:
    return {"g": state.generator.state_dict(), "d": state.discriminator.state_dict()}


@pytest.mark.parametrize("family", FAMILIES)
def test_dp2_follows_the_single_device_block(dp2, family):
    single, ranks, _ = dp2
    state, m = single[family]
    want = _params(state)
    for doc in ranks:
        got = doc[family]
        for net in ("g", "d"):
            for k, v in want[net].items():
                np.testing.assert_allclose(got[net][k].numpy(), v.numpy(), atol=1e-5,
                                           rtol=0, err_msg=f"{net}.{k}")
        for k in m:
            np.testing.assert_allclose(got["m"][k].numpy(), m[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
        assert got["step"] == state.step == EPOCHS
        # one all_reduce an update: n_critic critic updates (two a critic
        # iteration for the clip and bce losses) and the generator's
        updates = (2 * NC + 1 if family == "wgan" else 3 if family == "gan" else NC + 1)
        assert got["collectives"]["all_reduce"] == updates * EPOCHS
    a, b = ranks[0][family], ranks[1][family]
    for net in ("g", "d"):
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net])
    assert all(torch.equal(a["m"][k], b["m"][k]) for k in a["m"])
    assert ranks[0]["backend"] == ranks[1]["backend"] == "gloo"


def test_dp2_against_jax_s_dp2_mesh(dp2):
    _, ranks, (jstate, jm) = dp2
    got = ranks[0]["jax"]
    for k in jm:
        np.testing.assert_allclose(got["m"][k].numpy(), np.asarray(jm[k]), rtol=1e-4,
                                   err_msg=k)
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
                     device="cpu")
    for net, module, tree in (("g", pair.generator, jstate.g_params),
                              ("d", pair.discriminator, jstate.d_params)):
        module.load_state_dict(got[net])
        mine = jax.tree_util.tree_leaves_with_path(to_flax(module))
        ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree))
        assert [p for p, _ in mine] == [p for p, _ in ref]
        for (path, a), (_, r) in zip(mine, ref):
            np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{net} {jax.tree_util.keystr(path)}")
    assert got["step"] == int(jstate.step) == EPOCHS


def test_replicate_to_global_is_a_broadcast_from_rank_0(dp2):
    _, ranks, _ = dp2
    assert all(torch.equal(d["replicated"], torch.zeros(3)) for d in ranks)


# ----------------------------------------------------------------- the CLI
def _cli(args, port=None, pid=None) -> list:
    argv = [sys.executable, "-m", "hfrep_tpu_torch", "train-gan", "--preset", "wgan",
            "--cleaned-dir", CLEANED, "--device", "cpu", "--quiet", *map(str, args)]
    if port is not None:
        argv += ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(pid)]
    return argv


def _generator(path) -> dict:
    return ckpt.restore(str(path))["state"]["generator"]


def test_cli_drill_two_ranks_land_on_one_process_and_resume_bitwise(tmp_path):
    p1, p2 = _free_port(), _free_port()
    procs = {"single": _spawn(lambda r: _cli(["--epochs", 4, "--checkpoint-dir",
                                              tmp_path / "single"]), n=1),
             "dp2": _spawn(lambda r: _cli(["--epochs", 4, "--checkpoint-dir", tmp_path / "dp2",
                                           "--obs-dir", tmp_path / "obs"], p1, r)),
             "half": _spawn(lambda r: _cli(["--epochs", 2, "--checkpoint-dir",
                                            tmp_path / "half"], p2, r))}
    runs = {k: _wait(v) for k, v in procs.items()}
    for k, rs in runs.items():
        for rc, o, e in rs:
            assert rc == 0, (k, e[-3000:])
    assert "trained wgan for 4 epochs" in runs["dp2"][0][1]
    assert runs["dp2"][1][1] == "" and runs["half"][1][1] == ""     # rank 0 alone prints
    p3 = _free_port()
    resumed = _wait(_spawn(lambda r: _cli(["--epochs", 4, "--checkpoint-dir",
                                           tmp_path / "half", "--resume"], p3, r)))
    assert [rc for rc, _, _ in resumed] == [0, 0], resumed[0][2][-3000:]
    assert "resumed from" in resumed[0][1]
    single = _generator(tmp_path / "single" / "ckpt_4")
    dp = _generator(tmp_path / "dp2" / "ckpt_4")
    res = _generator(tmp_path / "half" / "ckpt_4")
    for k, v in single.items():
        np.testing.assert_allclose(dp[k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=k)
        assert torch.equal(res[k], dp[k]), k
    spans = {r: sum(1 for line in (tmp_path / "obs" / f"proc{r}" / "events.jsonl")
                    .read_text().splitlines()
                    if '"checkpoint"' in line and '"span"' in line) for r in (0, 1)}
    assert spans[0] >= 1 and spans[1] == 0                  # rank 0 alone writes
    build = [json.loads(line) for line in (tmp_path / "obs" / "proc1" / "events.jsonl")
             .read_text().splitlines() if '"parallel_build"' in line]
    assert build and build[0]["mesh"] == {"dp": 2} and build[0]["backend"] == "gloo"
    manifest = json.loads((tmp_path / "obs" / "proc0" / "run.json").read_text())
    assert manifest["mesh"] == {"dp": 2}


def test_sigterm_to_one_rank_drains_both_into_exit_75(tmp_path):
    port = _free_port()
    procs = _spawn(lambda r: _cli(["--epochs", 2000, "--checkpoint-dir", tmp_path / "ck",
                                   "--obs-dir", tmp_path / "obs"], port, r))
    try:
        manifest = tmp_path / "obs" / "proc1" / "run.json"
        deadline = time.time() + 120
        while not (manifest.exists() and '"mesh"' in manifest.read_text()):
            assert time.time() < deadline and procs[1].poll() is None, "rank 1 never trained"
            time.sleep(0.1)
        procs[1].send_signal(signal.SIGTERM)
    finally:
        runs = _wait(procs)
    assert [rc for rc, _, _ in runs] == [75, 75], [e[-2000:] for _, _, e in runs]
    ckpts = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert ckpts and ckpts[-1].startswith("ckpt_")
    epoch = int(ckpts[-1].split("_")[1])
    assert 0 < epoch < 2000 and ckpt.restore(str(tmp_path / "ck" / ckpts[-1]))["epoch"] == epoch
