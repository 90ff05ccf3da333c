"""The window axis's mesh and CLI surface (``hfrep_tpu_torch/parallel/
{mesh,rules,dp_sp}.py``, ``experiments/cli.py``) against the JAX
package, on the CPU.

* The flags (``hfrep_tpu/experiments/cli.py:51-90, :415-500``):
  ``--sp-mesh``, ``--dp-sp``, ``--tp-mesh``, ``--dp-tp``, ``--dp-sp-tp``
  parse as JAX's; they and ``--mesh`` exclude each other, with JAX's
  messages; the retired knobs ``--sp-microbatches`` and ``--sp-remat``
  are validated as JAX validates them, threaded to ``TrainConfig`` and
  ignored; the tp flags' values parse as JAX's, with its messages, and
  build their meshes.
* ``make_mesh_2d`` (``hfrep_tpu/parallel/mesh.py:35``) and its
  refusals; the hook's layout rule (``data_constraint``, JAX's
  ``rules.py:288-325``) and the window chain on a 2×2 dp×sp mesh.
* dp×sp on four gloo ranks (a 2×2 mesh: the window chains in sub-groups
  of their own): one WGAN-GP epoch from JAX's init on JAX's draws
  against JAX's plain epoch at atol 1e-4, the four ranks within rtol
  1e-6 (``tests/test_distributed.py:326-372``).
* The verb: ``train-gan --dp-sp 1x2 --coordinator`` as two processes
  exits 0 with rank 0 alone printing, and a ``--resume`` from its
  mid-run checkpoint is bit-equal to the straight run.
"""

from __future__ import annotations

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

from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.experiments import cli as jcli
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu.train.steps import make_train_step as jax_make_train_step
from hfrep_tpu_torch.config import ModelConfig
from hfrep_tpu_torch.experiments import cli
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import mesh as pmesh
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.parallel.chain import Chain
from hfrep_tpu_torch.parallel.rules import Mesh
from hfrep_tpu_torch.utils import checkpoint as ckpt
from hfrep_tpu_torch.utils.bridge import gan_state_from_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
H, W, F, B, NC, N_ROWS = 8, 12, 5, 8, 2, 32
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------- the flags
def test_the_mesh_flags_parse_as_jax_s():
    args = cli._build_parser().parse_args(
        ["train-gan", "--dp-sp", "1x2", "--sp-microbatches", "2", "--sp-remat"])
    assert (args.dp_sp, args.sp_microbatches, args.sp_remat, args.sp_mesh, args.tp_mesh,
            args.dp_tp, args.dp_sp_tp) == ("1x2", 2, True, False, None, None, None)
    args = cli._build_parser().parse_args(["train-gan", "--tp-mesh", "2", "--sp-mesh"])
    assert (args.tp_mesh, args.sp_mesh) == (2, True)
    help_text = cli._build_parser()._subparsers._group_actions[0].choices["train-gan"] \
        .format_help()
    for flag in ("--sp-mesh", "--dp-sp", "--tp-mesh", "--dp-tp", "--dp-sp-tp",
                 "--sp-microbatches", "--sp-remat"):
        assert flag in help_text
    assert help_text.count("RETIRED") == 2 and "9c" not in help_text
    assert "parallel/tensor.py" in help_text and "parallel/dp_sp_tp.py" in help_text


#: flag sets JAX's ``_make_trainer`` refuses before any device work, and
#: the port's with them, by the same message
REFUSED = [
    dict(mesh=True, sp_mesh=True),
    dict(sp_mesh=True, dp_sp="1x2"),
    dict(dp_sp="1x2", tp_mesh=2),
    dict(dp_tp="1x2", dp_sp_tp="1x1x2"),
    dict(mesh=True, sp_remat=True),
    dict(sp_remat=True),
    dict(dp_sp="2by4"),
    dict(tp_mesh=0),
    dict(dp_tp="2by4"),
    dict(dp_sp_tp="2x2"),
]


@pytest.mark.parametrize("flags", REFUSED, ids=lambda f: "+".join(sorted(f)))
def test_flag_refusals_are_jax_s(flags):
    with pytest.raises(SystemExit) as theirs:
        jcli._make_trainer("mtss_wgan_gp", CLEANED, **flags)
    with pytest.raises(SystemExit) as mine:
        cli._make_trainer("mtss_wgan_gp", CLEANED, device="cpu", **flags)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("flags,match", [
    (dict(sp_microbatches=0, sp_mesh=True), "--sp-microbatches wants M >= 1, got 0"),
    (dict(sp_microbatches=2, mesh=True), "requires a window-sharded mesh"),
    (dict(tp_mesh=2), r"requested tp=2 but the process group spans 1 rank"),
    (dict(dp_tp="1by2"), r"--dp-tp wants DPxTP \(e\.g\. 2x4\), got '1by2'"),
    (dict(dp_sp_tp="1x2"), r"--dp-sp-tp wants DPxSPxTP \(e\.g\. 2x2x2\), got '1x2'"),
    (dict(tp_mesh=0), "--tp-mesh wants N >= 1 devices, got 0"),
    (dict(dp_sp="1x2"), r"requested dp×sp=1×2 but the process group spans 1 rank"),
])
def test_flag_refusals_the_port_adds_or_moves(flags, match):
    """The retired knobs checked before any mesh is built (JAX checks them
    after its mesh, which needs devices this process lacks); the tp
    flags' bad values with JAX's messages; a mesh larger than the group
    refused."""
    with pytest.raises((SystemExit, ValueError), match=match):
        cli._make_trainer("mtss_wgan_gp", CLEANED, device="cpu", **flags)


def test_retired_knobs_thread_to_the_config_and_change_nothing():
    tr, cfg = cli._make_trainer("mtss_wgan_gp", CLEANED, device="cpu", sp_mesh=True,
                                sp_microbatches=4, sp_remat=True)
    assert (cfg.train.sp_microbatches, cfg.train.sp_remat) == (4, True)
    assert tr.mesh.shape == {"sp": 1} and rules.data_constraint(tr.mesh) is None
    plain, _ = cli._make_trainer("mtss_wgan_gp", CLEANED, device="cpu")
    tr.train(1)
    plain.train(1)
    assert tr.history == plain.history


@pytest.mark.parametrize("flags,shape", [
    (dict(tp_mesh=1), {"tp": 1}),
    (dict(dp_tp="1x1"), {"dp": 1, "tp": 1}),
    (dict(dp_sp_tp="1x1x1"), {"dp": 1, "sp": 1, "tp": 1}),
])
def test_the_tp_flags_build_their_meshes(flags, shape):
    """Each tp flag builds the mesh it names (one rank here: no hook, the
    plain step) and the trainer on it trains the plain trajectory."""
    tr, _ = cli._make_trainer("mtss_wgan_gp", CLEANED, device="cpu", **flags)
    assert tr.mesh.shape == shape and rules.data_constraint(tr.mesh) is None
    plain, _ = cli._make_trainer("mtss_wgan_gp", CLEANED, device="cpu")
    tr.train(1)
    plain.train(1)
    assert tr.history == plain.history


# ----------------------------------------------------------- the mesh core
def test_mesh_2d_and_its_refusals():
    one = pmesh.make_mesh_2d(1, 1, device="cpu")
    assert (one.axis_names, one.axis_sizes, one.group) == (("dp", "sp"), (1, 1), None)
    with pytest.raises(ValueError, match=r"dp×sp mesh dims must be >= 1, got 0×2"):
        pmesh.make_mesh_2d(0, 2, device="cpu")
    with pytest.raises(ValueError, match="requested dp×sp=2×2 but the process group spans 1"):
        pmesh.make_mesh_2d(2, 2, device="cpu")
    assert rules.mesh_spec(Mesh(("dp", "sp"), (2, 4), CPU)) == rules.MeshSpec(dp=2, sp=4)
    tp = pmesh.make_mesh_2d(1, 1, device="cpu", axis_names=("dp", "tp"))
    assert (tp.axis_names, tp.axis_sizes) == (("dp", "tp"), (1, 1))
    with pytest.raises(ValueError, match=r"dp×tp mesh dims must be >= 1, got 1×0"):
        pmesh.make_mesh_2d(1, 0, device="cpu", axis_names=("dp", "tp"))
    with pytest.raises(ValueError, match="requested dp×tp=1×2 but the process group spans 1"):
        pmesh.make_mesh_2d(1, 2, device="cpu", axis_names=("dp", "tp"))
    three = pmesh.make_mesh_3d(1, 1, 1, device="cpu")
    assert (three.axis_names, three.axis_sizes) == (("dp", "sp", "tp"), (1, 1, 1))
    with pytest.raises(ValueError, match="dp×sp×tp mesh dims must be >= 1, got sp=0"):
        pmesh.make_mesh_3d(1, 0, 2, device="cpu")
    with pytest.raises(ValueError, match=r"requested dp×sp×tp=1×2×2 \(4 devices\) but the "
                                         "process group spans 1"):
        pmesh.make_mesh_3d(1, 2, 2, device="cpu")


@pytest.mark.parametrize("rank", range(4))
def test_the_hook_s_layout_on_a_2x2_mesh(rank):
    """Rows over dp and the window chunk over sp, by JAX's rule: a draw
    with a window axis and a feature axis after it is cut along both, an
    index or α along the rows only; the window's chain runs in the sp
    sub-group between the ranks of one dp row."""
    mesh = Mesh(("dp", "sp"), (2, 2), CPU, rank=rank, group=object(),
                axis_groups={0: "dp group", 1: "sp group"})
    hook = rules.data_constraint(mesh)
    dp, sp = divmod(rank, 2)
    assert (hook.n, hook.rank, hook.n_sp, hook.sp_rank, hook.inner) == (2, dp, 2, sp, 2)
    assert hook.sum_window is None and rules.data_constraint(mesh, len).sum_window is len
    chain = Chain(mesh, "sp")
    assert chain.group == "sp group" and chain.k == sp
    assert (chain.prev, chain.next) == ((None, rank + 1) if sp == 0 else (rank - 1, None))
    noises = torch.arange(2 * 8 * 12 * 3.0).reshape(2, 8, 12, 3)
    got = hook(noises, 1)
    assert torch.equal(got, noises[:, 4 * dp:4 * dp + 4, 6 * sp:6 * sp + 6])
    idx = torch.arange(16).reshape(2, 8)
    assert torch.equal(hook(idx, 1), idx[:, 4 * dp:4 * dp + 4])
    alphas = torch.rand(2, 8, 1, 1)
    assert torch.equal(hook(alphas, 1), alphas[:, 4 * dp:4 * dp + 4])
    with pytest.raises(ValueError, match="window 7 not divisible by sp=2"):
        hook.window(torch.zeros(1, 7, 2), 1)
    assert rules.data_constraint(Mesh(("dp", "sp"), (1, 1), CPU)) is None


# ------------------------------------------------------------ dp × sp = 2 × 2
RANK4 = r'''
import sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import (initialize_distributed, make_dp_sp_train_step,
                                      make_mesh_2d, shutdown_distributed)
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.train import Draws, init_gan_state
rank, store, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
initialize_distributed("file://" + store, 4, rank, device="cpu")
try:
    mesh = make_mesh_2d(2, 2, device="cpu")
    mcfg, tcfg = ModelConfig(**job["mcfg"]), TrainConfig(**job["tcfg"])
    pair = build_gan(mcfg, device="cpu")
    state = init_gan_state(0, mcfg, "cpu")
    state.generator.load_state_dict(job["g0"])
    state.discriminator.load_state_dict(job["d0"])
    state, m = make_dp_sp_train_step(pair, tcfg, job["dataset"], mesh)(state, Draws(*job["draws"]))
    torch.save({"g": state.generator.state_dict(), "d": state.discriminator.state_dict(),
                "m": m, "coords": mesh.coords(), "collectives": rules.collective_counts()},
               spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("HFREP_")}
    return dict(env, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def _finish(procs, timeout: float) -> list:
    try:
        runs = [(p,) + p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, out, err in runs]


def test_dp_sp_2x2_matches_one_device(tmp_path):
    jm = JaxModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F)
    jt = JaxTrainConfig(batch_size=B, n_critic=NC, lstm_backend="xla")
    ds = np.random.default_rng(3).uniform(0, 1, (N_ROWS, W, F)).astype(np.float32)
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(jax.random.PRNGKey(0), jm, jt, jpair)
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
                     device="cpu")
    start = gan_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate.g_params),
                                jax.tree_util.tree_map(np.asarray, jstate.d_params), pair)
    key = jax.random.PRNGKey(1)
    ks = [jax.random.split(jax.random.fold_in(key, i), 3) for i in range(NC)]
    draws = (_t(jnp.stack([jax.random.randint(k[0], (B,), 0, N_ROWS) for k in ks]), torch.long),
             _t(jnp.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])),
             _t(jnp.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])))
    jstate1, jmetrics = jax.jit(jax_make_train_step(jpair, jt, jnp.asarray(ds)))(jstate, key)
    spec = str(tmp_path / "job.pt")
    torch.save({"mcfg": dict(family="mtss_wgan_gp", features=F, window=W, hidden=H),
                "tcfg": dict(batch_size=B, n_critic=NC), "dataset": torch.from_numpy(ds),
                "g0": start.generator.state_dict(), "d0": start.discriminator.state_dict(),
                "draws": draws}, spec)
    procs = [subprocess.Popen([sys.executable, "-c", RANK4, str(r), spec + ".store", spec],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    runs = _finish(procs, 300)
    assert all(rc == 0 for rc, _, _ in runs), [e[-2000:] for _, _, e in runs]
    ranks = [torch.load(spec + f".rank{r}", weights_only=False) for r in range(4)]
    assert [d["coords"] for d in ranks] == [{"dp": a, "sp": b} for a in (0, 1) for b in (0, 1)]
    for doc in ranks:
        for k in jmetrics:
            np.testing.assert_allclose(doc["m"][k].numpy(), np.asarray(jmetrics[k]), atol=1e-4,
                                       rtol=0, err_msg=k)
        for net, module, tree in (("g", pair.generator, jstate1.g_params),
                                  ("d", pair.discriminator, jstate1.d_params)):
            module.load_state_dict(doc[net])
            mine = jax.tree_util.tree_leaves_with_path(to_flax(module))
            ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree))
            for (path, a), (_, r) in zip(mine, ref):
                np.testing.assert_allclose(a, r, atol=1e-4, rtol=0,
                                           err_msg=f"{net} {jax.tree_util.keystr(path)}")
        for net in ("g", "d"):
            for k in doc[net]:
                np.testing.assert_allclose(doc[net][k].numpy(), ranks[0][net][k].numpy(),
                                           rtol=1e-6, atol=0)
        # an sp pair's carries and scores stay in its dp row: one update's
        # reduction spans all four ranks
        assert doc["collectives"]["all_reduce"] == (2 * NC + 1) + NC + (NC + 1)


# ----------------------------------------------------------------- the verb
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(args) -> list:
    port = str(_free_port())
    argv = [sys.executable, "-m", "hfrep_tpu_torch", "train-gan", "--preset", "mtss_wgan_gp",
            "--cleaned-dir", CLEANED, "--device", "cpu", "--dp-sp", "1x2",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", *map(str, args)]
    return [subprocess.Popen(argv + ["--process-id", str(r)], cwd=ROOT, env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in (0, 1)]


def test_train_gan_dp_sp_two_ranks_resume_is_bit_equal(tmp_path):
    straight, half = tmp_path / "straight", tmp_path / "half"
    runs = {"straight": _pair(["--epochs", 3, "--checkpoint-dir", straight]),
            "half": _pair(["--epochs", 1, "--checkpoint-dir", half])}
    done = {k: _finish(v, 300) for k, v in runs.items()}
    for name, pair in done.items():
        assert [rc for rc, _, _ in pair] == [0, 0], (name, [e[-2000:] for _, _, e in pair])
        assert "trained mtss_wgan_gp" in pair[0][1] and pair[1][1].strip() == ""
    resumed = _finish(_pair(["--epochs", 3, "--checkpoint-dir", half, "--resume"]), 300)
    assert [rc for rc, _, _ in resumed] == [0, 0], [e[-2000:] for _, _, e in resumed]
    assert "resumed from" in resumed[0][1] and resumed[1][1].strip() == ""
    a = ckpt.restore(str(straight / "ckpt_3"))["state"]
    b = ckpt.restore(str(half / "ckpt_3"))["state"]
    for net in ("generator", "discriminator"):
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net])
