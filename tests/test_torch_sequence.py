"""Sequence parallelism (``hfrep_tpu_torch/parallel/sequence.py``) against
the JAX package, on the CPU.

* The plain param-level forwards in one process: ``generator_forward``,
  ``critic_forward`` and ``_lstm_layer`` against JAX's on JAX's params and
  inputs at 2e-5; a window run as chained carry chunks equals the whole
  window; ``sp_microbatch_plan`` equals JAX's.
* On two gloo ranks (``sp=2``): ``sp_generate`` (the ranks' chunks
  joined), ``sp_critic`` and ``sp_lstm`` against JAX's forwards at 2e-5;
  the critic's gradients (the ranks' parameter partials summed, each
  rank's input chunk) against ``jax.grad`` at 1e-4; one WGAN-GP epoch
  from JAX's init on JAX's draws against JAX's plain step at atol 1e-4
  (``tests/test_distributed.py:326-440``), on an ``('sp',)`` mesh and on
  a 1×2 ``('dp', 'sp')`` mesh; a 3-epoch block against the port's
  single-device block; the ranks within rtol 1e-6 of each other.
* The trainer (``tests/test_train.py:174-251``): ``GanTrainer`` on the
  sp mesh against the plain trainer's trajectory at rtol 1e-3, atol
  1e-4, and a resume from its mid-run checkpoint exactly the straight
  run.
* The refusals: a window sp does not divide, a family sp does not run.
"""

from __future__ import annotations

import dataclasses
import os
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
from hfrep_tpu.models.discriminators import LSTMFlatCritic as JaxCritic
from hfrep_tpu.models.generators import LSTMGenerator as JaxGenerator
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.parallel import sequence as jseq
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu.train.steps import make_train_step as jax_make_train_step
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.models.discriminators import LSTMFlatCritic
from hfrep_tpu_torch.models.generators import LSTMGenerator
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import sequence as seq
from hfrep_tpu_torch.parallel.rules import Mesh
from hfrep_tpu_torch.train import Draws, init_gan_state, make_multi_step, sample_draws
from hfrep_tpu_torch.train.trainer import GanTrainer
from hfrep_tpu_torch.utils.bridge import from_flax, gan_state_from_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
H, W, F, B, NC, N_ROWS = 8, 12, 5, 8, 2, 32
GF, CW = 6, 10

#: one rank of the sp=2 mesh: every job of the spec file, results saved
RANK = r'''
import dataclasses, sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.models.discriminators import LSTMFlatCritic
from hfrep_tpu_torch.models.generators import LSTMGenerator
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, initialize_distributed,
                                      make_dp_sp_train_step, make_mesh_2d, make_sp_multi_step,
                                      make_sp_train_step, shutdown_distributed, sp_critic,
                                      sp_generate, sp_lstm)
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.train import Draws, init_gan_state
from hfrep_tpu_torch.train.trainer import GanTrainer
rank, store, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
out = {"backend": initialize_distributed("file://" + store, 2, rank, device="cpu")}
try:
    mesh = build_mesh(MeshSpec(sp=2), device="cpu")
    gen = LSTMGenerator(features=job["gf"], hidden=job["h"], device="cpu")
    gen.load_state_dict(job["generator"])
    with torch.no_grad():
        out["gen"] = sp_generate(gen, job["z"], mesh)
    critic = LSTMFlatCritic(features=job["gf"], window=job["cw"], hidden=job["h"], device="cpu")
    critic.load_state_dict(job["critic"])
    with torch.no_grad():
        lstm = {k[6:]: v for k, v in job["critic"].items() if k.startswith("lstm0.")}
        out["lstm"] = sp_lstm(lstm["kernel"], lstm["recurrent_kernel"], lstm["bias"], job["x"],
                              mesh)
    x = job["x"].clone().requires_grad_(True)
    scores = sp_critic(critic, x, mesh)
    inputs = [x] + list(critic.parameters())
    grads = torch.autograd.grad((scores ** 2).sum(), inputs)
    out["critic"] = {"scores": scores.detach(), "dx": grads[0],
                     "dp": dict(zip([n for n, _ in critic.named_parameters()], grads[1:]))}
    mcfg, tcfg = ModelConfig(**job["mcfg"]), TrainConfig(**job["tcfg"])
    pair = build_gan(mcfg, device="cpu")

    def start():
        state = init_gan_state(0, mcfg, "cpu")
        state.generator.load_state_dict(job["g0"])
        state.discriminator.load_state_dict(job["d0"])
        return state

    def keep(state, metrics):
        return {"g": state.generator.state_dict(), "d": state.discriminator.state_dict(),
                "m": metrics, "step": state.step, "collectives": rules.collective_counts()}

    for name, m, build in (("sp", mesh, make_sp_train_step),
                           ("dp_sp", make_mesh_2d(1, 2, device="cpu"), make_dp_sp_train_step)):
        rules.reset_collective_counts()
        out[name] = keep(*build(pair, tcfg, job["dataset"], m)(start(), Draws(*job["draws"])))
    block = make_sp_multi_step(pair, dataclasses.replace(tcfg, steps_per_call=3),
                               job["dataset"], mesh)
    out["block"] = keep(*block(start(), draws=[Draws(*d) for d in job["block_draws"]]))
    cfg = ExperimentConfig(model=mcfg, train=TrainConfig(**job["trainer"]))
    tr = GanTrainer(cfg, job["dataset"], device="cpu", mesh=mesh)
    tr.train(4)
    back = GanTrainer(cfg, job["dataset"], device="cpu", mesh=mesh)
    back.restore_checkpoint(job["trainer"]["checkpoint_dir"] + "/ckpt_2")
    resumed_at = back.epoch
    back.train(2)
    out["trainer"] = {"history": tr.history, "epoch": tr.epoch, "timed": tr.timer.samples,
                      "g": tr.state.generator.state_dict(), "resumed_at": resumed_at,
                      "resumed_g": back.state.generator.state_dict(),
                      "resumed_history": back.history}
    torch.save(out, spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def run_ranks(script: str, spec: str, n: int = 2, timeout: float = 300.0) -> list:
    """``script`` as ``n`` spawned ranks over a file store beside
    ``spec``; their saved results, in rank order."""
    store = spec + ".store"
    env = {k: v for k, v in os.environ.items() if not k.startswith("HFREP_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), store, spec], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    try:
        runs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err)) in enumerate(zip(procs, runs))
           if p.returncode != 0]
    assert not bad, bad
    return [torch.load(spec + f".rank{r}", weights_only=False) for r in range(n)]


def _jax_draws(key) -> Draws:
    """The draws JAX's wgan_gp ``make_train_step`` derives from ``key``."""
    ks = [jax.random.split(jax.random.fold_in(key, i), 3) for i in range(NC)]
    idx = jnp.stack([jax.random.randint(k[0], (B,), 0, N_ROWS) for k in ks])
    noises = jnp.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])
    alphas = jnp.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])
    return Draws(idx=_t(idx, torch.long), noises=_t(noises), alphas=_t(alphas))


def _models(seed: int = 0):
    """JAX's generator and critic, their params, inputs, and the port's
    modules holding the same params."""
    key = jax.random.PRNGKey(seed)
    jgen, jcritic = JaxGenerator(features=GF, hidden=H), JaxCritic(hidden=H)
    z = jax.random.normal(jax.random.fold_in(key, 1), (8, W, GF))
    x = jax.random.normal(jax.random.fold_in(key, 2), (8, CW, GF))
    g_params = jgen.init(key, z)["params"]
    d_params = jcritic.init(jax.random.fold_in(key, 3), x)["params"]
    gen = from_flax(jax.tree_util.tree_map(np.asarray, g_params),
                    LSTMGenerator(features=GF, hidden=H, device="cpu"))
    critic = from_flax(jax.tree_util.tree_map(np.asarray, d_params),
                       LSTMFlatCritic(features=GF, window=CW, hidden=H, device="cpu"))
    return jgen, jcritic, g_params, d_params, z, x, gen, critic


def _jax_epoch():
    """JAX's plain epoch on its init, the dataset and the draws."""
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
    out = jax.jit(jax_make_train_step(jpair, jt, jnp.asarray(ds)))(jstate, key)
    return ds, start, _jax_draws(key), out


# ------------------------------------------------------- the plain forwards
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forwards_match_jax_s(seed):
    jgen, jcritic, g_params, d_params, z, x, gen, critic = _models(seed)
    with torch.no_grad():
        got_g = seq.generator_forward(gen, _t(z))
        got_d = seq.critic_forward(critic, _t(x))
        got_l = seq._lstm_layer(seq._sub(dict(critic.named_parameters()), "lstm0"), _t(x),
                                "tanh")
    np.testing.assert_allclose(got_g.numpy(), np.asarray(jgen.apply({"params": g_params}, z)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(jseq.generator_forward(g_params, z)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jseq.critic_forward(d_params, x)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got_l.numpy(), np.asarray(jseq._lstm_layer(d_params["KerasLSTM_0"], x, "tanh")),
        rtol=2e-5, atol=2e-5)
    with torch.no_grad():        # the plain forwards are the modules' own routes
        assert torch.equal(seq.generator_forward(gen, _t(z)), gen(_t(z)))


@pytest.mark.parametrize("chunks", [2, 3, 4])
def test_chained_carry_chunks_are_the_whole_window(chunks):
    """``_lstm_chunk`` from each chunk's predecessor's final (h, c) gives
    the whole window's sequence, forward and gradients."""
    *_, x, _, critic = _models()
    p = seq._sub(dict(critic.named_parameters()), "lstm0")
    xt = _t(x).requires_grad_(True)
    whole = seq._lstm_layer(p, xt, "tanh")
    zero = torch.zeros((xt.shape[0], H))
    carry, parts = (zero, zero), []
    for part in xt.split(CW // chunks + (CW % chunks > 0), dim=1):
        h, carry = seq._lstm_chunk(p, part, carry, "tanh")
        parts.append(h)
    joined = torch.cat(parts, dim=1)
    torch.testing.assert_close(joined, whole, rtol=1e-6, atol=1e-6)
    g1 = torch.autograd.grad((whole ** 2).sum(), [xt, p["recurrent_kernel"]])
    g2 = torch.autograd.grad((joined ** 2).sum(), [xt, p["recurrent_kernel"]])
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("args", [(32, 2), (32, 4, 48), (8, 8, 168, 100), (64, 2, 168, 128)])
def test_sp_microbatch_plan_is_jax_s(args):
    assert seq.sp_microbatch_plan(*args) == jseq.sp_microbatch_plan(*args)


# ------------------------------------------------------------- two ranks
@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    jgen, jcritic, g_params, d_params, z, x, gen, critic = _models()

    def loss(p, v):
        return jnp.sum(jcritic.apply({"params": p}, v) ** 2)

    gp_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(d_params, x)
    refs = {"gen": np.asarray(jgen.apply({"params": g_params}, z)),
            "scores": np.asarray(jcritic.apply({"params": d_params}, x)),
            "lstm": np.asarray(jseq._lstm_layer(d_params["KerasLSTM_0"], x, "tanh")),
            "gp": gp_ref, "gx": np.asarray(gx_ref), "critic": critic}
    ds, start, draws, refs["step"] = _jax_epoch()
    # the port's single-device block and trainer, for the block and trainer jobs
    mcfg = ModelConfig(family="mtss_wgan_gp", features=F, window=W, hidden=H)
    tcfg = TrainConfig(batch_size=B, n_critic=NC, steps_per_call=3)
    pair = build_gan(mcfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    block_draws = [sample_draws(g, pair, tcfg, torch.from_numpy(ds)) for _ in range(3)]
    state = init_gan_state(0, mcfg, "cpu")
    state.generator.load_state_dict(start.generator.state_dict())
    state.discriminator.load_state_dict(start.discriminator.state_dict())
    refs["block"] = make_multi_step(pair, tcfg, torch.from_numpy(ds))(state, draws=block_draws)
    tmp = tmp_path_factory.mktemp("sp2")
    trainer_cfg = dict(batch_size=B, n_critic=NC, steps_per_call=2, seed=4,
                       checkpoint_dir=str(tmp / "ck"), checkpoint_every=2)
    plain = GanTrainer(ExperimentConfig(model=mcfg, train=TrainConfig(
        **dict(trainer_cfg, checkpoint_dir=None))), torch.from_numpy(ds), device="cpu")
    plain.train(4)
    refs["trainer"] = plain
    job = {"gf": GF, "cw": CW, "h": H, "z": _t(z), "x": _t(x), "generator": gen.state_dict(),
           "critic": critic.state_dict(), "mcfg": dataclasses.asdict(mcfg),
           "tcfg": dict(batch_size=B, n_critic=NC), "dataset": torch.from_numpy(ds),
           "g0": start.generator.state_dict(), "d0": start.discriminator.state_dict(),
           "draws": (draws.idx, draws.noises, draws.alphas),
           "block_draws": [(d.idx, d.noises, d.alphas) for d in block_draws],
           "trainer": trainer_cfg}
    spec = str(tmp / "job.pt")
    torch.save(job, spec)
    return refs, run_ranks(RANK, spec)


def test_sp_forwards_match_jax_s(sp2):
    refs, ranks = sp2
    joined = torch.cat([d["gen"] for d in ranks], dim=1)
    np.testing.assert_allclose(joined.numpy(), refs["gen"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(torch.cat([d["lstm"] for d in ranks], dim=1).numpy(),
                               refs["lstm"], rtol=2e-5, atol=2e-5)
    for doc in ranks:
        np.testing.assert_allclose(doc["critic"]["scores"].numpy(), refs["scores"], rtol=2e-5,
                                   atol=2e-5)
    assert torch.equal(ranks[0]["critic"]["scores"], ranks[1]["critic"]["scores"])
    assert [d["gen"].shape[1] for d in ranks] == [W // 2] * 2


def test_sp_critic_gradients_match_jax_s(sp2):
    """The input gradient and the parameters' as the two ranks' partials
    summed (each rank's is zero off its window chunk; the carry
    cotangents handed back)."""
    refs, ranks = sp2
    for r, doc in enumerate(ranks):
        off = doc["critic"]["dx"].narrow(1, (1 - r) * (CW // 2), CW // 2)
        assert not off.any()
    np.testing.assert_allclose((ranks[0]["critic"]["dx"] + ranks[1]["critic"]["dx"]).numpy(),
                               refs["gx"], rtol=1e-4, atol=1e-4)
    critic = refs["critic"]
    with torch.no_grad():
        for k, p in critic.named_parameters():
            p.copy_(ranks[0]["critic"]["dp"][k] + ranks[1]["critic"]["dp"][k])
    mine = jax.tree_util.tree_leaves_with_path(to_flax(critic))
    ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, refs["gp"]))
    for (path, a), (_, r) in zip(mine, ref):
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def _check_against_jax(got, jout, atol):
    jstate, jm = jout
    for k in jm:
        np.testing.assert_allclose(got["m"][k].numpy(), np.asarray(jm[k]), atol=atol, rtol=0,
                                   err_msg=k)
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
                     device="cpu")
    for net, module, tree in (("g", pair.generator, jstate.g_params),
                              ("d", pair.discriminator, jstate.d_params)):
        module.load_state_dict(got[net])
        mine = jax.tree_util.tree_leaves_with_path(to_flax(module))
        ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree))
        for (path, a), (_, r) in zip(mine, ref):
            np.testing.assert_allclose(a, r, atol=atol, rtol=0,
                                       err_msg=f"{net} {jax.tree_util.keystr(path)}")
    assert got["step"] == int(jstate.step)


def _ranks_agree(a, b):
    for net in ("g", "d"):
        for k in a[net]:
            np.testing.assert_allclose(a[net][k].numpy(), b[net][k].numpy(), rtol=1e-6, atol=0)
    for k in a["m"]:
        np.testing.assert_allclose(a["m"][k].numpy(), b["m"][k].numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("mesh", ["sp", "dp_sp"])
def test_sp_step_matches_one_device(sp2, mesh):
    """One epoch on JAX's init and draws against JAX's plain epoch at
    JAX's two-process bar (atol 1e-4), the ranks within rtol 1e-6; per
    update one all_reduce of the gradients, per penalty one of the
    squared norms."""
    refs, ranks = sp2
    for doc in ranks:
        _check_against_jax(doc[mesh], refs["step"], atol=1e-4)
        c = doc[mesh]["collectives"]
        passes = 1 + 2 * NC + 2
        assert c["all_reduce"] == (2 * NC + 1) + NC + (NC + 1), c   # scores, norms, updates
        assert c["send"] + c["recv"] == passes + (2 * NC + 2) + 2 * NC, c
    _ranks_agree(ranks[0][mesh], ranks[1][mesh])


def test_sp_block_matches_the_single_device_block(sp2):
    refs, ranks = sp2
    state, m = refs["block"]
    for doc in ranks:
        got = doc["block"]
        for net, module in (("g", state.generator), ("d", state.discriminator)):
            for k, v in module.state_dict().items():
                np.testing.assert_allclose(got[net][k].numpy(), v.numpy(), atol=1e-5, rtol=0,
                                           err_msg=f"{net}.{k}")
        for k in m:
            np.testing.assert_allclose(got["m"][k].numpy(), m[k].numpy(), atol=1e-5, rtol=1e-5)
        assert got["step"] == 3
    _ranks_agree(ranks[0]["block"], ranks[1]["block"])


def test_sp_trainer_matches_plain_trajectory_and_resumes_exactly(sp2):
    refs, ranks = sp2
    plain = refs["trainer"]
    for doc in ranks:
        t = doc["trainer"]
        assert t["epoch"] == 4 and len(t["history"]) == 4 and t["timed"]
        for a, b in zip(t["history"], plain.history):
            np.testing.assert_allclose(a["d_loss"], b["d_loss"], rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(a["g_loss"], b["g_loss"], rtol=1e-3, atol=1e-4)
        for k, v in plain.state.generator.state_dict().items():
            np.testing.assert_allclose(t["g"][k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4)
        assert t["resumed_at"] == 2
        assert all(torch.equal(t["g"][k], t["resumed_g"][k]) for k in t["g"])
        assert t["resumed_history"] == t["history"][2:]
    assert ranks[0]["trainer"]["history"] == ranks[1]["trainer"]["history"]


# ---------------------------------------------------------- the refusals
def test_sp_refusals_name_what_was_asked():
    cpu = torch.device("cpu")
    sp_mesh = Mesh(("sp",), (2,), cpu, group=object())
    tcfg = TrainConfig(batch_size=8, n_critic=2)
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", features=5, window=7, hidden=8),
                     device="cpu")
    with pytest.raises(ValueError, match="window 7 not divisible by sp=2"):
        seq.make_sp_multi_step(pair, tcfg, torch.zeros((16, 7, 5)), sp_mesh)
    wgan = build_gan(ModelConfig(family="wgan_gp", features=5, window=8, hidden=8),
                     device="cpu")
    with pytest.raises(ValueError, match="supports the mtss_wgan_gp family"):
        seq.make_sp_multi_step(wgan, tcfg, torch.zeros((16, 8, 5)), sp_mesh)
    for names in (("sp", "tp"), ("sp", "pp")):
        with pytest.raises(ValueError, match="dp_sp_tp.py launch|layer_pipeline.py axis"):
            seq.make_sp_train_step(pair, tcfg, torch.zeros((16, 8, 5)),
                                   Mesh(names, (2, 2), cpu, group=object()))
    bf16 = build_gan(ModelConfig(family="mtss_wgan_gp", features=5, window=8, hidden=8,
                                 dtype="bfloat16"), device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        seq.validate_sp_pair(bf16)
    with pytest.raises(ValueError, match="axis 'tp' not in mesh"):
        seq._window_chain(sp_mesh, "tp")
    with pytest.raises(NotImplementedError, match="sigmoid gates"):
        seq.sp_lstm(*(torch.zeros(1),) * 4, sp_mesh, recurrent_activation="tanh")
