"""The layer pipeline (``hfrep_tpu_torch/parallel/layer_pipeline.py``)
against the JAX package, on two gloo CPU ranks.

The bars are JAX's own (``tests/test_layer_pipeline.py:31-118``): the
pp forwards against ``generator.apply`` / ``critic.apply`` at rtol 2e-5,
atol 2e-5 for M = 1, 2 and 4 microbatches; the critic's gradients with
respect to its parameters and its input against ``jax.grad`` at rtol
1e-4, atol 1e-4; one WGAN-GP epoch (the penalty's second order through
both stages) against JAX's plain step on JAX's init and draws at rtol
1e-4, atol 1e-5.  A stage's parameter gradients are its own, so the
test sums the two ranks' (the step's reduction does the same).  The
ranks hold the same outputs and the same state bit for bit.  JAX's own
pp tests need ``jax.shard_map``, absent on this runtime, so the JAX side
is its plain single-device program, which those tests hold pp to.

Spawned ranks run on one thread each, rendezvous through a file store.
"""

from __future__ import annotations

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
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu.train.steps import make_train_step as jax_make_train_step
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.models.discriminators import LSTMFlatCritic
from hfrep_tpu_torch.models.generators import LSTMGenerator
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import layer_pipeline as lp
from hfrep_tpu_torch.parallel.rules import Mesh
from hfrep_tpu_torch.train import Draws
from hfrep_tpu_torch.utils.bridge import from_flax, gan_state_from_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
H, W, F, B, NC, N_ROWS = 8, 12, 5, 8, 2, 32
MICROBATCHES = (1, 2, 4)
STEP_MICROBATCHES = (1, 2)

#: one rank of the pp=2 mesh: every job of the spec file, results saved
RANK = r'''
import sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.models.discriminators import LSTMFlatCritic
from hfrep_tpu_torch.models.generators import LSTMGenerator
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, initialize_distributed,
                                      make_pp_train_step, pp_critic, pp_generate,
                                      shutdown_distributed)
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.train import Draws, init_gan_state
rank, store, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
out = {"backend": initialize_distributed("file://" + store, 2, rank, device="cpu")}
try:
    mesh = build_mesh(MeshSpec(pp=2), device="cpu")
    gen = LSTMGenerator(features=job["gf"], hidden=job["h"], device="cpu")
    gen.load_state_dict(job["generator"])
    for m in job["microbatches"]:
        with torch.no_grad():
            out[f"gen_m{m}"] = pp_generate(gen, job["z"], mesh, microbatches=m)
    critic = LSTMFlatCritic(features=job["gf"], window=job["cw"], hidden=job["h"], device="cpu")
    critic.load_state_dict(job["critic"])
    x = job["x"].clone().requires_grad_(True)
    scores = pp_critic(critic, x, mesh, microbatches=2)
    names = [n for n, _ in critic.named_parameters()]
    inputs = [x] + list(critic.parameters())
    grads = torch.autograd.grad((scores ** 2).sum(), inputs, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
    out["critic"] = {"scores": scores.detach(), "dx": grads[0],
                     "dp": dict(zip(names, grads[1:]))}
    mcfg, tcfg = ModelConfig(**job["mcfg"]), TrainConfig(**job["tcfg"])
    pair = build_gan(mcfg, device="cpu")
    for m in job["step_microbatches"]:
        state = init_gan_state(0, mcfg, "cpu")
        state.generator.load_state_dict(job["g0"])
        state.discriminator.load_state_dict(job["d0"])
        rules.reset_collective_counts()
        step = make_pp_train_step(pair, tcfg, job["dataset"], mesh, microbatches=m)
        state, metrics = step(state, Draws(*job["draws"]))
        out[f"step_m{m}"] = {"g": state.generator.state_dict(),
                             "d": state.discriminator.state_dict(), "m": metrics,
                             "step": state.step, "collectives": rules.collective_counts()}
    torch.save(out, spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _jax_draws(key) -> Draws:
    """The draws JAX's wgan_gp ``make_train_step`` derives from ``key``
    (``tests/test_torch_train.py::_jax_draws``, at this file's sizes)."""
    ks = [jax.random.split(jax.random.fold_in(key, i), 3) for i in range(NC)]
    idx = jnp.stack([jax.random.randint(k[0], (B,), 0, N_ROWS) for k in ks])
    noises = jnp.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])
    alphas = jnp.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])
    return Draws(idx=_t(idx, torch.long), noises=_t(noises), alphas=_t(alphas))


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


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    """JAX's references in this process, the pp jobs on two ranks."""
    key = jax.random.PRNGKey(0)
    gf, cw = 6, 10
    jgen = JaxGenerator(features=gf, hidden=H)
    z = jax.random.normal(jax.random.fold_in(key, 1), (8, W, gf))
    g_params = jgen.init(key, z)["params"]
    jcritic = JaxCritic(hidden=H)
    x = jax.random.normal(jax.random.fold_in(key, 2), (8, cw, gf))
    d_params = jcritic.init(jax.random.PRNGKey(2), x)["params"]
    gen = from_flax(jax.tree_util.tree_map(np.asarray, g_params),
                    LSTMGenerator(features=gf, hidden=H, device="cpu"))
    critic = from_flax(jax.tree_util.tree_map(np.asarray, d_params),
                       LSTMFlatCritic(features=gf, window=cw, hidden=H, device="cpu"))

    def loss(p, v):
        return jnp.sum(jcritic.apply({"params": p}, v) ** 2)

    gp_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(d_params, x)
    refs = {"gen": np.asarray(jgen.apply({"params": g_params}, z)),
            "scores": np.asarray(jcritic.apply({"params": d_params}, x)),
            "gp": gp_ref, "gx": np.asarray(gx_ref), "critic": critic}

    # one epoch: JAX's plain step on its init and its draws
    jm = JaxModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F)
    jt = JaxTrainConfig(batch_size=B, n_critic=NC, lstm_backend="xla")
    ds = np.random.default_rng(3).uniform(0, 1, (N_ROWS, W, F)).astype(np.float32)
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(jax.random.PRNGKey(0), jm, jt, jpair)
    step_key = jax.random.PRNGKey(1)
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
                     device="cpu")
    start = gan_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate.g_params),
                                jax.tree_util.tree_map(np.asarray, jstate.d_params), pair)
    refs["step"] = jax.jit(jax_make_train_step(jpair, jt, jnp.asarray(ds)))(jstate, step_key)
    draws = _jax_draws(step_key)
    job = {"gf": gf, "cw": cw, "h": H, "z": _t(z), "x": _t(x),
           "generator": gen.state_dict(), "critic": critic.state_dict(),
           "microbatches": MICROBATCHES, "step_microbatches": STEP_MICROBATCHES,
           "mcfg": dict(family="mtss_wgan_gp", features=F, window=W, hidden=H),
           "tcfg": dict(batch_size=B, n_critic=NC), "dataset": torch.from_numpy(ds),
           "g0": start.generator.state_dict(), "d0": start.discriminator.state_dict(),
           "draws": (draws.idx, draws.noises, draws.alphas)}
    spec = str(tmp_path_factory.mktemp("pp2") / "job.pt")
    torch.save(job, spec)
    return refs, run_ranks(RANK, spec)


@pytest.mark.parametrize("m", MICROBATCHES)
def test_pp_generator_matches_single_device(pp2, m):
    refs, ranks = pp2
    for doc in ranks:
        np.testing.assert_allclose(doc[f"gen_m{m}"].numpy(), refs["gen"], rtol=2e-5, atol=2e-5)
    assert torch.equal(ranks[0][f"gen_m{m}"], ranks[1][f"gen_m{m}"])


def test_pp_critic_matches_single_device_with_grads(pp2):
    """Values and gradients with respect to the parameters (the two
    stages' summed) and the input (whole on both ranks: the penalty's
    ∇ₓc path)."""
    refs, ranks = pp2
    for doc in ranks:
        np.testing.assert_allclose(doc["critic"]["scores"].numpy(), refs["scores"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(doc["critic"]["dx"].numpy(), refs["gx"], rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(ranks[0]["critic"]["dx"], ranks[1]["critic"]["dx"])
    summed = {k: ranks[0]["critic"]["dp"][k] + ranks[1]["critic"]["dp"][k]
              for k in ranks[0]["critic"]["dp"]}
    critic = refs["critic"]
    with torch.no_grad():
        for k, p in critic.named_parameters():
            p.copy_(summed[k])
    mine = jax.tree_util.tree_leaves_with_path(to_flax(critic))
    ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, refs["gp"]))
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, a), (_, r) in zip(mine, ref):
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    # each stage's gradient is its own layer's: the other layer's is zero
    for r, own in ((0, "lstm0"), (1, "lstm1")):
        for k, g in ranks[r]["critic"]["dp"].items():
            if k.startswith("lstm") and not k.startswith(own):
                assert not g.any(), (r, k)


@pytest.mark.parametrize("m", STEP_MICROBATCHES)
def test_pp_train_step_matches_plain_step(pp2, m):
    """The depth-split WGAN-GP epoch (the penalty's second order through
    both stages) follows JAX's plain epoch on JAX's init and draws."""
    refs, ranks = pp2
    jstate, jm = refs["step"]
    pair = build_gan(ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
                     device="cpu")
    for doc in ranks:
        got = doc[f"step_m{m}"]
        for k in jm:
            np.testing.assert_allclose(got["m"][k].numpy(), np.asarray(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for net, module, tree in (("g", pair.generator, jstate.g_params),
                                  ("d", pair.discriminator, jstate.d_params)):
            module.load_state_dict(got[net])
            mine = jax.tree_util.tree_leaves_with_path(to_flax(module))
            ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree))
            for (path, a), (_, r) in zip(mine, ref):
                np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{net} {jax.tree_util.keystr(path)}")
        assert got["step"] == int(jstate.step) == 1
    a, b = ranks[0][f"step_m{m}"], ranks[1][f"step_m{m}"]
    for net in ("g", "d"):
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net])
    assert all(torch.equal(a["m"][k], b["m"][k]) for k in a["m"])


@pytest.mark.parametrize("m", STEP_MICROBATCHES)
def test_pp_step_transfers_are_the_schedule_s(pp2, m):
    """What crosses between the stages in one epoch (n_critic 2): every
    forward pass sends one message a microbatch from stage 0 and its
    first order one message back; a penalty's second order one message
    each way; the fakes' pass has no backward.  One all_reduce sums each
    pass's outputs, each input-gradient pass's dx and each update's
    gradients."""
    _, ranks = pp2
    passes = 1 + NC * 2 + 2               # fakes, scores and penalty a critic iteration, G and D
    backwards = NC * 2 + 2                # every pass but the fakes'
    s0, s1 = (ranks[r][f"step_m{m}"]["collectives"] for r in (0, 1))
    assert s0["send"] == s1["recv"] == passes * m + NC
    assert s1["send"] == s0["recv"] == backwards + NC
    dx_sums = NC + 1                      # the penalty's ∇ₓc, the generator update's dx
    updates = NC + 1
    assert s0["all_reduce"] == s1["all_reduce"] == passes + dx_sums + NC + updates


def test_pp_build_time_refusals():
    mcfg = ModelConfig(family="mtss_wgan_gp", features=5, window=12, hidden=8)
    pair = build_gan(mcfg, device="cpu")
    cpu = torch.device("cpu")
    ds = torch.zeros((16, 12, 5))
    with pytest.raises(ValueError, match="no 'pp' axis"):
        lp._resolve_pp_axis(Mesh(("dp",), (2,), cpu), None)
    with pytest.raises(ValueError, match="exactly 2 'pp' devices"):
        lp._resolve_pp_axis(Mesh(("pp",), (4,), cpu), None)
    with pytest.raises(ValueError, match="mtss_wgan_gp family"):
        lp.validate_pp_pair(build_gan(ModelConfig(family="wgan_gp", features=5, window=12,
                                                  hidden=8), device="cpu"))
    with pytest.raises(NotImplementedError, match="f32"):
        lp.validate_pp_pair(build_gan(ModelConfig(family="mtss_wgan_gp", features=5,
                                                  window=12, hidden=8, dtype="bfloat16"),
                                      device="cpu"))
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        lp.make_pp_train_step(pair, TrainConfig(batch_size=8, n_critic=2), ds,
                              Mesh(("pp",), (2,), cpu, group=object()), microbatches=3)
    with pytest.raises(ValueError, match="the mesh launch shards dp and sp"):
        from hfrep_tpu_torch.parallel import make_gan_multi_step
        make_gan_multi_step(pair, TrainConfig(), ds, Mesh(("pp",), (2,), cpu))
    assert lp.N_STAGES == 2
