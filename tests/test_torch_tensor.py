"""Tensor (hidden-unit) parallelism (``hfrep_tpu_torch/parallel/{tensor,
dp_sp_tp,rules,mesh}.py``) against the JAX package, on the CPU.

* The rule table: JAX's ``TestPartitionRules`` (``tests/test_mesh_rules.py:
  90-133``) on the port's ``GAN_PARTITION_RULES``, and the table equal to
  JAX's leaf by leaf through ``FLAX_NAMES``.
* On two gloo ranks (``tp=2``, one module-scoped pool of spawned ranks
  doing every job): ``tp_generate`` and ``tp_critic`` against JAX's
  forwards on JAX's params at 2e-5; the critic's gradients (the ranks'
  partials summed, a replicated leaf's from rank 0) against ``jax.grad``
  at 1e-4, each rank's partial of a sliced leaf nonzero only in its own
  gate columns; one WGAN-GP epoch from JAX's init on JAX's draws against
  JAX's plain step at atol 1e-4, its all_reduces exactly
  :func:`tp_reduces`; a 3-epoch block against the port's single-device
  block; the ranks bit-equal; ``GanTrainer`` on the tp mesh against the
  plain trajectory (rtol 1e-3, atol 1e-4), resumed from its mid-run
  checkpoint exactly the straight run, and its checkpoint restored into a
  one-device trainer bit for bit (``tests/test_distributed.py:663-686``).
* On four ranks: dp×tp 2×2 and dp×sp×tp 1×2×2 against JAX's epoch at
  atol 1e-4 with their counts, tp=4's forwards; 2×2×2 on eight (slow, as
  JAX marks it).
* Health on tp=2 and dp×sp×tp 1×2×2: bit for bit the health-off epoch
  (params, slots, metrics), the all_reduces unchanged, the five values
  JAX's ``_health_metrics`` at ``test_torch_health.py``'s bars, the ranks
  bit-equal; ``GanTrainer`` on the tp mesh with health on (rank 0 alone
  sets the gauges; a NaN parameter trips every rank at one boundary,
  rank 0 alone dumps).
* bf16 on tp=2 and dp×sp×tp 1×2×2 at the bf16 bars (``PERF.md`` §2)
  against JAX's bf16 epoch and the port's single-device bf16 epochs.
* JAX's refusals and messages (bf16 and health now build, as in JAX),
  the retired knobs' ``TypeError``, and the launch names
  (``tests/test_obs.py:402-423``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from hfrep_tpu.parallel import rules as jrules
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.obs import health
from hfrep_tpu_torch.parallel import dp_sp_tp, rules, sequence, tensor
from hfrep_tpu_torch.parallel.rules import GAN_PARTITION_RULES, Mesh, MeshSpec
from hfrep_tpu_torch.train import init_gan_state, make_multi_step, sample_draws
from hfrep_tpu_torch.train.trainer import GanTrainer
from hfrep_tpu_torch.utils.bridge import to_flax
from hfrep_tpu.obs import health as jax_health
from test_torch_sequence import (B, CW, F, GF, H, N_ROWS, NC, W, _check_against_jax, _jax_epoch,
                                 _models, _t, assert_bf16_bars, bf16_errs, bf16_refs, family_job,
                                 jax_family_epoch, run_ranks, state_doc, state_equal)

CPU = torch.device("cpu")
MCFG = dict(family="mtss_wgan_gp", features=F, window=W, hidden=H)

#: one rank of a tp mesh: every job of the spec file, results saved
RANK = r'''
import dataclasses, sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.models.discriminators import LSTMFlatCritic
from hfrep_tpu_torch.models.generators import LSTMGenerator
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, initialize_distributed,
                                      make_dp_sp_tp_train_step, make_dp_tp_train_step,
                                      make_mesh_2d, make_mesh_3d, make_tp_multi_step,
                                      make_tp_train_step, shutdown_distributed, tp_critic,
                                      tp_generate)
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.train import Draws, init_gan_state
from hfrep_tpu_torch.train.trainer import GanTrainer
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu_torch.obs import health
rank, store, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
n = job["ranks"]
out = {"backend": initialize_distributed("file://" + store, n, rank, device="cpu")}
try:
    gen = LSTMGenerator(features=job["gf"], hidden=job["h"], device="cpu")
    gen.load_state_dict(job["generator"])
    critic = LSTMFlatCritic(features=job["gf"], window=job["cw"], hidden=job["h"], device="cpu")
    critic.load_state_dict(job["critic"])
    mcfg, tcfg = ModelConfig(**job["mcfg"]), TrainConfig(**job["tcfg"])
    pair = build_gan(mcfg, device="cpu")

    def start():
        state = init_gan_state(0, mcfg, "cpu")
        state.generator.load_state_dict(job["g0"])
        state.discriminator.load_state_dict(job["d0"])
        return state

    def keep(state, metrics, mesh):
        return {"g": state.generator.state_dict(), "d": state.discriminator.state_dict(),
                "m": metrics, "step": state.step, "coords": mesh.coords(),
                "slots": {"g": state.g_opt, "d": state.d_opt},
                "collectives": rules.collective_counts()}

    def healthy(build, mesh):
        """The tp job's epoch with health on, its collectives counted."""
        health.configure(health.HealthConfig())
        try:
            rules.reset_collective_counts()
            return keep(*build(pair, tcfg, job["dataset"], mesh)(start(), Draws(*job["draws"])),
                        mesh)
        finally:
            health.configure(None)

    def bf16(build, mesh):
        """One bf16 flagship epoch from JAX's bf16 init on its draws."""
        bj = job["bf16"]
        bm = ModelConfig(**bj["mcfg"])
        st = init_gan_state(0, bm, "cpu")
        st.generator.load_state_dict(bj["g0"])
        st.discriminator.load_state_dict(bj["d0"])
        rules.reset_collective_counts()
        return keep(*build(build_gan(bm, device="cpu"), tcfg, job["dataset"], mesh)(
            st, Draws(*bj["draws"])), mesh)

    if n == 2:
        mesh = build_mesh(MeshSpec(tp=2), device="cpu")
        with torch.no_grad():
            out["gen"] = tp_generate(gen, job["z"], mesh, manual=True, chunk=4)
        x = job["x"].clone().requires_grad_(True)
        scores = tp_critic(critic, x, mesh)
        grads = torch.autograd.grad((scores ** 2).sum(), [x] + list(critic.parameters()))
        out["critic"] = {"scores": scores.detach(), "dx": grads[0],
                         "dp": dict(zip([k for k, _ in critic.named_parameters()], grads[1:]))}
        rules.reset_collective_counts()
        out["tp"] = keep(*make_tp_train_step(pair, tcfg, job["dataset"], mesh)(
            start(), Draws(*job["draws"])), mesh)
        rules.reset_collective_counts()
        block = make_tp_multi_step(pair, dataclasses.replace(tcfg, steps_per_call=3),
                                   job["dataset"], mesh)
        out["block"] = keep(*block(start(), draws=[Draws(*d) for d in job["block_draws"]]),
                            mesh)
        cfg = ExperimentConfig(model=mcfg, train=TrainConfig(**job["trainer"]))
        tr = GanTrainer(cfg, job["dataset"], device="cpu", mesh=mesh)
        tr.train(4)
        back = GanTrainer(cfg, job["dataset"], device="cpu", mesh=mesh)
        back.restore_checkpoint(job["trainer"]["checkpoint_dir"] + "/ckpt_2")
        resumed_at = back.epoch
        back.train(2)
        out["trainer"] = {"history": tr.history, "epoch": tr.epoch, "timed": tr.timer.samples,
                          "g": tr.state.generator.state_dict(),
                          "d": tr.state.discriminator.state_dict(), "resumed_at": resumed_at,
                          "resumed_g": back.state.generator.state_dict(),
                          "resumed_history": back.history,
                          "slots": {"g": tr.state.g_opt, "d": tr.state.d_opt}}
        out["tp_health"] = healthy(make_tp_train_step, mesh)
        out["tp_bf16"] = bf16(make_tp_train_step, mesh)
        # the trainer with health on: its gauges in rank 0's stream alone
        plain = ExperimentConfig(model=mcfg, train=TrainConfig(
            **dict(job["trainer"], checkpoint_dir=None)))
        health.configure(health.HealthConfig())
        with obs_pkg.session(job["obs"] + f"/rank{rank}", command="t"):
            th = GanTrainer(plain, job["dataset"], device="cpu", mesh=mesh)
            th.train(4)
        out["trainer_health"] = {"history": th.history, "g": th.state.generator.state_dict(),
                                 "d": th.state.discriminator.state_dict(),
                                 "slots": {"g": th.state.g_opt, "d": th.state.d_opt}}
        # a NaN parameter under the armed tripwire: every rank raises at
        # the first block boundary, rank 0 alone dumps
        health.configure(health.HealthConfig(abort_on_nonfinite=True, dump_dir=job["dump"]))
        tn = GanTrainer(plain, job["dataset"], device="cpu", mesh=mesh)
        with torch.no_grad():
            tn.state.generator.lstm0.kernel[0, 0] = float("nan")
        try:
            tn.train(4)
            out["fault"] = None
        except health.NumericFault as e:
            out["fault"] = {"site": e.site, "epoch": e.epoch, "dump": e.dump,
                            "trainer_epoch": tn.epoch}
        health.configure(None)
    elif n == 4:
        for name, mesh, build in (
                ("dp_tp", make_mesh_2d(2, 2, device="cpu", axis_names=("dp", "tp")),
                 make_dp_tp_train_step),
                ("dp_sp_tp", make_mesh_3d(1, 2, 2, device="cpu"), make_dp_sp_tp_train_step)):
            rules.reset_collective_counts()
            out[name] = keep(*build(pair, tcfg, job["dataset"], mesh)(start(), Draws(*job["draws"])),
                             mesh)
        out["dp_sp_tp_health"] = healthy(make_dp_sp_tp_train_step, mesh)
        out["dp_sp_tp_bf16"] = bf16(make_dp_sp_tp_train_step, mesh)
        mesh = build_mesh(MeshSpec(tp=4), device="cpu")
        with torch.no_grad():
            out["gen"] = tp_generate(gen, job["z"], mesh)
            out["scores"] = tp_critic(critic, job["x"], mesh)
        rules.reset_collective_counts()
        out["tp4"] = keep(*make_tp_train_step(pair, tcfg, job["dataset"], mesh)(
            start(), Draws(*job["draws"])), mesh)
    else:
        mesh = make_mesh_3d(2, 2, 2, device="cpu")
        rules.reset_collective_counts()
        out["dp_sp_tp"] = keep(*make_dp_sp_tp_train_step(pair, tcfg, job["dataset"], mesh)(
            start(), Draws(*job["draws"])), mesh)
    torch.save(out, spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tp_reduces(n_critic: int, wc: int, sp: int = 1, sp_rank: int = 0) -> int:
    """A rank's all_reduces in one WGAN-GP epoch of the tp step, two LSTM
    layers on a window (chunk) of ``wc`` steps: a pass gathers h once a
    step and layer; a backward all_reduces the cotangent of each F, one
    a recorded h product (none at a zero carry's first step) and one a
    layer input that needs a gradient; the penalty's second order gathers
    once a slice of its first order.  In a window chain (``sp`` > 1) the
    scores and the norms are summed over sp, the second order also
    reaches the penalty's input, and a rank with a next rank runs the
    boundary pass; the hook reduces once an update."""
    lay = 2
    chain = int(sp > 1)
    nxt = int(chain and sp_rank < sp - 1)
    gathers, hprod = lay * wc, lay * (wc - 1 + int(sp_rank > 0))
    critic = (2 * (gathers + chain)                  # the scores' and the penalty's passes
              + hprod + lay + chain                  # the penalty's first order (+ norms)
              + hprod + lay - 1                      # the scores' backward
              + gathers + hprod + lay - 1 + chain    # the second order
              + nxt * (hprod + lay)                  # its boundary pass
              + 1)                                   # the hook
    gen = (2 * gathers                               # the fakes; the update's generator
           + gathers + chain                         # the update's critic
           + hprod + lay                             # its backward (the fake input's F)
           + hprod + lay - 1                         # the generator's (the noise needs none)
           + 1)                                      # the hook
    return n_critic * critic + gen


# ------------------------------------------------------------ the rule table
def _state():
    return init_gan_state(0, ModelConfig(**MCFG), "cpu")


def test_gan_state_every_leaf_matched():
    specs = rules.gan_state_specs(_state(), Mesh(("tp",), (2,), CPU))
    assert list(specs) == [n for n, _ in rules.named_leaves(_state())]
    assert all(isinstance(s, tuple) for s in specs.values())


def test_tp_rules_hit_lstm_gate_columns():
    specs = rules.gan_state_specs(_state(), Mesh(("tp",), (2,), CPU))
    # params AND their optimizer-slot mirrors slice the gate axis
    assert specs["generator/lstm0.kernel"] == (None, "tp")
    assert specs["generator/lstm0.bias"] == ("tp",)
    assert specs["g_opt/nu/lstm1.recurrent_kernel"] == (None, "tp")
    assert specs["d_opt/nu/lstm0.bias"] == ("tp",)
    # heads / LayerNorms replicate
    assert specs["generator/out.kernel"] == () and specs["generator/norm0.scale"] == ()
    assert specs["discriminator/out.kernel"] == ()


def test_scalars_always_replicate():
    specs = rules.match_partition_rules(((r".*", ("tp",)),), _state(),
                                        Mesh(("tp",), (2,), CPU))
    assert specs["step"] == ()               # scalar guard wins
    assert specs["discriminator/out.bias"] == ()        # one element


def test_unmatched_param_raises_with_path():
    tree = {"g_params": {"lstm0.kernel": torch.zeros((3, 4))}}
    with pytest.raises(ValueError, match=r"g_params/lstm0\.kernel"):
        rules.match_partition_rules(((r"only/this", ()),), tree)


def test_absent_axes_strip_to_replicated():
    for mesh in (Mesh(("dp",), (2,), CPU), Mesh(("dp", "tp"), (2, 1), CPU)):
        specs = rules.gan_state_specs(_state(), mesh)
        assert all(s == () for s in specs.values())      # tp names stripped


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_the_rule_table_is_jax_s_leaf_by_leaf(net):
    """JAX's ``GAN_PARTITION_RULES`` over the JAX tree of the same
    parameters and the port's over the port's names give the same spec
    for every leaf, through ``FLAX_NAMES``."""
    module = getattr(build_gan(ModelConfig(**MCFG), device="cpu"), net)
    theirs = jax.tree_util.tree_flatten_with_path(
        jrules.match_partition_rules(jrules.GAN_PARTITION_RULES, to_flax(module)),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    mine = rules.match_partition_rules(GAN_PARTITION_RULES, module)
    names = type(module).FLAX_NAMES
    got = {f"{names[p[0].key]}.{p[-1].key}": tuple(s) for p, s in theirs}
    assert got == mine


# ------------------------------------------------------------- the layout
@pytest.mark.parametrize("n", [1, 2, 4])
def test_gate_columns_tile_the_gate_axis(n):
    cols = [tensor.gate_columns(H, n, k) for k in range(n)]
    assert torch.equal(torch.sort(torch.cat(cols)).values, torch.arange(4 * H))
    hl = H // n
    for k, c in enumerate(cols):        # each gate's block of this rank's units
        assert torch.equal(c.reshape(4, hl) % H, torch.arange(k * hl, (k + 1) * hl).expand(4, hl))


# ---------------------------------------------------------- the refusals
def _tp_mesh(names=("tp",), sizes=(2,)):
    return Mesh(names, sizes, CPU, group=object(),
                axis_groups={i: object() for i in range(len(names))} if len(names) > 1 else None)


def test_jax_s_refusals_and_messages():
    tcfg = TrainConfig(batch_size=B, n_critic=NC)
    pair, ds = build_gan(ModelConfig(**MCFG), device="cpu"), torch.zeros((16, W, F))
    wgan = build_gan(ModelConfig(**dict(MCFG, family="wgan_gp")), device="cpu")
    with pytest.raises(ValueError, match="tp \\(hidden-unit\\) sharding supports the "
                                         "mtss_wgan_gp family's LSTM stacks, got 'wgan_gp'"):
        tensor.make_tp_train_step(wgan, tcfg, ds, _tp_mesh())
    with pytest.raises(ValueError, match="tensor-parallel step supports the mtss_wgan_gp "
                                         "family, got 'wgan_gp'"):
        tensor.validate_tp_pair(wgan, 2)
    wide = build_gan(ModelConfig(**dict(MCFG, hidden=6)), device="cpu")
    with pytest.raises(ValueError, match="hidden width 6 not divisible by tp=4 devices"):
        tensor.make_tp_train_step(wide, tcfg, ds, _tp_mesh(sizes=(4,)))
    with pytest.raises(ValueError, match="hidden width 6 not divisible by tp=4 devices"):
        tensor.validate_tp_pair(wide, 4)
    with pytest.raises(ValueError, match="lstm_backend='pallas' cannot be GSPMD-partitioned "
                                         "over a 2-device mesh"):
        tensor.make_tp_multi_step(pair, dataclasses.replace(tcfg, lstm_backend="pallas"), ds,
                                  _tp_mesh())
    # bf16 and health build on a tp mesh: JAX puts no dtype or health rule
    # on tp (its _validate_gan_mesh)
    bf16 = build_gan(ModelConfig(**dict(MCFG, dtype="bfloat16")), device="cpu")
    assert callable(tensor.make_tp_train_step(bf16, tcfg, ds, _tp_mesh()))
    health.configure(health.HealthConfig())
    try:
        assert callable(tensor.make_tp_train_step(pair, tcfg, ds, _tp_mesh()))
    finally:
        health.configure(None)
    with pytest.raises(ValueError, match="dp_sp_tp.py launch"):
        tensor.make_tp_train_step(pair, tcfg, ds, _tp_mesh(("sp", "tp"), (2, 2)))
    with pytest.raises(ValueError, match="dp_sp_tp.py launch"):
        sequence.make_sp_train_step(pair, tcfg, ds, _tp_mesh(("sp", "tp"), (2, 2)))
    with pytest.raises(ValueError, match="tensor.py axis"):
        rules.make_gan_train_step(pair, tcfg, ds, _tp_mesh())
    with pytest.raises(ValueError, match="an sp or tp extent of 1"):
        dp_sp_tp.make_dp_sp_tp_train_step(pair, tcfg, ds, _tp_mesh(("dp", "tp"), (1, 2)))
    with pytest.raises(ValueError, match="window 12 not divisible by sp=5"):
        dp_sp_tp.make_dp_sp_tp_train_step(pair, tcfg, ds, _tp_mesh(("sp", "tp"), (5, 2)))
    with pytest.raises(ValueError, match="has no 'tp' axis"):
        tensor.tp_critic(pair.discriminator, ds, Mesh(("dp",), (1,), CPU))
    with pytest.raises(ValueError, match="axis 'model' not in mesh axes"):
        tensor.tp_critic(pair.discriminator, ds, Mesh(("dp",), (1,), CPU), axis_name="model")


def test_retired_knobs_are_accepted_and_others_are_type_errors():
    pair = build_gan(ModelConfig(**MCFG), device="cpu")
    gen, critic = pair.generator, pair.discriminator
    z = torch.randn((4, W, F), generator=torch.Generator().manual_seed(1))
    one = Mesh(("tp",), (1,), CPU)
    with torch.no_grad():
        got = tensor.tp_generate(gen, z, one, manual=True, check_vma=False, chunk=4)
        assert torch.allclose(got, gen(z), atol=2e-5)
        assert torch.allclose(tensor.tp_critic(critic, z, one, manual=False), critic(z),
                              atol=2e-5)
        for fn, net in ((tensor.tp_generate, gen), (tensor.tp_critic, critic)):
            with pytest.raises(TypeError):
                fn(net, z, one, microbatches=2)


@pytest.mark.parametrize("names,sizes", [(("tp",), (2,)), (("dp", "tp"), (2, 2)),
                                         (("dp", "sp", "tp"), (1, 2, 2))])
def test_launch_names_are_jax_s(names, sizes):
    jmesh = JaxMesh(np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes), names)
    assert (rules._launch_name(Mesh(names, sizes, CPU), "multi_step")
            == jrules._launch_name(jmesh, "multi_step"))


def test_a_one_device_tp_mesh_step_is_the_plain_step():
    """A tp extent of 1: no hook, the plain forwards, bit for bit."""
    mcfg, tcfg = ModelConfig(**MCFG), TrainConfig(batch_size=B, n_critic=NC, steps_per_call=2)
    pair = build_gan(mcfg, device="cpu")
    ds = torch.rand((N_ROWS, W, F), generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(5)
    draws = [sample_draws(g, pair, tcfg, ds) for _ in range(2)]
    runs = []
    for block in (make_multi_step(pair, tcfg, ds),
                  tensor.make_tp_multi_step(pair, tcfg, ds, Mesh(("tp",), (1,), CPU))):
        rules.reset_collective_counts()
        runs.append(block(init_gan_state(0, mcfg, "cpu"), draws=draws))
        assert not any(rules.collective_counts().values())
    (a, ma), (b, mb) = runs
    assert all(torch.equal(p, q) for p, q in zip(a.discriminator.parameters(),
                                                 b.discriminator.parameters()))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


# ------------------------------------------------------------ the rank pools
def _job(tmp, ranks: int) -> tuple:
    """The spec file a pool's ranks read, and the parent's references."""
    jgen, jcritic, g_params, d_params, z, x, gen, critic = _models()

    def loss(p, v):
        return jax.numpy.sum(jcritic.apply({"params": p}, v) ** 2)

    gp_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(d_params, x)
    refs = {"gen": np.asarray(jgen.apply({"params": g_params}, z)),
            "scores": np.asarray(jcritic.apply({"params": d_params}, x)),
            "gp": gp_ref, "gx": np.asarray(gx_ref), "critic": critic}
    ds, start, draws, refs["step"] = _jax_epoch()
    mcfg = ModelConfig(**MCFG)
    tcfg = TrainConfig(batch_size=B, n_critic=NC, steps_per_call=3)
    pair = build_gan(mcfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    block_draws = [sample_draws(g, pair, tcfg, torch.from_numpy(ds)) for _ in range(3)]
    trainer_cfg = dict(batch_size=B, n_critic=NC, steps_per_call=2, seed=4,
                       checkpoint_dir=str(tmp / "ck"), checkpoint_every=2)
    if ranks == 2:
        state = init_gan_state(0, mcfg, "cpu")
        state.generator.load_state_dict(start.generator.state_dict())
        state.discriminator.load_state_dict(start.discriminator.state_dict())
        refs["block"] = make_multi_step(pair, tcfg, torch.from_numpy(ds))(state,
                                                                          draws=block_draws)
        plain = GanTrainer(ExperimentConfig(model=mcfg, train=TrainConfig(
            **dict(trainer_cfg, checkpoint_dir=None))), torch.from_numpy(ds), device="cpu")
        plain.train(4)
        refs["trainer"] = plain
    # JAX's epoch with health on (its _health_metrics), and the bf16 refs
    jax_health.configure(jax_health.HealthConfig())
    try:
        refs["jax_health"] = jax_family_epoch("mtss_wgan_gp")["ref"]["m"]
    finally:
        jax_health.configure(None)
    refs["bf16"] = bf = bf16_refs()
    refs.update(ds=ds, trainer_cfg=trainer_cfg)
    job = {"ranks": ranks, "gf": GF, "cw": CW, "h": H, "z": _t(z), "x": _t(x),
           "generator": gen.state_dict(), "critic": critic.state_dict(),
           "mcfg": dataclasses.asdict(mcfg), "tcfg": dict(batch_size=B, n_critic=NC),
           "dataset": torch.from_numpy(ds), "g0": start.generator.state_dict(),
           "d0": start.discriminator.state_dict(),
           "draws": (draws.idx, draws.noises, draws.alphas),
           "block_draws": [(d.idx, d.noises, d.alphas) for d in block_draws],
           "trainer": trainer_cfg, "bf16": family_job(bf), "obs": str(tmp / "obs"),
           "dump": str(tmp / "dump")}
    spec = str(tmp / "job.pt")
    torch.save(job, spec)
    return refs, spec


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    refs, spec = _job(tmp_path_factory.mktemp("tp2"), 2)
    return refs, run_ranks(RANK, spec, n=2)


def _bit_equal(docs, key):
    a = docs[0][key]
    for doc in docs[1:]:
        b = doc[key]
        for net in ("g", "d"):
            assert all(torch.equal(a[net][k], b[net][k]) for k in a[net]), (key, net)
        assert all(torch.equal(a["m"][k], b["m"][k]) for k in a["m"]), key


def test_tp_forwards_match_jax_s(tp2):
    refs, ranks = tp2
    for doc in ranks:
        np.testing.assert_allclose(doc["gen"].numpy(), refs["gen"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(doc["critic"]["scores"].numpy(), refs["scores"], rtol=2e-5,
                                   atol=2e-5)
    assert torch.equal(ranks[0]["gen"], ranks[1]["gen"])
    assert torch.equal(ranks[0]["critic"]["scores"], ranks[1]["critic"]["scores"])


def test_tp_critic_gradients_match_jax_s(tp2):
    """The input gradient whole on each rank; a sliced leaf's gradient the
    two ranks' partials summed, each nonzero only in its own gate columns;
    a replicated leaf's whole on each rank (the hook keeps rank 0's)."""
    refs, ranks = tp2
    for doc in ranks:
        np.testing.assert_allclose(doc["critic"]["dx"].numpy(), refs["gx"], rtol=1e-4,
                                   atol=1e-4)
    critic = refs["critic"]
    summed = {}
    for k, p in critic.named_parameters():
        axis = rules.sliced_axis(k)
        parts = [d["critic"]["dp"][k] for d in ranks]
        if axis is None:
            assert torch.equal(parts[0], parts[1]), k
            summed[k] = parts[0]
            continue
        for r, part in enumerate(parts):
            mask = torch.zeros(p.shape[axis], dtype=torch.bool)
            mask[tensor.gate_columns(H, 2, r)] = True
            off = part.index_select(axis, torch.nonzero(~mask).flatten())
            assert not off.any(), (k, r)
            assert part.index_select(axis, torch.nonzero(mask).flatten()).any(), (k, r)
        summed[k] = parts[0] + parts[1]
    with torch.no_grad():
        for k, p in critic.named_parameters():
            p.copy_(summed[k])
    mine = jax.tree_util.tree_leaves_with_path(to_flax(critic))
    ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, refs["gp"]))
    for (path, a), (_, r) in zip(mine, ref):
        np.testing.assert_allclose(a, r, rtol=1e-4, atol=1e-4, err_msg=jax.tree_util.keystr(path))


def test_tp_step_matches_jax_s_plain_step(tp2):
    """One epoch from JAX's init on JAX's draws against JAX's plain epoch
    at JAX's cross-process tp bar (atol 1e-4); the ranks bit-equal; the
    all_reduces exactly :func:`tp_reduces`."""
    refs, ranks = tp2
    for doc in ranks:
        _check_against_jax(doc["tp"], refs["step"], atol=1e-4)
        c = doc["tp"]["collectives"]
        assert c == {"all_reduce": tp_reduces(NC, W), "all_gather": 0, "broadcast": 0,
                     "send": 0, "recv": 0}, c
    assert [d["tp"]["coords"] for d in ranks] == [{"tp": 0}, {"tp": 1}]
    _bit_equal(ranks, "tp")


def test_tp_block_matches_the_single_device_block(tp2):
    refs, ranks = tp2
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
        assert got["collectives"]["all_reduce"] == 3 * tp_reduces(NC, W)
    _bit_equal(ranks, "block")


def test_tp_trainer_matches_plain_trajectory_and_resumes_exactly(tp2):
    refs, ranks = tp2
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
    assert all(torch.equal(ranks[0]["trainer"]["d"][k], ranks[1]["trainer"]["d"][k])
               for k in ranks[0]["trainer"]["d"])


def test_a_tp_checkpoint_restores_on_one_device_bit_for_bit(tp2):
    refs, ranks = tp2
    cfg = ExperimentConfig(model=ModelConfig(**MCFG), train=TrainConfig(**refs["trainer_cfg"]))
    one = GanTrainer(cfg, torch.from_numpy(refs["ds"]), device="cpu")
    one.restore_checkpoint(refs["trainer_cfg"]["checkpoint_dir"] + "/ckpt_4")
    assert one.epoch == 4 and one.mesh is None
    t = ranks[0]["trainer"]
    for net, module in (("g", one.state.generator), ("d", one.state.discriminator)):
        assert all(torch.equal(v, t[net][k]) for k, v in module.state_dict().items()), net


def test_tp_health_is_off_bit_for_bit_and_jax_s_values(tp2):
    """One tp=2 epoch with health on from JAX's init on JAX's draws: params,
    slots and the plain metrics bit for bit the health-off epoch's, the
    all_reduces still exactly :func:`tp_reduces` (health reads the reduced
    gradients and the replicated state: no collective of its own), the
    five values JAX's ``_health_metrics`` at the bars of
    ``test_torch_health.py::test_health_values_match_jax``, the ranks bit
    for bit."""
    refs, ranks = tp2
    for doc in ranks:
        on, off = doc["tp_health"], doc["tp"]
        assert state_equal(off, on)
        assert set(on["m"]) == set(off["m"]) | set(health.STEP_KEYS)
        assert on["collectives"]["all_reduce"] == tp_reduces(NC, W), on["collectives"]
        for k in health.STEP_KEYS:
            np.testing.assert_allclose(float(on["m"][k]), float(refs["jax_health"][k]),
                                       atol=1e-5, rtol=1e-4, err_msg=k)
    assert state_equal(ranks[0]["tp_health"], ranks[1]["tp_health"], health_keys=True)


def test_tp_trainer_with_health_gauges_on_rank_0_and_trips_every_rank(tp2, tmp_path_factory):
    """``GanTrainer`` on the tp mesh with health on: history (the plain
    keys), params and slots bit for bit the health-off trainer's; the
    ``health/*`` gauges in rank 0's stream alone; a NaN parameter under
    the armed tripwire raises ``NumericFault`` on both ranks at the first
    block boundary, with one dump, rank 0's."""
    refs, ranks = tp2
    for doc in ranks:
        on, off = doc["trainer_health"], doc["trainer"]
        assert [{k: v for k, v in h.items() if not k.startswith("health_")}
                for h in on["history"]] == off["history"]
        assert all("health_nonfinite" in h for h in on["history"])
        for net in ("g", "d"):
            assert all(torch.equal(on[net][k], off[net][k]) for k in off[net]), net
        assert state_equal(dict(on, m={}, step=0), dict(off, m={}, step=0))
    assert ranks[0]["trainer_health"]["history"] == ranks[1]["trainer_health"]["history"]
    obs_root = Path(ranks[0]["fault"]["dump"]).parents[1] / "obs"
    gauges = [{json.loads(line)["name"] for line in
               (obs_root / f"rank{r}" / "events.jsonl").read_text().splitlines()
               if line and json.loads(line).get("kind") == "gauge"} for r in (0, 1)]
    assert {f"health/{k[len('health_'):]}" for k in health.STEP_KEYS} <= gauges[0]
    assert not any(g.startswith("health/") for g in gauges[1])
    faults = [d["fault"] for d in ranks]
    assert [(f["site"], f["epoch"], f["trainer_epoch"]) for f in faults] == [("block", 1, 0)] * 2
    assert faults[1]["dump"] is None and Path(faults[0]["dump"]).is_dir()
    assert [p.name for p in Path(faults[0]["dump"]).parent.iterdir()] == ["numeric_fault_1"]


def test_tp_bf16_epoch_at_the_bf16_bars(tp2):
    """A bf16 tp=2 epoch from JAX's bf16 init on its draws: at the bf16
    bars against JAX's bf16 epoch and the port's single-device bf16 epoch
    on both critic routes (the rank's gate columns under
    ``lstm_seq_plain``'s policy: bf16 streams, float32 state and gate
    math, float32 exchanges), the all_reduces :func:`tp_reduces`, float32
    state, the ranks bit for bit."""
    refs, ranks = tp2
    bf = refs["bf16"]
    p0 = state_doc(bf["start"], {})
    for doc in ranks:
        got = doc["tp_bf16"]
        for ref in (bf["ref"], bf["auto"], bf["chained"]):
            assert_bf16_bars(bf16_errs(got, ref, p0))
        assert got["collectives"]["all_reduce"] == tp_reduces(NC, W)
        assert all(v.dtype == torch.float32 for net in ("g", "d") for v in got[net].values())
    assert state_equal(ranks[0]["tp_bf16"], ranks[1]["tp_bf16"])


#: one rank of ``train-gan`` on a tiny flagship preset over the committed
#: panel (H=8, W=12, 2 epochs), the mesh flags after the spec
CLI_RANK = r'''
import dataclasses, sys
from hfrep_tpu_torch import config
tiny = config.ExperimentConfig(
    data=config.DataConfig(n_sample=48, window=12),
    model=config.ModelConfig(family="mtss_wgan_gp", hidden=8, window=12, features=35),
    train=config.TrainConfig(batch_size=8, n_critic=2, steps_per_call=2, epochs=2), name="tiny")
config.PRESETS["tiny"] = tiny
from hfrep_tpu_torch.experiments.cli import main
sys.exit(main(["train-gan", "--preset", "tiny", *sys.argv[1:]]))
'''


@pytest.mark.parametrize("flags", [("--tp-mesh", "2"), ("--dp-tp", "1x2")])
def test_train_gan_on_a_tp_mesh_with_health_on(tmp_path, flags):
    """``train-gan --tp-mesh 2`` and ``--dp-tp 1x2`` as two ranks under
    ``HFREP_HEALTH=abort``: both exit 0, rank 0's stream alone holds the
    ``health/*`` gauges, no ``numeric_fault``."""
    import os
    import socket
    import subprocess
    import sys

    from test_torch_sequence import ROOT

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith("HFREP_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", HFREP_HEALTH="abort")
    argv = ["--cleaned-dir", str(ROOT / "results" / "rederived_cleaned"), "--device", "cpu",
            "--quiet", *flags, "--obs-dir", str(tmp_path / "obs"), "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-c", CLI_RANK, *argv, "--process-id", str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    try:
        runs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in runs]
    streams = [(tmp_path / "obs" / f"proc{r}" / "events.jsonl").read_text() for r in (0, 1)]
    gauges = [{json.loads(line)["name"] for line in text.splitlines()
               if line and json.loads(line).get("kind") == "gauge"} for text in streams]
    assert {f"health/{k[len('health_'):]}" for k in health.STEP_KEYS} <= gauges[0]
    assert not any(g.startswith("health/") for g in gauges[1])
    assert not any("numeric_fault" in text for text in streams)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    refs, spec = _job(tmp_path_factory.mktemp("tp4"), 4)
    return refs, run_ranks(RANK, spec, n=4)


@pytest.mark.parametrize("mesh", ["dp_tp", "dp_sp_tp", "tp4"])
def test_four_rank_meshes_match_jax_s_plain_step(tp4, mesh):
    """dp×tp 2×2, dp×sp×tp 1×2×2 and tp=4, one epoch each against JAX's
    plain epoch at atol 1e-4: every rank's all_reduces exactly
    :func:`tp_reduces` (dp×sp×tp's chain transfers as sp's), the ranks of
    each tile bit-equal and every rank within rtol 1e-6."""
    refs, ranks = tp4
    for doc in ranks:
        got = doc[mesh]
        _check_against_jax(got, refs["step"], atol=1e-4)
        c = got["collectives"]
        if mesh == "dp_sp_tp":
            s = got["coords"]["sp"]
            assert c["all_reduce"] == tp_reduces(NC, W // 2, 2, s), (s, c)
            passes = 1 + 2 * NC + 2
            assert c["send"] + c["recv"] == passes + (2 * NC + 2) + 2 * NC, c
        else:
            assert c["all_reduce"] == tp_reduces(NC, W) and c["send"] == c["recv"] == 0, c
    for doc in ranks[1:]:
        for net in ("g", "d"):
            for k in doc[mesh][net]:
                np.testing.assert_allclose(doc[mesh][net][k].numpy(),
                                           ranks[0][mesh][net][k].numpy(), rtol=1e-6, atol=0)
    tiles = {}
    for doc in ranks:
        key = tuple(v for a, v in doc[mesh]["coords"].items() if a != "tp")
        tiles.setdefault(key, []).append(doc)
    for docs in tiles.values():
        _bit_equal(docs, mesh)


def test_dp_sp_tp_health_and_bf16(tp4):
    """dp×sp×tp 1×2×2: the epoch with health on bit for bit the health-off
    one (params, slots, plain metrics), its counts unchanged, the health
    values JAX's; a bf16 epoch at the bf16 bars against JAX's and the
    port's single-device bf16 epochs; each tp group bit-equal."""
    refs, ranks = tp4
    bf = refs["bf16"]
    p0 = state_doc(bf["start"], {})
    for doc in ranks:
        on, off = doc["dp_sp_tp_health"], doc["dp_sp_tp"]
        assert state_equal(off, on)
        assert on["collectives"]["all_reduce"] == tp_reduces(NC, W // 2, 2, on["coords"]["sp"])
        for k in health.STEP_KEYS:
            np.testing.assert_allclose(float(on["m"][k]), float(refs["jax_health"][k]),
                                       atol=1e-5, rtol=1e-4, err_msg=k)
        for ref in (bf["ref"], bf["auto"], bf["chained"]):
            assert_bf16_bars(bf16_errs(doc["dp_sp_tp_bf16"], ref, p0))
    for key in ("dp_sp_tp_health", "dp_sp_tp_bf16"):
        tiles = {}
        for doc in ranks:
            tiles.setdefault(doc[key]["coords"]["sp"], []).append(doc[key])
        for docs in tiles.values():
            assert state_equal(docs[0], docs[1], health_keys=True), key


def test_tp4_forwards_match_jax_s(tp4):
    refs, ranks = tp4
    for doc in ranks:
        np.testing.assert_allclose(doc["gen"].numpy(), refs["gen"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(doc["scores"].numpy(), refs["scores"], rtol=2e-5, atol=2e-5)


@pytest.mark.slow
def test_dp_sp_tp_2x2x2_matches_jax_s_plain_step(tmp_path):
    refs, spec = _job(tmp_path, 8)
    ranks = run_ranks(RANK, spec, n=8)
    for doc in ranks:
        _check_against_jax(doc["dp_sp_tp"], refs["step"], atol=1e-4)
        assert doc["dp_sp_tp"]["collectives"]["all_reduce"] == tp_reduces(
            NC, W // 2, 2, doc["dp_sp_tp"]["coords"]["sp"])
