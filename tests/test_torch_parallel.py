"""The port's mesh core (``hfrep_tpu_torch/parallel/{rules,mesh,
data_parallel,__init__}``) against the JAX package's, on the CPU.

* The rules (``tests/test_mesh_rules.py:91-206``): ``MeshSpec``,
  ``normalize_spec`` and ``match_partition_rules`` over the GAN state give
  JAX's specs leaf by leaf, the port's names mapped to JAX's through
  ``FLAX_NAMES``; an unmatched leaf and an indivisible shard are refused
  naming the leaf, as JAX refuses them; shard and gather round-trip.
* The identity (``:208-232``): a one-device mesh step is bit for bit the
  plain step, for each loss kind, with no collective.
* The refusals: a batch dp does not divide, unknown axis names, sp, tp
  and pp naming ROADMAP item 9b, a multi-device hook with no process
  group.
* The backend and device rules, and that no new module imports JAX.
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
from jax.sharding import PartitionSpec as JP

from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.parallel import rules as jrules
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu_torch.config import ExperimentConfig, MeshConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.obs import health as health_mod
from hfrep_tpu_torch.parallel import mesh as pmesh
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.parallel.rules import Mesh, MeshSpec, P
from hfrep_tpu_torch.train import init_gan_state, make_multi_step, sample_draws
from hfrep_tpu_torch.train.trainer import GanTrainer

ROOT = Path(__file__).resolve().parents[1]
MCFG = dict(family="mtss_wgan_gp", features=5, window=8, hidden=8)
TCFG = dict(batch_size=16, n_critic=2, steps_per_call=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dataset():
    return torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (64, 8, 5))
                            .astype(np.float32))


def _jax_flax_name(net: str, port_name: str, module) -> str:
    """The JAX path of a port parameter: ``g_params/KerasLSTM_0/kernel``."""
    for path, name in health_mod._flax_paths(module):
        if name == port_name:
            return "/".join(({"generator": "g_params", "discriminator": "d_params"}[net],)
                            + path)
    raise KeyError(port_name)


def _spec_tuple(s):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in s)


# ---------------------------------------------------------------- the rules
@pytest.mark.parametrize("spec", [MeshSpec(), MeshSpec(dp=2), MeshSpec(tp=2),
                                  MeshSpec(dp=2, sp=4), MeshSpec(dp=2, tp=2, pp=2)])
def test_mesh_spec_is_jax_s(spec):
    j = jrules.MeshSpec(**dataclasses.asdict(spec))
    assert (spec.size, spec.axis_names, spec.axis_sizes, spec.describe()) == \
        (j.size, j.axis_names, j.axis_sizes, j.describe())
    with pytest.raises(ValueError, match=">= 1"):
        MeshSpec(dp=0)


@pytest.mark.parametrize("spec", [JP(), JP("dp"), JP(None, "tp"), JP(("dp", "tp"), None),
                                  JP(None, ("sp", "tp")), JP("sp", None, None)])
@pytest.mark.parametrize("mesh", [MeshSpec(), MeshSpec(dp=2), MeshSpec(tp=2),
                                  MeshSpec(dp=2, sp=2, tp=2)])
def test_normalize_spec_is_jax_s(spec, mesh):
    jmesh = jrules.build_mesh(jrules.MeshSpec(**dataclasses.asdict(mesh)),
                              devices=jax.devices()[:mesh.size])
    want = jrules.normalize_spec(spec, jmesh)
    got = rules.normalize_spec(P(*spec), mesh)
    assert _spec_tuple(got) == _spec_tuple(want)


@pytest.mark.parametrize("mesh", [MeshSpec(), MeshSpec(dp=2), MeshSpec(tp=2),
                                  MeshSpec(dp=2, tp=4)])
@pytest.mark.parametrize("family", ["mtss_wgan_gp", "gan"])
def test_gan_state_specs_are_jax_s_leaf_by_leaf(mesh, family):
    """The port's rules over the port's names give, for every parameter,
    the spec JAX's rules give its JAX leaf; optimizer slots follow their
    parameter; scalars replicate."""
    jm = JaxModelConfig(**dict(MCFG, family=family))
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(jax.random.PRNGKey(0), jm, JaxTrainConfig(**TCFG), jpair)
    jmesh = jrules.build_mesh(jrules.MeshSpec(**dataclasses.asdict(mesh)),
                              devices=jax.devices()[:mesh.size])
    jspecs = dict(jrules.named_leaves(jrules.gan_state_specs(jstate, jmesh)))
    state = init_gan_state(0, ModelConfig(**dict(MCFG, family=family)), "cpu")
    specs = rules.gan_state_specs(state, mesh)
    by_name = dict(rules.named_leaves(specs))
    for net, module in (("generator", state.generator), ("discriminator", state.discriminator)):
        for name, _ in module.named_parameters():
            want = jspecs[_jax_flax_name(net, name, module)]
            assert _spec_tuple(by_name[f"{net}/{name}"]) == _spec_tuple(want), name
            opt = "g_opt" if net == "generator" else "d_opt"
            slots = [k for k in by_name if k.startswith(f"{opt}/") and k.endswith(f"/{name}")]
            assert slots and all(_spec_tuple(by_name[k]) == _spec_tuple(want) for k in slots)
    assert by_name["step"] == P()
    if "tp" not in mesh.axis_names:
        assert all(s == P() for s in by_name.values())


def test_scalars_replicate_and_unmatched_leaf_is_named_as_jax_does():
    state = init_gan_state(0, ModelConfig(**MCFG), "cpu")
    specs = rules.match_partition_rules(((r".*", P("tp")),), state, MeshSpec(tp=2))
    assert dict(rules.named_leaves(specs))["step"] == P()
    tree = {"generator": {"lstm0.kernel": torch.zeros(3, 4)}}
    with pytest.raises(ValueError, match=r"generator/lstm0\.kernel") as mine:
        rules.match_partition_rules(((r"only/this", P()),), tree)
    with pytest.raises(ValueError) as theirs:
        jrules.match_partition_rules(((r"only/this", JP()),),
                                     {"generator": {"lstm0.kernel": jnp.zeros((3, 4))}})
    assert str(mine.value).split(":")[0] == str(theirs.value).split(":")[0]


def test_ae_lane_rules_over_the_engine_carry():
    """AE_LANE_RULES over a real (D, L) grid carry: every vector leaf leads
    with the dataset axis and shards over dp (JAX ``:139-155``)."""
    from hfrep_tpu_torch.config import AEConfig
    from hfrep_tpu_torch.replication import engine

    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=4, batch_size=16, patience=2,
                   chunk_epochs=2)
    x = torch.rand(2, 24, 4)
    init = engine.keras_init_params(torch.Generator().manual_seed(0), (2, 2), 4, 2, "cpu")
    grid = engine._Grid(cfg, x, torch.ones(2, 2), None, init, 2)
    specs = dict(rules.named_leaves(rules.match_partition_rules(
        rules.AE_LANE_RULES, grid.carry(), MeshSpec(dp=2))))
    for name, leaf in rules.named_leaves(grid.carry()):
        assert leaf.shape[0] == 2 and specs[name] == P("dp"), name


def test_shard_and_gather_one_device_and_the_divisibility_error():
    one = rules.build_mesh(MeshSpec(), device="cpu")
    tree = {"a": np.arange(8.0, dtype=np.float32), "b": np.ones((4, 3), np.float32)}
    shard, gather = rules.make_shard_and_gather_fns(one, P("dp"))
    placed = shard(tree)
    assert isinstance(placed["a"], torch.Tensor) and placed["a"].shape == (8,)
    np.testing.assert_array_equal(gather(placed)["a"], np.arange(8.0))
    # rank 1 of a declared dp=4 mesh: its block of each leaf (no collective)
    mesh4 = Mesh(("dp",), (4,), torch.device("cpu"), rank=1)
    assert rules.shard_put(tree, mesh4, P("dp"))["a"].tolist() == [2.0, 3.0]
    bad = {"ok": np.zeros(8, np.float32), "bad": np.zeros(6, np.float32)}
    with pytest.raises(ValueError, match=r"bad.*not divisible") as mine:
        rules.shard_put(bad, mesh4, P("dp"))
    jmesh = jrules.build_mesh(jrules.MeshSpec(dp=4), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as theirs:
        jrules.shard_put({"ok": jnp.zeros(8), "bad": jnp.zeros(6)}, jmesh, JP("dp"))
    assert str(mine.value) == str(theirs.value)


def test_mesh_building_and_its_refusals():
    m = rules.build_mesh(MeshSpec(), device="cpu")
    assert (m.axis_names, m.shape, m.size, m.group, m.spans_processes) == \
        (("dp",), {"dp": 1}, 1, None, False)
    assert rules.mesh_spec(m) == MeshSpec() and rules.mesh_spec(None) == MeshSpec()
    assert rules.mesh_spec(Mesh(("dp", "tp"), (2, 2), torch.device("cpu"))) == \
        MeshSpec(dp=2, tp=2)
    with pytest.raises(ValueError, match="not in"):
        rules.mesh_spec(Mesh(("model",), (2,), torch.device("cpu")))
    with pytest.raises(ValueError, match="no process group|none is initialized"):
        rules.build_mesh(MeshSpec(dp=2), device="cpu")
    assert rules.lane_mesh(21, device="cpu").shape == {"dp": 1}
    assert pmesh.make_mesh(MeshConfig(), device="cpu").shape == {"dp": 1}
    with pytest.raises(ValueError, match="spans 1"):
        pmesh.make_mesh(MeshConfig(dp=2), device="cpu")
    assert pmesh.initialize_distributed(None) is None
    assert not pmesh.spans_processes(m) and pmesh.replicate_to_global({"x": 1}, m) == {"x": 1}


def test_backend_and_device_rules():
    cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
    assert rules.choose_backend([cpu, cpu]) == "gloo"
    assert rules.choose_backend([c0, c0]) == "gloo"      # two ranks share a card
    assert rules.choose_backend([c0, c1]) == "nccl"
    assert rules.choose_backend([c0, cpu]) == "gloo"
    assert rules.rank_device("cpu", 3) == cpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rules.rank_device(None, 0)


# ----------------------------------------------------------- the identity
@pytest.mark.parametrize("family", ["gan", "wgan", "mtss_wgan_gp"])
def test_one_device_mesh_block_is_the_plain_block_bit_for_bit(family):
    mcfg, tcfg = ModelConfig(**dict(MCFG, family=family)), TrainConfig(**TCFG)
    ds = _dataset()
    pair = build_gan(mcfg, device="cpu")
    mesh1 = rules.build_mesh(MeshSpec(), device="cpu")
    assert rules.data_constraint(mesh1) is None and rules.data_constraint(None) is None
    g = torch.Generator().manual_seed(1)
    draws = [sample_draws(g, pair, tcfg, ds) for _ in range(tcfg.steps_per_call)]
    out = []
    from hfrep_tpu_torch.parallel import make_dp_multi_step
    for fn in (make_multi_step(pair, tcfg, ds),
               rules.make_gan_multi_step(pair, tcfg, ds, mesh1),
               make_dp_multi_step(pair, tcfg, ds, mesh1)):
        rules.reset_collective_counts()
        state, m = fn(init_gan_state(0, mcfg, "cpu"), draws=draws)
        assert rules.collective_counts()["all_reduce"] == 0
        out.append((state, m))
    (a, ma), *rest = out
    for b, mb in rest:
        for x, y in zip(list(a.generator.parameters()) + list(a.discriminator.parameters()),
                        list(b.generator.parameters()) + list(b.discriminator.parameters())):
            assert torch.equal(x, y)
        assert all(torch.equal(ma[k], mb[k]) for k in ma) and a.step == b.step == 2
    assert rules._launch_name(mesh1, "multi_step") == "dp_multi_step"


def test_a_one_device_mesh_trainer_is_the_plain_trainer(tmp_path):
    cfg = ExperimentConfig(model=ModelConfig(**MCFG), train=TrainConfig(**TCFG))
    ds = _dataset()
    runs = []
    for mesh in (None, rules.build_mesh(MeshSpec(), device="cpu")):
        tr = GanTrainer(cfg, ds, device="cpu", mesh=mesh)
        tr.train(5)                       # two blocks and a remainder epoch
        runs.append(tr)
    assert runs[0].history == runs[1].history
    assert all(torch.equal(x, y) for x, y in zip(runs[0].state.generator.parameters(),
                                                 runs[1].state.generator.parameters()))


# ----------------------------------------------------------- the refusals
def test_refusals_name_what_was_asked():
    mcfg, tcfg = ModelConfig(**MCFG), TrainConfig(**dict(TCFG, batch_size=9))
    pair, ds = build_gan(mcfg, device="cpu"), _dataset()
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="global batch 9 not divisible by dp=2"):
        rules.make_gan_multi_step(pair, tcfg, ds, Mesh(("dp",), (2,), cpu))
    for names in (("sp",), ("tp",), ("pp",), ("dp", "sp")):
        with pytest.raises(ValueError, match="item 9b"):
            rules.make_gan_multi_step(pair, TrainConfig(**TCFG), ds,
                                      Mesh(names, (2,) * len(names), cpu))
    with pytest.raises(RuntimeError, match="needs a process group"):
        rules.make_gan_train_step(pair, TrainConfig(**TCFG), ds, Mesh(("dp",), (2,), cpu))
    cfg = ExperimentConfig(model=mcfg, train=TrainConfig(**TCFG))
    with pytest.raises(ValueError, match=r"mesh axis names \('model',\) not recognized"):
        GanTrainer(cfg, ds, device="cpu", mesh=Mesh(("model",), (1,), cpu))


def test_the_new_modules_import_no_jax():
    code = ("import sys\n"
            "import hfrep_tpu_torch.parallel, hfrep_tpu_torch.parallel.rules\n"
            "import hfrep_tpu_torch.parallel.mesh, hfrep_tpu_torch.parallel.data_parallel\n"
            "import hfrep_tpu_torch.train.multi_seed, hfrep_tpu_torch.train.trainer\n"
            "import hfrep_tpu_torch.replication.engine, hfrep_tpu_torch.experiments.cli\n"
            "import hfrep_tpu_torch.resilience.drive_fixtures\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hfrep_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr
