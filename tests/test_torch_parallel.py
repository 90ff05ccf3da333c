"""The port's mesh core (``hfrep_tpu_torch/parallel/{rules,mesh,
__init__}``) against the JAX package's, on the CPU.

* ``MeshSpec`` as JAX's (``tests/test_mesh_rules.py:91-206``).  JAX's
  partition-rule machinery has no port: its one use is the tp layout,
  ROADMAP queue 1 item 9c.
* The identity (``:208-232``): a one-device mesh step is bit for bit the
  plain step, for each loss kind, with no collective.
* The refusals: a batch dp does not divide, unknown axis names, tp
  naming ROADMAP item 9c, pp left to the layer pipeline and sp to the
  window launch, a multi-device hook with no process group.
* The backend and device rules, and that no new module imports JAX.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hfrep_tpu.parallel import rules as jrules
from hfrep_tpu_torch.config import ExperimentConfig, MeshConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.parallel import mesh as pmesh
from hfrep_tpu_torch.parallel import sequence
from hfrep_tpu_torch.parallel import rules
from hfrep_tpu_torch.parallel.rules import Mesh, MeshSpec
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


# ---------------------------------------------------------------- the rules
@pytest.mark.parametrize("spec", [MeshSpec(), MeshSpec(dp=2), MeshSpec(tp=2),
                                  MeshSpec(dp=2, sp=4), MeshSpec(dp=2, tp=2, pp=2)])
def test_mesh_spec_is_jax_s(spec):
    j = jrules.MeshSpec(**dataclasses.asdict(spec))
    assert (spec.size, spec.axis_names, spec.axis_sizes, spec.describe()) == \
        (j.size, j.axis_names, j.axis_sizes, j.describe())
    with pytest.raises(ValueError, match=">= 1"):
        MeshSpec(dp=0)


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
    for fn in (make_multi_step(pair, tcfg, ds),
               rules.make_gan_multi_step(pair, tcfg, ds, mesh1),
               rules.make_gan_multi_step(pair, tcfg, ds, pmesh.make_mesh_2d(1, 1, "cpu"))):
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
    for names in (("tp",), ("dp", "tp"), ("dp", "sp", "tp")):
        with pytest.raises(ValueError, match="item 9c"):
            rules.make_gan_multi_step(pair, TrainConfig(**TCFG), ds,
                                      Mesh(names, (2,) * len(names), cpu))
    with pytest.raises(ValueError, match="layer_pipeline.py axis"):
        rules.make_gan_multi_step(pair, TrainConfig(**TCFG), ds, Mesh(("pp",), (2,), cpu))
    for names in (("sp",), ("dp", "sp")):
        with pytest.raises(ValueError, match="sequence.py axis"):
            rules.make_gan_multi_step(pair, TrainConfig(**TCFG), ds,
                                      Mesh(names, (2,) * len(names), cpu))
    with pytest.raises(RuntimeError, match="needs a process group"):
        rules.make_gan_train_step(pair, TrainConfig(**TCFG), ds, Mesh(("dp",), (2,), cpu))
    for names in (("sp",), ("dp", "sp")):
        with pytest.raises(RuntimeError, match="needs a process group"):
            sequence.make_sp_train_step(pair, TrainConfig(**TCFG), ds,
                                        Mesh(names, (2,) * len(names), cpu))
    cfg = ExperimentConfig(model=mcfg, train=TrainConfig(**TCFG))
    with pytest.raises(ValueError, match=r"mesh axis names \('model',\) not recognized"):
        GanTrainer(cfg, ds, device="cpu", mesh=Mesh(("model",), (1,), cpu))


def test_the_new_modules_import_no_jax():
    code = ("import sys\n"
            "import hfrep_tpu_torch.parallel, hfrep_tpu_torch.parallel.rules\n"
            "import hfrep_tpu_torch.parallel.mesh, hfrep_tpu_torch.parallel.chain\n"
            "import hfrep_tpu_torch.parallel.sequence, hfrep_tpu_torch.parallel.dp_sp\n"
            "import hfrep_tpu_torch.parallel.layer_pipeline\n"
            "import hfrep_tpu_torch.train.multi_seed, hfrep_tpu_torch.train.trainer\n"
            "import hfrep_tpu_torch.replication.engine, hfrep_tpu_torch.experiments.cli\n"
            "import hfrep_tpu_torch.resilience.drive_fixtures\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hfrep_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr
