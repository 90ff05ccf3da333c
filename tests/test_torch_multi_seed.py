"""``train/multi_seed.py`` against the port's trainer and the JAX
package's multi-seed trainer, on the CPU.

* Member k equals ``GanTrainer`` with ``train.seed = seeds[k]`` bit for
  bit (a block and a remainder epoch), for each loss kind: the port's
  form of JAX's member-exactness (``hfrep_tpu/train/multi_seed.py:1-25``).
* Fed JAX's members' init and draws through ``draw_sources``, each member
  matches JAX's ``MultiSeedTrainer`` member at the epoch bars.
* Checkpoints (``tests/test_resilience.py:581-601``): a resume from
  ``ckpt_4`` is bit-equal to the straight run; other seeds are refused;
  a drain at a block boundary writes a final checkpoint; a malformed
  fault spec is loud (``tests/test_orchestrate.py:331-337``).
* The seed mesh: two spawned gloo ranks, one member each, each bit-equal
  to its standalone trainer, the checkpoint (rank 0's) holding both, and
  ``generate`` gathered.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hfrep_tpu.config import ExperimentConfig as JaxExperimentConfig
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.train.multi_seed import MultiSeedTrainer as JaxMultiSeedTrainer
from hfrep_tpu_torch import resilience as res
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.parallel.rules import Mesh
from hfrep_tpu_torch.resilience.faults import FaultPlan
from hfrep_tpu_torch.train import Draws
from hfrep_tpu_torch.train.multi_seed import MultiSeedTrainer, init_multi_seed_states
from hfrep_tpu_torch.train.trainer import GanTrainer
from hfrep_tpu_torch.utils.bridge import gan_state_from_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
H, W, F, B, NC, N_ROWS = 8, 8, 5, 16, 2, 64
SEEDS = (3, 4)

RANK = r'''
import sys, torch
torch.set_num_threads(1)
from hfrep_tpu_torch.parallel import initialize_distributed, shutdown_distributed
from hfrep_tpu_torch.train.multi_seed import MultiSeedTrainer, seed_mesh
rank, port, spec = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = torch.load(spec, weights_only=False)
initialize_distributed("127.0.0.1:" + port, 2, rank, device="cpu")
try:
    try:
        seed_mesh(3, device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    ms = MultiSeedTrainer(job["cfg"], job["ds"], job["seeds"], mesh="auto", device="cpu")
    ms.train(5)
    out = {"refused": refused, "mesh": ms.mesh.shape, "held": sorted(ms.members),
           "params": {i: {k: v.clone() for k, v in m.state.generator.state_dict().items()}
                      for i, m in ms.members.items()},
           "path": ms.save_checkpoint(),
           "samples": ms.generate(3, generator=torch.Generator().manual_seed(1))}
    torch.save(out, spec + f".rank{rank}")
finally:
    shutdown_distributed()
'''


@pytest.fixture(autouse=True)
def _pristine(monkeypatch):
    torch.set_num_threads(1)
    res.clear_plan()
    monkeypatch.setattr(res, "_env_consumed", False)
    monkeypatch.delenv(res.ENV_FAULTS, raising=False)
    yield
    res.clear_plan()


def _ds():
    return torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (N_ROWS, W, F))
                            .astype(np.float32))


def _cfg(family="mtss_wgan_gp", **train) -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(family=family, features=F, window=W, hidden=H),
        train=TrainConfig(batch_size=B, n_critic=NC, steps_per_call=2, **train))


def _gparams(state) -> list:
    return list(state.generator.parameters()) + list(state.discriminator.parameters())


@pytest.mark.parametrize("family", ["mtss_wgan_gp", "gan", "wgan"])
def test_member_k_is_gan_trainer_of_seed_k_bit_for_bit(family):
    cfg, ds = _cfg(family), _ds()
    ms = MultiSeedTrainer(cfg, ds, SEEDS, device="cpu")
    states = ms.train(5)                        # two blocks and a remainder epoch
    assert ms.epoch == 5 and sorted(states) == [0, 1]
    for k, seed in enumerate(SEEDS):
        tr = GanTrainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed)),
                        ds, device="cpu")
        tr.train(5)
        assert all(torch.equal(a, b) for a, b in zip(_gparams(tr.state), _gparams(states[k])))
        assert tr.state.step == states[k].step == 5
    for k, state in enumerate(init_multi_seed_states(SEEDS, cfg.model, "cpu")):
        want = GanTrainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, seed=SEEDS[k])), ds, device="cpu").state
        assert all(torch.equal(a, b) for a, b in zip(_gparams(want), _gparams(state)))
    samples = ms.generate(3, generator=torch.Generator().manual_seed(1))
    assert samples.shape == (2, 3, W, F) and torch.isfinite(samples).all()


def _jax_draws(key) -> Draws:
    ks = [jax.random.split(jax.random.fold_in(key, i), 3) for i in range(NC)]
    t = lambda x, d=torch.float32: torch.from_numpy(np.array(x)).to(d)   # noqa: E731
    return Draws(idx=t(jax.numpy.stack([jax.random.randint(k[0], (B,), 0, N_ROWS)
                                        for k in ks]), torch.long),
                 noises=t(jax.numpy.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])),
                 alphas=t(jax.numpy.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])))


def test_members_fed_jax_s_draws_match_jax_s_members():
    """JAX's member k: run key ``split(PRNGKey(seed))[0]`` split once a
    block or remainder epoch; a block's epoch i folds i into the block's
    key, a remainder epoch takes its key raw."""
    ds = _ds()
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(family="mtss_wgan_gp", features=F, window=W, hidden=H),
        train=JaxTrainConfig(batch_size=B, n_critic=NC, steps_per_call=2, lstm_backend="xla"))
    jms = JaxMultiSeedTrainer(jcfg, jax.numpy.asarray(ds.numpy()), SEEDS)
    init = jax.tree_util.tree_map(np.asarray, jms.states)
    run_keys = np.asarray(jms.keys)
    jms.train(3)
    sources = []
    for k in range(len(SEEDS)):
        key, blocks = jax.numpy.asarray(run_keys[k]), []
        for _ in range(2):                       # one block, one remainder epoch
            key, sub = jax.random.split(key)
            blocks.append(sub)
        sources.append(lambda b, i, bl=blocks: _jax_draws(jax.random.fold_in(bl[b], i))
                       if b == 0 else _jax_draws(bl[b]))
    ms = MultiSeedTrainer(_cfg(), ds, SEEDS, device="cpu", draw_sources=sources)
    for k, m in ms.members.items():
        start = gan_state_from_flax(jax.tree_util.tree_map(lambda x: x[k], init.g_params),
                                    jax.tree_util.tree_map(lambda x: x[k], init.d_params),
                                    ms.pair)
        m.state.generator.load_state_dict(start.generator.state_dict())
        m.state.discriminator.load_state_dict(start.discriminator.state_dict())
    states = ms.train(3)
    for k in range(len(SEEDS)):
        for module, tree in ((states[k].generator, jms.states.g_params),
                             (states[k].discriminator, jms.states.d_params)):
            mine = jax.tree_util.tree_leaves(to_flax(module))
            ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: np.asarray(x[k]),
                                                                   tree))
            for a, r in zip(mine, ref):
                np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-4)


def test_checkpoint_roundtrip_resume_and_foreign_seeds(tmp_path):
    cfg, ds = _cfg(checkpoint_dir=str(tmp_path / "ms"), checkpoint_every=2), _ds()
    base = MultiSeedTrainer(cfg, ds, SEEDS, device="cpu")
    base.train(6)                               # saves at 2, 4, 6
    resumed = MultiSeedTrainer(cfg, ds, SEEDS, device="cpu")
    assert resumed.restore_checkpoint(str(tmp_path / "ms" / "ckpt_4")).endswith("ckpt_4")
    assert resumed.epoch == 4
    resumed.train(2)
    for k in base.members:
        assert all(torch.equal(a, b) for a, b in zip(_gparams(base.members[k].state),
                                                     _gparams(resumed.members[k].state)))
        assert torch.equal(base.members[k].gen.get_state(), resumed.members[k].gen.get_state())
    other = MultiSeedTrainer(cfg, ds, (5, 6), device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        other.restore_checkpoint(str(tmp_path / "ms" / "ckpt_6"))


def test_drain_at_a_block_boundary_and_a_malformed_fault_spec(tmp_path, monkeypatch):
    cfg, ds = _cfg(checkpoint_dir=str(tmp_path / "d")), _ds()
    tr = MultiSeedTrainer(cfg, ds, SEEDS, device="cpu")
    res.install_plan(FaultPlan.parse("preempt@block=1"))
    with pytest.raises(res.Preempted) as e:
        tr.train(6)
    res.clear_plan()
    assert e.value.epoch == 2 and str(e.value.snapshot).endswith("ckpt_2")
    back = MultiSeedTrainer(cfg, ds, SEEDS, device="cpu")
    back.restore_checkpoint()
    back.train(4)
    straight = MultiSeedTrainer(_cfg(), ds, SEEDS, device="cpu")
    straight.train(6)
    for k in straight.members:
        assert all(torch.equal(a, b) for a, b in zip(_gparams(straight.members[k].state),
                                                     _gparams(back.members[k].state)))
    monkeypatch.setenv(res.ENV_FAULTS, "totally@@broken")
    monkeypatch.setattr(res, "_env_consumed", False)     # install_plan consumed it
    with pytest.raises(res.FaultSpecError):
        MultiSeedTrainer(_cfg(), ds, SEEDS, device="cpu").train(2)


def test_seed_mesh_refusals():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="3 members not divisible by the 2-device"):
        MultiSeedTrainer(_cfg(), _ds(), (1, 2, 3), mesh=Mesh(("seed",), (2,), cpu))
    with pytest.raises(ValueError, match="'seed'"):
        MultiSeedTrainer(_cfg(), _ds(), SEEDS, mesh=Mesh(("dp",), (2,), cpu))
    assert MultiSeedTrainer(_cfg(), _ds(), SEEDS, mesh="auto", device="cpu").mesh is None


def test_seed_mesh_of_two_ranks_is_member_exact(tmp_path):
    cfg, ds = _cfg(checkpoint_dir=str(tmp_path / "ck")), _ds()
    spec = str(tmp_path / "job.pt")
    torch.save({"cfg": cfg, "ds": ds, "seeds": SEEDS}, spec)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict({k: v for k, v in os.environ.items() if not k.startswith("HFREP_")},
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), port, spec], cwd=ROOT,
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
    ranks = [torch.load(spec + f".rank{r}", weights_only=False) for r in (0, 1)]
    local = MultiSeedTrainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=None)), ds, SEEDS, device="cpu")
    local.train(5)
    for r, doc in enumerate(ranks):
        assert doc["mesh"] == {"seed": 2} and doc["held"] == [r]
        assert "3 members not divisible by the 2 ranks" in doc["refused"]
        want = local.members[r].state.generator.state_dict()
        assert all(torch.equal(doc["params"][r][k], v) for k, v in want.items())
        assert torch.equal(doc["samples"], local.generate(
            3, generator=torch.Generator().manual_seed(1)))
    back = MultiSeedTrainer(cfg, ds, SEEDS, device="cpu")
    assert back.restore_checkpoint(ranks[0]["path"]) and back.epoch == 5
    for k in local.members:
        assert all(torch.equal(a, b) for a, b in zip(_gparams(local.members[k].state),
                                                     _gparams(back.members[k].state)))
