"""K independent GAN members of one configuration, each seeded on its own
(``hfrep_tpu/train/multi_seed.py``).

JAX packs the members into one program with ``vmap`` over the train
step.  The port's hand kernels take one weight set a launch and have no
vmap rule, so here the members run one after another on the device, each
through the very step :class:`~hfrep_tpu_torch.train.trainer.GanTrainer`
runs; on a ``('seed',)`` mesh (one process a rank) each rank holds and
trains K/n of them, with no collective in training.  Member k follows the
trainer's stream discipline with ``train.seed = seeds[k]`` (init from the
seed, the draw stream seeded ``seed_mix(seed, 1)``, a block's epochs then
the remainder's), so it equals ``GanTrainer`` of that seed bit for bit:
the port's form of JAX's member-exactness.  ``draw_sources`` replaces
each member's draw stream (the trainer's ``draw_source`` seam, one a
member), the seam through which a test feeds JAX's members' draws.

Preemption as in the trainer: periodic checkpoints of every member and
its draw stream (``train.checkpoint_dir`` / ``checkpoint_every`` /
``checkpoint_keep``), checksum-verified restore with fallback to the
previous good checkpoint and refusal of another seed list, and a drain at
a block boundary (final checkpoint, then
:class:`~hfrep_tpu_torch.resilience.Preempted`).  On a seed mesh that
spans processes the members are gathered for a checkpoint (each owner
broadcasts its own) and rank 0 writes it, then a barrier; a drain seen by
any rank drains every rank at the same boundary.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.config import ExperimentConfig
from hfrep_tpu_torch.core import scaler as mm
from hfrep_tpu_torch.core.data import GanDataset
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.train.states import GanState, init_gan_state
from hfrep_tpu_torch.train.steps import Draws, make_multi_step, make_train_step, sample_draws
from hfrep_tpu_torch.train.trainer import (load_state_tree, restore_walk, seed_mix,
                                           state_tree)
from hfrep_tpu_torch.utils import checkpoint as ckpt

DrawSource = Callable[[int, int], Draws]


class Member:
    """One member's live training state: its networks and slots, its draw
    stream, and the blocks it has dispatched (the ``draw_source`` key)."""

    def __init__(self, seed: int, mcfg, device: torch.device,
                 draw_source: Optional[DrawSource] = None):
        self.seed = int(seed)
        self.state = init_gan_state(self.seed, mcfg, device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed_mix(self.seed, 1))
        self.draw_source = draw_source
        self.block = 0

    def next_block(self) -> int:
        block, self.block = self.block, self.block + 1
        return block

    def tree(self) -> dict:
        return {"state": state_tree(self.state), "draws": self.gen.get_state(),
                "block": self.block}

    def load(self, tree: dict) -> None:
        load_state_tree(self.state, tree["state"])
        self.gen.set_state(tree["draws"])
        self.block = int(tree["block"])


def init_multi_seed_states(seeds: Sequence[int], mcfg, device: DeviceLike = None
                           ) -> List[GanState]:
    """One state a member; member k equals ``init_gan_state(seeds[k])``."""
    dev = resolve_device(device)
    return [init_gan_state(int(s), mcfg, dev) for s in seeds]


def make_multi_seed_step(pair, tcfg, dataset: torch.Tensor):
    """``fn(members) -> [metrics]``: one ``steps_per_call``-epoch block for
    every :class:`Member` in turn, each on its own draws (its stream, or
    its ``draw_source``) from the shared, read-only dataset."""
    multi = make_multi_step(pair, tcfg, dataset)
    n = tcfg.steps_per_call

    def fn(members: Sequence[Member]) -> list:
        out = []
        for m in members:
            block = m.next_block()
            if m.draw_source is None:
                m.state, metrics = multi(m.state, generator=m.gen)
            else:
                m.state, metrics = multi(m.state, draws=[m.draw_source(block, i)
                                                         for i in range(n)])
            out.append(metrics)
        return out

    return fn


def _one_epoch(pair, tcfg, dataset: torch.Tensor):
    """The remainder's one-epoch step over members, as the trainer's."""
    step = make_train_step(pair, tcfg, dataset)

    def fn(members: Sequence[Member]) -> list:
        out = []
        for m in members:
            block = m.next_block()
            draws = (sample_draws(m.gen, pair, tcfg, dataset) if m.draw_source is None
                     else m.draw_source(block, 0))
            m.state, metrics = step(m.state, draws)
            out.append(metrics)
        return out

    return fn


def _check_seed_mesh(mesh) -> None:
    if tuple(mesh.axis_names) != ("seed",):
        raise ValueError(f"a multi-seed mesh has one axis, 'seed'; got "
                         f"{tuple(mesh.axis_names)}")


def seed_mesh(n_members: int, device: DeviceLike = None):
    """The ``"auto"`` mesh: a ``('seed',)`` mesh over the process group
    when it has more than one rank, else ``None`` (the members in turn on
    this device).  A group whose size does not divide ``n_members`` is
    refused: every rank would otherwise run every member and write the
    same checkpoints."""
    from hfrep_tpu_torch.parallel.mesh import world_size
    from hfrep_tpu_torch.parallel.rules import make_named_mesh

    n = world_size()
    if n == 1:
        return None
    if n_members % n:
        raise ValueError(f"{n_members} members not divisible by the {n} ranks of the "
                         "process group (a seed mesh spans every rank)")
    return make_named_mesh(("seed",), (n,), device)


class MultiSeedTrainer:
    """K member-exact :class:`~hfrep_tpu_torch.train.trainer.GanTrainer`
    runs (module docstring).

    ``mesh``: ``None`` (the members in turn on ``device``), a ``('seed',)``
    :class:`~hfrep_tpu_torch.parallel.rules.Mesh` (K/n members a rank), or
    ``"auto"`` (:func:`seed_mesh`)."""

    def __init__(self, cfg: ExperimentConfig, dataset: Union[GanDataset, torch.Tensor],
                 seeds: Sequence[int], mesh=None, device: DeviceLike = None,
                 draw_sources: Optional[Sequence[DrawSource]] = None):
        self.cfg = cfg
        self.seeds = tuple(int(s) for s in seeds)
        k = len(self.seeds)
        if mesh == "auto":
            mesh = seed_mesh(k, device)
        if mesh is not None:
            _check_seed_mesh(mesh)
            if k % mesh.size:
                raise ValueError(f"{k} members not divisible by the {mesh.size}-device "
                                 "seed mesh")
            device = mesh.device
        if draw_sources is not None and len(draw_sources) != k:
            raise ValueError(f"{k} members but {len(draw_sources)} draw sources")
        self.mesh = mesh
        self.device = resolve_device(device)
        if isinstance(dataset, GanDataset):
            windows, self.scaler = dataset.windows, mm.ScalerParams(
                *(t.to(self.device) for t in dataset.scaler))
        else:
            windows, self.scaler = torch.as_tensor(dataset), None
        self.windows = windows.to(self.device, torch.float32)
        self.pair = build_gan(cfg.model, device=self.device)
        per = k // (mesh.size if mesh is not None else 1)
        first = (mesh.rank if mesh is not None else 0) * per
        #: the members this process holds, by member index
        self.members: Dict[int, Member] = {
            i: Member(self.seeds[i], cfg.model, self.device,
                      draw_sources[i] if draw_sources is not None else None)
            for i in range(first, first + per)}
        # the member axis is purely spatial: each rank holds only its own
        # members, so a seed mesh's step is the plain one, no collective
        self._multi = make_multi_seed_step(self.pair, cfg.train, self.windows)
        self._one = None
        self.epoch = 0

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    def _multiprocess(self) -> bool:
        return self.mesh is not None and self.mesh.spans_processes

    def _drain_seen(self) -> bool:
        if not self._multiprocess():
            return resilience.drain_requested()
        return self.mesh.any(resilience.drain_requested())[0]

    def train(self, epochs: Optional[int] = None) -> Dict[int, GanState]:
        """Run the schedule; returns this process's members' states by
        member index."""
        from hfrep_tpu_torch.obs import get_obs, mesh_attrs

        obs = get_obs()
        tcfg = self.cfg.train
        spc = tcfg.steps_per_call
        epochs = epochs if epochs is not None else tcfg.epochs
        n_full, remainder = divmod(epochs, spc)
        members = [self.members[i] for i in sorted(self.members)]
        if obs.enabled:
            obs.event("multi_seed_train_start", members=self.n_seeds, epochs=epochs,
                      mesh=mesh_attrs(self.mesh),
                      mode="seed_sharded" if self.mesh is not None else "in_turn",
                      precision=self.pair.policy.describe())
        blocks = obs.counter("multi_seed_blocks")

        def boundary(block_epochs: int) -> None:
            if (tcfg.checkpoint_dir and tcfg.checkpoint_every > 0
                    and self.epoch % tcfg.checkpoint_every < block_epochs):
                self.save_checkpoint()
            resilience.tick("block")            # injected faults fire here
            if self._drain_seen():
                path = self.save_checkpoint() if tcfg.checkpoint_dir else None
                obs.event("preempt_drain", epoch=self.epoch, checkpoint=path)
                raise resilience.Preempted(site="block", epoch=self.epoch, snapshot=path)

        with resilience.graceful_drain(), \
                obs.span("multi_seed_train", members=self.n_seeds, epochs=epochs):
            for _ in range(n_full):
                self._multi(members)
                self.epoch += spc
                blocks.inc(member_epochs=self.n_seeds * spc)
                boundary(spc)
            if remainder:
                if self._one is None:
                    self._one = _one_epoch(self.pair, tcfg, self.windows)
                for _ in range(remainder):
                    self._one(members)
                    self.epoch += 1
                    boundary(1)
            if obs.enabled and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # the span times the work
        if obs.enabled:
            obs.memory_snapshot(phase="multi_seed_train_end")
        return {i: m.state for i, m in self.members.items()}

    # ---------------------------------------------------------- checkpoint
    def _owner(self, i: int) -> int:
        return i // (self.n_seeds // self.mesh.size)

    def _all_trees(self) -> Dict[int, dict]:
        """Every member's checkpoint tree; on a seed mesh that spans
        processes each owner broadcasts its members' (host copies)."""
        if not self._multiprocess():
            return {i: m.tree() for i, m in self.members.items()}
        from hfrep_tpu_torch.parallel.rules import _rebuild, named_leaves

        template = next(iter(self.members.values())).tree()
        out = {}
        for i in range(self.n_seeds):
            mine = i in self.members
            leaves = []
            for _, leaf in named_leaves(self.members[i].tree() if mine else template):
                if isinstance(leaf, torch.Tensor):
                    t = leaf.detach().clone()
                    leaves.append(self.mesh.broadcast_(t, src=self._owner(i)))
                else:
                    t = torch.tensor(int(leaf), dtype=torch.int64)
                    leaves.append(int(self.mesh.broadcast_(t, src=self._owner(i))))
            out[i] = _rebuild(template, leaves)
        return out

    def _ckpt_tree(self) -> dict:
        return {"members": {str(i): t for i, t in self._all_trees().items()},
                "seeds": torch.tensor(self.seeds, dtype=torch.int64), "epoch": self.epoch}

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Atomic checkpoint of every member, its draw stream and the
        epoch; on a multi-process seed mesh rank 0 writes, then a
        barrier."""
        from hfrep_tpu_torch.obs import get_obs

        path = path or f"{self.cfg.train.checkpoint_dir}/ckpt_{self.epoch}"
        tree = self._ckpt_tree()
        if not self._multiprocess() or self.mesh.rank == 0:
            obs = get_obs()
            with obs.span("checkpoint", epoch=self.epoch, path=str(path)):
                ckpt.save(path, tree, metadata={"family": self.cfg.model.family,
                                                "epoch": self.epoch,
                                                "members": self.n_seeds,
                                                "seeds": list(self.seeds)},
                          keep=self.cfg.train.checkpoint_keep)
            obs.counter("checkpoints").inc()
        if self._multiprocess():
            self.mesh.barrier()
        return path

    def restore_checkpoint(self, path: Optional[str] = None) -> str:
        """Restore ``path`` or the newest good checkpoint in the
        configured directory (``""`` when every candidate is corrupt: the
        members keep their fresh state); a checkpoint of other seeds is
        refused (the member axis would mean something else).  Every rank
        reads it and loads the members it holds."""
        restored, path = restore_walk(path, self.cfg.train.checkpoint_dir)
        if restored is None:
            return ""
        saved = tuple(int(s) for s in np.asarray(restored["seeds"]).reshape(-1))
        if saved != self.seeds:
            raise ValueError(f"checkpoint {path} holds seeds {saved}, trainer was built "
                             f"with {self.seeds}")
        for i, m in self.members.items():
            m.load(restored["members"][str(i)])
        self.epoch = int(restored["epoch"])
        return str(path)

    # ------------------------------------------------------------ sampling
    @torch.no_grad()
    def generate(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None, unscale: bool = True) -> torch.Tensor:
        """(K, n, W, F) samples: every member on the same noise (drawn from
        ``generator`` on the device, or ``noise``; on a multi-process mesh
        rank 0's), so members compare pointwise; gathered on every rank."""
        w, f = self.windows.shape[1], self.windows.shape[2]
        if noise is None:
            noise = torch.randn((n_samples, w, f), generator=generator, device=self.device)
        else:
            noise = torch.as_tensor(noise).to(self.device, torch.float32)
        if self._multiprocess():
            self.mesh.broadcast_(noise)
        out = torch.stack([self.members[i].state.generator(noise)
                           for i in sorted(self.members)])
        if self._multiprocess():
            out = self.mesh.all_gather_cat(out, 0)
        if unscale and self.scaler is not None:
            out = mm.inverse_transform(self.scaler, out)
        return out
