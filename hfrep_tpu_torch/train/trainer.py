"""Host-side training driver (``hfrep_tpu/train/trainer.py``).

Runs the schedule as blocks of ``steps_per_call`` epochs through
:func:`~hfrep_tpu_torch.train.steps.make_multi_step`, and the remainder
one epoch at a time on a cached
:func:`~hfrep_tpu_torch.train.steps.make_train_step`, so the epoch count
is exact.  Around the blocks: per-epoch history and metric logs, block
timing, periodic full-state checkpoints with resume, and an optional
NaN guard.  The epochs launch the hand-written kernels through the same
wrappers as the steps do; nothing here falls back to another path.

Random draws come from the trainer's own ``torch.Generator`` on the
device (:func:`~hfrep_tpu_torch.train.steps.sample_draws`), whose state
is part of every checkpoint, so a resumed run continues bit for bit on
the same device.  ``draw_source`` replaces it: a callable from (block,
epoch in block) to :class:`~hfrep_tpu_torch.train.steps.Draws`, where
``block`` counts every block dispatched (a NaN-guard retry is a new
block), the seam through which a test feeds JAX's draws.

Seeds are derived with :func:`seed_mix`, a fixed 64-bit mix of integers:
the draw stream is seeded with ``seed_mix(seed, 1)``; a NaN-guard
rollback reseeds it with ``seed_mix(seed, epoch, 7919 + recoveries)``;
:meth:`GanTrainer.generate_block` draws its noise from a fresh generator
seeded with ``seed_mix(stream_seed, seq)``.

Preemption: :meth:`GanTrainer.train` runs under
:func:`~hfrep_tpu_torch.resilience.graceful_drain`; every block boundary
crosses ``resilience.tick("block")`` (where injected faults fire), and a
requested drain (SIGTERM) lands the staged checkpoint, writes a final
one when a checkpoint dir is configured, and raises
:class:`~hfrep_tpu_torch.resilience.Preempted` — the CLI's exit 75,
resumed bit for bit by ``--resume``.  With telemetry on, the run is a
``train`` span with ``train_start``/``train_end`` events, memory
snapshots and the ``steps_per_sec`` gauge, each checkpoint a
``checkpoint`` span, each sample a ``generate`` span, and every block a
wall-clock ledger window (:class:`~hfrep_tpu_torch.obs.timeline.BlockTimer`);
the flagship family also sets the ``mfu`` gauge
(:func:`hfrep_tpu_torch.obs.flops.mfu`).

Health (:mod:`hfrep_tpu_torch.obs.health`, on when the trainer is built):
each block's ``health_*`` metrics ride the metrics fetch the trainer
already makes and surface as ``health/*`` gauges; a nonfinite count
emits ``numeric_fault``, and under ``HFREP_HEALTH=abort`` writes a
forensic dump of the whole checkpoint tree and raises
:class:`~hfrep_tpu_torch.obs.health.NumericFault`.

Mesh (``mesh=``, a :class:`~hfrep_tpu_torch.parallel.rules.Mesh` over
the axis names JAX's trainer accepts): the blocks and the remainder
launch through the mesh's builders (:func:`_mesh_builders`:
:mod:`~hfrep_tpu_torch.parallel.dp_sp_tp`'s on sp and tp axes both
longer than 1, :mod:`~hfrep_tpu_torch.parallel.tensor`'s on a tp axis,
:mod:`~hfrep_tpu_torch.parallel.sequence`'s on an sp axis, else
:func:`~hfrep_tpu_torch.parallel.rules.make_gan_multi_step` /
``make_gan_train_step``; ``dp_multi_step``, ``sp_train_step``,
``dp_tp_multi_step``, ...): every rank draws the global batch from the
same stream and steps on its block of it (its rows over dp, its window
chunk over sp, its gate columns over tp), the gradients reduced over
the mesh.  On a mesh that spans
processes the state and the draw stream are broadcast from rank 0 at
construction, ``generate``'s noise too; rank 0 alone writes a
checkpoint, synchronously, then every rank meets it at a barrier (every
rank restores); a drain seen by any rank drains every rank at the same
block boundary, and the NaN guard's verdict is reduced across ranks, so
no rank is left waiting in a collective.  Health on such a mesh: every
rank's ``health_*`` values are the same (they read the reduced gradients
and the replicated state), so every rank trips the nonfinite tripwire at
the same block boundary; rank 0 alone sets the gauges and writes the
forensic dump.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.config import ExperimentConfig
from hfrep_tpu_torch.core import scaler as mm
from hfrep_tpu_torch.core.data import GanDataset
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.obs import get_obs, instrument_step
from hfrep_tpu_torch.obs.metriclog import MetricLogger
from hfrep_tpu_torch.obs.timeline import BlockTimer
from hfrep_tpu_torch.train.states import GanState, init_gan_state
from hfrep_tpu_torch.train.steps import (Draws, make_multi_step, make_train_step,
                                         sample_draws)
from hfrep_tpu_torch.utils import checkpoint as ckpt

DrawSource = Callable[[int, int], Draws]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def seed_mix(*words: int) -> int:
    """A fixed 64-bit mix of ``words``: ``h = 0``, then for each word
    ``h = splitmix64(h ^ (word mod 2**64))``.  Pure, so the same words
    give the same seed in every process and on every device."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def state_tree(state: GanState) -> dict:
    """A state's checkpoint tree, referencing the live tensors: both
    networks' ``state_dict``, the optimizer slots, ``step``."""
    return {"generator": state.generator.state_dict(),
            "discriminator": state.discriminator.state_dict(),
            "g_opt": state.g_opt, "d_opt": state.d_opt, "step": state.step}


@torch.no_grad()
def load_state_tree(state: GanState, saved: dict) -> None:
    """Copy a :func:`state_tree` into the live networks and slots, in
    place; a tree of other tensors is refused as corrupt."""
    for name, module in (("generator", state.generator),
                         ("discriminator", state.discriminator)):
        own, theirs = module.state_dict(), saved[name]
        if set(own) != set(theirs):
            raise ckpt.CheckpointCorrupt(
                f"the checkpoint's {name} has tensors {sorted(theirs)}, "
                f"the model {sorted(own)}")
        for k, t in own.items():
            t.copy_(theirs[k])
    for slots, theirs in ((state.g_opt, saved["g_opt"]), (state.d_opt, saved["d_opt"])):
        for k, v in theirs.items():
            if isinstance(v, dict):
                for n, t in v.items():
                    slots[k][n].copy_(t)
            else:
                slots[k] = v
    state.step = int(saved["step"])


def restore_walk(path: Optional[str], ckpt_dir: Optional[str]):
    """``(tree, path restored)``: ``path``, falling back to the newest
    good checkpoint in ``ckpt_dir`` when it is corrupt; with no path, the
    newest good one there, ``(None, ...)`` when every candidate is
    corrupt."""
    if path is not None:
        try:
            return ckpt.restore(path), path
        except ckpt.CheckpointCorrupt:
            if not ckpt_dir:
                raise
            return ckpt.restore_latest_good(ckpt_dir)
    if not ckpt_dir:
        raise FileNotFoundError("no checkpoint found")
    return ckpt.restore_latest_good(ckpt_dir, on_exhausted="fresh")


def _mesh_builders(mesh) -> tuple:
    """``(train_step, multi_step)`` builders of a mesh launch: the 3-D
    launch where the mesh shards the window and the hidden units, the
    hidden-unit launch where it shards those, the window launch where it
    shards the window, else the data-parallel one (each refuses the axes
    it does not shard)."""
    sp, tp = (int(mesh.shape.get(a, 1)) for a in ("sp", "tp"))
    if sp > 1 and tp > 1:
        from hfrep_tpu_torch.parallel import dp_sp_tp
        return dp_sp_tp.make_dp_sp_tp_train_step, dp_sp_tp.make_dp_sp_tp_multi_step
    if tp > 1:
        from hfrep_tpu_torch.parallel import tensor
        return tensor.make_tp_train_step, tensor.make_tp_multi_step
    if sp > 1:
        from hfrep_tpu_torch.parallel import sequence
        return sequence.make_sp_train_step, sequence.make_sp_multi_step
    from hfrep_tpu_torch.parallel import rules
    return rules.make_gan_train_step, rules.make_gan_multi_step


class GanTrainer:
    def __init__(self, cfg: ExperimentConfig, dataset: Union[GanDataset, torch.Tensor],
                 logger: Optional[MetricLogger] = None, nan_guard: bool = False,
                 max_recoveries: int = 3, device: DeviceLike = None,
                 draw_source: Optional[DrawSource] = None, mesh=None):
        if mesh is not None:
            # the axis names declare the partitioning; checked before any
            # parallel import, so the refusal never depends on import order
            names = tuple(mesh.axis_names)
            if names not in (("dp",), ("sp",), ("tp",), ("dp", "sp"), ("dp", "tp"),
                             ("dp", "sp", "tp")):
                raise ValueError(
                    f"mesh axis names {names} not recognized; use ('dp',), ('sp',), "
                    "('tp',), ('dp', 'sp'), ('dp', 'tp'), or ('dp', 'sp', 'tp')")
            if device is not None and resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} is not the mesh's {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.cfg = cfg
        if isinstance(dataset, GanDataset):
            windows, self.scaler = dataset.windows, mm.ScalerParams(
                *(t.to(self.device) for t in dataset.scaler))
        else:
            windows, self.scaler = torch.as_tensor(dataset), None
        self.windows = windows.to(self.device, torch.float32)
        self.pair = build_gan(cfg.model, device=self.device)
        self.state = init_gan_state(cfg.train.seed, cfg.model, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed_mix(cfg.train.seed, 1))
        self.draw_source = draw_source
        # the build-time telemetry hook: with obs on, a compile:multi_step
        # span for the first block and a dispatch counter after it
        if mesh is not None:
            self._multi = _mesh_builders(mesh)[1](
                self.pair, cfg.train, self.windows, mesh, flops=self._block_flops(),
                steps_per_call=cfg.train.steps_per_call)
            if self._multiprocess():
                # ranks built the same state from the same seed; rank 0's
                # bytes make that a fact, the draw stream's state included
                from hfrep_tpu_torch.parallel.mesh import replicate_to_global
                replicate_to_global(self.state, mesh)
                draws_state = self.gen.get_state()
                mesh.broadcast_(draws_state)
                self.gen.set_state(draws_state)
        else:
            self._multi = instrument_step(
                make_multi_step(self.pair, cfg.train, self.windows), "multi_step",
                flops=self._block_flops(), batch=cfg.train.batch_size,
                steps_per_call=cfg.train.steps_per_call)
        self._single_step = None
        style = {"bce": "gan", "wgan_clip": "wgan", "wgan_gp": "wgan_gp"}[self.pair.loss]
        self.logger = logger or MetricLogger(echo=False, echo_style=style)
        self.timer = BlockTimer(self.device)
        self.epoch = 0
        self.block = 0                  # blocks dispatched, retries included
        #: per-epoch metric history (host floats), kept even with a null logger
        self.history: list[dict] = []
        self._multi_warm = False        # a program's first block builds its kernels
        self._one_warm = False
        # NaN guard: a block with non-finite metrics is rolled back to a
        # copy of the state taken before it and retried on a reseeded
        # stream; after max_recoveries failures in a row it raises.
        self.nan_guard = nan_guard
        self.max_recoveries = max_recoveries
        self.recoveries = 0
        # one-slot staged checkpoint: (host tree, path, epoch), copied to
        # the host at the boundary and written after the next block is
        # enqueued, so the write overlaps device work
        self._pending_ckpt = None

    # ------------------------------------------------------------ training
    def train(self, epochs: Optional[int] = None) -> GanState:
        """Run the schedule under the drain handler; with telemetry on,
        the run is a ``train`` span with the config merged into
        ``run.json``."""
        obs = get_obs()
        with resilience.graceful_drain():
            if not obs.enabled:
                return self._train_loop(epochs)
            from hfrep_tpu_torch.obs import manifest, mesh_attrs
            obs.annotate(config=manifest.config_dict(self.cfg), mesh=mesh_attrs(self.mesh))
            n = epochs if epochs is not None else self.cfg.train.epochs
            obs.event("train_start", family=self.cfg.model.family, epochs=n,
                      start_epoch=self.epoch, mesh=mesh_attrs(self.mesh),
                      steps_per_call=self.cfg.train.steps_per_call, device=str(self.device))
            obs.memory_snapshot(phase="train_start")
            with obs.span("train", epochs=n):
                state = self._train_loop(epochs)
            obs.memory_snapshot(phase="train_end")
            sps = self.timer.steps_per_sec
            obs.gauge("steps_per_sec").set(sps)
            if self.cfg.model.family == "mtss_wgan_gp":
                # the analytic FLOPs model is the flagship's (obs/flops.py)
                from hfrep_tpu_torch.obs import flops
                m = self.cfg.model
                obs.gauge("mfu").set(flops.mfu(sps, m.window, m.features, m.hidden,
                                               self.cfg.train.batch_size))
            obs.event("train_end", epoch=self.epoch, recoveries=self.recoveries)
            obs.flush()
            return state

    def _block_flops(self) -> Optional[float]:
        """One multi-step call's logical FLOPs where the analytic model
        covers the family (the flagship's, ``obs/flops.py``), else None."""
        if self.cfg.model.family != "mtss_wgan_gp":
            return None
        from hfrep_tpu_torch.obs import flops
        m = self.cfg.model
        return float(flops.epoch_flops(m.window, m.features, m.hidden, self.cfg.train.batch_size)
                     * self.cfg.train.steps_per_call)

    def _train_loop(self, epochs: Optional[int] = None) -> GanState:
        tcfg = self.cfg.train
        spc = tcfg.steps_per_call
        epochs = epochs if epochs is not None else tcfg.epochs
        n_full, remainder = divmod(epochs, spc)
        done = 0
        # Steady blocks are pipelined: block i's metrics are fetched (a
        # sync) only after block i+1 is enqueued, so the card does not
        # wait on the logger.  The NaN guard inspects metrics at once,
        # so it keeps one block at a time.  The open steady window spans
        # whole pipelined stretches and is closed (synced) before
        # anything that is not training, checkpoints in particular.
        pending = None                      # (metrics, base_epoch)
        steady_steps = 0                    # steps in the open window; 0 = closed

        def flush_pending():
            nonlocal pending
            if pending is not None:
                self._log_block(pending[0], spc, pending[1])
                pending = None

        def close_steady():
            nonlocal steady_steps
            if steady_steps:
                self.timer.stop(steady_steps)
                steady_steps = 0

        pipeline_ok = False
        try:
            while done < n_full:
                warm_block = not self._multi_warm
                if warm_block or self.nan_guard:
                    close_steady()
                    self.timer.start()
                    metrics = self._guarded(self._run_multi)
                    if metrics is None:
                        continue                # guard tripped: block retried
                    self.timer.stop(spc, warmup=warm_block)
                    self._multi_warm = True
                    flush_pending()
                    self._log_block(metrics, spc, self.epoch)
                else:
                    if steady_steps == 0:
                        self.timer.start()
                    metrics = self._guarded(self._run_multi)   # enqueued
                    self._commit_pending_ckpt()  # the staged write overlaps it
                    flush_pending()
                    pending = (metrics, self.epoch)
                    steady_steps += spc
                self.epoch += spc
                done += 1
                if (tcfg.checkpoint_dir and tcfg.checkpoint_every > 0
                        and self.epoch % tcfg.checkpoint_every < spc):
                    close_steady()
                    flush_pending()
                    if self.nan_guard or self._multiprocess():
                        # the guard wants the last written checkpoint to
                        # be the last verified block, not a staged one; a
                        # multi-process write is rank 0's, then a barrier
                        self.save_checkpoint()
                    else:
                        self._commit_pending_ckpt()   # one slot: land the prior
                        self._stage_checkpoint()
                resilience.tick("block")        # injected faults fire here
                if self._drain_seen():
                    close_steady()
                    flush_pending()
                    self._drain_now()
            close_steady()
            flush_pending()
            self._commit_pending_ckpt()
            pipeline_ok = True
        finally:
            if not pipeline_ok:
                # an exception escaped the pipelined loop: drain the
                # pending block's metrics, the open window and the staged
                # (host-side) checkpoint best-effort, without masking it
                for cleanup in (close_steady, flush_pending,
                                self._commit_pending_ckpt, self.logger.flush):
                    try:
                        cleanup()
                    except Exception:
                        pass
        done = 0
        while done < remainder:
            # exact epoch counts: leftover epochs run on a cached 1-epoch step
            self.timer.start()
            metrics = self._guarded(self._run_one)
            if metrics is None:
                continue
            self.timer.stop(1, warmup=not self._one_warm)
            self._one_warm = True
            self._log_block({k: v[None] for k, v in metrics.items()}, 1, self.epoch)
            self.epoch += 1
            done += 1
            if (tcfg.checkpoint_dir and tcfg.checkpoint_every > 0
                    and self.epoch % tcfg.checkpoint_every == 0):
                self.save_checkpoint()
            resilience.tick("block")
            if self._drain_seen():
                self._drain_now()
        self.logger.flush()
        return self.state

    def _drain_now(self) -> None:
        """Graceful preemption at a block boundary: land the staged
        checkpoint, write a final one (when a checkpoint dir is
        configured), flush the metric log, announce the drain, and raise
        :class:`~hfrep_tpu_torch.resilience.Preempted` — the CLI's
        resumable exit instead of a death mid-write."""
        self._commit_pending_ckpt()
        path = self.save_checkpoint() if self.cfg.train.checkpoint_dir else None
        try:
            self.logger.flush()
        except Exception:
            pass
        get_obs().event("preempt_drain", epoch=self.epoch, checkpoint=path)
        raise resilience.Preempted(site="block", epoch=self.epoch, snapshot=path)

    def _multiprocess(self) -> bool:
        return self.mesh is not None and self.mesh.spans_processes

    def _drain_seen(self) -> bool:
        """A drain requested on any rank drains every rank at this
        boundary (one flag reduction a block on a multi-process mesh)."""
        if not self._multiprocess():
            return resilience.drain_requested()
        return self.mesh.any(resilience.drain_requested())[0]

    def _next_block(self) -> int:
        block, self.block = self.block, self.block + 1
        return block

    def _run_multi(self, state: GanState):
        block = self._next_block()
        if self.draw_source is None:
            return self._multi(state, generator=self.gen)
        n = self.cfg.train.steps_per_call
        return self._multi(state, draws=[self.draw_source(block, i) for i in range(n)])

    def _run_one(self, state: GanState):
        block = self._next_block()
        if self._single_step is None:
            # instrumented like the multi-step, so the remainder's first
            # build and its dispatches land in the same ledger and window;
            # a mesh's remainder runs through the same mesh
            if self.mesh is not None:
                self._single_step = _mesh_builders(self.mesh)[0](
                    self.pair, self.cfg.train, self.windows, self.mesh)
            else:
                self._single_step = instrument_step(
                    make_train_step(self.pair, self.cfg.train, self.windows), "single_step",
                    batch=self.cfg.train.batch_size)
        draws = (sample_draws(self.gen, self.pair, self.cfg.train, self.windows)
                 if self.draw_source is None else self.draw_source(block, 0))
        return self._single_step(state, draws)

    def _guarded(self, fn) -> Optional[Dict[str, torch.Tensor]]:
        """Run one block; under the NaN guard, roll back and reseed on
        non-finite metrics.

        Returns the metrics, or None when the guard rolled the block back
        (the caller retries).  Raises ``FloatingPointError`` after
        ``max_recoveries`` failures in a row.  The steps update the
        networks in place, so the rollback target is a copy taken before
        the block."""
        prev_state = self.state.to(self.device) if self.nan_guard else None
        state, metrics = fn(self.state)
        if self.nan_guard:
            host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
            bad = not all(np.isfinite(v).all() for v in host.values())
            if self._multiprocess():
                bad = self.mesh.any(bad)[0]     # no rank rolls back alone
            if bad:
                self.recoveries += 1
                if self.recoveries > self.max_recoveries:
                    raise FloatingPointError(
                        f"training diverged {self.recoveries} times in a row "
                        f"(epoch {self.epoch}); last metrics: "
                        f"{ {k: np.asarray(v).reshape(-1)[-1] for k, v in host.items()} }")
                self.logger.log(self.epoch, {"recovery": self.recoveries})
                self.state = prev_state
                self.gen.manual_seed(seed_mix(self.cfg.train.seed, self.epoch,
                                              7919 + self.recoveries))
                return None
            self.recoveries = 0
        self.state = state
        return metrics

    def _log_block(self, metrics: dict, n: int, base_epoch: int) -> None:
        host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        for i in range(n):
            e = base_epoch + i
            rec = {k: v[i] for k, v in host.items()}
            self.history.append({"epoch": e, **{k: float(v) for k, v in rec.items()}})
            if e % self.cfg.train.log_every == 0:
                self.logger.log(e, rec)
        if "health_nonfinite" in host:
            self._health_boundary(host, n, base_epoch)

    def _health_boundary(self, host: dict, n: int, base_epoch: int) -> None:
        """A block's health values (already on the host: they rode the
        metrics fetch) as ``health/*`` gauges, and the nonfinite
        tripwire with a forensic dump of the live checkpoint tree (on a
        multi-process mesh rank 0's gauges and dump, every rank's raise)."""
        from hfrep_tpu_torch.obs import health as health_mod
        if float(np.nansum(host["health_nonfinite"])) > 0:
            self.logger.flush()         # the log up to the fault, before a raise
        health_mod.gan_boundary(host, base_epoch + n - 1, "block", self._ckpt_tree(),
                                fallback=self.cfg.train.checkpoint_dir,
                                leader=not self._multiprocess() or self.mesh.rank == 0)

    @property
    def steps_per_sec(self) -> float:
        return self.timer.steps_per_sec

    # ---------------------------------------------------------- checkpoint
    def _ckpt_tree(self) -> dict:
        """Everything a resume needs, referencing the live tensors:
        params, optimizer slots (Adam's ``count`` too), ``step``, the
        draw stream's state, the block and epoch counts, the scaler."""
        tree = {"state": state_tree(self.state), "draws": self.gen.get_state(),
                "block": self.block, "epoch": self.epoch}
        if self.scaler is not None:
            tree["scaler"] = {"data_min": self.scaler.data_min,
                              "data_max": self.scaler.data_max}
        return tree

    def _meta(self, epoch: int) -> dict:
        return {"family": self.cfg.model.family, "epoch": epoch}

    def _stage_checkpoint(self) -> str:
        """Copy the checkpoint tree to the host without writing it.

        The steps update the parameters in place, so the tree must be a
        copy taken now (a synchronous device-to-host copy), not a
        reference the next block would overwrite.  The staged tree is
        what :meth:`save_checkpoint` would have written."""
        path = f"{self.cfg.train.checkpoint_dir}/ckpt_{self.epoch}"
        self._pending_ckpt = (ckpt.to_host(self._ckpt_tree()), path, self.epoch)
        return path

    def _commit_pending_ckpt(self) -> None:
        """Atomically publish the staged checkpoint, if any: after the
        next block is enqueued, at every loop exit."""
        if self._pending_ckpt is None:
            return
        tree, path, epoch = self._pending_ckpt
        self._pending_ckpt = None
        obs = get_obs()
        with obs.span("checkpoint", epoch=epoch, path=str(path)):
            ckpt.save(path, tree, metadata=self._meta(epoch),
                      keep=self.cfg.train.checkpoint_keep)
        obs.counter("checkpoints").inc()

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write the checkpoint; on a multi-process mesh the state is
        replicated, so rank 0 writes it and every rank then meets at a
        barrier (no rank reads a checkpoint still being written)."""
        path = path or f"{self.cfg.train.checkpoint_dir}/ckpt_{self.epoch}"
        if not self._multiprocess() or self.mesh.rank == 0:
            obs = get_obs()
            with obs.span("checkpoint", epoch=self.epoch, path=str(path)):
                ckpt.save(path, self._ckpt_tree(), metadata=self._meta(self.epoch),
                          keep=self.cfg.train.checkpoint_keep)
            obs.counter("checkpoints").inc()
        if self._multiprocess():
            self.mesh.barrier()
        return path

    def restore_checkpoint(self, path: Optional[str] = None) -> str:
        """Restore ``path``, or the newest checkpoint in the configured
        directory that verifies (``checkpoint.restore_latest_good``: a
        torn one falls back to the previous good one).  Returns the path
        actually restored.  With ``path=None``, when every candidate is
        corrupt this returns ``""`` and leaves the fresh state as it is;
        a named checkpoint that cannot be recovered raises.

        The values are copied into the live networks and slots, and the
        draw stream's state is restored, so a resumed run continues bit
        for bit on the same device."""
        restored, path = restore_walk(path, self.cfg.train.checkpoint_dir)
        if restored is None:
            return ""
        self._load_tree(restored)
        return str(path)

    def _load_tree(self, tree: dict) -> None:
        load_state_tree(self.state, tree["state"])
        self.gen.set_state(tree["draws"])
        self.block = int(tree["block"])
        self.epoch = int(tree["epoch"])

    # ------------------------------------------------------------ sampling
    @torch.no_grad()
    def generate(self, n_samples: int, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 unscale: bool = True) -> torch.Tensor:
        """Sample (n, W, F) windows from the trained generator on standard
        normal noise drawn on the device from ``generator`` (the notebook's
        ``generator.predict(normal(0,1,(10,168,36)))``,
        ``autoencoder_v4.ipynb`` cell 43), inverse-scaled by default.
        ``noise`` (n, W, F) replaces the draw."""
        w, f = self.windows.shape[1], self.windows.shape[2]
        if noise is None:
            noise = torch.randn((n_samples, w, f), generator=generator, device=self.device)
        else:
            noise = torch.as_tensor(noise).to(self.device, torch.float32)
        if self._multiprocess():
            self.mesh.broadcast_(noise)     # every rank samples rank 0's noise
        obs = get_obs()
        # with telemetry on the span synchronises: it times the samples'
        # device work, not their launches
        with obs.span("generate", sync_on=noise if obs.enabled else None,
                      n_samples=int(noise.shape[0])):
            out = self.state.generator(noise)
        if unscale and self.scaler is not None:
            out = mm.inverse_transform(self.scaler, out)
        return out

    def generate_block(self, seq: int, n_samples: int, stream_seed: int = 0,
                       unscale: bool = True) -> torch.Tensor:
        """The ``seq``-th sample block of a deterministic stream: pure in
        (``stream_seed``, ``seq``), so a restarted producer regenerates
        exactly the block it would have delivered.  The noise comes from
        a fresh device generator seeded with ``seed_mix(stream_seed, seq)``."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed_mix(stream_seed, seq))
        return self.generate(n_samples, generator=g, unscale=unscale)
