"""Autoencoder replication engine: training, evaluation, strategy build
(``hfrep_tpu/replication/engine.py``).

The reference (``Autoencoder_encapsulate.py:38-224``, class ``AE``)
trains 21 Keras models in a Python loop.  Here every training of a sweep
is one lane of a **lane grid**: the encoder kernels of all lanes are one
``(D, L, F, M)`` tensor and the decoders ``(D, L, M, F)`` (L latent lanes
of D datasets; the single and the latent-sweep paths are D = 1), the
products batch over the grid, and one autograd pass over the sum of the
lane losses gives every lane its own gradient (the lanes share nothing).
A lane of latent width d masks its latent columns past d
(:func:`~hfrep_tpu_torch.models.autoencoder.latent_mask`), so a masked
lane is the smaller model.

Training recipe (``Autoencoder_encapsulate.py:62-105``), with Keras's
semantics kept exactly: MinMax-scale x_train only (x_test stays
unscaled); tf.keras Nadam on MSE (:mod:`~hfrep_tpu_torch.ops.optimizers`);
at most ``cfg.epochs`` epochs of batches of 48; ``validation_split``: the
first ``int(n * (1 - val_split))`` rows fit, the rest validate; the fit
rows reshuffled every epoch, the last batch padded with zero weight; the
weighted MSE ``sum(err * w) / max(sum(w), 1)``; early stopping on
``val < best_val`` with patience 5 and no best-weight restore; a stopped
lane's params and optimizer state frozen, its losses NaN.

The draws are a seam.  ``init_params`` (a dict of the two kernels with
the grid's leading dims) replaces the Keras-default glorot draw, and
``perm_source(pos, length)`` (the epochs ``pos .. pos+length-1``'s
permutations of the fit rows, ``(*lanes, length, n_train)`` int64)
replaces the default :class:`PermStream`, which draws on the device one
block of epochs a call.  The CPU tests feed JAX's own draws through
them.

The chunked early-exit drive runs ``cfg.chunk_epochs`` epochs at a time
and stops once every lane has stopped; ``double_buffer`` reads the stop
flag one chunk behind (a copy into pinned memory behind a CUDA event).
Chunked and monolithic drives, with the flag read either way, give
bit-identical results: each epoch's work depends only on the epoch.

``resume_dir`` makes a chunked drive preemption-safe: at every chunk
boundary the lane carry (params, Nadam slots, early-stopping registers),
the traces so far and the epoch position are persisted there
(:class:`~hfrep_tpu_torch.resilience.snapshot.ChunkSnapshot`, the stop
flag then read at the boundary, not one chunk behind), a SIGTERM drains
at the boundary (:class:`~hfrep_tpu_torch.resilience.Preempted`), and a
re-run with the same arguments resumes from the last completed chunk
bit-identically: the permutations are a pure function of the seed and
the epoch.  Every chunked drive crosses the ``chunk`` boundary of the
resilience layer, snapshot or not.

Health (:mod:`hfrep_tpu_torch.obs.health`, decided when a drive starts):
each epoch also traces every lane's gradient norm over the epoch's
batches (NaN once the lane has stopped) and the nonfinite count of its
kept params and validation loss.  They are read at the chunk boundary
the host already syncs at (the drive then reads the stop flag there,
not one chunk behind) and at the drive's end, with the grid's param
norm, as the ``health/ae_*`` gauges; under ``HFREP_HEALTH=abort`` a
nonfinite count writes a forensic dump of the carry and raises
:class:`~hfrep_tpu_torch.obs.health.NumericFault`.  The training itself
is bit-identical either way, and a chunk snapshot records the health
setting: a resume across a toggle is refused.

The precision policy is ``cfg.dtype`` (:func:`compute_dtype`, JAX
``_ae_model``): ``"float32"`` applies the model with no cast at all;
``"bfloat16"`` casts both operands of each of its two products to bf16
wherever the model is applied (the training grid's MSE, the in-sample
fit, the OOS prefixes, the ex-ante encode and
:meth:`ReplicationEngine._apply`), over float32 master weights and
Nadam slots; every loss and reduction is float32, since the error
against the float32 panel promotes before it is reduced, and the
ex-ante factors are cast back to float32 before the rolling OLS.

``mesh`` (a ``('dp',)`` :class:`~hfrep_tpu_torch.parallel.rules.Mesh`,
e.g. :func:`~hfrep_tpu_torch.parallel.rules.lane_mesh`) splits the lane
grid's rows over the ranks in the chunked drives (JAX ``_run_chunked``):
the latent lanes of ``lanes`` drives, the datasets of ``multi`` drives.
Each rank makes the whole grid's draws (init, permutations), exactly the
meshless drive's, and trains its contiguous rows of them; the ranks
agree at every chunk boundary on the stop flag and on a drain (one flag
reduction), and the result is assembled on every rank by an all-gather
(through host copies under gloo, so the bytes are unchanged).  Lanes
share nothing, so a mesh drive is bit for bit the meshless one as far as
the rows' kernels are (JAX pins the same).  A lane count the dp extent
does not divide is refused naming the lane axis.  Chunk snapshots hold
the whole grid (rank 0 writes them), so a drive resumes on another
device count.  A one-device mesh runs the meshless drive itself; the
health gauges of a grid split over ranks are not ported (refused).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core import costs
from hfrep_tpu_torch.core import scaler as mm
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.models.autoencoder import ae_apply, ae_encode, latent_mask
from hfrep_tpu_torch.obs import get_obs
from hfrep_tpu_torch.obs import health as health_mod
from hfrep_tpu_torch.ops.optimizers import keras_nadam
from hfrep_tpu_torch.ops.rolling import (_window_stack, expanding_minmax_scale,
                                         rolling_ols_beta)
from hfrep_tpu_torch.replication import perf_stats
from hfrep_tpu_torch.train.trainer import seed_mix

PermSource = Callable[[int, int], torch.Tensor]


class AEResult(NamedTuple):
    params: dict                 # encoder_kernel (..., F, M), decoder_kernel (..., M, F)
    stop_epoch: torch.Tensor     # (...,) epoch at which early stopping fired
    train_loss: torch.Tensor     # (..., epochs), NaN after the stop
    val_loss: torch.Tensor       # (..., epochs)


class ChunkStats(NamedTuple):
    """Dispatch accounting of a chunked early-exit drive."""

    chunks_dispatched: int       # chunks the host ran
    epochs_dispatched: int       # epochs those chunks ran
    epochs_total: int            # cfg.epochs (what the monolithic drive runs)
    chunk_epochs: int            # epochs a chunk
    lanes: int                   # trainings in the grid
    lanes_stopped: int           # lanes whose early stopping fired
    overshoot_chunks: int = 0    # chunks the double-buffered drive ran past
    #                              all(stopped) before its deferred read saw
    #                              it (0 or 1); results are the same

    @property
    def epochs_saved(self) -> int:
        return self.epochs_total - self.epochs_dispatched


def _epoch_batches(n_train: int, batch_size: int) -> Tuple[int, int]:
    n_batches = -(-n_train // batch_size)
    return n_batches, n_batches * batch_size


def compute_dtype(cfg: AEConfig) -> Optional[torch.dtype]:
    """``cfg.dtype`` as the model's compute dtype (JAX ``_ae_model``):
    ``"float32"`` and ``None`` give ``None``, no cast (the float32 path's
    graph); ``"bfloat16"`` gives bf16, its GEMMs accumulating in float32
    (set at the package's import); any other dtype is refused."""
    if cfg.dtype in (None, "float32"):
        return None
    if cfg.dtype != "bfloat16":
        raise ValueError(f"AEConfig.dtype={cfg.dtype!r}: the AE trains in float32 or "
                         "bfloat16")
    return torch.bfloat16


# --------------------------------------------------------------- the draws
class PermStream:
    """The default permutation draws, a pure function of (seed, epoch):
    epochs come in blocks of ``block``, each block one ``argsort`` of a
    ``torch.rand`` block on ``device`` from a generator seeded with
    ``seed_mix(seed, block index)``, so any chunking of the epochs sees
    the same permutations."""

    def __init__(self, seed: int, lanes: Sequence[int], n_train: int,
                 device: torch.device, block: int = 50):
        self.seed, self.lanes, self.n_train = seed, tuple(lanes), n_train
        self.device, self.block = device, block
        self._gen = torch.Generator(device=device)
        self._cached: Optional[Tuple[int, torch.Tensor]] = None

    def _draw(self, b: int) -> torch.Tensor:
        if self._cached is None or self._cached[0] != b:
            self._gen.manual_seed(seed_mix(self.seed, b))
            u = torch.rand(self.lanes + (self.block, self.n_train), generator=self._gen,
                           device=self.device)
            self._cached = (b, torch.argsort(u, dim=-1, stable=True))
        return self._cached[1]

    def __call__(self, pos: int, length: int) -> torch.Tensor:
        parts, e, end = [], pos, pos + length
        while e < end:
            b = e // self.block
            hi = min(end, (b + 1) * self.block)
            parts.append(self._draw(b)[..., e - b * self.block:hi - b * self.block, :])
            e = hi
        return torch.cat(parts, dim=-2)


def keras_init_params(generator: torch.Generator, lanes: Sequence[int], n_features: int,
                      latent: int, device: DeviceLike = None) -> dict:
    """Keras-default (glorot uniform) kernels for every lane, drawn on the
    CPU from ``generator`` (encoders, then decoders), then moved."""
    limit = math.sqrt(6.0 / (n_features + latent))
    enc = torch.empty(tuple(lanes) + (n_features, latent)).uniform_(-limit, limit,
                                                                     generator=generator)
    dec = torch.empty(tuple(lanes) + (latent, n_features)).uniform_(-limit, limit,
                                                                     generator=generator)
    dev = resolve_device(device)
    return {"encoder_kernel": enc.to(dev), "decoder_kernel": dec.to(dev)}


def _rows_info(cfg: AEConfig, n_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padded paths' ``(n_rows, n_train_eff)``, the Keras split of each
    dataset's own rows in exact host arithmetic: ``int(r * (1 -
    val_split))`` in float64, the dense path's formula (a float32 floor
    rounds the wrong way for some splits)."""
    arr = np.asarray(torch.as_tensor(n_rows).cpu(), dtype=np.int64).reshape(-1)
    fit = (arr * (1.0 - cfg.val_split)).astype(np.int64)
    return torch.from_numpy(arr), torch.from_numpy(fit)


# ---------------------------------------------------------- the lane grid
class _Grid:
    """The training carry of a (D, L) lane grid and its epoch.

    ``x`` is (Dx, n, F) with Dx = 1 (every lane trains on one panel) or D
    (the multi path); ``masks`` (L, M); ``rows_info`` the padded
    semantics' (n_rows, n_train_eff), each (D,), or None (dense)."""

    def __init__(self, cfg: AEConfig, x: torch.Tensor, masks: torch.Tensor, rows_info,
                 init_params: dict, d: int, health: bool = False):
        self.cfg = cfg
        self.health = health
        self.dtype = compute_dtype(cfg)
        dev = x.device
        self.dx, n, self.f = x.shape
        self.d, self.l, self.m = d, masks.shape[0], masks.shape[1]
        self.masks = masks
        self.n_train = int(n * (1.0 - cfg.val_split))
        self.n_batches, self.padded = _epoch_batches(self.n_train, cfg.batch_size)
        self.x_fit = x[:, :self.n_train]
        if rows_info is None:
            self.n_eff = None
            self.val_x, self.val_w = x[:, self.n_train:], None
        else:
            n_rows, n_eff = (t.to(dev) for t in rows_info)
            self.n_eff = n_eff[:, None, None]
            rows = torch.arange(n, device=dev)
            self.val_x = x
            self.val_w = ((rows[None] >= n_eff[:, None]) & (rows[None] < n_rows[:, None])
                          ).to(torch.float32)[:, None, :]               # (D, 1, n)
        self.base_w = (torch.arange(self.padded, device=dev) < self.n_train).to(torch.float32)
        self.pad_order = torch.zeros(self.padded - self.n_train, dtype=torch.int64, device=dev)
        fm = self.f * self.m
        # both kernels of a lane in one flat row: one optimizer update a step
        self.flat = torch.cat([init_params["encoder_kernel"].reshape(d, self.l, fm),
                               init_params["decoder_kernel"].reshape(d, self.l, fm)], dim=-1)
        self.tx = keras_nadam(cfg.lr, b1=0.9, b2=0.999, eps=1e-7)
        self.opt = self.tx.init([self.flat], (d, self.l))
        self.best_val = torch.full((d, self.l), math.inf, dtype=torch.float32, device=dev)
        self.wait = torch.zeros((d, self.l), dtype=torch.int32, device=dev)
        self.stopped = torch.zeros((d, self.l), dtype=torch.bool, device=dev)
        self._nan = torch.full((), math.nan, dtype=torch.float32, device=dev)

    def kernels(self, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        fm = self.f * self.m
        return (flat[..., :fm].view(self.d, self.l, self.f, self.m),
                flat[..., fm:].view(self.d, self.l, self.m, self.f))

    def mse(self, flat: torch.Tensor, x: torch.Tensor, w: Optional[torch.Tensor] = None,
            ) -> torch.Tensor:
        enc, dec = self.kernels(flat)
        pred = ae_apply(x, enc, dec, self.masks, self.cfg.leaky_slope, self.dtype)
        err = torch.mean((pred - x) ** 2, dim=-1)
        if w is None:
            return torch.mean(err, dim=-1)
        return torch.sum(err * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)

    def sq_norms(self, flat: torch.Tensor) -> torch.Tensor:
        """Each lane's Σ‖leaf‖² in the JAX leaf order (decoder, then
        encoder), float32, (D, L)."""
        fm = self.f * self.m
        return (torch.sum(torch.square(flat[..., fm:]), dim=-1)
                + torch.sum(torch.square(flat[..., :fm]), dim=-1))

    def param_norm(self) -> torch.Tensor:
        """The global norm of every lane's kernels (the JAX carry's
        params tree: decoder, then encoder)."""
        fm = self.f * self.m
        return torch.sqrt(torch.sum(torch.square(self.flat[..., fm:]))
                          + torch.sum(torch.square(self.flat[..., :fm])))

    def epoch(self, perm: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """One epoch on every lane (``perm`` (D, L, n_train)), in place;
        returns its (train loss, val loss), each (D, L), and with health
        on also (grad norm, nonfinite count)."""
        cfg, d, l = self.cfg, self.d, self.l
        order = torch.cat([perm, self.pad_order.expand(d, l, -1)], dim=-1)
        weights = self.base_w.expand(d, l, -1)
        if self.n_eff is not None:
            weights = weights * (order < self.n_eff)
        if self.dx == 1:
            xs = self.x_fit[0][order]                                    # (D, L, P, F)
        else:
            xs = self.x_fit[torch.arange(d, device=order.device)[:, None, None], order]
        losses, gsq = [], []
        bs = cfg.batch_size
        for i in range(self.n_batches):
            xb, w = xs[:, :, i * bs:(i + 1) * bs], weights[:, :, i * bs:(i + 1) * bs]
            p = self.flat.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = self.mse(p, xb, w)
                (grad,) = torch.autograd.grad(loss.sum(), p)
            if self.health:
                gsq.append(self.sq_norms(grad))
            self.tx.step([self.flat], [grad], self.opt, frozen=self.stopped)
            losses.append(loss.detach())
        stopped = self.stopped
        val = self.mse(self.flat, self.val_x[:, None], self.val_w)
        improved = val < self.best_val
        self.wait.copy_(torch.where(stopped, self.wait,
                                    torch.where(improved, 0, self.wait + 1)))
        self.best_val.copy_(torch.where(stopped, self.best_val,
                                        torch.minimum(self.best_val, val)))
        newly = ~stopped & (self.wait >= cfg.patience)
        train_loss = torch.where(stopped, self._nan, torch.stack(losses).mean(dim=0))
        val_out = torch.where(stopped, self._nan, val)
        out = (train_loss, val_out)
        if self.health:
            # NaN after the lane stopped, like the losses; the count covers
            # the kept params and the epoch's validation loss
            gn = torch.where(stopped, self._nan, torch.sqrt(torch.stack(gsq).sum(dim=0)))
            nf = (torch.sum((~torch.isfinite(self.flat)).float(), dim=-1)
                  + (~torch.isfinite(val)).float())
            out = out + (gn, nf)
        self.stopped.copy_(stopped | newly)
        return out

    def run(self, perms: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``perms.shape[-2]`` epochs; traces (train, val, stopped), each
        (D, L, epochs), and with health on (grad norm, nonfinite)."""
        traces = [[] for _ in range(5 if self.health else 3)]
        for e in range(perms.shape[-2]):
            out = self.epoch(perms[..., e, :])
            for t, v in zip(traces, out[:2] + (self.stopped.clone(),) + out[2:]):
                t.append(v)
        return tuple(torch.stack(t, dim=-1) for t in traces)

    def params(self) -> dict:
        enc, dec = self.kernels(self.flat)
        return {"encoder_kernel": enc.clone(), "decoder_kernel": dec.clone()}

    def carry(self) -> dict:
        """The live training state a chunk boundary snapshots."""
        return {"flat": self.flat, "count": self.opt.count,
                "m_schedule": self.opt.m_schedule, "mu": self.opt.mu[0],
                "nu": self.opt.nu[0], "best_val": self.best_val, "wait": self.wait,
                "stopped": self.stopped}

    def load(self, carry: dict) -> None:
        """Copy a snapshot's carry into the live state, in place."""
        for k, t in self.carry().items():
            t.copy_(carry[k])


class _Flag:
    """A stop flag on its way to the host: on a card, a non-blocking copy
    into pinned memory behind a CUDA event; on the CPU, read at once."""

    def __init__(self, flag: torch.Tensor):
        if flag.device.type == "cuda":
            self.host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self.host.copy_(flag, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = flag.clone(), None

    def get(self) -> bool:
        if self.event is not None:
            self.event.synchronize()
        return bool(self.host)


def _concat_traces(traces: list) -> Tuple[torch.Tensor, ...]:
    """Per-chunk trace tuples joined along the epoch axis: (train loss,
    val loss, stopped), and on a health-armed drive (grad norm, nonfinite)."""
    return tuple(torch.cat([t[i] for t in traces], dim=-1) for i in range(len(traces[0])))


def _emit_ae_health(grid: "_Grid", gn: float, nf: float, pn: float, epoch: int,
                    snapshot) -> None:
    """Publish one AE boundary's health scalars; under
    ``abort_on_nonfinite`` a nonfinite count writes a forensic dump of the
    carry (the failing chunk's snapshot is not yet written, so a resume
    replays it) and raises :class:`~hfrep_tpu_torch.obs.health.NumericFault`."""
    obs = get_obs()
    if obs.enabled:
        obs.gauge("health/ae_grad_norm").set(gn, epoch=epoch)
        obs.gauge("health/ae_nonfinite").set(nf, epoch=epoch)
        obs.gauge("health/ae_param_norm").set(pn, epoch=epoch)
    health_mod.tripwire("chunk", epoch, nf, grid.carry(),
                        {"grad_norm": gn, "param_norm": pn},
                        fallback=str(snapshot.dir) if snapshot is not None else None)


def _health_scalars(grid: "_Grid", tr: Tuple[torch.Tensor, ...], last: int):
    """(grad norm, nonfinite, param norm) of epoch ``last`` of the traces
    ``tr`` as device tensors: the lanes' largest grad norm (NaN when every
    lane's is NaN, as ``jnp.nanmax``), their summed nonfinite count, the
    grid's param norm."""
    gn = tr[3][..., last]
    gn = torch.where(torch.isnan(gn), torch.full_like(gn, -math.inf), gn).max()
    gn = torch.where(gn == -math.inf, torch.full_like(gn, math.nan), gn)
    return gn, torch.nansum(tr[4][..., last]), grid.param_norm()


def _boundary_sync(stopped: torch.Tensor, grid: Optional["_Grid"], tr: Tuple[torch.Tensor, ...],
                   pos: int, snapshot) -> bool:
    """The serial drive's one read at a boundary: ``all(stopped)``, and
    with a health-armed ``grid`` the boundary's health scalars of the
    chunk's traces ``tr`` in the same copy (:func:`_emit_ae_health`)."""
    if grid is None:
        return bool(torch.all(stopped))
    flag, *vals = (float(v) for v in torch.stack(
        (torch.all(stopped).float(),) + _health_scalars(grid, tr, -1)).cpu())
    _emit_ae_health(grid, *vals, pos, snapshot)
    return bool(flag)


def _snapshot_save_failed(snapshot, pos: int, e: OSError) -> None:
    """A chunk snapshot is a resume optimisation: a write that outlasts
    the retry policy costs resume granularity (the last snapshot that
    landed, or a fresh start, both bit-identical), never the drive."""
    import sys

    obs = get_obs()
    obs.counter("resilience/snapshot_save_failures").inc()
    obs.event("snapshot_save_failed", path=str(snapshot.path), epoch=pos, error=str(e))
    print(f"warning: chunk snapshot {snapshot.path} not saved ({e}); "
          "resume granularity degraded, training continues", file=sys.stderr)


def _drive_chunks(chunk_fn, stopped: torch.Tensor, epochs: int, chunk_epochs: int,
                  double_buffer: bool = True, snapshot=None, grid: Optional["_Grid"] = None,
                  cross: bool = True, agree: Optional[Callable[[bool], bool]] = None):
    """The host side of chunked early-exit training: ``chunk_fn(pos,
    length)`` runs ``length`` epochs and returns their traces; between
    chunks the host reads ``all(stopped)`` and stops once it holds.  With
    ``double_buffer`` it reads the previous chunk's flag after enqueueing
    the next chunk, one chunk behind: at most one chunk of overshoot,
    whose outputs are the padding values (frozen lanes, NaN losses, True
    flags), so the result is the serial drive's.  The epochs not run are
    padded with NaN losses and True flags, the values the monolithic
    drive computes for them.

    ``snapshot`` (a :class:`~hfrep_tpu_torch.resilience.snapshot.
    ChunkSnapshot` of ``grid``'s carry) loads the resume state before the
    loop and saves it at every boundary; its drive reads the flag at the
    boundary (the snapshot records it), as does a drive of a health-armed
    ``grid``, whose boundary health scalars join that read
    (:func:`_emit_ae_health`).  Every boundary crosses
    ``resilience.boundary("chunk")`` (unless ``cross`` is False: the
    monolithic drive, one scan in the JAX package, has no boundary),
    where injected faults fire and a requested drain raises
    :class:`~hfrep_tpu_torch.resilience.Preempted` with the state
    already on disk.  ``agree`` (a lane mesh's) turns this rank's stop
    flag into the grid's at every boundary, read there, and spreads a
    drain requested on any rank, before the snapshot and the boundary.
    Returns ``(traces, epochs_dispatched, chunks_dispatched,
    overshoot_chunks)``."""
    chunk = int(chunk_epochs) if chunk_epochs and chunk_epochs > 0 else epochs
    traces: list = []
    pos = chunks = overshoot = 0
    stopped_all = False
    health = grid is not None and grid.health
    if snapshot is not None or health or agree is not None:
        double_buffer = False
    if snapshot is not None:
        loaded = snapshot.load(grid.carry())
        if loaded is not None:
            carry, tr, pos, chunks, stopped_all = loaded
            grid.load(carry)
            traces.append(tuple(t.to(stopped.device) for t in tr))
            obs = get_obs()
            obs.counter("resilience/resumes").inc()
            obs.event("chunk_resume", pos=pos, chunks=chunks, epochs=epochs,
                      path=str(snapshot.path))
    # dispatch-vs-compute attribution (obs/attrib.py), decided once a
    # drive: each chunk's launches are timed on the host and flushed
    # against the wall ending at the boundary's flag read, the sync the
    # drive already makes.  The first window is a warmup (its launches
    # build the kernels) and is discarded; the wall-clock ledger's window
    # runs boundary to boundary.
    from hfrep_tpu_torch.obs import attrib, timeline
    attrib_on = get_obs().enabled
    calls_here = flushes = steps_window = 0
    t_window0 = timeline.clock()
    pending: Optional[_Flag] = None
    try:
        while pos < epochs and not stopped_all:
            length = min(chunk, epochs - pos)
            t_chunk0 = timeline.clock() if attrib_on else 0.0
            with attrib.dispatch_timer("ae_chunk") if attrib_on else contextlib.nullcontext():
                traces.append(chunk_fn(pos, length))
            pos += length
            chunks += 1
            calls_here += 1
            steps_window += length
            if double_buffer:
                flag = _Flag(torch.all(stopped))
                if pending is not None:
                    t_sync0 = timeline.clock()
                    stopped_all = pending.get()
                    if stopped_all:
                        overshoot = 1
                    if attrib_on:
                        # the wait is on a flag already resolving with the
                        # next chunk queued behind it: device time, booked
                        # as overlapped (sync_wait_s=0)
                        now = timeline.clock()
                        wait_s = now - t_sync0
                        timeline.note_sync(wait_s)
                        disp_s = attrib.window_dispatch_s()
                        attrib.flush_window(now - t_window0, steps=steps_window,
                                            warmup=flushes == 0, epoch=pos)
                        timeline.flush_window(now - t_window0, drive="ae_chunk",
                                              steps=steps_window, warmup=flushes == 0,
                                              dispatch_s=disp_s, sync_wait_s=0.0, epoch=pos,
                                              pending_wait_ms=round(wait_s * 1e3, 3))
                        t_window0, flushes, steps_window = now, flushes + 1, 0
                pending = flag
            elif pos < epochs:
                t_sync0 = timeline.clock()
                stopped_all = _boundary_sync(stopped, grid if health else None, traces[-1],
                                             pos, snapshot)
                if attrib_on:
                    now = timeline.clock()
                    disp_s = attrib.window_dispatch_s()
                    attrib.flush_window(now - t_chunk0, steps=length,
                                        warmup=calls_here == 1, epoch=pos)
                    timeline.flush_window(now - t_window0, drive="ae_chunk", steps=length,
                                          warmup=calls_here == 1, dispatch_s=disp_s,
                                          sync_wait_s=now - t_sync0, epoch=pos)
                    t_window0, flushes, steps_window = now, flushes + 1, 0
            if agree is not None:
                stopped_all = agree(stopped_all or pos >= epochs)
            if snapshot is not None and not resilience.drain_requested():
                # a drain already requested (a SIGTERM during the chunk) skips
                # this boundary's write: the resume replays the chunk from the
                # committed predecessor, bit-identically
                try:
                    snapshot.save(grid.carry(), _concat_traces(traces), pos, chunks,
                                  stopped_all)
                except OSError as e:
                    _snapshot_save_failed(snapshot, pos, e)
            if not cross:
                continue
            try:
                resilience.boundary("chunk")
            except resilience.Preempted as e:
                raise resilience.Preempted(
                    site=e.site, reason=e.reason, epoch=pos,
                    snapshot=str(snapshot.path) if snapshot is not None else None) from None
    finally:
        if attrib_on:
            # the last chunk has no boundary read inside the loop (and a
            # drain exits mid-window): its launches must not bleed into the
            # next drive's window
            attrib.reset_window()
    out = _concat_traces(traces)
    if pos < epochs:
        lead = out[0].shape[:-1]
        pad = lead + (epochs - pos,)
        # the stop trace pads True, every other trace NaN: the values the
        # monolithic drive computes for the epochs not run
        out = tuple(torch.cat([t, t.new_ones(pad) if i == 2 else t.new_full(pad, math.nan)],
                              dim=-1) for i, t in enumerate(out))
    return out, pos, chunks, overshoot


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """float32 on ``dev``; a numpy array is copied (it may be read-only)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(dev, torch.float32)


def _stop_epoch(stop_trace: torch.Tensor, epochs: int) -> torch.Tensor:
    any_stop = torch.any(stop_trace, dim=-1)
    first = torch.argmax(stop_trace.to(torch.uint8), dim=-1)
    return torch.where(any_stop, first, torch.full_like(first, epochs))


class _LaneSplit:
    """This rank's contiguous rows of a lane grid split over a mesh's
    ``dp`` ranks: rows of the grid's leading axis as the caller sees it
    (the lane axis of a ``lanes`` grid, the dataset axis of a ``multi``
    one), which is axis ``gax`` of the engine's (D, L) grid tensors."""

    def __init__(self, mesh, kind: str, lead: Tuple[int, ...]):
        mesh._need_group("a lane grid split over dp ranks")
        self.mesh, self.kind = mesh, kind
        self.n = int(mesh.shape["dp"])
        self.rank = mesh.coords()["dp"]
        self.rows = lead[0] // self.n
        self.gax = 0 if kind == "multi" else 1

    @staticmethod
    def of(mesh, kind: str, lead: Tuple[int, ...]) -> Optional["_LaneSplit"]:
        """The split a mesh asks for, or ``None`` (no mesh, a one-device
        mesh, or a ``single`` drive: every rank trains the one lane)."""
        if mesh is None:
            return None
        if "dp" not in mesh.axis_names:
            raise ValueError(f"chunked drive wants a mesh with a 'dp' axis, got "
                             f"{tuple(mesh.axis_names)}")
        n_dp = int(mesh.shape["dp"])
        if kind != "single" and lead[0] % n_dp:
            raise ValueError(
                f"lane axis of size {lead[0]} not divisible by the dp={n_dp} mesh")
        if n_dp == 1 or kind == "single":
            return None
        return _LaneSplit(mesh, kind, lead)

    def lead_rows(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return t.narrow(axis, self.rank * self.rows, self.rows)

    def grid_rows(self, t: torch.Tensor) -> torch.Tensor:
        return self.lead_rows(t, self.gax)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole grid's ``t`` from every rank's rows (axis ``gax``)."""
        return self.mesh.all_gather_cat(t, self.gax)

    def agree(self, stopped_all: bool) -> bool:
        """Every rank's stop flag and drain request in one reduction: the
        grid stops when every rank's lanes have; a drain requested on any
        rank is requested here too."""
        running, drain = self.mesh.any(not stopped_all, resilience.drain_requested())
        if drain and not resilience.drain_requested():
            resilience.request_drain("peer")
        return not running


class _SplitSnapshot:
    """A :class:`~hfrep_tpu_torch.resilience.snapshot.ChunkSnapshot` of the
    whole grid over a split one: every rank reads the snapshot and keeps
    its rows; at a boundary the rows are gathered and rank 0 writes, then
    the ranks meet at a barrier."""

    def __init__(self, snap, split: _LaneSplit):
        self.snap, self.split = snap, split
        self.path, self.dir = snap.path, snap.dir

    def load(self, template: dict):
        loaded = self.snap.load(template)
        if loaded is None:
            return None
        carry, tr, pos, chunks, stopped_all = loaded
        return ({k: self.split.grid_rows(v) for k, v in carry.items()},
                tuple(self.split.grid_rows(t) for t in tr), pos, chunks, stopped_all)

    def save(self, carry: dict, traces: Tuple, pos: int, chunks: int,
             stopped_all: bool) -> None:
        full = {k: self.split.gather(v) for k, v in carry.items()}
        trs = tuple(self.split.gather(t) for t in traces)
        err = None
        if self.split.rank == 0:
            try:
                self.snap.save(full, trs, pos, chunks, stopped_all)
            except OSError as e:
                err = e
        self.split.mesh.barrier()
        if err is not None:
            raise err

    def clear(self) -> None:
        self.split.mesh.barrier()
        if self.split.rank == 0:
            self.snap.clear()


def _train_grid(cfg: AEConfig, seed: int, x, masks: torch.Tensor, rows_info,
                lead: Tuple[int, ...], init_params: Optional[dict],
                perm_source: Optional[PermSource], device: DeviceLike,
                monolithic: bool = False, resume_dir: Optional[str] = None,
                mesh=None) -> Tuple[AEResult, ChunkStats]:
    """The shared drive of every training entry point: ``lead`` is the
    grid's shape as the caller sees it, () / (L,) / (D, L).

    ``resume_dir`` keeps chunk snapshots there; their fingerprint covers
    the config, the grid's kind and lanes, the seed and a digest of the
    operands (data, masks, row counts, given init), so a snapshot of
    another drive is refused.  A ``perm_source`` seam is outside the
    fingerprint: a resume must pass the same one.  ``mesh`` splits the
    grid's rows over its ranks (module docstring); its device is the
    drive's."""
    if resume_dir is not None and (monolithic or not cfg.chunk_epochs):
        raise ValueError("resume_dir requires the chunked drive (cfg.chunk_epochs > 0): "
                         "a monolithic drive has no chunk boundary to resume from")
    kind = ("single", "lanes", "multi")[len(lead)]
    split = _LaneSplit.of(mesh, kind, lead)
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    health = health_mod.active() is not None
    x = _tensor(x, dev)
    d = x.shape[0] if x.dim() == 3 else 1
    x = x if x.dim() == 3 else x[None]
    masks = masks.to(dev)
    grid_shape = (d, masks.shape[0])
    given_init = init_params is not None
    if init_params is None:
        g = torch.Generator()
        g.manual_seed(seed_mix(seed, 1))
        init_params = keras_init_params(g, lead, x.shape[-1], cfg.latent_dim, dev)
    init_params = {k: _tensor(v, dev) for k, v in init_params.items()}
    snap = None
    if resume_dir is not None:
        from hfrep_tpu_torch.resilience.snapshot import ChunkSnapshot, digest_arrays
        snap = ChunkSnapshot(resume_dir, fingerprint={
            "cfg": list(dataclasses.astuple(cfg)),
            "kind": ("single", "lanes", "multi")[len(lead)], "lanes": list(lead),
            "seed": int(seed),
            # health changes the persisted trace arity: a resume must not
            # adopt a snapshot of the other setting
            "health": health,
            "operands": digest_arrays(x, masks, rows_info, init_params if given_init else None)})
    full_shape, local_shape = grid_shape, grid_shape
    if split is not None:
        if health:
            raise ValueError("the health gauges of a lane grid split over dp ranks are not "
                             "ported: run with health off or on a one-device mesh")
        if kind == "multi":
            x = split.lead_rows(x)
            rows_info = tuple(split.lead_rows(t) for t in rows_info)
        else:
            masks = split.lead_rows(masks)
        init_params = {k: split.lead_rows(v) for k, v in init_params.items()}
        local_shape = tuple(s // split.n if i == split.gax else s
                            for i, s in enumerate(grid_shape))
        snap = _SplitSnapshot(snap, split) if snap is not None else None
    with torch.no_grad(), resilience.graceful_drain():
        grid = _Grid(cfg, x, masks, rows_info, init_params, local_shape[0], health=health)
        if perm_source is None:
            perm_source = PermStream(seed_mix(seed, 2), lead, grid.n_train, dev)

        def chunk_fn(pos: int, length: int):
            perms = perm_source(pos, length).to(dev, torch.int64)
            if split is not None:
                perms = split.lead_rows(perms)
            return grid.run(perms.reshape(local_shape + (length, grid.n_train)))

        traces, dispatched, chunks, overshoot = _drive_chunks(
            chunk_fn, grid.stopped, cfg.epochs, 0 if monolithic else cfg.chunk_epochs,
            double_buffer=cfg.double_buffer, snapshot=snap, grid=grid, cross=not monolithic,
            agree=split.agree if split is not None else None)
        params = grid.params()
        if split is not None:
            traces = tuple(split.gather(t) for t in traces)
            params = {k: split.gather(v) for k, v in params.items()}
        tl, vl, st = traces[:3]
        if health and not monolithic:
            # the drive's end: the last dispatched epoch's health scalars
            # (the monolithic drive, one scan in the JAX package, has none)
            gn, nf, pn = (float(v) for v in torch.stack(
                _health_scalars(grid, traces, max(0, dispatched - 1))).cpu())
            _emit_ae_health(grid, gn, nf, pn, dispatched, snap)
        params = {k: v.reshape(lead + v.shape[2:]) for k, v in params.items()}
        tl, vl, st = (t.reshape(lead + (cfg.epochs,)) for t in (tl, vl, st))
        stop_epoch = _stop_epoch(st, cfg.epochs)
    res = AEResult(params=params, stop_epoch=stop_epoch, train_loss=tl, val_loss=vl)
    stats = ChunkStats(chunks_dispatched=chunks, epochs_dispatched=dispatched,
                       epochs_total=cfg.epochs,
                       chunk_epochs=cfg.epochs if monolithic else (cfg.chunk_epochs
                                                                   or cfg.epochs),
                       lanes=int(np.prod(full_shape)),
                       lanes_stopped=int(torch.sum(stop_epoch < cfg.epochs)),
                       overshoot_chunks=overshoot)
    if snap is not None:
        snap.clear()
    return res, stats


def _sweep_masks(cfg: AEConfig, latent_dims: Sequence[int]):
    max_latent = max(latent_dims)
    cfg = dataclasses.replace(cfg, latent_dim=max_latent)
    return cfg, torch.stack([latent_mask(d, max_latent, device="cpu") for d in latent_dims])


# ------------------------------------------------------- public training
def train_autoencoder(seed: int, x_train_scaled, cfg: AEConfig,
                      mask: Optional[torch.Tensor] = None, init_params: Optional[dict] = None,
                      perm_source: Optional[PermSource] = None,
                      device: DeviceLike = None) -> AEResult:
    """Train one (optionally masked) AE, every epoch in one drive.

    ``mask`` is a (latent_dim,) 0/1 vector of active latent columns (None:
    all); the early-exit form with the same results is
    :func:`train_autoencoder_chunked`."""
    m = torch.ones(cfg.latent_dim) if mask is None else torch.as_tensor(mask).cpu()
    return _train_grid(cfg, seed, x_train_scaled, m.reshape(1, -1), None, (), init_params,
                       perm_source, device, monolithic=True)[0]


def train_autoencoder_chunked(seed: int, x_train_scaled, cfg: AEConfig,
                              mask: Optional[torch.Tensor] = None,
                              init_params: Optional[dict] = None,
                              perm_source: Optional[PermSource] = None,
                              device: DeviceLike = None, resume_dir: Optional[str] = None,
                              ) -> Tuple[AEResult, ChunkStats]:
    """:func:`train_autoencoder` as a chunked early-exit drive:
    ``cfg.chunk_epochs`` epochs a chunk, no chunk after early stopping
    fired; bit-identical to the monolithic drive.  ``resume_dir`` keeps
    chunk snapshots and resumes from them."""
    m = torch.ones(cfg.latent_dim) if mask is None else torch.as_tensor(mask).cpu()
    return _train_grid(cfg, seed, x_train_scaled, m.reshape(1, -1), None, (), init_params,
                       perm_source, device, resume_dir=resume_dir)


def sweep_autoencoders(seed: int, x_train_scaled, cfg: AEConfig,
                       latent_dims: Sequence[int], init_params: Optional[dict] = None,
                       perm_source: Optional[PermSource] = None,
                       device: DeviceLike = None) -> AEResult:
    """Every latent width as one lane of one grid, every epoch in one
    drive; the result's arrays lead with the lane axis."""
    cfg, masks = _sweep_masks(cfg, latent_dims)
    return _train_grid(cfg, seed, x_train_scaled, masks, None, (len(latent_dims),),
                       init_params, perm_source, device, monolithic=True)[0]


def sweep_autoencoders_chunked(seed: int, x_train_scaled, cfg: AEConfig,
                               latent_dims: Sequence[int], init_params: Optional[dict] = None,
                               perm_source: Optional[PermSource] = None,
                               device: DeviceLike = None, resume_dir: Optional[str] = None,
                               mesh=None) -> Tuple[AEResult, ChunkStats]:
    """:func:`sweep_autoencoders` as a chunked early-exit drive: chunks run
    until every lane has stopped; bit-identical to the monolithic sweep.
    ``mesh`` splits the lanes over its ranks (module docstring)."""
    cfg, masks = _sweep_masks(cfg, latent_dims)
    return _train_grid(cfg, seed, x_train_scaled, masks, None, (len(latent_dims),),
                       init_params, perm_source, device, resume_dir=resume_dir, mesh=mesh)


def stack_padded(x_list: Sequence) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack (T_d, F) panels of different lengths into a (D, T_max, F) cube,
    zero rows after each panel's tail, and the (D,) row counts."""
    xs = [x.to(torch.float32) if isinstance(x, torch.Tensor) else _tensor(x, torch.device("cpu"))
          for x in x_list]
    n_max = max(int(x.shape[0]) for x in xs)
    padded = [torch.cat([x, x.new_zeros((n_max - x.shape[0], x.shape[1]))])
              if x.shape[0] < n_max else x for x in xs]
    return torch.stack(padded), torch.tensor([x.shape[0] for x in xs], dtype=torch.int64)


def sweep_autoencoders_padded(seed: int, x_pad, n_rows, cfg: AEConfig,
                              latent_dims: Sequence[int], init_params: Optional[dict] = None,
                              perm_source: Optional[PermSource] = None,
                              device: DeviceLike = None, resume_dir: Optional[str] = None,
                              mesh=None) -> Tuple[AEResult, ChunkStats]:
    """One padded dataset's latent sweep: ``x_pad`` (T_max, F) holds
    ``n_rows`` real rows, then zeros; the unit that
    :func:`sweep_autoencoders_multi` batches across datasets; ``mesh``
    splits the lanes over its ranks."""
    cfg, masks = _sweep_masks(cfg, latent_dims)
    return _train_grid(cfg, seed, x_pad, masks, _rows_info(cfg, n_rows),
                       (len(latent_dims),), init_params, perm_source, device,
                       resume_dir=resume_dir, mesh=mesh)


def sweep_autoencoders_multi(seed: int, x_stack, n_rows, cfg: AEConfig,
                             latent_dims: Sequence[int], init_params: Optional[dict] = None,
                             perm_source: Optional[PermSource] = None,
                             device: DeviceLike = None, resume_dir: Optional[str] = None,
                             mesh=None) -> Tuple[AEResult, ChunkStats]:
    """Every (dataset, latent) pair as one lane of a (D, L) grid:
    ``x_stack`` the :func:`stack_padded` cube of the real and the
    augmented training sets, ``n_rows`` their row counts.  Chunks run
    while any lane of the grid trains.  ``mesh`` splits the datasets over
    its ranks (module docstring)."""
    cfg, masks = _sweep_masks(cfg, latent_dims)
    d = int(torch.as_tensor(x_stack).shape[0])
    return _train_grid(cfg, seed, x_stack, masks, _rows_info(cfg, n_rows),
                       (d, len(latent_dims)), init_params, perm_source, device,
                       resume_dir=resume_dir, mesh=mesh)


def sweep_item_arrays(seed: int, panel, cfg: AEConfig, latent_dims: Sequence[int],
                      init_params: Optional[dict] = None,
                      perm_source: Optional[PermSource] = None,
                      device: DeviceLike = None) -> dict:
    """One queue item's latent sweep as a flat ``{name: np.ndarray}`` dict
    ready for an ``npz`` artifact (the actors' entry point).

    A pure function of ``(seed, panel, cfg, latent_dims)`` on a given
    device — the property the fabric's kill→resume bit-identity rests on
    — with the JAX artifact's names and dtypes: ``param_<name>`` per
    parameter with its leading lane axis, ``stop_epoch`` (int32), the
    loss traces and ``chunks_dispatched``.  Runs the chunked early-exit
    drive on the panel as given (already scaled)."""
    res, stats = sweep_autoencoders_chunked(seed, panel, cfg, list(latent_dims),
                                            init_params, perm_source, device)
    out = {f"param_{k}": v.cpu().numpy() for k, v in sorted(res.params.items())}
    out["stop_epoch"] = res.stop_epoch.cpu().numpy().astype(np.int32)
    out["train_loss"] = res.train_loss.cpu().numpy()
    out["val_loss"] = res.val_loss.cpu().numpy()
    out["chunks_dispatched"] = np.asarray(stats.chunks_dispatched)
    return out


def emit_chunk_stats(stats: Optional[ChunkStats]) -> None:
    """Publish a chunked drive's savings as obs gauges (no-op when
    telemetry is off or the drive ran monolithically)."""
    if stats is None:
        return
    obs = get_obs()
    if not obs.enabled:
        return
    obs.gauge("ae/epochs_saved").set(int(stats.epochs_saved),
                                     epochs_total=int(stats.epochs_total),
                                     chunk_epochs=int(stats.chunk_epochs),
                                     overshoot_chunks=int(stats.overshoot_chunks))
    obs.gauge("ae/lanes_stopped").set(int(stats.lanes_stopped), lanes=int(stats.lanes))
    obs.counter("ae_chunks_dispatched").inc(int(stats.chunks_dispatched))


# ------------------------------------------------------ pure evaluation
def _r2_columns_mean(actual: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """sklearn r2_score, multioutput='uniform_average', over rows (dim -2)."""
    ss_res = torch.sum((actual - pred) ** 2, dim=-2)
    ss_tot = torch.sum((actual - torch.mean(actual, dim=-2, keepdim=True)) ** 2, dim=-2)
    return torch.mean(1.0 - ss_res / ss_tot, dim=-1)


def _r2_columns_mean_masked(actual, pred, mask_rows) -> torch.Tensor:
    """:func:`_r2_columns_mean` over the rows where ``mask_rows`` (..., T, 1)
    holds."""
    w = mask_rows.to(actual.dtype)
    n = torch.clamp(torch.sum(w, dim=(-2, -1)), min=1.0)[..., None]
    mean = torch.sum(actual * w, dim=-2) / n
    ss_res = torch.sum(((actual - pred) * w) ** 2, dim=-2)
    ss_tot = torch.sum(((actual - mean.unsqueeze(-2)) * w) ** 2, dim=-2)
    return torch.mean(1.0 - ss_res / ss_tot, dim=-1)


def _kernels(params: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    return params["encoder_kernel"], params["decoder_kernel"]


@torch.no_grad()
def oos_prefix_metrics(x_test: torch.Tensor, params: dict,
                       mask: Optional[torch.Tensor], slope: float = 0.2,
                       dtype: Optional[torch.dtype] = None):
    """Per-prefix OOS R² and RMSE (``Autoencoder_encapsulate.py:115-131``):
    for prefix length i in [2, T), ``x_test`` MinMax-scaled by the prefix's
    own min and max (a zero range taken as 1), reconstructed in ``dtype``
    (:func:`compute_dtype`), and scored in float32 on its first i rows.
    Params with lane dims give (..., T - 2) each."""
    t = x_test.shape[0]
    mins, maxs = expanding_minmax_scale(x_test)
    rng = maxs - mins
    scale = torch.where(rng == 0.0, torch.ones_like(rng), rng)
    i = torch.arange(2, t, device=x_test.device)
    scaled = (x_test[None] - mins[i - 1][:, None]) / scale[i - 1][:, None]      # (P, T, F)
    mask_rows = (torch.arange(t, device=x_test.device)[None, :] < i[:, None])[..., None]
    enc, dec = _kernels(params)
    pred = ae_apply(scaled, enc.unsqueeze(-3), dec.unsqueeze(-3),
                    None if mask is None else mask.unsqueeze(-2), slope, dtype)
    r2 = _r2_columns_mean_masked(scaled, pred, mask_rows)
    sq = torch.sum((scaled - pred) ** 2 * mask_rows, dim=(-2, -1))
    rmse = torch.sqrt(sq / (torch.sum(mask_rows, dim=(-2, -1)) * x_test.shape[1]))
    return r2, rmse


@torch.no_grad()
def ante_weights(cfg: AEConfig, params: dict, mask: Optional[torch.Tensor],
                 x_test: torch.Tensor, y_test: torch.Tensor, rf, window: int):
    """Ex-ante replication returns and strategy weights
    (``Autoencoder_encapsulate.py:133-201``): ``(ante (..., P, S), weights
    (..., P, F, S))``.  The encoder sees the raw test returns (``:140``), in
    the policy's compute dtype; the factors leave it as float32, since the
    rolling pseudo-inverse has no bf16 path (an identity at float32)."""
    rf = _tensor(rf, x_test.device).reshape(-1, 1)
    enc, dec = _kernels(params)
    factors = ae_encode(x_test, enc, mask, cfg.leaky_slope,
                        compute_dtype(cfg)).float()                 # (..., T, M)
    n_windows = x_test.shape[0] - window                            # :148 range
    betas = rolling_ols_beta(y_test, factors, window)[..., :n_windows, :, :]
    xw = _window_stack(factors, window)[..., :n_windows, :, :]
    yw = _window_stack(y_test, window)[:n_windows]
    norms = costs.normalization(yw, xw, betas, window)             # (..., N, S)
    w_dec = dec if mask is None else dec * mask.unsqueeze(-1)       # (..., M, F), :159
    # the LeakyReLU mask from the month's decoded sign, :163-166
    decoded = factors[..., window:window + n_windows, :] @ w_dec    # (..., N, F)
    leaky = torch.where(decoded < 0, decoded.new_tensor(cfg.leaky_slope),
                        decoded.new_tensor(1.0))
    if cfg.beta_mode == "first":
        betas, norms = betas[..., :1, :, :], norms[..., :1, :]
    weights = ((betas.transpose(-1, -2) @ w_dec.unsqueeze(-3)) * leaky.unsqueeze(-2)
               ).transpose(-1, -2) * norms.unsqueeze(-2)            # (..., N, F, S)
    weights = weights[..., :-1, :, :]                               # :179-180
    p = weights.shape[-3]
    delta = 1.0 - torch.sum(weights, dim=-2)                        # (..., P, S)
    ante = delta * rf[-p:] + torch.einsum("pf,...pfs->...ps", x_test[-p:], weights)
    return ante, weights


@torch.no_grad()
def evaluate_params(cfg: AEConfig, x_train_scaled, x_test, y_test, rf, factor_full,
                    params: dict, mask: Optional[torch.Tensor]) -> dict:
    """Every per-latent number of the notebook's result cells: IS/OOS fit
    metrics, ex-ante and ex-post returns, turnover and Sharpe ratios.
    Params with lane dims evaluate the whole lane grid at once."""
    enc, dec = _kernels(params)
    dev = enc.device
    x_train_scaled, x_test, y_test, rf, factor_full = (
        _tensor(a, dev) for a in (x_train_scaled, x_test, y_test, rf, factor_full))
    dt = compute_dtype(cfg)
    pred_train = ae_apply(x_train_scaled, enc, dec, mask, cfg.leaky_slope, dt)
    is_r2 = _r2_columns_mean(x_train_scaled, pred_train)
    is_rmse = torch.sqrt(torch.mean((x_train_scaled - pred_train) ** 2, dim=(-2, -1)))
    oos_r2, oos_rmse = oos_prefix_metrics(x_test, params, mask, cfg.leaky_slope, dt)
    window = cfg.ols_window
    ante, weights = ante_weights(cfg, params, mask, x_test, y_test, rf, window)
    p = ante.shape[-2]
    post = costs.ex_post_return(ante, window, weights.movedim(-1, -3),
                                factor_full[-(p + window):])
    rf_tail = rf.reshape(-1)[-p:]
    return {
        "is_r2": is_r2, "is_rmse": is_rmse,
        "oos_r2": oos_r2, "oos_rmse": oos_rmse,
        "ante": ante, "post": post,
        "turnover": costs.turnover(weights),
        "sharpe_ante": perf_stats.annualized_sharpe(ante.movedim(-2, 0), rf_tail),
        "sharpe_post": perf_stats.annualized_sharpe(post.movedim(-2, 0), rf_tail),
    }


def sweep_evaluate(cfg: AEConfig, x_train_scaled, x_test, y_test, rf, factor_full,
                   stacked_params: dict, masks: torch.Tensor) -> dict:
    """Evaluate every latent width of a sweep at once: ``stacked_params``
    and ``masks`` lead with the lane axis, and so does every result."""
    return evaluate_params(cfg, x_train_scaled, x_test, y_test, rf, factor_full,
                           stacked_params, masks.to(stacked_params["encoder_kernel"].device))


# ---------------------------------------------------------------- engine
class ReplicationEngine:
    """The reference ``AE`` wrapper's API on one trained model
    (``Autoencoder_encapsulate.py:39-70``): unscaled train and test panels
    in, the train set's MinMax params fit here; x_test stays unscaled
    (``:67``)."""

    def __init__(self, x_train, y_train, x_test, y_test, cfg: Optional[AEConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg or AEConfig()
        self.dtype = compute_dtype(self.cfg)
        if len(x_train) != len(y_train) or len(x_test) != len(y_test):
            raise ValueError("x/y length mismatch")
        self.device = resolve_device(device)

        self.x_train_raw, self.x_test, self.y_train, self.y_test = (
            _tensor(a, self.device) for a in (x_train, x_test, y_train, y_test))
        self.train_scale, self.x_train = mm.fit_transform(self.x_train_raw)
        self.result: Optional[AEResult] = None
        self.mask: Optional[torch.Tensor] = None
        self._invalidate()

    def train(self, seed: Optional[int] = None, init_params: Optional[dict] = None,
              perm_source: Optional[PermSource] = None) -> AEResult:
        """Train the full-latent model: the chunked drive when
        ``cfg.chunk_epochs > 0`` (the default), else the monolithic one,
        with the same results."""
        seed = self.cfg.seed if seed is None else seed
        if self.cfg.chunk_epochs and self.cfg.chunk_epochs > 0:
            self.result, _ = train_autoencoder_chunked(
                seed, self.x_train, self.cfg, init_params=init_params,
                perm_source=perm_source, device=self.device)
        else:
            self.result = train_autoencoder(seed, self.x_train, self.cfg,
                                            init_params=init_params,
                                            perm_source=perm_source, device=self.device)
        self.mask = None
        self._invalidate()
        return self.result

    def use_params(self, params: dict, mask: Optional[torch.Tensor] = None) -> None:
        """Adopt externally trained (e.g. sweep-sliced) parameters."""
        params = {k: _tensor(v, self.device) for k, v in params.items()}
        zero = torch.zeros((), device=self.device)
        self.result = AEResult(params=params, stop_epoch=zero.to(torch.int64),
                               train_loss=zero, val_loss=zero)
        self.mask = None if mask is None else torch.as_tensor(mask).to(self.device)
        self._invalidate()

    def _invalidate(self) -> None:
        self._oos_cache = None
        self._ante = None
        self._strat_weights = None
        self._post = None

    @property
    def params(self) -> dict:
        if self.result is None:
            raise RuntimeError("train() first")
        return self.result.params

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        enc, dec = _kernels(self.params)
        with torch.no_grad():
            return ae_apply(x, enc, dec, self.mask, self.cfg.leaky_slope, self.dtype)

    # ------------------------------------------------------------- metrics
    def model_IS_r2(self) -> float:
        """r2_score(x_train_scaled, reconstruction), uniform over columns
        (``Autoencoder_encapsulate.py:107-109``)."""
        return float(_r2_columns_mean(self.x_train, self._apply(self.x_train)))

    def model_IS_RMSE(self) -> float:
        pred = self._apply(self.x_train)
        return float(torch.sqrt(torch.mean((self.x_train - pred) ** 2)))

    def _oos_eval(self):
        if self._oos_cache is None:
            self._oos_cache = oos_prefix_metrics(self.x_test, self.params, self.mask,
                                                 self.cfg.leaky_slope, self.dtype)
        return self._oos_cache

    def model_OOS_r2(self) -> np.ndarray:
        return self._oos_eval()[0].cpu().numpy()

    def model_OOS_RMSE(self) -> np.ndarray:
        return self._oos_eval()[1].cpu().numpy()

    # ------------------------------------------------------------ strategy
    def ante(self, rf, window: Optional[int] = None) -> np.ndarray:
        """Ex-ante replication returns (``Autoencoder_encapsulate.py:133-201``).
        ``beta_mode='first'`` (the reference) reuses the first window's
        beta and normalization for every month; ``'rolling'`` uses each
        window's own."""
        window = window or self.cfg.ols_window
        ante, weights = ante_weights(self.cfg, self.params, self.mask, self.x_test,
                                     self.y_test, rf, window)
        self._strat_weights = weights
        self._ante = ante
        self.window = window
        self.oos_hfd = self.y_test[-weights.shape[0]:]
        return ante.cpu().numpy()

    def post(self, factor_etf_full) -> np.ndarray:
        """Ex-post returns net of costs (``Autoencoder_encapsulate.py:203-208``),
        the costs from the full factor panel's trailing P + window months."""
        if self._ante is None:
            raise RuntimeError("ante() first")
        p = self._ante.shape[0]
        panel = _tensor(factor_etf_full, self.device)
        with torch.no_grad():
            self._post = costs.ex_post_return(self._ante, self.window,
                                              self._strat_weights.permute(2, 0, 1),
                                              panel[-(p + self.window):])
        return self._post.cpu().numpy()

    def turnover(self) -> np.ndarray:
        """Annualized turnover per strategy (``Autoencoder_encapsulate.py:210-224``)."""
        if self._strat_weights is None:
            raise RuntimeError("ante() first")
        return costs.turnover(self._strat_weights).cpu().numpy()
