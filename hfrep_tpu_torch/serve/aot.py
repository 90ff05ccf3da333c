"""Serving programs, shape buckets and the program LRU (``hfrep_tpu/serve/aot.py``).

* **padded-shape buckets** — tenant panels arrive with arbitrary row
  counts; requests are padded up to a small fixed ladder of row buckets
  (zero rows after the true tail plus an ``n_rows`` operand the program
  masks by), so one program serves every tenant whose shape falls in the
  bucket;
* **programs built ahead of traffic** (:func:`aot_compile`) — each
  bucket's program is exported at its static shapes with
  ``torch.export``, saved into a buffer and loaded back, the artifact a
  model registry could ship, whose LSTM layers are the hand kernel's
  dispatcher op ``hfrep::lstm_fwd``
  (:func:`~hfrep_tpu_torch.ops.cuda_lstm.lstm_fwd_op`); where the export
  fails, the eager program serves instead (mode ``"compiled"``).  Either
  way the program runs once on the bucket's operands before traffic,
  which builds the CUDA kernels and warms the allocator outside the
  request path;
* **LRU of programs + device-resident weights** — model weights move to
  the device once, at registration, and reach every bucket's program as
  its first operand (``model.params``), so one device copy serves every
  bucket and no loaded program holds one of its own; programs live in a
  bounded least-recently-used cache whose builds are visible to the
  circuit breaker.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import io
import sys
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree

from hfrep_tpu_torch.config import AEConfig, ModelConfig
from hfrep_tpu_torch.core.device import DeviceLike, dtype_of, resolve_device
from hfrep_tpu_torch.models.autoencoder import Autoencoder, latent_mask

#: default row-bucket ladder (tenant panels up to 512 rows)
DEFAULT_ROW_BUCKETS = (32, 64, 128, 256, 512)


class BucketError(ValueError):
    """A request shape no bucket covers (rows beyond the ladder)."""


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n — the padded shape the request runs at."""
    for b in buckets:
        if n <= b:
            return int(b)
    raise BucketError(f"{n} rows exceeds the largest serve bucket "
                      f"{max(buckets)}; raise ServeConfig.row_buckets")


def torch_export_supported() -> bool:
    """Does this torch carry ``torch.export``'s export / save / load?"""
    try:
        from torch import export
    except ImportError:
        return False
    return all(hasattr(export, n) for n in ("export", "save", "load"))


class Program:
    """A bucket's built program: called with the bucket's operands, it runs
    under ``inference_mode``; ``mode`` is ``"export"`` (a loaded
    ``torch.export`` program) or ``"compiled"`` (the eager function).
    ``exported`` is the loaded ``ExportedProgram`` itself (``None`` in mode
    ``"compiled"``): its graph and signature are what the program audit
    reads (:mod:`hfrep_tpu_torch.analysis.programs`)."""

    def __init__(self, fn: Callable, mode: str, exported=None):
        self.fn, self.mode, self.exported = fn, mode, exported

    def __call__(self, *args):
        with torch.inference_mode():
            return self.fn(*args)


class _Exportable(nn.Module):
    """A batch function as a module with no state of its own: the served
    weights are an operand, so the exported program holds no copy."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _run_once(program: Program, example_args: tuple) -> None:
    program(*example_args)
    for t in _pytree.tree_leaves(example_args):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            break


def aot_compile(fn: Callable, *example_args, via_export: bool = True,
                label: Optional[str] = None) -> Tuple[Program, str]:
    """Build a bucket's program ahead of traffic; returns ``(program,
    mode)``.

    With ``via_export`` (and :func:`torch_export_supported`): ``fn`` is
    exported at the example operands' static shapes (``torch.export``),
    saved into a buffer and loaded back, mode ``"export"``.  A failure
    there is printed on stderr and the eager ``fn`` serves instead, mode
    ``"compiled"``, as it does without ``via_export``: serving comes up on
    every runtime, and callers that need the export check the mode.
    Either way the program runs once on the example operands and the
    device is synchronised before this returns, so the kernels' build
    and the allocator's first blocks stay out of the request path.

    ``label`` opts the bucket into the perf microscope: with telemetry on,
    the kernel libraries loaded by then are fingerprinted at the
    ``<label>:<mode>`` boundary (``program_profile`` events and
    ``run.json`` ``programs`` entries, :mod:`hfrep_tpu_torch.obs.attrib`),
    at build time only, never on the request path."""
    program = None
    if via_export and torch_export_supported():
        try:
            exported = torch.export.export(_Exportable(fn), tuple(example_args),
                                           strict=False)
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            buf.seek(0)
            loaded = torch.export.load(buf)
            program = Program(loaded.module(), "export", loaded)
            _run_once(program, example_args)
        except Exception as e:          # any failure: serve the eager program
            print(f"serve: {label or 'program'}: torch.export round trip failed "
                  f"({type(e).__name__}: {e}); serving the eager program", file=sys.stderr)
            program = None
    if program is None:
        program = Program(fn, "compiled")
        _run_once(program, example_args)
    if label:
        from hfrep_tpu_torch.obs import attrib
        attrib.profile_boundary(f"{label}:{program.mode}")
    return program, program.mode


# ------------------------------------------------------------ serve models
@dataclasses.dataclass(frozen=True)
class AEServeModel:
    """The replication head, weights resident on ``device``.

    ``module`` is the :class:`Autoencoder` holding the engine's
    ``{encoder_kernel, decoder_kernel}``; ``mask`` the optional latent
    mask of the lane served.  ``decoder_host`` is the one host copy of
    the replication weights every response carries, fetched at
    registration and not per request.
    """

    cfg: AEConfig
    module: Autoencoder
    decoder_host: np.ndarray
    mask: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.module.encoder_kernel.device

    @functools.cached_property
    def params(self) -> dict:
        """The head's weights by name, the device tensors themselves (built
        once, shared by every dispatch): the first operand of
        :func:`ae_batch_fn`."""
        return _params(self.module)

    @classmethod
    def create(cls, cfg: AEConfig, params: Optional[dict] = None, mask=None,
               device: DeviceLike = None,
               generator: Optional[torch.Generator] = None) -> "AEServeModel":
        """``params`` is the JAX package's ``{encoder_kernel,
        decoder_kernel}`` as arrays; ``None`` keeps the Keras-default
        init drawn from ``generator``."""
        from hfrep_tpu_torch.utils.bridge import from_flax

        dev = resolve_device(device)
        dt = None if cfg.dtype in (None, "float32") else dtype_of(cfg.dtype)
        ae = Autoencoder(n_features=cfg.n_factors, latent_dim=cfg.latent_dim,
                         slope=cfg.leaky_slope, dtype=dt, device=dev,
                         generator=generator)
        if params is not None:
            from_flax(params, ae)
        ae.eval().requires_grad_(False)
        m = None if mask is None else torch.as_tensor(
            np.asarray(mask, np.float32)).to(dev)
        host = ae.decoder_kernel.detach().cpu().numpy()
        return cls(cfg=cfg, module=ae, decoder_host=host, mask=m)


@dataclasses.dataclass(frozen=True)
class GenServeModel:
    """A GAN generator (any family), weights resident on the device."""

    cfg: ModelConfig
    module: nn.Module

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @functools.cached_property
    def params(self) -> dict:
        """The generator's weights by name, built once (:func:`gen_batch_fn`'s
        first operand)."""
        return _params(self.module)

    @classmethod
    def create(cls, cfg: ModelConfig, params: Optional[dict] = None,
               device: DeviceLike = None,
               generator: Optional[torch.Generator] = None) -> "GenServeModel":
        """``params`` is the JAX package's generator param tree as arrays;
        ``None`` keeps the Keras-default init drawn from ``generator``."""
        from hfrep_tpu_torch.models.registry import build_generator
        from hfrep_tpu_torch.utils.bridge import from_flax

        gen = build_generator(cfg, device=resolve_device(device),
                              generator=generator)
        if params is not None:
            from_flax(params, gen)
        return cls(cfg=cfg, module=gen.eval().requires_grad_(False))


def _params(module: nn.Module) -> dict:
    return {k: p.detach() for k, p in module.named_parameters()}


# ------------------------------------------------------- batch programs
def ae_batch_fn(model: AEServeModel) -> Callable:
    """The AE replication program one (batch, rows) bucket runs, the JAX
    program's signature: ``fn(params, x (B, T, F), n_rows (B,), mask)`` →
    ``(recon (B, T, F), err (B,))``, ``params`` the head's weights
    (``model.params``).  Each request's panel is MinMax-scaled with its own
    masked column ranges (rows past ``n_rows`` excluded), encoded and
    decoded through the head, and scored with a row-masked reconstruction
    MSE.  The JAX program's ``vmap`` over requests is the leading batch
    axis."""
    ae = model.module

    def batch(params: dict, x: torch.Tensor, n_rows: torch.Tensor, mask):
        t = x.shape[1]
        rows = (torch.arange(t, device=x.device)[None, :] < n_rows[:, None]
                ).to(torch.float32)[..., None]                    # (B, T, 1)
        n = torch.clamp(n_rows.to(torch.float32), min=1.0)
        # masked per-column min/max over the true rows only: padding
        # zeros must not widen a tenant's scale range
        big = torch.tensor(3.4e38, dtype=torch.float32, device=x.device)
        mins = torch.where(rows > 0, x, big).amin(dim=1, keepdim=True)
        maxs = torch.where(rows > 0, x, -big).amax(dim=1, keepdim=True)
        scale = torch.where(maxs - mins == 0.0, torch.ones_like(maxs), maxs - mins)
        scaled = (x - mins) / scale * rows
        recon = torch.func.functional_call(ae, params, (scaled, mask))
        err = torch.sum(torch.mean((recon - scaled) ** 2, dim=2) * rows[..., 0],
                        dim=1) / n
        return recon * rows, err

    return batch


def gen_batch_fn(model: GenServeModel) -> Callable:
    """The generator sampling program: ``fn(params, noise (B, W, F))`` →
    (B, W, F) windows in scaler space, ``params`` the generator's weights
    (``model.params``)."""
    gen = model.module

    def batch(params: dict, noise: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(gen, params, (noise,))

    return batch


# ---------------------------------------------------------------- the LRU
class ProgramCache:
    """Bounded LRU of built programs.

    Keys are ``(kind, batch, bucket)`` tuples; values the callables.
    ``get_or_compile`` is the only entry point: a hit refreshes recency;
    a miss builds under the lock and reports the build to ``on_compile``
    (the circuit breaker's compile-storm signal).
    """

    def __init__(self, capacity: int = 8,
                 on_compile: Optional[Callable[[], None]] = None):
        self.capacity = max(1, int(capacity))
        self.on_compile = on_compile
        #: True while an intentional pre-traffic warm() fills the grid:
        #: those builds must not count toward the compile-storm signal
        self.warming = False
        self._lock = threading.Lock()
        self._programs: "OrderedDict[tuple, Callable]" = OrderedDict()
        self.compiles = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def programs(self) -> dict:
        """The resident programs by key, least recently used first."""
        with self._lock:
            return dict(self._programs)

    def modes(self) -> dict:
        """The resident programs counted by build mode (``Program.mode``)."""
        return dict(collections.Counter(getattr(fn, "mode", "compiled")
                                        for fn in self.programs().values()))

    def get_or_compile(self, key: tuple, build: Callable[[], Callable]):
        with self._lock:
            fn = self._programs.get(key)
            if fn is not None:
                self._programs.move_to_end(key)
                return fn
            fn = build()
            self.compiles += 1
            self._programs[key] = fn
            evicted = None
            if len(self._programs) > self.capacity:
                evicted, _ = self._programs.popitem(last=False)
                self.evictions += 1
        if self.on_compile is not None and not self.warming:
            self.on_compile()
        try:
            from hfrep_tpu_torch.obs import get_obs
            obs = get_obs()
            obs.counter("serve/compiles").inc(key=str(key))
            if evicted is not None:
                obs.event("serve_evict", key=str(evicted), capacity=self.capacity)
        except Exception:
            pass
        return fn


def pad_panel_batch(panels: Sequence[np.ndarray], batch: int, rows: int,
                    feats: int, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack request panels into the bucket's ``(batch, rows, feats)``
    operand plus the ``(batch,)`` true-row counts; empty slots are all
    padding with ``n_rows == 0``, which the masked program reduces to
    zero."""
    x = np.zeros((batch, rows, feats), np.float32)
    n = np.zeros((batch,), np.int32)
    for i, p in enumerate(panels):
        arr = np.asarray(p, np.float32)
        if arr.ndim != 2 or arr.shape[1] != feats:
            raise ValueError(f"panel {i}: want (rows, {feats}), "
                             f"got {arr.shape}")
        if arr.shape[0] > rows:
            raise ValueError(f"panel {i}: {arr.shape[0]} rows exceeds "
                             f"bucket {rows}")
        x[i, : arr.shape[0]] = arr
        n[i] = arr.shape[0]
    dev = resolve_device(device)
    return torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev)


def full_mask(cfg: AEConfig, device: DeviceLike = None) -> torch.Tensor:
    """The all-ones latent mask a full-latent AE head serves with."""
    return latent_mask(cfg.latent_dim, cfg.latent_dim, device=device)
