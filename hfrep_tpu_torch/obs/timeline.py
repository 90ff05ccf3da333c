"""Block-boundary timing (``BlockTimer`` of ``hfrep_tpu/obs/timeline.py``).

The JAX module is also the wall-clock ledger (windows, categories,
overlap); the port has only the timer so far.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from hfrep_tpu_torch.core.device import DeviceLike


class BlockTimer:
    """Device-synced step timing: one sample a window, ``(n_steps,
    seconds, warmup)``, and a warmup-aware :attr:`steps_per_sec`.

    On a card :meth:`stop` calls ``torch.cuda.synchronize`` first, so a
    window holds the device work enqueued in it and not just its
    launches."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = torch.device("cuda" if device is None else device)
        self.samples: List[tuple] = []      # (n_steps, secs, warmup)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, warmup: bool = False) -> float:
        """Close one window.  ``warmup=True`` marks a sample that carries
        a first call's build (excluded from :attr:`steps_per_sec` when
        steady samples exist)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self.samples.append((n_steps, dt, warmup))
        return dt

    @property
    def steps_per_sec(self) -> float:
        """Steady-state rate (warmup samples excluded when possible);
        ``nan`` on zero-duration windows rather than dividing by zero."""
        steady = [(n, t) for n, t, w in self.samples if not w]
        samples = steady or [(n, t) for n, t, _ in self.samples]
        steps = sum(n for n, _ in samples)
        secs = sum(t for _, t in samples)
        return steps / secs if secs > 0.0 else float("nan")
