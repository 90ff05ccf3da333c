"""Structured per-epoch metric logging: JSONL plus the reference's echo
(``hfrep_tpu/obs/metriclog.py``).

The console formatter reproduces the reference's print lines for
eyeball comparison, including the WGAN quirk of printing ``1 − d_loss``
(``GAN/WGAN.py:208``) while WGAN-GP prints raw losses.  With telemetry
on, every record is also forwarded into the obs event stream as
``train/<key>`` gauges: one logging call site, two sinks.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import IO, Mapping, Optional

import numpy as np
import torch

from hfrep_tpu_torch.obs import get_obs


def _to_py(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        return np.asarray(v).item() if np.ndim(v) == 0 else np.asarray(v).tolist()
    return v


class MetricLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False,
                 echo_style: Optional[str] = None):
        """``echo_style`` in {None, "gan", "wgan", "wgan_gp"} reproduces
        the reference's console format for that family."""
        self.path = Path(path) if path else None
        self._fh: Optional[IO] = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        self.echo = echo
        self.echo_style = echo_style
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: Mapping[str, object]) -> None:
        rec = {"step": int(step), "t": time.perf_counter() - self._t0}
        rec.update({k: _to_py(v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        obs = get_obs()
        if obs.enabled:
            for k, v in rec.items():
                if k not in ("step", "t") and isinstance(v, (int, float)):
                    obs.gauge(f"train/{k}").set(v, step=int(step))
        if self.echo:
            print(self.format_line(step, rec))

    def format_line(self, step: int, m: Mapping) -> str:
        d, g = m.get("d_loss", float("nan")), m.get("g_loss", float("nan"))
        if self.echo_style == "gan":      # GAN/GAN.py:201
            return "%d [D loss: %f, acc.: %.2f%%] [G loss: %f]" % (step, d, 100 * m.get("d_acc", 0.0), g)
        if self.echo_style == "wgan":     # GAN/WGAN.py:208 prints 1 - loss
            return "%d [D loss: %f] [G loss: %f]" % (step, 1 - d, 1 - g)
        if self.echo_style == "wgan_gp":  # GAN/MTSS_WGAN_GP.py:284
            return "%d [D loss: %f] [G loss: %f]" % (step, d, g)
        return f"{step} " + " ".join(f"{k}={v}" for k, v in m.items() if k not in ("step", "t"))

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        """Idempotent: an error path may close an already-closed logger."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
