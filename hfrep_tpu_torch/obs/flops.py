"""Analytic FLOPs of the MTSS-WGAN-GP training epoch and model FLOPs
utilization (``hfrep_tpu/obs/flops.py``), for the trainer's ``mfu``
gauge.

The model is the JAX package's, integer for integer (B=32, H=100,
n_critic=5; a matmul is 2mnk FLOPs):

* generator forward on b samples: ``Gf(b) = 2bW(5HF + 12H²)`` — LSTM(F→H)
  projection 4HF and recurrence 4H², LSTM(H→H) 4H² + 4H², Dense(H→F) HF;
* critic forward on b: ``Cf(b) = 2bW(4HF + 12H² + H)`` — two LSTMs and
  Flatten→Dense(WH→1);
* a critic iteration ≈ Gf(B) + 15·Cf(B) (fakes, then the loss graph with
  the penalty's input gradient and its parameter backward ≈ 3× it); the
  generator update ≈ 3(Gf(B) + Cf(B));
* an epoch ≈ 8·Gf(B) + 78·Cf(B).

These are the logical FLOPs.  The TPU package also counted "executed"
FLOPs at its 128-lane padding; the port pads to no such width, so it
counts none.

Peaks are the H100 SXM5's (the card ``nvidia-smi`` names "NVIDIA H100
80GB HBM3", 700 W), from NVIDIA's H100 Tensor Core GPU datasheet: dense
BF16 tensor 989.4 TFLOP/s, FP32 (non-tensor) 66.9 TFLOP/s.  MFU is
quoted against the BF16 peak by default, as the JAX package quotes its
own; the training kernels run f32 on the CUDA cores, so :func:`report`
prints the FP32 share as well.
"""

from __future__ import annotations

import sys

from hfrep_tpu_torch.analysis.contracts import contract

#: NVIDIA H100 SXM5 dense BF16 tensor peak (datasheet), FLOP/s
PEAK_BF16 = 989.4e12
#: NVIDIA H100 SXM5 FP32 (non-tensor) peak (datasheet), FLOP/s
PEAK_F32 = 66.9e12
#: the JAX package's own MFU denominator (``hfrep_tpu/obs/flops.py``'s
#: ``PEAK_BF16``, its TPU's bf16 peak), FLOP/s: not a number of the port's
#: card.  The obs report quotes a run the JAX package wrote against it
#: (``report.mfu_peak``), so reading such a run gives that package's MFU.
REFERENCE_PEAK_BF16 = 197e12
B, H, N_CRITIC = 32, 100, 5


def gf(b, w, f, h):
    return 2 * b * w * (5 * h * f + 12 * h * h)


def cf(b, w, f, h):
    return 2 * b * w * (4 * h * f + 12 * h * h + h)


def epoch_flops(w, f, h=H, batch=B):
    """Logical FLOPs of one flagship training epoch at (window, features,
    hidden, per-model batch)."""
    return 8 * gf(batch, w, f, h) + 78 * cf(batch, w, f, h)


def mfu(steps_per_sec: float, w: int, f: int, h: int = H, batch: int = B,
        peak: float = PEAK_BF16) -> float:
    """Model FLOPs utilization of a measured epoch rate against ``peak``;
    a rate that is not finite or not positive gives ``nan``."""
    try:
        rate = float(steps_per_sec)
    except (TypeError, ValueError):
        return float("nan")
    if not rate > 0.0 or rate != rate or rate == float("inf"):
        return float("nan")
    return epoch_flops(w, f, h, batch) * rate / peak


@contract("(N,)->(N,)")
def mfu_series(step_times, w: int, f: int, h: int = H, batch: int = B,
               peak: float = PEAK_BF16):
    """Per-step MFU from an (N,) array of per-epoch seconds."""
    import numpy as np
    dt = np.asarray(step_times, dtype=np.float64)
    flops = float(epoch_flops(w, f, h, batch))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(dt > 0.0, flops / (dt * peak), np.nan)


def report(w, f, steps_per_sec):
    logical = epoch_flops(w, f, H)
    achieved = logical * steps_per_sec
    print(f"shape ({w}, {f}) @ {steps_per_sec} steps/s:")
    print(f"  model FLOPs/epoch:    {logical/1e9:.1f} GF")
    print(f"  achieved:             {achieved/1e12:.3f} TFLOP/s")
    print(f"  MFU vs bf16 peak:     {achieved/PEAK_BF16*100:.3f}%  (H100 SXM5 dense tensor)")
    print(f"  MFU vs f32 peak:      {achieved/PEAK_F32*100:.3f}%  (CUDA cores, the kernels' path)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("usage: python -m hfrep_tpu_torch.obs.flops STEPS_PER_SEC_W48 "
              "[STEPS_PER_SEC_W168]", file=sys.stderr)
        return 2
    report(48, 35, float(argv[0]))
    if len(argv) > 1:
        report(168, 36, float(argv[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
