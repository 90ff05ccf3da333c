"""Host-side regime labeling, the condition vocabulary of the factory
(``hfrep_tpu/scenario/regimes.py``, numpy only, the same code).

A regime label is a small integer per month, computed from the *real*
panel on the host (pure numpy — labels are data preparation, not part of
any traced program): the trailing volatility of the cross-sectional mean
factor return, quantile-binned into ``n_regimes`` states (calm → stress).
Expanding windows seed the first months so every month gets a label and
the labeling is a pure function of the panel (no look-ahead beyond the
quantile thresholds, which are fit on the full labeling sample exactly
once — a scenario vocabulary, not a tradable signal).

The one-hot of a label is the condition vector the conditional GAN
concatenates into its generator input and discriminator score path
(:mod:`hfrep_tpu_torch.scenario.conditional`).
"""

from __future__ import annotations

import numpy as np


def trailing_vol(factors: np.ndarray, window: int = 12) -> np.ndarray:
    """(T,) trailing std of the cross-sectional mean return; the first
    ``window`` months use the expanding prefix (min 2 samples, month 0
    reuses month 1's value) so every month is labeled."""
    x = np.asarray(factors, dtype=np.float64)
    if x.ndim != 2 or x.shape[0] < 2:
        raise ValueError(f"factors must be (T>=2, F), got {x.shape}")
    mean_ret = x.mean(axis=1)
    t = mean_ret.shape[0]
    vol = np.empty(t, dtype=np.float64)
    for i in range(1, t):
        lo = max(0, i + 1 - window)
        vol[i] = mean_ret[lo:i + 1].std()
    vol[0] = vol[1]
    return vol


def label_regimes(factors: np.ndarray, window: int = 12,
                  n_regimes: int = 3) -> np.ndarray:
    """(T,) int32 regime labels: trailing-vol quantile bins, 0 = calmest.

    Deterministic pure function of ``(factors, window, n_regimes)``; the
    quantile edges come from the labeling sample itself, so every regime
    is populated (ties broken toward the lower regime, numpy
    ``searchsorted`` semantics).
    """
    if n_regimes < 2:
        raise ValueError(f"n_regimes must be >= 2, got {n_regimes}")
    vol = trailing_vol(factors, window)
    edges = np.quantile(vol, np.linspace(0.0, 1.0, n_regimes + 1)[1:-1])
    return np.searchsorted(edges, vol, side="right").astype(np.int32)


def one_hot(labels, n_regimes: int) -> np.ndarray:
    """(T, n_regimes) float32 condition vectors from integer labels."""
    lab = np.asarray(labels, dtype=np.int64).reshape(-1)
    if lab.size and (lab.min() < 0 or lab.max() >= n_regimes):
        raise ValueError(f"labels outside [0, {n_regimes}): "
                         f"[{lab.min()}, {lab.max()}]")
    out = np.zeros((lab.shape[0], n_regimes), dtype=np.float32)
    out[np.arange(lab.shape[0]), lab] = 1.0
    return out


def window_conditions(labels: np.ndarray, window: int,
                      n_regimes: int) -> np.ndarray:
    """(T-window+1, n_regimes) one-hot conditions for sliding training
    windows: each window is conditioned on the regime of its LAST month
    (the state the window ends in is the state a sampled continuation
    should be conditioned on)."""
    lab = np.asarray(labels).reshape(-1)
    if lab.shape[0] < window:
        raise ValueError(f"{lab.shape[0]} labels < window {window}")
    return one_hot(lab[window - 1:], n_regimes)


def regime_counts(labels: np.ndarray, n_regimes: int) -> np.ndarray:
    """(n_regimes,) months per regime — the bank CLI's summary line."""
    return np.bincount(np.asarray(labels).reshape(-1),
                       minlength=n_regimes).astype(np.int64)
