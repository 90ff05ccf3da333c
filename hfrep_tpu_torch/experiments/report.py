"""Reporting: the stats table and the report charts
(``hfrep_tpu/experiments/report.py``; ``autoencoder_v4.ipynb`` cells
23-38).

The table is written with ``csv``.  The charts (:func:`multiplot`,
:func:`ae_loss_curves`, :func:`omega_curve_grid`) are offline PNGs drawn
with matplotlib under its ``Agg`` backend, imported inside the function
that draws: the card's machine has no matplotlib, and only ``sweep
--plots`` draws.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from hfrep_tpu_torch.experiments.sweep import write_table
from hfrep_tpu_torch.replication import perf_stats


def _panel_grid(n_panels: int, ncols: int, panel_size: tuple, draw, path: str) -> str:
    """Lay out ``n_panels`` axes, call ``draw(ax, j)`` on each, blank the
    leftovers, save to ``path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nrows = -(-n_panels // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(panel_size[0] * ncols, panel_size[1] * nrows),
                             squeeze=False)
    for j in range(nrows * ncols):
        ax = axes[j // ncols][j % ncols]
        if j >= n_panels:
            ax.axis("off")
            continue
        draw(ax, j)
        ax.legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def multiplot(replication: np.ndarray, actual: np.ndarray, names: Sequence[str],
              path: str, ncols: int = 3, labels: tuple = ("replication", "actual"),
              ante: Optional[np.ndarray] = None,
              ante_label: str = "replication (ex-ante)",
              reference_compat: bool = False) -> str:
    """Cumulative-return grid, one panel a strategy (cell 38): replicated
    against actual index, compounded from monthly returns; ``ante`` adds
    the ex-ante series of ``Autoencoder_encapsulate.py:226-243``.
    ``reference_compat`` draws the reference's ``np.cumsum`` of raw
    returns instead of compounding."""
    cum = ((lambda r: np.cumsum(r)) if reference_compat
           else (lambda r: np.cumprod(1.0 + r) - 1.0))
    replication, actual = np.asarray(replication), np.asarray(actual)

    def draw(ax, j):
        # colours pinned a series, so the optional ante line takes no slot
        if ante is not None:
            ax.plot(cum(np.asarray(ante)[:, j]), label=ante_label, linestyle="--", color="C2")
        ax.plot(cum(replication[:, j]), label=labels[0], color="C0")
        ax.plot(cum(actual[:, j]), label=labels[1], color="C1")
        ax.set_title(names[j], fontsize=9)

    return _panel_grid(replication.shape[1], ncols, (4.2, 3.0), draw, path)


def ae_loss_curves(train_loss: np.ndarray, val_loss: np.ndarray,
                   latent_dims: Sequence[int], path: str, ncols: int = 4) -> str:
    """Per-latent AE train/val loss curves (``Autoencoder_encapsulate.py:97-105``);
    the traces are NaN after the early stop, so each panel ends there."""
    def draw(ax, j):
        tl, vl = np.asarray(train_loss[j]), np.asarray(val_loss[j])
        live = np.isfinite(tl)
        ax.plot(np.arange(len(tl))[live], tl[live], label="train")
        ax.plot(np.arange(len(vl))[live], vl[live], label="val")
        ax.set_title(f"latent={latent_dims[j]}", fontsize=9)
        ax.set_yscale("log")

    return _panel_grid(len(latent_dims), ncols, (3.6, 2.6), draw, path)


def omega_curve_grid(replication: np.ndarray, actual: np.ndarray, names: Sequence[str],
                     path: str, ncols: int = 3, thresholds=None,
                     labels: tuple = ("replication", "actual")) -> str:
    """Omega-ratio curves a strategy (cells 23/38): Ω(τ) of replication and
    actual index over a threshold grid."""
    thresholds = thresholds if thresholds is not None else np.linspace(0, 0.2, 50)
    rep_curves = perf_stats.omega_curve(replication, thresholds)   # (T, S)
    act_curves = perf_stats.omega_curve(actual, thresholds)

    def draw(ax, j):
        ax.plot(thresholds, rep_curves[:, j], label=labels[0])
        ax.plot(thresholds, act_curves[:, j], label=labels[1])
        ax.set_title(names[j], fontsize=9)
        ax.set_xlabel("threshold", fontsize=7)

    return _panel_grid(np.asarray(replication).shape[1], ncols, (4.2, 3.0), draw, path)


@dataclasses.dataclass
class StatsTable:
    """One row a strategy, one column a statistic."""

    index: List[str]
    columns: Dict[str, np.ndarray]

    def to_csv(self, path: str) -> None:
        """pandas' ``DataFrame.to_csv`` layout, an unnamed index."""
        write_table(path, None, self.index, self.columns)


def stats_table(returns, names: Sequence[str], rf=None,
                ff3_path: Optional[str] = None, ff5_path: Optional[str] = None,
                span=None, start: str = "1994-04-30",
                end: str = "2022-04-30") -> StatsTable:
    """The notebook's ``data_analysis`` battery: Omega, Sharpe, cVaR, CEQ,
    skew and kurtosis, the FF alphas of the factor files that exist, and
    the HK/GRS spanning tests."""
    n = np.asarray(returns).shape[0]

    def aligned(path, five):
        fac = perf_stats.load_ff_factors(path, start=start, end=end, five=five).values
        if fac.shape[0] < n:
            raise ValueError(f"factor file {path} covers {fac.shape[0]} months < "
                             f"{n} return months in [{start}, {end}]")
        return fac[-n:]

    three = aligned(ff3_path, False) if ff3_path and os.path.exists(ff3_path) else None
    five = aligned(ff5_path, True) if ff5_path and os.path.exists(ff5_path) else None
    cols = perf_stats.data_analysis(returns, rf=rf, three_factor=three, five_factor=five,
                                    span=span)
    return StatsTable(index=list(names), columns=cols)
