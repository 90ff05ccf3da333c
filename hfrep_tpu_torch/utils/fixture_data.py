"""Deterministic fabricated-data builders (``hfrep_tpu/utils/fixture_data.py``).

Each builder consumes its numpy generator in the JAX package's pinned
order, so every array and file is that module's bit for bit.  numpy and
the standard library only: :func:`write_cleaned_fixture` writes its CSVs
with the ``csv`` module in pandas' ``to_csv`` layout (the card machine
has no pandas), and :func:`scaled_panel` scales with the port's scaler on
the CPU.
"""

from __future__ import annotations

import calendar
import csv
import datetime
from pathlib import Path
from typing import Tuple

import numpy as np


def low_rank_returns(g: np.random.Generator, rows: int, feats: int,
                     rank: int = 3) -> np.ndarray:
    """``rank`` latent factors mixed into ``feats`` observed columns plus
    idiosyncratic noise, scaled to monthly-return magnitude.  Consumes
    ``g`` in the pinned order (z, mix, noise)."""
    z = g.normal(size=(rows, rank))
    return (z @ g.normal(size=(rank, feats))
            + 0.05 * g.normal(size=(rows, feats))).astype(np.float32) * 0.02


def scaled_panel(rows: int, feats: int, *, seed: int, rank: int = 3):
    """The MinMax-scaled low-rank panel as a float32 CPU tensor (the serve
    fixture's training panel is ``seed + 17``)."""
    import torch

    from hfrep_tpu_torch.core import scaler as mm

    x = low_rank_returns(np.random.default_rng(seed), rows, feats, rank)
    _, scaled = mm.fit_transform(torch.from_numpy(x))
    return scaled


def keyed_scaled_panel(stream_seed: int, source_idx: int, seq: int,
                       rows: int, feats: int, rank: int = 3) -> np.ndarray:
    """The numpy-scaled low-rank panel of a (stream, source, seq)
    coordinate: unique per coordinate, reproducible anywhere."""
    g = np.random.default_rng((stream_seed, source_idx, seq))
    x = low_rank_returns(g, rows, feats, rank)
    lo, hi = x.min(axis=0), x.max(axis=0)
    scale = np.where(hi - lo == 0.0, 1.0, hi - lo)
    return ((x - lo) / scale).astype(np.float32)


def _month_ends(start: datetime.date, months: int) -> list:
    """``pd.date_range(start, periods=months, freq="ME")`` as ISO dates,
    ``start`` a month end."""
    out, y, m = [], start.year, start.month
    for _ in range(months):
        out.append(datetime.date(y, m, calendar.monthrange(y, m)[1]).isoformat())
        y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    return out


def _write_frame(path: Path, dates: list, cols: list, vals: np.ndarray) -> None:
    """``DataFrame(vals, columns=cols)`` with a leading ``Date`` column,
    written as ``to_csv(path, index=False)`` writes it."""
    from hfrep_tpu_torch.experiments.sweep import _cells

    cells = [_cells(vals[:, j]) for j in range(vals.shape[1])]
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(["Date"] + list(cols))
        for i, d in enumerate(dates):
            w.writerow([d] + [c[i] for c in cells])


def write_cleaned_fixture(d, months: int = 96, seed: int = 5) -> None:
    """A fabricated ``cleaned_data/`` directory shaped like the real one
    (22 factors, 13 HF indices, 1 rf, a Date column), loadable by
    ``core.data.load_panel``; the JAX package's files byte for byte."""
    from hfrep_tpu_torch.core.data import dic_save

    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    g = np.random.default_rng(seed)
    dates = _month_ends(datetime.date(2000, 1, 31), months)
    fac = [f"F{j}" for j in range(22)]
    hf = [f"H{j}" for j in range(13)]
    mix = g.normal(size=(22, 13)) * 0.3
    x = g.normal(0, 0.03, (months, 22))
    y = x @ mix + g.normal(0, 0.01, (months, 13))
    for name, cols, vals in (
            ("factor_etf_data.csv", fac, x),
            ("hfd.csv", hf, y),
            ("rf.csv", ["RF"], np.abs(g.normal(0.002, 5e-4, (months, 1))))):
        _write_frame(d / name, dates, cols, vals.astype(np.float32))
    dic_save({c: c for c in hf}, d / "hfd_fullname.pkl")
    dic_save({c: c for c in fac}, d / "factor_etf_name.pkl")


def fund_cross_section(factors: np.ndarray, seed: int,
                       funds: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(hfd, rf)`` for any factor panel: the fund mix and noise stream is
    seeded apart from the factor values, so swapping the factor source
    leaves the cross-section's construction unchanged."""
    months, n_factors = factors.shape
    g_mix = np.random.default_rng((seed, months, funds, 1))
    mix = (g_mix.normal(size=(n_factors, funds)) * 0.3).astype(np.float32)
    hfd = (factors @ mix
           + 0.01 * g_mix.normal(size=(months, funds))).astype(np.float32)
    rf = np.abs(g_mix.normal(0.002, 5e-4, months)).astype(np.float32)
    return hfd, rf


def universe_arrays(seed: int, funds: int, months: int, n_factors: int = 22,
                    rank: int = 4) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A synthetic ``(factors, hfd, rf)`` universe of any size."""
    g_fac = np.random.default_rng((seed, months, n_factors, 0))
    factors = low_rank_returns(g_fac, months, n_factors, rank)
    hfd, rf = fund_cross_section(factors, seed, funds)
    return factors, hfd, rf
