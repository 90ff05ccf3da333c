"""Reporting: the stats table (``hfrep_tpu/experiments/report.py``;
``autoencoder_v4.ipynb`` cells 23-38), written with ``csv``.

Not ported yet (ROADMAP): the three plots (``multiplot``,
``ae_loss_curves``, ``omega_curve_grid``), which need matplotlib.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from hfrep_tpu_torch.experiments.sweep import write_table
from hfrep_tpu_torch.replication import perf_stats


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
