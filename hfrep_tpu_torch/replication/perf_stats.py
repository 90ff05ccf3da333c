"""Performance statistics, the notebook's ``data_analysis`` battery
(``hfrep_tpu/replication/perf_stats.py``).

Ports of ``autoencoder_v4.ipynb`` cell 23: Omega ratio and curve,
annualized Sharpe, FF3/FF5 OLS alpha, historical VaR/CVaR and CEQ,
assembled into a per-strategy table with the spanning tests of
:mod:`hfrep_tpu_torch.replication.spanning`.  Nothing here imports
pandas: the French factor files are read with ``csv`` and ``datetime``.

Reference quirks kept (each at its function): ``omega_ratio`` converts
the annual threshold with the exponent ``sqrt(1/252)`` and applies it to
monthly series; the five-factor loader reads only Mkt-RF/SMB/HML under
``reference_compat``.
"""

from __future__ import annotations

import calendar
import csv
import datetime
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hfrep_tpu_torch.core.data import Frame
from hfrep_tpu_torch.ops.rolling import ols_beta


def _t(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """float32, on ``device`` or where ``x`` lies; numpy input is copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device if device is not None else x.device, torch.float32)


def omega_ratio(returns, threshold: float = 0.0) -> torch.Tensor:
    """Omega = sum max(r - tau, 0) / sum max(tau - r, 0) over axis 0, with
    the reference's ``tau = (threshold + 1)**sqrt(1/252) - 1`` (cell 23)."""
    tau = float((threshold + 1.0) ** np.sqrt(1.0 / 252.0) - 1.0)
    r = torch.as_tensor(returns)
    excess = r - tau
    zero = torch.zeros((), dtype=excess.dtype, device=excess.device)
    gains = torch.sum(torch.where(excess > 0, excess, zero), dim=0)
    losses = -torch.sum(torch.where(excess < 0, excess, zero), dim=0)
    return gains / losses


def omega_curve(returns, thresholds: Optional[np.ndarray] = None) -> np.ndarray:
    thresholds = thresholds if thresholds is not None else np.linspace(0, 0.2, 50)
    return np.asarray([omega_ratio(returns, t).cpu().numpy() for t in thresholds])


def annualized_sharpe(returns, rf=0.0) -> torch.Tensor:
    """(mean(ret) - mean(rf)) / std(ret) * sqrt(12) over axis 0, the
    population std as np.std (cell 23)."""
    r = torch.as_tensor(returns)
    rf_mean = torch.mean(torch.as_tensor(rf, dtype=r.dtype, device=r.device))
    return ((torch.mean(r, dim=0) - rf_mean) / torch.std(r, dim=0, correction=0)
            * float(np.sqrt(12.0)))


def ols_alpha(returns, factors) -> torch.Tensor:
    """Intercept of OLS(ret ~ const + factors) (cell 23 ``OLS_alpha``)."""
    y = torch.as_tensor(returns)
    squeeze = y.dim() == 1
    if squeeze:
        y = y[:, None]
    beta = ols_beta(y, torch.as_tensor(factors, device=y.device), add_constant=True)
    return beta[0, 0] if squeeze else beta[0]


def historical_var(returns, alpha: float = 5.0) -> np.ndarray:
    """Per-column ``np.percentile(returns, alpha)`` (cell 23)."""
    return np.percentile(_host(returns), alpha, axis=0)


def historical_cvar(returns, alpha: float = 5.0) -> np.ndarray:
    """Mean of the returns at or below the VaR quantile (cell 23)."""
    r = _host(returns)
    if r.ndim == 1:
        r = r[:, None]
    var = np.percentile(r, alpha, axis=0)
    out = np.empty(r.shape[1])
    for j in range(r.shape[1]):
        below = r[:, j] <= var[j]
        out[j] = r[below, j].mean() if below.any() else np.nan
    return out


def ceq(returns, rf, gamma: float = 2.0) -> torch.Tensor:
    """Certainty-equivalent return, CRRA gamma != 1 (cell 23 ``ceq``):
    log(mean(((1+r)/(1+rf))**(1-gamma))) / ((1-gamma)/12)."""
    if gamma == 1:
        raise ValueError("gamma must differ from 1")
    r = torch.as_tensor(returns)
    rf = torch.as_tensor(rf, dtype=r.dtype, device=r.device).reshape(
        -1, *([1] * (r.dim() - 1)))
    mid = ((1.0 + r) / (1.0 + rf)) ** (1.0 - gamma)
    return torch.log(torch.mean(mid, dim=0)) / ((1.0 - gamma) / 12.0)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ FF factors
def _month_end(year: int, month: int) -> datetime.date:
    return datetime.date(year, month, calendar.monthrange(year, month)[1])


def load_ff_factors(path, start="1994-04-30", end="2022-04-30",
                    five: bool = False, reference_compat: bool = False) -> Frame:
    """Daily French factor CSV → monthly log returns (cells 21-22), as a
    :class:`~hfrep_tpu_torch.core.data.Frame` (month-end dates, float64
    values): the daily percent returns of each calendar month summed
    (every month from the first to the last, an empty one as 0), then
    ``log(sum / 100 + 1)``, the months from ``start`` to ``end`` kept.

    ``reference_compat=True`` reads only Mkt-RF/SMB/HML even from the
    five-factor file, the notebook's ``usecols`` bug; by default the
    five-factor file gives RMW and CMA too."""
    cols = ["Mkt-RF", "SMB", "HML"]
    if five and not reference_compat:
        cols += ["RMW", "CMA"]
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh) if r]
    header = [h.strip() for h in rows[0]]
    at = [header.index(c) for c in ["Date"] + cols]
    sums: Dict[tuple, list] = {}
    for r in rows[1:]:
        d = datetime.datetime.strptime(r[at[0]].strip(), "%Y%m%d").date()
        acc = sums.setdefault((d.year, d.month), [0.0] * len(cols))
        for k, i in enumerate(at[1:]):
            acc[k] += float(r[i])
    (y, m), last = min(sums), max(sums)
    months = []
    while (y, m) <= last:
        months.append((y, m))
        y, m = (y + 1, 1) if m == 12 else (y, m + 1)
    lo, hi = (datetime.date.fromisoformat(str(s)[:10]) for s in (start, end))
    keep = [ym for ym in months if lo <= _month_end(*ym) <= hi]
    values = np.log(np.array([sums.get(ym, [0.0] * len(cols)) for ym in keep],
                             dtype=np.float64).reshape(len(keep), len(cols)) / 100.0 + 1.0)
    dates = np.array([_month_end(*ym).isoformat() for ym in keep], dtype="datetime64[D]")
    return Frame(columns=cols, dates=dates, values=values)


# ---------------------------------------------------------- full battery
def data_analysis(df, rf=None, three_factor=None, five_factor=None,
                  span=None, real_data: bool = True) -> Dict[str, np.ndarray]:
    """The notebook's per-strategy stats (cell 23 ``data_analysis``):
    Omega(0)/Omega(0.1), Sharpe, CVaR, CEQ(2/5/10), skew, kurtosis, FF
    alphas, and HK/GRS spanning stats when a spanning set is given.

    ``df`` is (T, S) returns, ``span`` (T, K) the spanning regressors
    each strategy is tested against.  Returns ``{statistic: (S,) array}``
    in the reference's column order."""
    from hfrep_tpu_torch.replication import spanning

    r = _t(df)
    t = r.shape[0]
    rf_arr = (torch.zeros((t,), device=r.device) if rf is None
              else _t(rf, r.device).reshape(-1))
    rh = r.cpu().numpy()
    out: Dict[str, np.ndarray] = {
        "Omega(0%)": omega_ratio(r, 0.0).cpu().numpy(),
        "Omega(10%)": omega_ratio(r, 0.1).cpu().numpy(),
        "Sharpe": annualized_sharpe(r, rf_arr).cpu().numpy(),
        "cVaR(95%)": historical_cvar(rh),
        "CEQ(2)": ceq(r, rf_arr, 2.0).cpu().numpy(),
        "CEQ(5)": ceq(r, rf_arr, 5.0).cpu().numpy(),
        "CEQ(10)": ceq(r, rf_arr, 10.0).cpu().numpy(),
        "Skewness": _skew(rh),
        "Kurtosis": _kurtosis(rh),
    }
    if real_data and three_factor is not None:
        out["FF3F_alpha"] = ols_alpha(r, _t(three_factor, r.device)).cpu().numpy()
    if real_data and five_factor is not None:
        out["FF5F_alpha"] = ols_alpha(r, _t(five_factor, r.device)).cpu().numpy()
    if span is not None:
        hk_f, hk_p, grs_f, grs_p = [], [], [], []
        span_t = _t(span, r.device)
        for j in range(r.shape[1]):
            f_stat, p = spanning.hktest(r[:, j:j + 1], span_t)
            hk_f.append(float(f_stat)); hk_p.append(float(p))
            f_stat, p = spanning.grstest(r[:, j:j + 1], span_t)
            grs_f.append(float(f_stat)); grs_p.append(float(p))
        out["HK_F"] = np.asarray(hk_f); out["HK_p"] = np.asarray(hk_p)
        out["GRS_F"] = np.asarray(grs_f); out["GRS_p"] = np.asarray(grs_p)
    return out


def _skew(r: np.ndarray) -> np.ndarray:
    m = r.mean(axis=0)
    s = r.std(axis=0)
    return (((r - m) / s) ** 3).mean(axis=0)


def _kurtosis(r: np.ndarray) -> np.ndarray:
    m = r.mean(axis=0)
    s = r.std(axis=0)
    return (((r - m) / s) ** 4).mean(axis=0) - 3.0


def res_sort(stats_by_latent: Dict[int, np.ndarray], strategy_names: Sequence[str]):
    """Best latent per strategy by Sharpe (cell 27 ``res_sort``): given
    {latent: sharpe (S,)}, the argmax latent and its Sharpe per strategy."""
    dims = sorted(stats_by_latent)
    mat = np.stack([stats_by_latent[d] for d in dims])       # (L, S)
    best_idx = np.argmax(mat, axis=0)
    return {
        name: {"latent": dims[best_idx[j]], "sharpe": float(mat[best_idx[j], j])}
        for j, name in enumerate(strategy_names)
    }
