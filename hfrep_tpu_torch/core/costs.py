"""Transaction-cost and price-impact model (``hfrep_tpu/core/costs.py``).

Ports of ``helper.py:65-131``:

* ``transaction_cost``: ``0.5 * dx**2 * sigma * param``, sigma the
  per-asset vol of the rolling covariance's diagonal (``helper.py:65-80``);
* ``price_impact``: ``phi * x_new * sigma * dx - x_old * sigma * dx -
  0.5 * dx**2 * sigma`` (``helper.py:83-92``), dx = x_old - x_new;
* ``ex_post_return``: the reference's nested host loop (strategies ×
  months × a fresh ``.cov()`` each) as one batched expression.

Every function takes leading batch dims (a lane grid) in front of the
reference's shapes; the panels (``factor_etf``) are shared by the lanes.
"""

from __future__ import annotations

import torch


def transaction_cost(old_x, new_x, cov_diag_vol, param: float = 0.05):
    """``0.5 * dx**2 * (vol * param)`` per asset; ``cov_diag_vol`` is
    sqrt(diag(cov))."""
    delta = torch.as_tensor(old_x) - torch.as_tensor(new_x)
    return 0.5 * delta ** 2 * (cov_diag_vol * param)


def price_impact(old_x, new_x, cov_diag_vol, param: float = 0.05, phi: float = 0.5):
    """phi-model price impact (``helper.py:83-92``)."""
    old_x = torch.as_tensor(old_x)
    new_x = torch.as_tensor(new_x)
    scaled_vol = cov_diag_vol * param
    delta = old_x - new_x
    return (phi * new_x * scaled_vol * delta - old_x * scaled_vol * delta
            - 0.5 * delta ** 2 * scaled_vol)


def rolling_cov_diag_vol(panel: torch.Tensor, window: int) -> torch.Tensor:
    """sqrt(diag(cov)) of every length-``window`` slice of a (T, F) panel:
    (T - window + 1, F), row ``i`` covering ``panel[i : i + window]``; the
    unbiased variance (ddof=1), as pandas ``.cov()``."""
    windows = panel.unfold(0, window, 1)                 # (N, F, window)
    return torch.sqrt(torch.var(windows, dim=-1, correction=1))


def ex_post_return(ex_ante: torch.Tensor, window: int, strat_weights: torch.Tensor,
                   factor_etf: torch.Tensor, param: float = 0.05,
                   phi: float = 0.5) -> torch.Tensor:
    """Ex-ante returns plus each month's cost penalty (``helper.py:112-131``).

    ``ex_ante`` (..., P, S); ``strat_weights`` (..., S, P, A), each
    strategy's ETF weights per month; ``factor_etf`` (P + window, A), the
    OOS panel with the first covariance window.  Month 0 carries no
    penalty; month ``i >= 1`` adds the penalty of the weight change from
    month ``i-1`` under the vols of ``factor_etf[i : i + window]``: P - 1
    penalties for P months, as the reference's loop range gives."""
    p = ex_ante.shape[-2]
    vols = rolling_cov_diag_vol(factor_etf, window)       # (P+1, A)
    v = vols[1:p][:, None, :]                             # (P-1, 1, A)
    by_month = strat_weights.transpose(-3, -2)            # (..., P, S, A)
    new_w = by_month[..., 1:p, :, :]
    old_w = by_month[..., 0:p - 1, :, :]
    tc = transaction_cost(old_w, new_w, v, param)
    pi = price_impact(old_w, new_w, v, param, phi)
    penalty = torch.sum(tc + pi, dim=-1)                  # (..., P-1, S)
    return torch.cat([ex_ante[..., :1, :], ex_ante[..., 1:, :] + penalty], dim=-2)


def normalization(y: torch.Tensor, x: torch.Tensor, beta: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Volatility-matching factor (``helper.py:10-17``): sqrt(Var(Y)) /
    sqrt(Var(X @ beta)) per column over the rows (dim -2), with the
    reference's ``window - 1`` denominator."""
    r_hat = x @ beta
    den = torch.sum((r_hat - torch.mean(r_hat, dim=-2, keepdim=True)) ** 2 / (window - 1),
                    dim=-2)
    num = torch.sum((y - torch.mean(y, dim=-2, keepdim=True)) ** 2 / (window - 1), dim=-2)
    return torch.sqrt(num) / torch.sqrt(den)


def turnover(strat_weights: torch.Tensor) -> torch.Tensor:
    """Mean annualized sum of |w_t - w_{t+1}| per strategy
    (``Autoencoder_encapsulate.py:210-224``): ``strat_weights`` (..., P, A,
    S), months × ETFs × strategies → (..., S)."""
    diffs = torch.sum(torch.abs(strat_weights[..., :-1, :, :] - strat_weights[..., 1:, :, :]),
                      dim=(-3, -2))
    return diffs / (strat_weights.shape[-3] / 12.0)
