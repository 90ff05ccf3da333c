"""Rolling-window linear algebra, batched (``hfrep_tpu/ops/rolling.py``).

The reference runs a 24-month rolling OLS as 143 sequential
``statsmodels.OLS(Y, X).fit()`` calls (``Autoencoder_encapsulate.py:148-157``)
and refits a MinMax scaler per expanding window (``:115-131``).  Here
every window is one slice of a batch and solved together.

Every pseudo-inverse takes JAX's cutoff, ``rtol = 10 * max(m, n) * eps``
(:func:`pinv`), not torch's default ``max(m, n) * eps``: a masked latent
lane's normal matrix is singular, and the two cutoffs keep different
singular values of it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pinv(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.pinv``: singular values at or below
    ``10 * max(m, n) * eps(dtype)`` times the largest are dropped."""
    m, n = a.shape[-2], a.shape[-1]
    return torch.linalg.pinv(a, rtol=10.0 * max(m, n) * torch.finfo(a.dtype).eps)


def _window_stack(x: torch.Tensor, window: int) -> torch.Tensor:
    """(..., T, F) → (..., T - window + 1, window, F) sliding windows."""
    if x.shape[-2] < window:
        raise ValueError(f"{x.shape[-2]} rows are fewer than a window of {window}")
    return x.unfold(-2, window, 1).transpose(-1, -2)


def rolling_ols_beta(y: torch.Tensor, x: torch.Tensor, window: int) -> torch.Tensor:
    """Rolling no-intercept OLS betas for every window start: ``y`` (T, S),
    ``x`` (..., T, K) → (..., T - window + 1, K, S), slice ``i`` regressing
    ``y[i:i+window]`` on ``x[i:i+window]`` by the normal equations and
    :func:`pinv` (as statsmodels' OLS with no constant)."""
    xw = _window_stack(x, window)                   # (..., N, W, K)
    yw = _window_stack(y, window)                   # (N, W, S)
    xtx = xw.transpose(-1, -2) @ xw
    xty = xw.transpose(-1, -2) @ yw
    return pinv(xtx) @ xty


def ols_beta(y: torch.Tensor, x: torch.Tensor, add_constant: bool = False) -> torch.Tensor:
    """One OLS fit via :func:`pinv`; with ``add_constant`` the intercept is
    row 0, as ``sm.add_constant`` puts it (``autoencoder_v4.ipynb`` cell 23)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"want (T, K) and (T, S), got {tuple(x.shape)} and {tuple(y.shape)}")
    if add_constant:
        x = torch.cat([torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device), x], dim=1)
    return pinv(x.T @ x) @ (x.T @ y)


def expanding_minmax_scale(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row i holds the column min and max of ``x[:i+1]`` (every prefix's
    MinMax params at once), each (T, F); exact, so equal to JAX's bit for
    bit."""
    return torch.cummin(x, dim=0).values, torch.cummax(x, dim=0).values
