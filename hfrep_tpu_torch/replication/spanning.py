"""Huberman-Kandel and GRS spanning tests (``hfrep_tpu/replication/spanning.py``).

The reference runs both in R through rpy2 (``autoencoder_v4.ipynb``
cells 16-20).  Here they are closed form on tensors: R's ``mldivide``
becomes an SVD least-squares solve on demeaned data, ``pseudoinverse``
:func:`~hfrep_tpu_torch.ops.rolling.pinv` (JAX's cutoff), and HK's
product of the 2×2 eigenvalues ``1 + tr(M) + det(M)``.  The F survival
function is ``scipy.special.betainc`` on the host, in float64.
"""

from __future__ import annotations

from typing import Tuple

import torch
from scipy.special import betainc

from hfrep_tpu_torch.ops.rolling import pinv


def f_sf(x, d1, d2) -> float:
    """Survival function of F(d1, d2): P(F > x) = I_{d2/(d2 + d1 x)}(d2/2, d1/2)."""
    x, d1, d2 = (float(v) for v in (x, d1, d2))
    x = max(x, 0.0)
    return float(betainc(d2 / 2.0, d1 / 2.0, d2 / (d2 + d1 * x)))


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(a, b)[0]``: the minimum-norm solution by SVD,
    singular values below ``max(m, n) * eps`` times the largest dropped."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    return vt.T @ (s_inv * (u.T @ b))


def _centered_ols(y: torch.Tensor, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """OLS with intercept of each column of ``y`` (T, N) on ``x`` (T, K),
    solved on demeaned data: ``(slopes (K, N), intercepts (N, 1),
    residuals (T, N))``, without squaring the design's condition number."""
    ym = torch.mean(y, dim=0, keepdim=True)
    xm = torch.mean(x, dim=0, keepdim=True)
    yc, xc = y - ym, x - xm
    slopes = _lstsq(xc, yc)
    alpha = (ym - xm @ slopes).T
    resid = yc - xc @ slopes
    return slopes, alpha, resid


def _2d(a) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a.reshape(1, -1) if a.dim() < 2 else a


def hktest(rt, rb) -> Tuple[torch.Tensor, float]:
    """Huberman-Kandel spanning test (R ``hktest``, notebook cell 17):
    ``rt`` (T, N) test assets, ``rb`` (T, K) spanning assets → (F, p)."""
    rt, rb = _2d(rt), _2d(rb)
    t, n = rt.shape
    k = rb.shape[1]
    slopes, alpha, e = _centered_ols(rt, rb)                  # (K,N),(N,1),(T,N)
    theta = torch.cat([alpha.T, 1.0 - torch.sum(slopes, dim=0, keepdim=True)])  # (2, N)
    sigma = (e.T @ e) / (t - 1)
    h = theta @ pinv(sigma) @ theta.T                         # (2, 2)

    mu1 = torch.mean(rb, dim=0, keepdim=True)                 # (1, K)
    rbc = rb - mu1
    v11i = pinv((rbc.T @ rbc) / (t - 1))
    a1 = (mu1 @ v11i @ mu1.T)[0, 0]
    b1 = torch.sum(v11i @ mu1.T)
    c1 = torch.sum(v11i)
    g = torch.stack([torch.stack([1.0 + a1, b1]), torch.stack([b1, c1])])
    m = h @ torch.linalg.inv(g)
    ui = 1.0 + torch.trace(m) + torch.linalg.det(m)
    if n == 1:
        f_stat = (t - k - 1) * (ui - 1.0) / 2.0
        p = f_sf(f_stat, 2.0, t - k - 1)
    else:
        f_stat = (t - k - n) * (torch.sqrt(ui) - 1.0) / n
        p = f_sf(f_stat, 2.0 * n, 2.0 * (t - n - k))
    return f_stat, p


def grstest(ret, factors) -> Tuple[torch.Tensor, float]:
    """Gibbons-Ross-Shanken test (R ``grstest``, notebook cell 19):
    ``ret`` (T, N), ``factors`` (T, K) → (F, p)."""
    ret, factors = _2d(ret), _2d(factors)
    t, n = ret.shape
    k = factors.shape[1]
    slopes, alpha, e = _centered_ols(ret, factors)
    sigma = (e.T @ e) / (t - k - 1)
    f_mean = torch.mean(factors, dim=0, keepdim=True)          # (1, K)
    fc = factors - f_mean
    omega = (fc.T @ fc) / (t - 1)
    tem1 = (alpha.T @ pinv(sigma) @ alpha)[0, 0]
    tem2 = 1.0 + (f_mean @ pinv(omega) @ f_mean.T)[0, 0]
    f_stat = (t / n) * ((t - n - k) / (t - k - 1)) * (tem1 / tem2)
    p = f_sf(f_stat, n, t - n - k)
    return f_stat, p

