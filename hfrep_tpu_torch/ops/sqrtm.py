"""The matrix square root piece FID needs (``hfrep_tpu/ops/sqrtm.py``).

FID uses only the trace of ``sqrtm(Σ₁ Σ₂)``, the sum of the square roots
of the product's eigenvalues.  With ``Σ₁ = L Lᵀ`` (Cholesky) those are
the eigenvalues of the symmetric ``Lᵀ Σ₂ L``, so one Cholesky and one
``eigvalsh`` give it; imaginary residue never arises, and eigenvalues
below zero (roundoff) are clipped, as the reference discards
``covmean.imag``.  A Cholesky that fails (a covariance too far from
positive definite for the jitter) gives NaN, as in the JAX package.
"""

from __future__ import annotations

import torch

from hfrep_tpu_torch.analysis.contracts import contract


@contract("(F,F),(F,F)->()")
def sqrtm_product_trace(sigma1: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
    """trace(sqrtm(sigma1 @ sigma2)) for symmetric PSD (F, F) inputs."""
    f = sigma1.shape[0]
    # jitter for the Cholesky of a rank-deficient sample covariance
    eps = 1e-10 * torch.trace(sigma1) / f
    eye = torch.eye(f, dtype=sigma1.dtype, device=sigma1.device)
    # a factorisation that fails gives NaN, as jnp.linalg.cholesky does
    c, info = torch.linalg.cholesky_ex(sigma1 + eps * eye)
    m = c.T @ sigma2 @ c
    m = 0.5 * (m + m.T)
    ok = info == 0
    m = torch.where(ok, m, torch.zeros_like(m))
    out = torch.sum(torch.sqrt(torch.clamp(torch.linalg.eigvalsh(m), min=0.0)))
    return torch.where(ok, out, torch.full_like(out, float("nan")))
