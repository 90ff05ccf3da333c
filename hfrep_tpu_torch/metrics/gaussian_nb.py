"""Gaussian naive-Bayes class-probability probe
(``hfrep_tpu/metrics/gaussian_nb.py``).

The reference's KL/JS divergences compare the class probabilities a
``sklearn.naive_bayes.GaussianNB`` assigns to real and to fake windows
after learning which feature a window series belongs to
(``GAN/GAN_eval.py:178-187``).  The probe is a few lines of Gaussian
log-pdf math with sklearn's semantics: per-class population mean and
variance, the variance smoothed by ``1e-9 · max_d Var(X_d)``, priors from
the class counts, probabilities by a softmax over the joint
log-likelihoods.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class GaussianNBParams(NamedTuple):
    theta: torch.Tensor       # (C, D) per-class means
    var: torch.Tensor         # (C, D) smoothed variances
    log_prior: torch.Tensor   # (C,)


def fit_gaussian_nb(x: torch.Tensor, y: torch.Tensor, n_classes: int,
                    var_smoothing: float = 1e-9) -> GaussianNBParams:
    """``x`` (N, D) float, ``y`` (N,) integer class labels in [0, n_classes)."""
    one_hot = F.one_hot(y.long(), n_classes).to(x.dtype)        # (N, C)
    counts = one_hot.sum(dim=0)                                 # (C,)
    safe = torch.clamp(counts, min=1.0)
    theta = (one_hot.T @ x) / safe[:, None]
    # centred two-pass variance: E[x²] − E[x]² cancels in float32 when
    # |mean| ≫ std and can go negative
    diff = x - one_hot @ theta                                  # x − θ[y]
    var = (one_hot.T @ (diff * diff)) / safe[:, None]
    eps = var_smoothing * torch.max(torch.var(x, dim=0, unbiased=False))
    return GaussianNBParams(theta=theta, var=var + eps,
                            log_prior=torch.log(counts / counts.sum()))


def joint_log_likelihood(params: GaussianNBParams, x: torch.Tensor) -> torch.Tensor:
    """(N, D) → (N, C) unnormalised class log-probabilities."""
    # -(1/2) sum_d [ log(2π var) + (x - θ)² / var ]
    x_ = x[:, None, :]                                          # (N, 1, D)
    ll = -0.5 * torch.sum(torch.log(2.0 * math.pi * params.var)[None]
                          + (x_ - params.theta[None]) ** 2 / params.var[None], dim=-1)
    return ll + params.log_prior[None]


def predict_proba(params: GaussianNBParams, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(joint_log_likelihood(params, x), dim=-1)


def predict_log_proba(params: GaussianNBParams, x: torch.Tensor) -> torch.Tensor:
    """Normalised log-probabilities.  sklearn's float64 probe gives tiny
    but nonzero probabilities where a float32 softmax underflows to 0,
    which would turn the KL/JS terms into spurious infinities, so the
    divergences are taken from these."""
    return torch.log_softmax(joint_log_likelihood(params, x), dim=-1)
