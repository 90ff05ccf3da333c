"""The 12-metric distributional evaluation suite
(``hfrep_tpu/metrics/gan_eval.py``; the reference's class ``GAN_eval``,
``GAN/GAN_eval.py:15-458``).

Method names mirror the reference; each function cites its source.  The
arrays stay on the device the cubes were given on (a CUDA tensor runs on
the card: PyTorch ops, cuBLAS and cuSOLVER); the KS p-values are host
math, as in the JAX package.

Two reference bugs are fixed by default, each behind a
``reference_compat`` switch that reproduces the original behaviour:

* ``kl_div``/``js_div`` label the GaussianNB training rows with
  ``np.repeat(np.arange(F), N)`` while the stacked rows run the feature
  index fastest (``GAN/GAN_eval.py:176-182``); correct labels are
  ``tile(arange(F), N)``.
* ``R2_relative_error`` scores the fitted OLS on ``real`` twice
  (``GAN/GAN_eval.py:397-398``), so the reported difference is 0; the
  corrected metric compares real with ``fake``.

``GanEval.to_frame`` (pandas) and ``GanEval.eyeball`` (matplotlib)
import their libraries inside themselves: the card's machine has
neither, and its path never calls them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from hfrep_tpu_torch.metrics.gaussian_nb import fit_gaussian_nb, predict_log_proba
from hfrep_tpu_torch.ops.rolling import ols_beta
from hfrep_tpu_torch.ops.sqrtm import sqrtm_product_trace

Tensor = torch.Tensor


def _flatten_rows(x: Tensor) -> Tensor:
    """(N, W, F) → (N·W, F); 2-D passes through (``GAN_eval.py:44-47``)."""
    return x.reshape(-1, x.shape[-1]) if x.dim() == 3 else x


def _mean_windows(x: Tensor) -> Tensor:
    """(N, W, F) → (W, F) by averaging windows, the reference's reduction
    for the MMD family (``GAN_eval.py:76-79``)."""
    return torch.mean(x, dim=0) if x.dim() == 3 else x


def _cov(x: Tensor) -> Tensor:
    """``jnp.cov(x, rowvar=False)``: columns are variables, ddof 1."""
    xc = x - x.mean(dim=0, keepdim=True)
    return (xc.T @ xc) / (x.shape[0] - 1)


# --------------------------------------------------------------------- FID
def fid(real: Tensor, fake: Tensor) -> Tensor:
    """Fréchet distance between row distributions (``GAN_eval.py:30-61``):
    ‖μ₁−μ₂‖² + tr(Σ₁+Σ₂−2·sqrtm(Σ₁Σ₂)), the sqrtm trace via eigvalsh."""
    r, f = _flatten_rows(real), _flatten_rows(fake)
    mu1, mu2 = r.mean(dim=0), f.mean(dim=0)
    s1, s2 = _cov(r), _cov(f)
    ssdiff = torch.sum((mu1 - mu2) ** 2)
    return ssdiff + torch.trace(s1 + s2) - 2.0 * sqrtm_product_trace(s1, s2)


# --------------------------------------------------------------------- MMD
def linear_mmd(real: Tensor, fake: Tensor) -> Tensor:
    """mean(R Rᵀ) + mean(F Fᵀ) − 2 mean(R Fᵀ) (``GAN_eval.py:63-83``)."""
    r, f = _mean_windows(real), _mean_windows(fake)
    return (r @ r.T).mean() + (f @ f.T).mean() - 2.0 * (r @ f.T).mean()


def _sq_dists(a: Tensor, b: Tensor) -> Tensor:
    aa = torch.sum(a * a, dim=1)[:, None]
    bb = torch.sum(b * b, dim=1)[None, :]
    return torch.clamp(aa + bb - 2.0 * a @ b.T, min=0.0)


def gaussian_mmd(real: Tensor, fake: Tensor, gamma: float = 1.0) -> Tensor:
    """RBF-kernel MMD, sklearn ``rbf_kernel`` semantics exp(−γ‖x−y‖²)
    (``GAN_eval.py:85-109``)."""
    r, f = _mean_windows(real), _mean_windows(fake)

    def k(a, b):
        return torch.exp(-gamma * _sq_dists(a, b))

    return k(r, r).mean() + k(f, f).mean() - 2.0 * k(r, f).mean()


def poly_mmd(real: Tensor, fake: Tensor, degree: int = 2, gamma: float = 1.0,
             coef0: float = 0.0) -> Tensor:
    """Polynomial-kernel MMD (γ⟨x,y⟩+c₀)^d (``GAN_eval.py:111-137``)."""
    r, f = _mean_windows(real), _mean_windows(fake)

    def k(a, b):
        return (gamma * a @ b.T + coef0) ** degree

    return k(r, r).mean() + k(f, f).mean() - 2.0 * k(r, f).mean()


# ------------------------------------------------------- divergence probe
def _probe_rows(x: Tensor) -> Tensor:
    """(N, W, F) → (N·F, W): each row is one feature's window series,
    transposed per window then stacked (``GAN_eval.py:159-176``)."""
    if x.dim() == 3:
        return torch.swapaxes(x, 1, 2).reshape(-1, x.shape[1])
    return x.T


def _probe_labels(n_windows: int, n_features: int, reference_compat: bool,
                  device: torch.device) -> Tensor:
    labels = torch.arange(n_features, device=device)
    if reference_compat:
        # GAN_eval.py:181: repeat(arange(F), N), misaligned unless N == F
        return labels.repeat_interleave(n_windows)
    return labels.repeat(n_windows)


def _nb_log_probs(real: Tensor, fake: Tensor, dataset: Tensor,
                  reference_compat: bool = False):
    n, _, f = dataset.shape
    params = fit_gaussian_nb(_probe_rows(dataset),
                             _probe_labels(n, f, reference_compat, dataset.device), f)
    return (predict_log_proba(params, _probe_rows(real)),
            predict_log_proba(params, _probe_rows(fake)))


def kl_div(real: Tensor, fake: Tensor, dataset: Tensor, div_only: bool = True,
           reference_compat: bool = False):
    """Mean per-row KL(fake‖real) of the NB class probabilities
    (``GAN_eval.py:139-191``), in the log domain
    (:func:`~hfrep_tpu_torch.metrics.gaussian_nb.predict_log_proba`)."""
    lr, lf = _nb_log_probs(real, fake, dataset, reference_compat)
    per_row = torch.sum(torch.exp(lf) * (lf - lr), dim=1)
    if div_only:
        return torch.mean(per_row)
    return torch.mean(per_row), torch.mean(torch.sqrt(torch.clamp(per_row, min=0.0)))


def js_div(real: Tensor, fake: Tensor, dataset: Tensor, div_only: bool = True,
           reference_compat: bool = False):
    """Jensen-Shannon divergence of the NB class probabilities
    (``GAN_eval.py:193-246``), in the log domain as :func:`kl_div`."""
    lr, lf = _nb_log_probs(real, fake, dataset, reference_compat)
    lm = torch.logaddexp(lr, lf) - math.log(2.0)
    per_row = (0.5 * torch.sum(torch.exp(lf) * (lf - lm), dim=1)
               + 0.5 * torch.sum(torch.exp(lr) * (lr - lm), dim=1))
    if div_only:
        return torch.mean(per_row)
    return torch.mean(per_row), torch.mean(torch.sqrt(torch.clamp(per_row, min=0.0)))


def inception_score(real: Tensor, fake: Tensor, dataset: Tensor,
                    reference_compat: bool = False) -> Tensor:
    """exp(mean KL) (``GAN_eval.py:248-263``); 1 ⇔ fake ≡ real."""
    return torch.exp(kl_div(real, fake, dataset, div_only=True,
                            reference_compat=reference_compat))


# ------------------------------------------------------------ two-sample
def _ks_statistics(real: Tensor, fake: Tensor) -> Tensor:
    """Per-column two-sample KS statistic, sort-based:
    D = sup_x |F̂_r(x) − F̂_f(x)| evaluated at every sample point."""
    r, f = _flatten_rows(real), _flatten_rows(fake)
    n, m = r.shape[0], f.shape[0]
    rs = torch.sort(r.T.contiguous(), dim=1).values           # (F, n)
    fs = torch.sort(f.T.contiguous(), dim=1).values           # (F, m)
    pts = torch.cat([rs, fs], dim=1)
    cdf_r = torch.searchsorted(rs, pts, right=True).to(r.dtype) / n
    cdf_f = torch.searchsorted(fs, pts, right=True).to(r.dtype) / m
    return torch.max(torch.abs(cdf_r - cdf_f), dim=1).values


def _kolmogorov_sf(x: np.ndarray, terms: int = 101) -> np.ndarray:
    """Asymptotic two-sided KS survival function 2Σ(−1)^{k−1}e^{−2k²x²}."""
    k = np.arange(1, terms)[:, None]
    s = 2.0 * np.sum((-1.0) ** (k - 1) * np.exp(-2.0 * (k * x[None, :]) ** 2), axis=0)
    return np.clip(s, 0.0, 1.0)


def _exact_ks2_pvalue(n: int, m: int, d: float) -> float:
    """Exact two-sided two-sample KS p-value P(D ≥ d), a lattice-path
    count (``hfrep_tpu/metrics/gan_eval.py:181-229``): a merged ordering
    of the two samples is a monotone path (0,0)→(n,m); the statistic
    stays below ``d`` iff the path keeps ``|i·m − j·n| < h·g`` where
    ``h = round(d·lcm(n,m))``.  Each row of the count is a cumulative sum
    over the in-band window, renormalised against a running log scale so
    it cannot overflow; the ratio to ``C(n+m, n)`` is formed in log space.
    Absolute accuracy floors at about 1e-12."""
    g = math.gcd(n, m)
    lcm = (n // g) * m
    h = int(round(d * lcm))
    if h == 0:
        return 1.0
    band_lim = h * g  # inside ⇔ |i·m − j·n| < band_lim
    j_idx = np.arange(m + 1)
    # row i = 0: inside while j·n < band_lim, a contiguous prefix of ones
    row = ((j_idx * n) < band_lim).astype(np.float64)
    log_scale = 0.0
    for i in range(1, n + 1):
        inside = np.abs(i * m - j_idx * n) < band_lim
        lo = int(np.argmax(inside))             # the band is one contiguous window
        hi = lo + int(np.sum(inside))
        nxt = np.zeros(m + 1)
        nxt[lo:hi] = np.cumsum(row[lo:hi])
        row = nxt
        peak = row[hi - 1] if hi > lo else 0.0
        if peak > 1e290:
            row *= 1e-290
            log_scale += 290.0 * math.log(10.0)
        elif peak == 0.0:                       # band pinched shut: no inside path
            return 1.0
    if row[m] <= 0.0:
        return 1.0
    log_inside = math.log(row[m]) + log_scale
    log_total = math.lgamma(n + m + 1) - math.lgamma(n + 1) - math.lgamma(m + 1)
    return float(np.clip(-math.expm1(log_inside - log_total), 0.0, 1.0))


def _ks_pvalues(stats: np.ndarray, n: int, m: int, method: str = "auto",
                columns: Optional[tuple] = None) -> np.ndarray:
    """Host p-values of the per-column statistics, the JAX package's
    rule (``gan_eval.py:232-288``): the exact distribution when ``max(n,
    m) <= 10000`` (scipy's cutoff), past ``n·m > 1e6`` delegated to
    scipy's exact ``ks_2samp`` on the raw columns, trusted only when it
    did not warn of its switch to the asymptotic answer and its statistic
    agrees with ours to ``2e-7 + 1e-6·|D|`` (else the column takes the
    DP); the asymptotic ``kstwo.sf(D, round(nm/(n+m)))`` otherwise."""
    if method not in ("auto", "exact", "asymp"):
        raise ValueError(f"method must be auto|exact|asymp, got {method!r}")
    if method == "exact" or (method == "auto" and max(n, m) <= 10000):
        if columns is not None and n * m > 1_000_000:
            try:
                from scipy.stats import ks_2samp
            except ImportError:  # pragma: no cover - scipy is on both machines
                pass
            else:
                import warnings
                r, f = (c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
                        else np.asarray(c) for c in columns)
                out = []
                for j in range(r.shape[1]):
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        res = ks_2samp(r[:, j], f[:, j], method="exact")
                    switched = any(issubclass(c.category, RuntimeWarning)
                                   and "ks_2samp" in str(c.message) for c in caught)
                    stat_ours = float(stats[j])
                    # the absolute term is the float32 statistic's rounding
                    stat_ok = (abs(float(res.statistic) - stat_ours)
                               <= 2e-7 + 1e-6 * abs(stat_ours))
                    if switched or not stat_ok:
                        out.append(_exact_ks2_pvalue(n, m, stat_ours))
                    else:
                        out.append(float(res.pvalue))
                return np.array(out)
        return np.array([_exact_ks2_pvalue(n, m, float(d)) for d in stats])
    try:
        from scipy.stats import distributions as _dist
    except ImportError:  # pragma: no cover - scipy is on both machines
        return _kolmogorov_sf(np.sqrt(n * m / (n + m)) * stats)
    return np.clip(_dist.kstwo.sf(stats, np.round(n * m / (n + m))), 0.0, 1.0)


def ks_test(real: Tensor, fake: Tensor, group: bool = True, p_val_only: bool = True,
            method: str = "auto"):
    """Per-feature two-sample KS test (``GAN_eval.py:267-288``): the
    statistic on the cubes' device, the p-values on the host
    (:func:`_ks_pvalues`)."""
    stats = _ks_statistics(real, fake).detach().cpu().numpy()
    r_cols, f_cols = _flatten_rows(real), _flatten_rows(fake)
    n, m = r_cols.shape[0], f_cols.shape[0]
    pvals = _ks_pvalues(stats, n, m, method, columns=(r_cols, f_cols))
    if group:
        if p_val_only:
            return float(np.mean(pvals))
        return float(np.mean(stats)), float(np.mean(pvals))
    return stats, pvals


def lp_dist(real: Tensor, fake: Tensor, ord: int = 2) -> Tensor:
    """Row-paired Lp distance per column / n_rows (``GAN_eval.py:290-307``)."""
    r, f = _flatten_rows(real), _flatten_rows(fake)
    d = torch.sum(torch.abs(r - f) ** ord, dim=0) ** (1.0 / ord)
    return torch.mean(d / r.shape[0])


def wasserstein(real: Tensor, fake: Tensor) -> Tensor:
    """Mean per-column 1-Wasserstein distance (``GAN_eval.py:309-326``):
    equal sample counts make it mean|sort(u) − sort(v)|."""
    r, f = _flatten_rows(real), _flatten_rows(fake)
    return torch.mean(torch.abs(torch.sort(r, dim=0).values - torch.sort(f, dim=0).values))


# -------------------------------------------------------------------- ACF
def _acf_1d_batch(x: Tensor, nlags: int) -> Tensor:
    """ACF lags 0..nlags for a batch of series, statsmodels ``acf``
    semantics (adjusted=False): r_k = Σ_t (x_t−x̄)(x_{t+k}−x̄) / Σ(x−x̄)².
    ``x`` (..., T) → (..., nlags+1)."""
    xc = x - torch.mean(x, dim=-1, keepdim=True)
    denom = torch.sum(xc * xc, dim=-1)
    t = x.shape[-1]
    ar = torch.arange(t, device=x.device)

    def one_lag(k):
        # the lagged product as a roll with its wrap-around masked
        rolled = torch.roll(xc, -k, dims=-1)
        mask = (ar < t - k).to(x.dtype)
        return torch.sum(xc * rolled * mask, dim=-1)

    nums = torch.stack([one_lag(k) for k in range(nlags + 1)], dim=-1)
    return nums / torch.clamp(denom, min=1e-30)[..., None]


def acf_abs_error(real: Tensor, fake: Tensor, nlags: int = 17, group: bool = True,
                  reference_compat: bool = False):
    """Mean absolute ACF error (``GAN_eval.py:328-369``): per-window
    per-feature ACF, averaged over windows, |real−fake| averaged over lags
    then features.  ``reference_compat`` keeps the reference's loop over
    ``range(nlags+1)`` indexing features (``GAN_eval.py:358-359``): only
    the first min(nlags+1, F) features enter the average."""
    if real.dim() == 3:
        r_acf = torch.mean(_acf_1d_batch(torch.swapaxes(real, 1, 2), nlags), dim=0)
        f_acf = torch.mean(_acf_1d_batch(torch.swapaxes(fake, 1, 2), nlags), dim=0)
        if reference_compat:
            keep = min(nlags + 1, r_acf.shape[0])
            r_acf, f_acf = r_acf[:keep], f_acf[:keep]
    else:
        r_acf = _acf_1d_batch(real.T, nlags)
        f_acf = _acf_1d_batch(fake.T, nlags)
    per_feature = torch.mean(torch.abs(r_acf - f_acf), dim=-1)
    return torch.mean(per_feature) if group else per_feature


# ------------------------------------------------------------- OLS probe
def _r2(y: Tensor, y_pred: Tensor) -> Tensor:
    ss_res = torch.sum((y - y_pred) ** 2)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    return 1.0 - ss_res / ss_tot


def _r2_relative_error_impl(dataset2d: Tensor, real2d: Tensor, fake2d: Tensor) -> Tensor:
    """Per-column next-step OLS: fit on the dataset's rows, compare the R²
    of real and fake (``GAN_eval.py:371-405``)."""
    n_feat = dataset2d.shape[1]
    ar = torch.arange(n_feat, device=dataset2d.device)
    errs = []
    for c in range(n_feat):
        mask = (ar != c).to(dataset2d.dtype)

        def xy(rows):
            return rows[1:, c], rows[:-1] * mask[None, :]      # the target column zeroed

        y_tr, x_tr = xy(dataset2d)
        beta = ols_beta(y_tr[:, None], x_tr)[:, 0]
        y_re, x_re = xy(real2d)
        y_fk, x_fk = xy(fake2d)
        errs.append(torch.abs(_r2(y_re, x_re @ beta) - _r2(y_fk, x_fk @ beta)))
    return torch.mean(torch.stack(errs))


def r2_relative_error(real: Tensor, fake: Tensor, dataset: Tensor,
                      reference_compat: bool = False) -> Tensor:
    if reference_compat:
        # GAN_eval.py:397-398 compares real with real: identically about 0
        return _r2_relative_error_impl(_flatten_rows(dataset), _flatten_rows(real),
                                       _flatten_rows(real))
    return _r2_relative_error_impl(_flatten_rows(dataset), _flatten_rows(real),
                                   _flatten_rows(fake))


# -------------------------------------------------------------- the suite
def _as_tensor(a, device: torch.device) -> Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
    return t.to(device=device, dtype=torch.float32)


class GanEval:
    """The reference's ``GAN_eval`` class (``GAN/GAN_eval.py:15-27``):
    real/fake/dataset cubes; ``run_all`` evaluates the whole battery on
    the device ``real`` lies on (numpy arrays: the CPU).  The display
    metadata (``subplot_title``, ``model_name``) serves ``eyeball`` and
    ``to_frame``."""

    METRICS = ("ACF", "FID", "Inception_score", "R2_relative_error",
               "gaussian_MMD", "js_div", "kl_div", "ks_test", "linear_MMD",
               "lp_dist", "poly_MMD", "wasserstein")

    def __init__(self, real, fake, dataset, subplot_title: Optional[Sequence[str]] = None,
                 model_name: Optional[Sequence[str]] = None, reference_compat: bool = False):
        dev = real.device if isinstance(real, torch.Tensor) else torch.device("cpu")
        real, fake, dataset = (_as_tensor(a, dev) for a in (real, fake, dataset))
        if real.dim() != fake.dim():
            raise ValueError("real/fake rank mismatch")
        if real.shape != fake.shape:
            raise ValueError("real/fake shape mismatch")
        self.real, self.fake, self.dataset = real, fake, dataset
        self.subplot_title = list(subplot_title or [])
        self.model_name = list(model_name or ["model"])
        self.reference_compat = reference_compat

    # reference-name methods
    def ACF(self):
        return float(acf_abs_error(self.real, self.fake,
                                   reference_compat=self.reference_compat))

    def FID(self):
        return float(fid(self.real, self.fake))

    def Inception_score(self):
        return float(inception_score(self.real, self.fake, self.dataset,
                                     self.reference_compat))

    def R2_relative_error(self):
        return float(r2_relative_error(self.real, self.fake, self.dataset,
                                       self.reference_compat))

    def gaussian_MMD(self):
        return float(gaussian_mmd(self.real, self.fake))

    def js_div(self):
        return float(js_div(self.real, self.fake, self.dataset,
                            reference_compat=self.reference_compat))

    def kl_div(self):
        return float(kl_div(self.real, self.fake, self.dataset,
                            reference_compat=self.reference_compat))

    def ks_test(self):
        return float(ks_test(self.real, self.fake))

    def linear_MMD(self):
        return float(linear_mmd(self.real, self.fake))

    def lp_dist(self):
        return float(lp_dist(self.real, self.fake))

    def poly_MMD(self):
        return float(poly_mmd(self.real, self.fake))

    def wasserstein(self):
        return float(wasserstein(self.real, self.fake))

    def run_all(self, verbose: bool = False,
                eyeball: Optional[str] = None) -> Dict[str, float]:
        """All 12 metrics, alphabetical (``GAN_eval.py:447-458``, the
        reference's ``dir(self)`` order); ``eyeball`` (a path) also
        draws the ECDF grid there."""
        res = {}
        for i, name in enumerate(self.METRICS):
            res[name] = getattr(self, name)()
            if verbose:
                print(f"{i + 1} out of {len(self.METRICS)} done.")
        if eyeball:
            self.eyeball(eyeball)
        return res

    def to_frame(self, res: Optional[Dict[str, float]] = None):
        """The metrics as a one-column pandas DataFrame named for the model."""
        import pandas as pd
        res = res or self.run_all()
        return pd.DataFrame({self.model_name[0]: list(res.values())}, index=list(res))

    def eyeball(self, path: Optional[str] = None, ncols: int = 3):
        """Per-feature ECDF overlay grid (``GAN_eval.py:407-445``) saved to
        ``path`` under matplotlib's ``Agg`` backend."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        real = _flatten_rows(self.real).cpu().numpy()
        fake = _flatten_rows(self.fake).cpu().numpy()
        n_feat = real.shape[1]
        nrows = int(np.ceil(n_feat / ncols))
        fig, ax = plt.subplots(nrows, ncols, figsize=(20, max(4, 2.5 * nrows)))
        ax = np.asarray(ax).reshape(nrows, ncols)
        titles = self.subplot_title or [f"feature {i}" for i in range(n_feat)]

        def ecdf(col, grid):
            return np.searchsorted(np.sort(col), grid, side="right") / len(col)

        for i in range(n_feat):
            r, c = divmod(i, ncols)
            xs = np.linspace(real[:, i].min(), real[:, i].max(), 50)
            ax[r, c].step(xs, ecdf(real[:, i], xs))
            ax[r, c].step(xs, ecdf(fake[:, i], xs))
            ax[r, c].set_title(titles[i] if i < len(titles) else f"feature {i}")
            ax[r, c].legend(["True", "Generated"], loc="upper left")
        fig.suptitle(self.model_name[0], y=1.0, fontsize=24)
        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=80, bbox_inches="tight")
        plt.close(fig)
        return path
