"""The port's GAN metrics (``hfrep_tpu_torch/metrics/{gan_eval,gaussian_nb}.py``,
``ops/sqrtm.py``) and the ``eval-gan`` / ``train-gan --eval`` verbs,
against the JAX package on the CPU, on numpy cubes made from a seed.

Bars (each metric is float32 on both sides; the JAX functions are the
reference):
* ACF, ks_test, lp_dist, wasserstein: rtol 1e-6, atol 1e-7 (the same
  sums and sorts);
* kl_div, js_div: rtol 1e-5, atol 1e-7; Inception_score = exp(kl_div)
  through its logarithm at the same bar (the exponential multiplies the
  KL's rounding by the KL itself; two infinities agree);
* FID: |Δ| <= 1e-5 · max(1, tr Σ₁ + tr Σ₂), because FID is a difference
  of terms of that size (the sqrtm trace through Cholesky and eigvalsh);
* linear, Gaussian and polynomial MMD: |Δ| <= 1e-5 · max(1, the sum of
  the three kernel means' magnitudes), the same cancellation;
* R2_relative_error: 1e-3 scaled by max(1, |JAX|), the port-to-JAX bar
  of every output through a float32 pseudo-inverse
  (``tests/test_torch_replication.py``): the OLS of a real panel's
  windows is ill-conditioned;
* ``sqrtm_product_trace``: rtol 1e-5 (NaN where both Cholesky fail);
* the NB probe on rows in [0, 1] as the metrics feed it: its params and
  probabilities rtol 1e-5, atol 1e-6; its log-likelihoods atol 1e-5
  (float32 sums of D terms of size 1–10);
* KS statistics atol 1e-7 (the same counts; the two packages round the
  ECDF difference a few float32 ulps apart) and p-values rtol 1e-6 on
  the exact DP and scipy's exact delegation, rtol 1e-4 on the asymptotic
  ``kstwo`` path, whose slope 4·n·D multiplies the statistic's rounding.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu import config as jax_config
from hfrep_tpu.experiments.cli import main as jax_main
from hfrep_tpu.metrics import gan_eval as jax_ge
from hfrep_tpu.metrics import gaussian_nb as jax_nb
from hfrep_tpu.ops.sqrtm import sqrtm_product_trace as jax_sqrtm
from hfrep_tpu_torch import config as port_config
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.metrics import gan_eval, gaussian_nb
from hfrep_tpu_torch.ops.sqrtm import sqrtm_product_trace

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
#: the small cubes: N windows of W steps and F features, the dataset 2N
N, W, F = 24, 12, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def cubes():
    """(real, fake, dataset): the real windows the dataset's first N, the
    fakes a shifted, narrowed draw, so every metric is away from 0."""
    g = np.random.default_rng(7)
    ds = g.uniform(size=(2 * N, W, F)).astype(np.float32)
    fake = (0.9 * g.uniform(size=(N, W, F)) + 0.05).astype(np.float32)
    return ds[:N], fake, ds


def _kernel_scale(name: str, real: np.ndarray, fake: np.ndarray) -> float:
    r = real.mean(axis=0).astype(np.float64)
    f = fake.mean(axis=0).astype(np.float64)

    def k(a, b):
        if name == "linear_MMD":
            return a @ b.T
        if name == "poly_MMD":
            return (a @ b.T) ** 2
        d = (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2 * a @ b.T
        return np.exp(-np.maximum(d, 0))

    return max(1.0, abs(k(r, r).mean()) + abs(k(f, f).mean()) + 2 * abs(k(r, f).mean()))


def _assert_metric(name: str, got: float, want: float, real, fake) -> None:
    """The module docstring's bar for metric ``name``."""
    real = np.asarray(real, np.float64).reshape(-1, np.shape(real)[-1])
    fake = np.asarray(fake, np.float64).reshape(-1, np.shape(fake)[-1])
    if name == "FID":
        scale = max(1.0, np.trace(np.cov(real, rowvar=False))
                    + np.trace(np.cov(fake, rowvar=False)))
        assert abs(got - want) <= 1e-5 * scale, (name, got, want, scale)
    elif name.endswith("MMD"):
        cube_r = real.reshape(-1, W, real.shape[-1]) if real.shape[0] % W == 0 else real
        cube_f = fake.reshape(-1, W, fake.shape[-1]) if fake.shape[0] % W == 0 else fake
        scale = _kernel_scale(name, cube_r, cube_f)
        assert abs(got - want) <= 1e-5 * scale, (name, got, want, scale)
    elif name == "R2_relative_error":
        assert abs(got - want) <= 1e-3 * max(1.0, abs(want)), (name, got, want)
    elif name == "Inception_score":
        if not (math.isinf(got) and math.isinf(want)):
            np.testing.assert_allclose(math.log(got), math.log(want), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    elif name in ("kl_div", "js_div"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def jax_results(cubes):
    real, fake, ds = cubes
    return {c: jax_ge.GanEval(real, fake, ds, reference_compat=c).run_all()
            for c in (False, True)}


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("name", jax_ge.GanEval.METRICS)
def test_each_metric_matches_jax(cubes, jax_results, compat, name):
    real, fake, ds = cubes
    got = getattr(gan_eval.GanEval(real, fake, ds, reference_compat=compat), name)()
    _assert_metric(name, got, jax_results[compat][name], real, fake)


def test_run_all_is_alphabetical_and_compat_moves_the_fixed_metrics(cubes):
    real, fake, ds = cubes
    fixed = gan_eval.GanEval(real, fake, ds).run_all()
    compat = gan_eval.GanEval(real, fake, ds, reference_compat=True).run_all()
    assert list(fixed) == sorted(fixed) == list(jax_ge.GanEval.METRICS)
    # R² of real against real is 0; the kl/js label order moves the probe
    assert compat["R2_relative_error"] == 0.0 and fixed["R2_relative_error"] > 0.0
    assert compat["kl_div"] != fixed["kl_div"] and compat["js_div"] != fixed["js_div"]
    assert all(math.isfinite(v) for v in list(fixed.values()) + list(compat.values()))


def test_gan_eval_refuses_mismatched_cubes(cubes):
    real, fake, ds = cubes
    with pytest.raises(ValueError, match="shape mismatch"):
        gan_eval.GanEval(real, fake[:-1], ds)
    with pytest.raises(ValueError, match="rank mismatch"):
        gan_eval.GanEval(real, fake.reshape(-1, F), ds)


def test_two_dimensional_inputs_match_jax(cubes):
    """The flat (rows, F) form of every metric that takes one."""
    real, fake, _ = (c.reshape(-1, F) for c in cubes)
    for fn in ("fid", "linear_mmd", "gaussian_mmd", "poly_mmd", "lp_dist", "wasserstein"):
        got = float(getattr(gan_eval, fn)(_t(real), _t(fake)))
        want = float(getattr(jax_ge, fn)(jnp.asarray(real), jnp.asarray(fake)))
        name = {"fid": "FID", "linear_mmd": "linear_MMD", "gaussian_mmd": "gaussian_MMD",
                "poly_mmd": "poly_MMD"}.get(fn, fn)
        _assert_metric(name, got, want, real, fake)
    got = float(gan_eval.acf_abs_error(_t(real), _t(fake)))
    want = float(jax_ge.acf_abs_error(jnp.asarray(real), jnp.asarray(fake)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("f,rank", [(5, 5), (12, 4), (36, 36)])
def test_sqrtm_product_trace_matches_jax(f, rank):
    """Full-rank sample covariances, and a rank-deficient one whose
    Cholesky fails in both packages (NaN)."""
    g = np.random.default_rng(f)
    a = g.normal(size=(200, rank)) @ g.normal(size=(rank, f))
    b = g.normal(size=(200, f))
    s1 = np.cov(a, rowvar=False).astype(np.float32)
    s2 = np.cov(b, rowvar=False).astype(np.float32)
    got = float(sqrtm_product_trace(_t(s1), _t(s2)))
    want = float(jax_sqrtm(jnp.asarray(s1), jnp.asarray(s2)))
    assert math.isnan(got) == math.isnan(want) == (rank < f)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gaussian_nb_matches_jax():
    g = np.random.default_rng(3)
    y = g.integers(0, 4, 300)
    x = (g.normal(size=(300, 8)) * 0.1 + 0.5 + 0.05 * y[:, None]).astype(np.float32)
    q = (g.normal(size=(50, 8)) * 0.1 + 0.55).astype(np.float32)
    jp = jax_nb.fit_gaussian_nb(jnp.asarray(x), jnp.asarray(y), 4)
    tp = gaussian_nb.fit_gaussian_nb(_t(x), torch.from_numpy(y), 4)
    for k in ("theta", "var", "log_prior"):
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for fn, atol in (("joint_log_likelihood", 1e-5), ("predict_log_proba", 1e-5),
                     ("predict_proba", 1e-6)):
        np.testing.assert_allclose(getattr(gaussian_nb, fn)(tp, _t(q)).numpy(),
                                   np.asarray(getattr(jax_nb, fn)(jp, jnp.asarray(q))),
                                   rtol=1e-5, atol=atol, err_msg=fn)


def test_gaussian_nb_variance_is_centred():
    """|mean| ≫ std: the two-pass variance stays positive (the E[x²] −
    E[x]² form goes negative in float32), so every likelihood is finite."""
    g = np.random.default_rng(5)
    x = (g.normal(size=(400, 6)) * 1e-3 + 50.0).astype(np.float32)
    y = torch.from_numpy(g.integers(0, 3, 400))
    p = gaussian_nb.fit_gaussian_nb(_t(x), y, 3)
    assert bool((p.var > 0).all())
    assert bool(torch.isfinite(gaussian_nb.predict_log_proba(p, _t(x))).all())


def _ks_columns(rows: int, cols: int, seed: int):
    g = np.random.default_rng(seed)
    r = g.normal(size=(rows, cols)).astype(np.float32)
    f = (g.normal(size=(rows, cols)) * 1.03 + 0.02).astype(np.float32)
    return r, f


@pytest.mark.parametrize("rows,path", [(300, "exact DP"), (1100, "scipy exact"),
                                       (10100, "asymptotic")])
def test_ks_pvalues_match_jax_on_each_path(rows, path):
    """n = m = ``rows``: the DP below n·m = 1e6, scipy's exact
    ``ks_2samp`` past it (trusted only when its statistic sits within
    2e-7 + 1e-6·|D| of ours, which the port's float32 statistic must),
    the asymptotic ``kstwo`` past 10,000 rows."""
    r, f = _ks_columns(rows, 3, rows)
    stats, pvals = gan_eval.ks_test(_t(r), _t(f), group=False)
    jstats, jpvals = jax_ge.ks_test(jnp.asarray(r), jnp.asarray(f), group=False)
    np.testing.assert_allclose(stats, np.asarray(jstats), rtol=0, atol=1e-7)
    np.testing.assert_allclose(pvals, np.asarray(jpvals), atol=0,
                               rtol=1e-4 if path == "asymptotic" else 1e-6)
    assert np.all((pvals > 0) & (pvals <= 1))
    if path == "scipy exact":
        from scipy.stats import ks_2samp

        for j in range(r.shape[1]):
            res = ks_2samp(r[:, j], f[:, j], method="exact")
            assert abs(res.statistic - stats[j]) <= 2e-7 + 1e-6 * abs(stats[j])
            assert pvals[j] == res.pvalue, "the column fell back to the DP"
    if path == "exact DP":
        want = [gan_eval._exact_ks2_pvalue(rows, rows, float(d)) for d in stats]
        np.testing.assert_array_equal(pvals, want)


def test_exact_ks2_pvalue_is_jax_s_on_unequal_sizes():
    for n, m, d in ((7, 11, 0.5), (40, 25, 0.3), (13, 13, 0.0), (60, 90, 0.9)):
        assert gan_eval._exact_ks2_pvalue(n, m, d) == jax_ge._exact_ks2_pvalue(n, m, d)


# ------------------------------------------------------------------- verbs
TINY_W = 12


@pytest.fixture
def tiny_preset(monkeypatch):
    """A preset at test widths over the committed panel's 35 features, in
    both packages (the eval builds its real windows from the preset)."""
    def make(mod):
        return mod.ExperimentConfig(
            data=mod.DataConfig(n_sample=40, window=TINY_W),
            model=mod.ModelConfig(family="mtss_wgan_gp", hidden=8, window=TINY_W,
                                  features=35),
            train=mod.TrainConfig(batch_size=8, n_critic=1, steps_per_call=2, epochs=2),
            name="tiny")
    monkeypatch.setitem(port_config.PRESETS, "tiny", make(port_config))
    monkeypatch.setitem(jax_config.PRESETS, "tiny", make(jax_config))
    return "tiny"


def _jax_starts(seed: int, n: int, t: int, w: int) -> np.ndarray:
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, t - w + 1))


def test_eval_gan_verb_matches_jax(tmp_path, tiny_preset, monkeypatch, capsys):
    """The same inverse-scaled cube through both verbs; the port's windows
    are JAX's, through ``build_gan_dataset``'s ``starts`` seam."""
    from hfrep_tpu_torch.core import data

    real_build = data.build_gan_dataset

    def with_jax_starts(cfg, generator=None, panel=None, **kw):
        starts = _jax_starts(cfg.seed, cfg.n_sample, panel.n_months, cfg.window)
        return real_build(cfg, generator, panel, starts=torch.from_numpy(starts), **kw)

    monkeypatch.setattr(data, "build_gan_dataset", with_jax_starts)
    panel = data.load_panel(CLEANED, device="cpu")
    lo = panel.joined().amin(0).numpy()
    hi = panel.joined().amax(0).numpy()
    g = np.random.default_rng(4)
    cube = (lo + (hi - lo) * g.uniform(0.1, 0.9, (16, TINY_W, 35))).astype(np.float32)
    np.save(tmp_path / "cube.npy", cube)
    argv = ["eval-gan", "--samples", str(tmp_path / "cube.npy"), "--preset", tiny_preset,
            "--cleaned-dir", CLEANED]
    assert jax_main(argv + ["--out", str(tmp_path / "jax.json")]) == 0
    assert main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert list(got) == list(want) and len(got) == 12
    real = with_jax_starts(port_config.PRESETS[tiny_preset].data, panel=panel).windows.numpy()
    fake = (cube - lo) / np.where(hi - lo == 0, 1, hi - lo)
    for name in got:
        _assert_metric(name, got[name], want[name], real[:16], fake)
    # a cube of another shape exits 2 in both
    np.save(tmp_path / "bad.npy", cube[:, :, :30])
    bad = ["eval-gan", "--samples", str(tmp_path / "bad.npy"), "--preset", tiny_preset,
           "--cleaned-dir", CLEANED]
    assert jax_main(bad) == 2
    assert main(bad + ["--device", "cpu"]) == 2
    assert "pass the matching --preset" in capsys.readouterr().err


def test_train_gan_eval_flag_scores_the_trained_generator(tmp_path, tiny_preset, capsys):
    assert main(["train-gan", "--preset", tiny_preset, "--cleaned-dir", CLEANED,
                 "--device", "cpu", "--quiet", "--eval"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out[out.index("{"):])
    assert list(doc) == list(jax_ge.GanEval.METRICS)
    assert all(math.isfinite(v) for v in doc.values())
