"""The port's replication slice against the JAX package: the tf.keras
Nadam (``ops/optimizers.py``), the rolling OLS (``ops/rolling.py``), the
cost model (``core/costs.py``), the statistics (``replication/
perf_stats.py``, ``spanning.py``) and the engine (``replication/
engine.py``).

The engine runs JAX's own draws: the test derives them outside the JAX
package as the JAX engine does, ``split(key, L)`` into lane keys (the
multi path first ``split(key, D)``), each lane ``key, init = split(key)``
with the Keras-default init from ``init`` and epoch ``e``'s permutation
``permutation(split(key, epochs)[e], n_train)``, and feeds them through
the port's ``init_params`` / ``perm_source`` seams.  Bars: params atol
1e-5 + rtol 1e-4, losses rtol 1e-4, stop epochs equal; the outputs that
go through a pseudo-inverse (betas, ante, post, turnover, Sharpe) 1e-3
scaled by max(1, max|JAX|).  The port runs on the CPU.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.core import costs as jax_costs
from hfrep_tpu.core import scaler as jax_scaler
from hfrep_tpu.core.data import load_panel as jax_load_panel
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu.models.autoencoder import latent_mask as jax_latent_mask
from hfrep_tpu.ops import optimizers as jax_optimizers
from hfrep_tpu.ops import rolling as jax_rolling
from hfrep_tpu.replication import engine as jax_engine
from hfrep_tpu.replication import perf_stats as jax_perf_stats
from hfrep_tpu.replication import spanning as jax_spanning
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core import costs
from hfrep_tpu_torch.models.autoencoder import latent_mask
from hfrep_tpu_torch.ops import optimizers, rolling
from hfrep_tpu_torch.replication import engine, perf_stats, spanning

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
F = 22
LATENTS = [1, 3, 21]
#: the engine parity configs: JAX's default lr (no lane stops in 20
#: epochs) and a larger one under which lanes stop, freeze and go NaN
ENGINE_CFGS = {"lr1e-3": dict(epochs=20, chunk_epochs=5, patience=3),
               "lr2e-2": dict(epochs=20, chunk_epochs=5, patience=3, lr=0.02)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def panel():
    """The committed panel's train/test blocks (numpy f32), the train block
    MinMax-scaled by the JAX scaler, and the test tail's rf."""
    p = jax_load_panel(CLEANED)
    xtr, xte, ytr, yte = (np.asarray(a) for a in p.train_test_split())
    _, xs = jax_scaler.fit_transform(jnp.asarray(xtr))
    return {"x_train": xtr, "x_test": xte, "y_train": ytr, "y_test": yte,
            "x_scaled": np.asarray(xs), "rf": np.asarray(p.rf)[xtr.shape[0]:],
            "factors": np.asarray(p.factors)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


# ------------------------------------------------------------ optimizer
def test_keras_nadam_matches_jax_with_frozen_lanes():
    rng = np.random.default_rng(0)
    lanes, steps = 4, 100
    params = [rng.normal(size=(lanes, 5, 3)).astype(np.float32),
              rng.normal(size=(lanes, 3)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(steps)]
    # lane 1 frozen from step 30 on, lane 2 between steps 50 and 70
    frozen = np.zeros((steps, lanes), bool)
    frozen[30:, 1] = True
    frozen[50:70, 2] = True

    tx = jax_optimizers.keras_nadam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    js = jax.vmap(tx.init)(jp)

    def one(g, s, p):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    step = jax.jit(jax.vmap(one))
    for i in range(steps):
        new_p, new_s = step([jnp.asarray(g) for g in grads[i]], js, jp)
        fz = jnp.asarray(frozen[i])

        def keep(old, new):
            return jnp.where(fz.reshape(fz.shape + (1,) * (old.ndim - 1)), old, new)

        jp = jax.tree_util.tree_map(keep, jp, new_p)
        js = jax.tree_util.tree_map(keep, js, new_s)

    opt = optimizers.keras_nadam(1e-3)
    pp = [_t(p) for p in params]
    ps = opt.init(pp, (lanes,))
    for i in range(steps):
        opt.step(pp, [_t(g) for g in grads[i]], ps, frozen=_t(frozen[i]))
    for a, b in zip(jp, pp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(ps.count.numpy(), np.asarray(js.count))
    np.testing.assert_array_equal(ps.count.numpy(), [100, 30, 80, 100])
    np.testing.assert_allclose(ps.m_schedule.numpy(), np.asarray(js.m_schedule), rtol=1e-5)
    for mine, theirs in ((ps.mu, js.mu), (ps.nu, js.nu)):
        for a, b in zip(theirs, mine):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-5)


def test_keras_nadam_is_not_torch_nadam():
    """``torch.optim.NAdam`` is another rule (its momentum_decay): the two
    part after one step."""
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.full((3,), 0.5)
    torch.optim.NAdam([p], lr=1e-3, eps=1e-7).step()
    mine = torch.ones(1, 3)
    opt = optimizers.keras_nadam(1e-3)
    opt.step([mine], [torch.full((1, 3), 0.5)], opt.init([mine], (1,)))
    assert not torch.allclose(mine[0], p.detach(), rtol=1e-6, atol=0)


# -------------------------------------------------------------- rolling
def test_expanding_minmax_scale_is_bitwise_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(60, 7)).astype(np.float32)
    x[:, 3] = 0.25                                   # a constant column
    x[10:20, 5] = x[9, 5]                            # ties
    jm, jx = jax_rolling.expanding_minmax_scale(jnp.asarray(x))
    pm, px = rolling.expanding_minmax_scale(_t(x))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))


def test_window_stack_matches_jax():
    x = np.random.default_rng(2).normal(size=(30, 4)).astype(np.float32)
    np.testing.assert_array_equal(rolling._window_stack(_t(x), 24).numpy(),
                                  np.asarray(jax_rolling._window_stack(jnp.asarray(x), 24)))


@pytest.fixture(scope="module")
def trained_factors(panel):
    """Encoded test factors of JAX-trained AEs (40 epochs, latents 1, 7
    and 21): lanes 1 and 7 are rank-deficient (masked columns), lane 21
    ill-conditioned."""
    lats = [1, 7, 21]
    res = jax_engine.sweep_autoencoders(jax.random.PRNGKey(123), jnp.asarray(panel["x_scaled"]),
                                        JaxAEConfig(epochs=40), lats)
    out = {}
    for i, d in enumerate(lats):
        p = {k: v[i] for k, v in res.params.items()}
        out[d] = np.asarray(JaxAutoencoder(n_features=F, latent_dim=21).apply(
            {"params": p}, jnp.asarray(panel["x_test"]), jax_latent_mask(d, 21),
            method=JaxAutoencoder.encode))
    return out


@pytest.mark.parametrize("latent", [1, 7, 21])
def test_rolling_ols_beta_matches_jax(panel, trained_factors, latent):
    f, y = trained_factors[latent], panel["y_test"]
    want = np.asarray(jax_rolling.rolling_ols_beta(jnp.asarray(y), jnp.asarray(f), 24))
    got = rolling.rolling_ols_beta(_t(y), _t(f), 24).numpy()
    assert got.shape == want.shape == (f.shape[0] - 23, 21, 13)
    assert _scaled_err(got, want) < 1e-3


def test_torchs_default_pinv_cutoff_breaks_the_bar(panel, trained_factors):
    """torch's default cutoff (max(m, n) * eps) keeps singular values that
    JAX's (10 * max(m, n) * eps) drops: at latent 21 its betas miss JAX's
    by far more than the bar, where :func:`rolling.pinv`'s hold it."""
    f, y = _t(trained_factors[21]), _t(panel["y_test"])
    want = np.asarray(jax_rolling.rolling_ols_beta(jnp.asarray(panel["y_test"]),
                                                   jnp.asarray(trained_factors[21]), 24))
    xw, yw = rolling._window_stack(f, 24), rolling._window_stack(y, 24)
    default = torch.linalg.pinv(xw.transpose(-1, -2) @ xw) @ (xw.transpose(-1, -2) @ yw)
    assert _scaled_err(default.numpy(), want) > 0.1
    assert _scaled_err(rolling.rolling_ols_beta(y, f, 24).numpy(), want) < 1e-3


@pytest.mark.parametrize("add_constant", [False, True])
@pytest.mark.parametrize("latent", [1, 7, 21])
def test_ols_beta_matches_jax(panel, trained_factors, latent, add_constant):
    f, y = trained_factors[latent], panel["y_test"]
    want = np.asarray(jax_rolling.ols_beta(jnp.asarray(y), jnp.asarray(f), add_constant))
    got = rolling.ols_beta(_t(y), _t(f), add_constant).numpy()
    assert _scaled_err(got, want) < 1e-3


# ---------------------------------------------------------------- costs
def test_costs_match_jax():
    rng = np.random.default_rng(3)
    p, s, a, w = 30, 4, 6, 24
    old, new = (rng.normal(0, 0.3, (s, p, a)).astype(np.float32) for _ in range(2))
    vol = rng.uniform(0.01, 0.05, (a,)).astype(np.float32)
    for name in ("transaction_cost", "price_impact"):
        np.testing.assert_allclose(getattr(costs, name)(_t(old), _t(new), _t(vol)).numpy(),
                                   np.asarray(getattr(jax_costs, name)(old, new, vol)),
                                   rtol=1e-4, atol=1e-9)
    panel = rng.normal(0, 0.03, (p + w, a)).astype(np.float32)
    np.testing.assert_allclose(costs.rolling_cov_diag_vol(_t(panel), w).numpy(),
                               np.asarray(jax_costs.rolling_cov_diag_vol(panel, w)), rtol=1e-4)
    ante = rng.normal(0, 0.02, (p, s)).astype(np.float32)
    np.testing.assert_allclose(
        costs.ex_post_return(_t(ante), w, _t(old), _t(panel)).numpy(),
        np.asarray(jax_costs.ex_post_return(jnp.asarray(ante), w, jnp.asarray(old), jnp.asarray(panel))), rtol=1e-4, atol=1e-9)
    # a lane grid in front: each lane as JAX's own call
    grid = rng.normal(0, 0.3, (3, s, p, a)).astype(np.float32)
    antes = rng.normal(0, 0.02, (3, p, s)).astype(np.float32)
    got = costs.ex_post_return(_t(antes), w, _t(grid), _t(panel)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jax_costs.ex_post_return(
            jnp.asarray(antes[i]), w, jnp.asarray(grid[i]), jnp.asarray(panel))), rtol=1e-4, atol=1e-9)
    y, x = rng.normal(size=(w, s)).astype(np.float32), rng.normal(size=(w, 3)).astype(np.float32)
    beta = rng.normal(size=(3, s)).astype(np.float32)
    np.testing.assert_allclose(costs.normalization(_t(y), _t(x), _t(beta), w).numpy(),
                               np.asarray(jax_costs.normalization(y, x, beta, w)), rtol=1e-4)
    sw = rng.normal(size=(p, a, s)).astype(np.float32)
    np.testing.assert_allclose(costs.turnover(_t(sw)).numpy(),
                               np.asarray(jax_costs.turnover(sw)), rtol=1e-4)


# ----------------------------------------------------------- perf stats
def _french_csv(path: Path, five: bool, seed: int) -> None:
    """A synthetic daily French factor file: percent returns, business
    days 2009-11-02 .. 2022-07-29 (May 2011 left out: an empty month)."""
    rng = np.random.default_rng(seed)
    cols = ["Mkt-RF", "SMB", "HML"] + (["RMW", "CMA"] if five else []) + ["RF"]
    days = np.arange(np.datetime64("2009-11-02"), np.datetime64("2022-07-30"))
    days = [d for d in days if np.is_busday(d) and not str(d).startswith("2011-05")]
    lines = ["Date," + ",".join(cols)]
    for d in days:
        vals = list(rng.normal(0.02, 1.0, len(cols) - 1)) + [rng.uniform(0.0, 0.01)]
        lines.append(str(d).replace("-", "") + "," + ",".join(f"{v:.2f}" for v in vals))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("five,compat", [(False, False), (True, False), (True, True)])
def test_load_ff_factors_matches_jax(tmp_path, five, compat):
    path = tmp_path / "ff.csv"
    _french_csv(path, five, seed=4)
    want = jax_perf_stats.load_ff_factors(path, start="2010-05-31", end="2022-04-30",
                                          five=five, reference_compat=compat)
    got = perf_stats.load_ff_factors(path, start="2010-05-31", end="2022-04-30",
                                     five=five, reference_compat=compat)
    assert got.columns == list(want.columns)
    np.testing.assert_array_equal(got.dates, want.index.values.astype("datetime64[D]"))
    assert got.values.shape == (144, 5 if five and not compat else 3)
    np.testing.assert_allclose(got.values, want.values, rtol=1e-4)
    assert np.all(got.values[12] == 0.0)             # May 2011: no days


def _ceq_atol(gamma: float) -> float:
    """CEQ is log(mean(...)) of values near 1, times 12 / (1 - gamma): one
    float32 ulp of the mean moves it by 12 * eps / |1 - gamma|, and the
    port's and XLA's sums round differently."""
    return 12.0 * float(np.finfo(np.float32).eps) / abs(1.0 - gamma)


def test_perf_stats_functions_match_jax(panel):
    y = panel["y_test"][-143:]
    rf = panel["rf"].reshape(-1)[-143:]
    span = panel["factors"][-143:]
    for thr in (0.0, 0.1):
        np.testing.assert_allclose(perf_stats.omega_ratio(_t(y), thr).numpy(),
                                   np.asarray(jax_perf_stats.omega_ratio(y, thr)), rtol=1e-4)
    np.testing.assert_allclose(perf_stats.omega_curve(_t(y)), jax_perf_stats.omega_curve(y),
                               rtol=1e-4)
    np.testing.assert_allclose(perf_stats.annualized_sharpe(_t(y), _t(rf)).numpy(),
                               np.asarray(jax_perf_stats.annualized_sharpe(y, rf)), rtol=1e-4)
    np.testing.assert_allclose(perf_stats.ols_alpha(_t(y), _t(span[:, :3])).numpy(),
                               np.asarray(jax_perf_stats.ols_alpha(y, span[:, :3])),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(perf_stats.ols_alpha(_t(y[:, 0]), _t(span[:, :3])).numpy(),
                               np.asarray(jax_perf_stats.ols_alpha(y[:, 0], span[:, :3])),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(perf_stats.historical_var(_t(y)),
                                  jax_perf_stats.historical_var(y))
    np.testing.assert_array_equal(perf_stats.historical_cvar(_t(y)),
                                  jax_perf_stats.historical_cvar(y))
    for gamma in (2.0, 5.0, 10.0):
        np.testing.assert_allclose(perf_stats.ceq(_t(y), _t(rf), gamma).numpy(),
                                   np.asarray(jax_perf_stats.ceq(y, rf, gamma)), rtol=1e-4,
                                   atol=_ceq_atol(gamma))
    with pytest.raises(ValueError):
        perf_stats.ceq(_t(y), _t(rf), 1.0)
    by_latent = {d: np.random.default_rng(d).normal(size=4) for d in (1, 2, 3)}
    assert perf_stats.res_sort(by_latent, list("abcd")) == jax_perf_stats.res_sort(
        by_latent, list("abcd"))


def test_data_analysis_matches_jax(panel, tmp_path):
    """The CLI's stats window: the last 143 test months, the factor
    universe as the spanning set."""
    y = panel["y_test"][-143:]
    rf = panel["rf"].reshape(-1)[-143:]
    span = panel["factors"][-143:]
    for five in (False, True):
        _french_csv(tmp_path / f"ff{int(five)}.csv", five, seed=5 + five)
    ff3, ff5 = (perf_stats.load_ff_factors(tmp_path / f"ff{i}.csv", "2010-05-31", "2022-04-30",
                                           five=bool(i)).values[-143:] for i in (0, 1))
    want = jax_perf_stats.data_analysis(y, rf=rf, three_factor=ff3, five_factor=ff5, span=span)
    got = perf_stats.data_analysis(y, rf=rf, three_factor=ff3, five_factor=ff5, span=span)
    assert list(got) == list(want)
    for k in want:
        if k.endswith("_p"):
            ref = [_sf_at(k[:-2], f, 143, 1, 22) for f in want[k[:-2] + "_F"]]
            np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-5, err_msg=k)
        elif k.endswith("alpha"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
        elif k.startswith("CEQ"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=_ceq_atol(float(k[4:-1])), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_a_month_below_total_loss_gives_jax_s_nan_ceq(panel, tmp_path):
    """A replication that loses more than all its capital in a month
    (r < -1, as an autoencoder 150 epochs into the sweep can give):
    (1 + r) ** (1 - gamma) is negative for odd 1 - gamma, CEQ(10)'s mean
    goes negative and its log NaN, in JAX's battery and the port's alike;
    the CSV writer leaves that cell empty, as pandas does."""
    from hfrep_tpu_torch.experiments.report import StatsTable

    y = np.array(panel["y_test"][-143:], dtype=np.float32)
    rf = panel["rf"].reshape(-1)[-143:]
    y[[40, 90], 3] = (-1.27, -1.01)
    want = jax_perf_stats.data_analysis(y, rf=rf)
    got = perf_stats.data_analysis(y, rf=rf)
    assert np.isnan(want["CEQ(10)"][3]) and np.isnan(got["CEQ(10)"][3])
    for k in want:
        assert np.array_equal(np.isnan(got[k]), np.isnan(want[k])), k
        ok = ~np.isnan(want[k])
        atol = _ceq_atol(float(k[4:-1])) if k.startswith("CEQ") else 0.0
        np.testing.assert_allclose(got[k][ok], want[k][ok], rtol=1e-4, atol=atol, err_msg=k)
    path = tmp_path / "stats.csv"
    StatsTable(index=[f"s{j}" for j in range(y.shape[1])], columns=got).to_csv(str(path))
    rows = [line.split(",") for line in path.read_text().splitlines()]
    assert rows[4][rows[0].index("CEQ(10)")] == ""


# ------------------------------------------------------------- spanning
def _sf_at(test: str, f_stat, t: int, n: int, k: int) -> float:
    """The float64 F survival function at JAX's statistic, with the test's
    degrees of freedom.  The p-values are held to it and not to JAX's,
    which takes ``betainc`` in float32: on the committed panel JAX's HK
    p-values miss float64's by more than the 1e-5 bar."""
    from scipy import stats

    if test == "HK":
        d1, d2 = (2.0, t - k - 1) if n == 1 else (2.0 * n, 2.0 * (t - n - k))
    else:
        d1, d2 = n, t - n - k
    return float(stats.f.sf(float(f_stat), d1, d2))


def test_f_sf_matches_jax():
    for x, d1, d2 in ((0.5, 2.0, 30.0), (3.0, 1.0, 120.0), (-1.0, 4.0, 10.0), (12.0, 2.0, 7.0)):
        assert abs(spanning.f_sf(x, d1, d2) - float(jax_spanning.f_sf(
            jnp.float32(x), jnp.float32(d1), jnp.float32(d2)))) < 1e-5


@pytest.mark.parametrize("n", [1, 3])
def test_spanning_tests_match_jax(panel, n):
    rt = panel["y_test"][-143:, :n]
    rb = panel["factors"][-143:]
    for name, test in (("hktest", "HK"), ("grstest", "GRS")):
        jf, jp = getattr(jax_spanning, name)(jnp.asarray(rt), jnp.asarray(rb))
        f, p = getattr(spanning, name)(_t(rt), _t(rb))
        np.testing.assert_allclose(float(f), float(jf), rtol=1e-4, err_msg=name)
        assert abs(p - _sf_at(test, jf, 143, n, 22)) < 1e-5, name
    js, ja, je = jax_spanning._centered_ols(jnp.asarray(rt), jnp.asarray(rb))
    ps, pa, pe = spanning._centered_ols(_t(rt), _t(rb))
    for got, want in ((ps, js), (pa, ja), (pe, je)):
        assert _scaled_err(got.numpy(), np.asarray(want)) < 1e-4


# ------------------------------------------------------------ the engine
def _lane_draws(keys, m: int, epochs: int, n_train: int):
    """JAX's draws of each lane key: Keras-default init and the epochs'
    permutations, as ``_ae_init`` and ``_ae_epoch_step`` take them."""
    enc, dec, perms = [], [], []
    perm = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n_train)))
    for k in keys:
        k, init_key = jax.random.split(k)
        p = JaxAutoencoder(n_features=F, latent_dim=m).init(init_key, jnp.zeros((1, F)))["params"]
        enc.append(np.asarray(p["encoder_kernel"]))
        dec.append(np.asarray(p["decoder_kernel"]))
        perms.append(np.asarray(perm(jax.random.split(k, epochs))).astype(np.int64))
    return {"encoder_kernel": np.stack(enc), "decoder_kernel": np.stack(dec)}, np.stack(perms)


def _seams(init, perms, lead):
    init = {k: v.reshape(lead + v.shape[1:]) for k, v in init.items()}
    perms = torch.from_numpy(perms.reshape(lead + perms.shape[1:]))
    return init, (lambda pos, n: perms[..., pos:pos + n, :])


def _assert_result(got, want, epochs):
    assert np.array_equal(got.stop_epoch.numpy(), np.asarray(want.stop_epoch)), (
        f"stop epochs {got.stop_epoch.numpy()} against JAX's {np.asarray(want.stop_epoch)}; "
        f"val losses {got.val_loss.numpy()} against {np.asarray(want.val_loss)}")
    for k in ("encoder_kernel", "decoder_kernel"):
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want.params[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    for k in ("train_loss", "val_loss"):
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape[-1] == epochs
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)


def _cfgs(name):
    return JaxAEConfig(**ENGINE_CFGS[name]), AEConfig(**ENGINE_CFGS[name])


@pytest.mark.parametrize("cfg_name", list(ENGINE_CFGS))
def test_single_lane_training_matches_jax(panel, cfg_name):
    jcfg, cfg = _cfgs(cfg_name)
    key = jax.random.PRNGKey(3)
    x = panel["x_scaled"]
    want, wstats = jax_engine.train_autoencoder_chunked(key, jnp.asarray(x), jcfg)
    init, perms = _lane_draws([key], jcfg.latent_dim, jcfg.epochs, int(x.shape[0] * 0.75))
    init, src = _seams(init, perms, ())
    got, stats = engine.train_autoencoder_chunked(0, x, cfg, init_params=init,
                                                  perm_source=src, device="cpu")
    _assert_result(got, want, jcfg.epochs)
    assert stats == wstats
    # the ReplicationEngine's train() is the same drive
    eng = engine.ReplicationEngine(panel["x_train"], panel["y_train"], panel["x_test"],
                                   panel["y_test"], cfg, device="cpu")
    np.testing.assert_array_equal(eng.x_train.numpy(), x)
    res = eng.train(init_params=init, perm_source=src)
    for k in res.params:
        assert torch.equal(res.params[k], got.params[k])


@pytest.mark.parametrize("cfg_name", list(ENGINE_CFGS))
def test_lane_sweep_matches_jax(panel, cfg_name):
    jcfg, cfg = _cfgs(cfg_name)
    key = jax.random.PRNGKey(5)
    x = panel["x_scaled"]
    want, wstats = jax_engine.sweep_autoencoders_chunked(key, jnp.asarray(x), jcfg, LATENTS)
    init, perms = _lane_draws(jax.random.split(key, len(LATENTS)), max(LATENTS),
                              jcfg.epochs, int(x.shape[0] * 0.75))
    init, src = _seams(init, perms, (len(LATENTS),))
    got, stats = engine.sweep_autoencoders_chunked(0, x, cfg, LATENTS, init_params=init,
                                                   perm_source=src, device="cpu")
    _assert_result(got, want, jcfg.epochs)
    assert stats == wstats


def _two_datasets(panel):
    """The real training block and an augmented one (96 synthetic rows
    above it), each MinMax-scaled on its own: 168 and 264 rows."""
    xtr = panel["x_train"]
    syn = np.random.default_rng(0).uniform(xtr.min(0), xtr.max(0), (96, F)).astype(np.float32)
    return [panel["x_scaled"],
            np.asarray(jax_scaler.fit_transform(jnp.asarray(np.vstack([syn, xtr])))[1])]


@pytest.mark.parametrize("cfg_name", list(ENGINE_CFGS))
def test_multi_dataset_sweep_matches_jax(panel, cfg_name):
    jcfg, cfg = _cfgs(cfg_name)
    key = jax.random.PRNGKey(5)
    xs = _two_datasets(panel)
    jx, jrows = jax_engine.stack_padded([jnp.asarray(x) for x in xs])
    want, wstats = jax_engine.sweep_autoencoders_multi(key, jx, jrows, jcfg, LATENTS)
    x_stack, n_rows = engine.stack_padded([_t(x) for x in xs])
    np.testing.assert_array_equal(x_stack.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(n_rows.numpy(), [168, 264])
    keys = [k for dk in jax.random.split(key, 2) for k in jax.random.split(dk, len(LATENTS))]
    init, perms = _lane_draws(keys, max(LATENTS), jcfg.epochs, int(264 * 0.75))
    init, src = _seams(init, perms, (2, len(LATENTS)))
    got, stats = engine.sweep_autoencoders_multi(0, x_stack, n_rows, cfg, LATENTS,
                                                 init_params=init, perm_source=src,
                                                 device="cpu")
    _assert_result(got, want, jcfg.epochs)
    assert stats == wstats
    # one padded dataset alone is its row of the grid
    one, _ = engine.sweep_autoencoders_padded(
        0, x_stack[0], n_rows[0], cfg, LATENTS,
        init_params={k: v[0] for k, v in init.items()},
        perm_source=lambda pos, n: src(pos, n)[0], device="cpu")
    for k in one.params:
        assert torch.equal(one.params[k], got.params[k][0])


def test_rows_info_is_exact_host_arithmetic():
    cfg = AEConfig(val_split=0.1)
    n, fit = engine._rows_info(cfg, torch.tensor([10, 168, 264]))
    assert n.tolist() == [10, 168, 264] and fit.tolist() == [9, 151, 237]
    jn, jfit = jax_engine._rows_info(JaxAEConfig(val_split=0.1), jnp.asarray([10, 168, 264]))
    assert fit.tolist() == np.asarray(jfit).tolist()


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


#: every lane stops by epoch 24 here, so the chunked drive exits early
BITWISE_CFG = dict(epochs=40, chunk_epochs=7, patience=2, lr=0.05)


@pytest.mark.parametrize("kind", ["single", "lanes", "multi"])
def test_chunked_equals_monolithic_and_double_buffer_bitwise(panel, kind):
    def run(**kw):
        cfg = AEConfig(**{**BITWISE_CFG, **kw})
        if kind == "single":
            return engine.train_autoencoder_chunked(7, panel["x_scaled"], cfg, device="cpu")
        if kind == "lanes":
            return engine.sweep_autoencoders_chunked(7, panel["x_scaled"], cfg, LATENTS,
                                                     device="cpu")
        x, rows = engine.stack_padded([_t(x) for x in _two_datasets(panel)])
        return engine.sweep_autoencoders_multi(7, x, rows, cfg, LATENTS, device="cpu")

    base, stats = run(double_buffer=True)
    assert stats.epochs_dispatched < BITWISE_CFG["epochs"], stats     # an early exit
    assert stats.overshoot_chunks == 1 and stats.lanes_stopped == stats.lanes
    for kw in (dict(double_buffer=False), dict(chunk_epochs=0), dict(chunk_epochs=4)):
        other, ostats = run(**kw)
        for k in base.params:
            np.testing.assert_array_equal(_bits(other.params[k]), _bits(base.params[k]))
        for f in ("stop_epoch", "train_loss", "val_loss"):
            np.testing.assert_array_equal(_bits(getattr(other, f)), _bits(getattr(base, f)))
        if kw.get("double_buffer") is False:
            assert ostats.overshoot_chunks == 0
            assert ostats.epochs_dispatched == stats.epochs_dispatched - 7
    # the monolithic entry points: one chunk of every epoch
    cfg = AEConfig(**BITWISE_CFG)
    if kind == "single":
        mono = engine.train_autoencoder(7, panel["x_scaled"], cfg, device="cpu")
    elif kind == "lanes":
        mono = engine.sweep_autoencoders(7, panel["x_scaled"], cfg, LATENTS, device="cpu")
    else:
        return
    for k in base.params:
        np.testing.assert_array_equal(_bits(mono.params[k]), _bits(base.params[k]))
    np.testing.assert_array_equal(_bits(mono.val_loss), _bits(base.val_loss))


def test_perm_stream_is_pure_in_the_epoch():
    s = engine.PermStream(3, (2,), 11, torch.device("cpu"), block=4)
    whole = s(0, 10)
    assert whole.shape == (2, 10, 11)
    assert torch.equal(torch.sort(whole, dim=-1).values,
                       torch.arange(11).expand(2, 10, 11))
    again = engine.PermStream(3, (2,), 11, torch.device("cpu"), block=4)
    assert torch.equal(torch.cat([again(0, 3), again(3, 5), again(8, 2)], dim=-2), whole)


# -------------------------------------------------------- evaluation
@pytest.fixture(scope="module")
def jax_sweep_params(panel):
    """JAX-trained params of three latent lanes (40 epochs)."""
    res = jax_engine.sweep_autoencoders(jax.random.PRNGKey(123),
                                        jnp.asarray(panel["x_scaled"]),
                                        JaxAEConfig(epochs=40), [1, 7, 21])
    return {k: np.asarray(v) for k, v in res.params.items()}, [1, 7, 21]


PINV_KEYS = ("ante", "post", "turnover", "sharpe_ante", "sharpe_post")


@pytest.mark.parametrize("beta_mode", ["first", "rolling"])
def test_sweep_evaluate_matches_jax(panel, jax_sweep_params, beta_mode):
    params, lats = jax_sweep_params
    jcfg = JaxAEConfig(latent_dim=21, beta_mode=beta_mode)
    cfg = AEConfig(latent_dim=21, beta_mode=beta_mode)
    args = (panel["x_scaled"], panel["x_test"], panel["y_test"], panel["rf"], panel["factors"])
    jmasks = jnp.stack([jax_latent_mask(d, 21) for d in lats])
    want = jax_engine.sweep_evaluate(jax_engine._ae_model(jcfg), jcfg,
                                     *(jnp.asarray(a) for a in args),
                                     {k: jnp.asarray(v) for k, v in params.items()}, jmasks)
    masks = torch.stack([latent_mask(d, 21, device="cpu") for d in lats])
    got = engine.sweep_evaluate(cfg, *(_t(a) for a in args),
                                {k: _t(v) for k, v in params.items()}, masks)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape, k
        if k in PINV_KEYS:
            assert _scaled_err(g, w) < 1e-3, k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=k)
    # one lane through evaluate_params is its row of the sweep
    one = engine.evaluate_params(cfg, *(_t(a) for a in args),
                                 {k: _t(v[1]) for k, v in params.items()}, masks[1])
    for k in got:
        np.testing.assert_allclose(one[k].numpy(), got[k][1].numpy(), rtol=1e-5, atol=1e-6)


def test_replication_engine_api_matches_jax(panel, jax_sweep_params):
    params, lats = jax_sweep_params
    lane = {k: v[2] for k, v in params.items()}          # latent 21
    args = (panel["x_train"], panel["y_train"], panel["x_test"], panel["y_test"])
    je = jax_engine.ReplicationEngine(*args, JaxAEConfig())
    pe = engine.ReplicationEngine(*args, AEConfig(), device="cpu")
    je.use_params({k: jnp.asarray(v) for k, v in lane.items()}, jax_latent_mask(21, 21))
    pe.use_params(lane, latent_mask(21, 21, device="cpu"))
    np.testing.assert_allclose(pe.model_IS_r2(), je.model_IS_r2(), rtol=1e-4)
    np.testing.assert_allclose(pe.model_IS_RMSE(), je.model_IS_RMSE(), rtol=1e-4)
    np.testing.assert_allclose(pe.model_OOS_r2(), je.model_OOS_r2(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pe.model_OOS_RMSE(), je.model_OOS_RMSE(), rtol=1e-4)
    rf = panel["rf"]
    assert _scaled_err(pe.ante(rf), je.ante(rf)) < 1e-3
    assert _scaled_err(pe.post(panel["factors"]), je.post(panel["factors"])) < 1e-3
    assert _scaled_err(pe.turnover(), je.turnover()) < 1e-3
    with pytest.raises(RuntimeError):
        engine.ReplicationEngine(*args, AEConfig(), device="cpu").post(panel["factors"])


def test_r2_helpers_match_jax():
    rng = np.random.default_rng(6)
    a, p = rng.normal(size=(2, 40, 5)).astype(np.float32)
    rows = (np.arange(40) < 17)[:, None]
    np.testing.assert_allclose(engine._r2_columns_mean(_t(a), _t(p)).numpy(),
                               np.asarray(jax_engine._r2_columns_mean(a, p)), rtol=1e-5)
    np.testing.assert_allclose(
        engine._r2_columns_mean_masked(_t(a), _t(p), _t(rows)).numpy(),
        np.asarray(jax_engine._r2_columns_mean_masked(a, p, rows)), rtol=1e-5)


def test_entry_points_without_device_raise_when_there_is_no_card(panel):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs there")
    cfg = AEConfig(epochs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.train_autoencoder(0, panel["x_scaled"], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.sweep_autoencoders_chunked(0, panel["x_scaled"], cfg, LATENTS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ReplicationEngine(panel["x_train"], panel["y_train"], panel["x_test"],
                                 panel["y_test"], cfg)


def test_non_float32_policy_is_refused(panel):
    """The policies are float32 and bfloat16 (the bf16 policy's parity is
    tests/test_torch_precision.py); another dtype is refused."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        engine.train_autoencoder(0, panel["x_scaled"], AEConfig(dtype="float16"),
                                 device="cpu")
    res = engine.train_autoencoder(0, panel["x_scaled"], AEConfig(dtype="bfloat16", epochs=2),
                                   device="cpu")
    assert all(v.dtype == torch.float32 for v in res.params.values())
