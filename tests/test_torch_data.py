"""The port's data path (``hfrep_tpu_torch.core`` and
``utils/safe_pickle.py``) against the JAX package's, on the committed
cleaned panel (``results/rederived_cleaned``).

The JAX windows' starts come from ``jax.random.randint``, which torch
cannot reproduce, so the test derives them as ``sample_windows`` does
and hands them to the port.  Every comparison is bitwise: reading,
scaling and gathering are exact in float32.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.config import get_preset as jax_get_preset
from hfrep_tpu.core import data as jax_data
from hfrep_tpu.core import sampling as jax_sampling
from hfrep_tpu.core import scaler as jax_scaler
from hfrep_tpu_torch.config import get_preset
from hfrep_tpu_torch.core import data, sampling, scaler
from hfrep_tpu_torch.utils import safe_pickle

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")


@pytest.fixture(scope="module")
def panels():
    return jax_data.load_panel(CLEANED), data.load_panel(CLEANED, device="cpu")


def _jax_starts(seed: int, n: int, t: int, w: int) -> np.ndarray:
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, t - w + 1))


def _bits(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=what)


class _Smuggled:
    def __reduce__(self):
        return (os.system, ("true",))


def test_safe_pickle_refuses_a_global_as_the_jax_one_does():
    from hfrep_tpu.utils.safe_pickle import safe_pickle_loads as jax_loads

    blob = pickle.dumps(_Smuggled())
    for loads in (safe_pickle.safe_pickle_loads, jax_loads):
        with pytest.raises(pickle.UnpicklingError, match="blocked pickle global"):
            loads(blob)
    plain = {"a": "b", "x": np.arange(3.0)}
    got = safe_pickle.safe_pickle_loads(pickle.dumps(plain))
    assert got["a"] == "b"
    np.testing.assert_array_equal(got["x"], plain["x"])


def test_dic_save_reads_back_and_refuses_non_plain_data(tmp_path):
    import datetime

    assert data.dic_save({"k": "v"}, tmp_path / "ok.pkl") == {"k": "v"}
    with pytest.raises(pickle.UnpicklingError):
        data.dic_save({"d": datetime.date(2020, 1, 1)}, tmp_path / "bad.pkl")


def test_load_panel_equals_jax_bitwise(panels):
    jp, tp = panels
    for name in ("factors", "hf", "rf"):
        _bits(getattr(tp, name), getattr(jp, name), name)
        assert getattr(tp, name).dtype == torch.float32
    assert tp.factors.shape == (337, 22) and tp.hf.shape == (337, 13)
    np.testing.assert_array_equal(tp.dates, jp.dates.astype("datetime64[D]"))
    assert str(tp.dates[0]) == "1994-04-30" and str(tp.dates[-1]) == "2022-04-30"
    assert tp.factor_names == jp.factor_names and tp.hf_names == jp.hf_names
    assert tp.factor_fullnames == jp.factor_fullnames
    assert tp.hf_fullnames == jp.hf_fullnames
    for include_rf in (False, True):
        _bits(tp.joined(include_rf), jp.joined(include_rf), f"joined rf={include_rf}")
    for a, b in zip(tp.train_test_split(), jp.train_test_split()):
        _bits(a, b, "train_test_split")


def test_load_panel_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.load_panel(CLEANED)


@pytest.mark.parametrize("include_rf", [False, True])
def test_scaler_equals_jax_bitwise_on_the_panel(panels, include_rf):
    jp, tp = panels
    jx, tx = jp.joined(include_rf), tp.joined(include_rf)
    jparams, jscaled = jax_scaler.fit_transform(jx)
    tparams, tscaled = scaler.fit_transform(tx)
    _bits(tparams.data_min, jparams.data_min)
    _bits(tparams.data_max, jparams.data_max)
    _bits(tparams.scale, jparams.scale)
    _bits(tscaled, jscaled)
    _bits(scaler.inverse_transform(tparams, tscaled),
          jax_scaler.inverse_transform(jparams, jscaled))


def test_scaler_constant_column_scales_by_one():
    x = np.random.default_rng(0).standard_normal((40, 4)).astype(np.float32)
    x[:, 2] = 0.37
    jparams, jscaled = jax_scaler.fit_transform(jnp.asarray(x))
    s = scaler.MinMaxScaler().fit(x)
    assert float(s.params.scale[2]) == 1.0
    _bits(s.params.scale, jparams.scale)
    _bits(s.transform(x), jscaled)
    _bits(s.fit_transform(x), jscaled)
    _bits(s.inverse_transform(s.transform(x)),
          jax_scaler.inverse_transform(jparams, jscaled))


@pytest.mark.parametrize("seed,n,w", [(0, 64, 48), (5, 200, 168), (7, 9, 337)])
def test_sample_windows_equals_jax_given_its_starts(panels, seed, n, w):
    jp, tp = panels
    jx, tx = jp.joined(), tp.joined()
    want = jax_sampling.sample_windows(jax.random.PRNGKey(seed), jx, n, w)
    starts = _jax_starts(seed, n, jx.shape[0], w)
    got = sampling.sample_windows(tx, n, w, starts=torch.from_numpy(starts))
    _bits(got, want)


def test_sample_windows_draws_inclusive_starts_from_a_generator():
    t, w = 6, 4
    x = torch.arange(t, dtype=torch.float32)[:, None]
    g = torch.Generator()
    g.manual_seed(0)
    out = sampling.sample_windows(x, 400, w, generator=g)
    firsts = set(out[:, 0, 0].long().tolist())
    assert firsts == {0, 1, 2}                     # [0, T - W] inclusive
    assert torch.equal(out[:, :, 0] - out[:, :1, 0], torch.arange(w).expand(400, w).float())
    g2 = torch.Generator()
    g2.manual_seed(0)
    assert torch.equal(sampling.sample_windows(x, 400, w, generator=g2), out)
    with pytest.raises(ValueError, match="longer than panel"):
        sampling.sample_windows(x, 3, t + 1, generator=g)


@pytest.mark.parametrize("preset", ["mtss_wgan_gp", "mtss_wgan_gp_prod"])
def test_build_gan_dataset_equals_jax_given_its_starts(panels, preset):
    jp, tp = panels
    jcfg, cfg = jax_get_preset(preset).data, get_preset(preset).data
    key = jax.random.PRNGKey(jcfg.seed)
    want = jax_data.build_gan_dataset(jcfg, key, jp)
    t = jp.n_months
    starts = _jax_starts(jcfg.seed, cfg.n_sample, t, cfg.window)
    got = data.build_gan_dataset(cfg, panel=tp, starts=torch.from_numpy(starts))
    _bits(got.windows, want.windows, "windows")
    assert got.windows.shape == (cfg.n_sample, cfg.window, 36 if cfg.include_rf else 35)
    _bits(got.scaler.data_min, want.scaler.data_min)
    _bits(got.scaler.data_max, want.scaler.data_max)
    _bits(got.panel_scaled, want.panel_scaled)
    assert got.feature_names == want.feature_names
    # the default stream: a CPU generator seeded with cfg.seed, repeatable
    a = data.build_gan_dataset(cfg, panel=tp)
    b = data.build_gan_dataset(cfg, cfg.seed, tp)
    assert torch.equal(a.windows, b.windows)


@pytest.mark.parametrize("split,reshape", [(22, True), (22, False), (1, True), (34, False)])
def test_factor_hf_split_matches_jax(split, reshape):
    cube = np.random.default_rng(split).standard_normal((3, 5, 35)).astype(np.float32)
    jf, jh = jax_sampling.factor_hf_split(jnp.asarray(cube), split, reshape)
    tf, th = sampling.factor_hf_split(torch.from_numpy(cube), split, reshape)
    _bits(tf, jf)
    _bits(th, jh)


@pytest.mark.parametrize("shape,split,match", [((3, 35), 22, "cube"),
                                               ((2, 4, 35), 0, "outside"),
                                               ((2, 4, 35), 35, "outside")])
def test_factor_hf_split_errors_match_jax(shape, split, match):
    arr = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        jax_sampling.factor_hf_split(jnp.asarray(arr), split)
    with pytest.raises(ValueError, match=match):
        sampling.factor_hf_split(torch.from_numpy(arr), split)


def test_the_data_path_imports_no_pandas():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel;"
            "from hfrep_tpu_torch.config import get_preset;"
            "p = load_panel(sys.argv[2], device='cpu');"
            "build_gan_dataset(get_preset('mtss_wgan_gp').data, panel=p);"
            "import hfrep_tpu_torch.train.trainer, hfrep_tpu_torch.experiments.cli;"
            "assert 'pandas' not in sys.modules, 'pandas was imported';"
            "assert 'jax' not in sys.modules, 'jax was imported';"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), CLEANED],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------- cleaning
def _raw_vendor_files(d: Path) -> None:
    """Small synthetic raw files in the vendor layouts ``run_cleaning``
    reads: the Fama-French daily CSV, NAVROR (percent strings, newest
    first, a title line) and ETF_data (a title line, interleaved
    (date, level) column pairs with mixed date formats)."""
    from hfrep_tpu_torch.core import cleaning

    g = np.random.default_rng(1)
    days = np.arange(np.datetime64("1994-03-01"), np.datetime64("1995-03-01"))
    ff = ["Date,  Mkt-RF,   SMB,    RF"]
    ff += [f"{str(d).replace('-', '')},{g.normal():.2f},{g.normal():.2f},{g.uniform(0.005, 0.02):.3f}"
           for d in days]
    (d / "F-F_Research_Data_Factors_daily.CSV").write_text("\n".join(ff) + "\n")
    months = np.arange(np.datetime64("1994-03"), np.datetime64("1995-03")) + 1
    ends = [str(m.astype("datetime64[D]") - 1) for m in months]
    hf = [f"h{i}" for i in range(13)]
    nav = ["Credit Suisse indices,,", "Date," + ",".join(hf)]
    nav += [e + "," + ",".join(f"{g.normal(0.5, 2):.2f}%" for _ in hf) for e in reversed(ends)]
    (d / "NAVROR_full.csv").write_text("\n".join(nav) + "\n")
    tickers = cleaning.FACTOR_TICKERS
    cols, rows = [], []
    for k, t in enumerate(tickers):
        cols += ["Date", t]
        level = 100.0 * np.exp(np.cumsum(g.normal(0, 0.01, len(days))))
        fmt = ("%Y-%m-%d", "%d-%m-%Y", "%d/%m/%Y")[k % 3]
        import datetime as _dt
        stamps = [_dt.date.fromisoformat(str(x)).strftime(fmt) for x in days]
        rows.append(list(zip(stamps, (f"{v:.4f}" for v in level))))
    lines = ["ETF levels" + "," * (2 * len(tickers) - 1), ",".join(cols)]
    for i in range(len(days)):
        lines.append(",".join(f"{rows[k][i][0]},{rows[k][i][1]}" for k in range(len(tickers))))
    (d / "ETF_data.csv").write_text("\n".join(lines) + "\n")


def test_cleaning_matches_jax_on_synthetic_vendor_files(tmp_path):
    import pandas as pd

    from hfrep_tpu.core import cleaning as jax_cleaning
    from hfrep_tpu_torch.core import cleaning

    _raw_vendor_files(tmp_path)
    ff = str(tmp_path / "F-F_Research_Data_Factors_daily.CSV")
    rf, jrf = cleaning.monthly_rf(ff), jax_cleaning.monthly_rf(ff)
    assert len(rf) == 11                       # 1994-04 .. 1995-02 month-ends
    pd.testing.assert_series_equal(rf, jrf)
    nav = str(tmp_path / "NAVROR_full.csv")
    pd.testing.assert_frame_equal(cleaning.clean_hfd(nav, rf), jax_cleaning.clean_hfd(nav, jrf))
    etf = str(tmp_path / "ETF_data.csv")
    got, want = cleaning.parse_etf_levels(etf), jax_cleaning.parse_etf_levels(etf)
    assert list(got) == list(want) == cleaning.FACTOR_TICKERS
    for t in got:
        pd.testing.assert_series_equal(got[t], want[t])
    pd.testing.assert_frame_equal(cleaning.clean_factor_etf(etf, rf),
                                  jax_cleaning.clean_factor_etf(etf, jrf))
    res = cleaning.run_cleaning(str(tmp_path), out_dir=str(tmp_path / "out"))
    jres = jax_cleaning.run_cleaning(str(tmp_path), out_dir=str(tmp_path / "jout"))
    for name in ("hfd", "factor_etf", "rf"):
        pd.testing.assert_frame_equal(getattr(res, name), getattr(jres, name))
    for f in ("hfd.csv", "factor_etf_data.csv", "rf.csv"):
        assert (tmp_path / "out" / f).read_bytes() == (tmp_path / "jout" / f).read_bytes()
    # the port's loader reads what the port's cleaning wrote, as JAX's does
    tp = data.load_panel(tmp_path / "out", device="cpu")
    jp = jax_data.load_panel(str(tmp_path / "jout"))
    _bits(tp.joined(True), jp.joined(True))
    assert tp.hf_fullnames == jp.hf_fullnames and len(tp.factor_names) == 22


def test_clean_verb_writes_a_loadable_panel(tmp_path, capsys):
    from hfrep_tpu_torch.experiments.cli import main

    _raw_vendor_files(tmp_path)
    assert main(["clean", "--raw-dir", str(tmp_path), "--out-dir", str(tmp_path / "c")]) == 0
    assert "wrote cleaned panel (11 months)" in capsys.readouterr().out
    assert data.load_panel(tmp_path / "c", device="cpu").n_months == 11
