"""The port's augmentation, sweep and report (``hfrep_tpu_torch/
experiments/{augment,sweep,report}.py``) and its ``sweep`` verb, against
the JAX package.

``run_sweep`` / ``run_sweep_multi`` run JAX's own draws through the
engine's seams (derived as ``tests/test_torch_replication.py`` derives
them); bars: fit metrics and losses rtol 1e-4, the pseudo-inverse's
outputs (ante, post, turnover, Sharpe) 1e-3 scaled by max(1, max|JAX|),
stop epochs equal.  The writers are held byte for byte to the JAX
package's pandas ones on the same arrays.  The port runs on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.core.data import load_panel as jax_load_panel
from hfrep_tpu.experiments import augment as jax_augment
from hfrep_tpu.experiments import sweep as jax_sweep
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core.data import load_panel
from hfrep_tpu_torch.experiments import augment, report, sweep
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.train.trainer import seed_mix

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
F = 22
LATENTS = [1, 3, 21]
#: lanes stop inside 20 epochs at this lr (the multi grid's in particular)
CFG = dict(epochs=20, chunk_epochs=5, patience=3, lr=0.02)
PINV_FIELDS = ("ante", "post", "turnover", "sharpe_ante", "sharpe_post")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def panels():
    return jax_load_panel(CLEANED), load_panel(CLEANED, device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


# --------------------------------------------------------------- augment
def test_source_labels_match_jax():
    for paths in (["/a/ckpt_5", "/b/ckpt_3"], ["/a/ckpt_5", "/b/ckpt_5/"],
                  ["run/gen.h5", "other/gen.h5", "x/y"]):
        assert augment.source_labels(paths) == jax_augment.source_labels(paths)
    with pytest.raises(ValueError, match="duplicate"):
        augment.source_labels(["/a/ckpt_5", "/a/ckpt_5"])


def test_source_sample_key_seeds_from_the_label():
    import hashlib

    digest = int.from_bytes(hashlib.sha256(b"ckpt_5").digest()[:4], "big") % (2 ** 31)
    g = augment.source_sample_key("ckpt_5", device="cpu")
    assert g.initial_seed() == seed_mix(7, digest)
    a = torch.randn(4, generator=g)
    assert torch.equal(a, torch.randn(4, generator=augment.source_sample_key("ckpt_5",
                                                                             device="cpu")))
    assert not torch.equal(a, torch.randn(4, generator=augment.source_sample_key(
        "ckpt_3", device="cpu")))


@pytest.mark.parametrize("features", [35, 36])
def test_split_and_augment_are_bitwise_jax(panels, features):
    cube = np.random.default_rng(features).normal(0, 0.02, (3, 10, features)).astype(np.float32)
    want, got = jax_augment.split_cube(jnp.asarray(cube)), augment.split_cube(_t(cube))
    for k in ("factors", "hf", "raw_windows"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    assert (got.rf is None) == (want.rf is None) == (features == 35)
    if got.rf is not None:
        np.testing.assert_array_equal(got.rf.numpy(), np.asarray(want.rf))
    jp, pp = panels
    xtr, ytr = np.asarray(jp.train_test_split()[0]), np.asarray(jp.train_test_split()[2])
    wx, wy = jax_augment.augment_training_set(jnp.asarray(xtr), jnp.asarray(ytr), want)
    gx, gy = augment.augment_training_set(_t(xtr), _t(ytr), got)
    assert gx.shape == (30 + 168, F)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    wsets = jax_augment.augment_training_sets(xtr, ytr, [want, want])
    gsets = augment.augment_training_sets(_t(xtr), _t(ytr), [got, got])
    assert len(gsets) == len(wsets) == 3
    for (a, b), (c, d) in zip(gsets, wsets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))
    include_rf = features == 36
    np.testing.assert_array_equal(
        augment.inverse_scale_cube(_t(cube), pp, include_rf=include_rf).numpy(),
        np.asarray(jax_augment.inverse_scale_cube(jnp.asarray(cube), jp, include_rf=include_rf)))


def test_sample_generator_splits_the_trainers_cube():
    from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig
    from hfrep_tpu_torch.train.trainer import GanTrainer

    cfg = ExperimentConfig(model=ModelConfig(family="mtss_wgan_gp", window=6, features=36,
                                             hidden=8))
    windows = torch.rand(16, 6, 36, generator=torch.Generator().manual_seed(0))
    tr = GanTrainer(cfg, windows, device="cpu")
    z = torch.randn(2, 6, 36, generator=torch.Generator().manual_seed(1))
    aug = augment.sample_generator(tr, noise=z)
    cube = tr.generate(2, noise=z)
    assert torch.equal(aug.raw_windows, cube)
    assert aug.factors.shape == (12, 22) and aug.hf.shape == (12, 13) and aug.rf.shape == (12,)
    drawn = augment.sample_generator(tr, augment.source_sample_key("a", device="cpu"), 2)
    again = augment.sample_generator(tr, augment.source_sample_key("a", device="cpu"), 2)
    assert torch.equal(drawn.raw_windows, again.raw_windows)


# ------------------------------------------------------------- run_sweep
def _lane_draws(keys, epochs: int, n_train: int):
    enc, dec, perms = [], [], []
    perm = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n_train)))
    for k in keys:
        k, init_key = jax.random.split(k)
        p = JaxAutoencoder(n_features=F, latent_dim=max(LATENTS)).init(
            init_key, jnp.zeros((1, F)))["params"]
        enc.append(np.asarray(p["encoder_kernel"]))
        dec.append(np.asarray(p["decoder_kernel"]))
        perms.append(np.asarray(perm(jax.random.split(k, epochs))).astype(np.int64))
    return {"encoder_kernel": np.stack(enc), "decoder_kernel": np.stack(dec)}, np.stack(perms)


def _seams(init, perms, lead):
    init = {k: v.reshape(lead + v.shape[1:]) for k, v in init.items()}
    perms = torch.from_numpy(perms.reshape(lead + perms.shape[1:]))
    return init, (lambda pos, n: perms[..., pos:pos + n, :])


def _assert_sweep(got: sweep.SweepResult, want) -> None:
    assert got.latent_dims == want.latent_dims and got.strategy_names == want.strategy_names
    np.testing.assert_array_equal(got.stop_epoch, np.asarray(want.stop_epoch))
    for f in ("is_r2", "is_rmse", "oos_r2_mean", "oos_r2_max", "oos_rmse_mean",
              "train_loss", "val_loss"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-4, atol=1e-6,
                                   err_msg=f)
    for f in PINV_FIELDS:
        assert _scaled_err(getattr(got, f), getattr(want, f)) < 1e-3, f
    assert got.summary()["best_oos_r2"]["latent"] == want.summary()["best_oos_r2"]["latent"]


def _blocks(jp):
    xtr, xte, ytr, yte = (np.asarray(a) for a in jp.train_test_split())
    return xtr, xte, ytr, yte, np.asarray(jp.rf)[xtr.shape[0]:], np.asarray(jp.factors)


def test_run_sweep_matches_jax(panels):
    jp, _ = panels
    xtr, xte, ytr, yte, rf, fac = _blocks(jp)
    key = jax.random.PRNGKey(8)
    want = jax_sweep.run_sweep(xtr, ytr, xte, yte, rf, fac, JaxAEConfig(**CFG), LATENTS,
                               key=key, strategy_names=jp.hf_names)
    init, perms = _lane_draws(jax.random.split(key, len(LATENTS)), CFG["epochs"],
                              int(168 * 0.75))
    init, src = _seams(init, perms, (len(LATENTS),))
    got = sweep.run_sweep(xtr, ytr, xte, yte, rf, fac, AEConfig(**CFG), LATENTS,
                          strategy_names=jp.hf_names, init_params=init, perm_source=src,
                          device="cpu")
    _assert_sweep(got, want)
    assert got.chunk_stats.epochs_total == CFG["epochs"]


def test_run_sweep_multi_matches_jax(panels):
    jp, _ = panels
    xtr, xte, ytr, yte, rf, fac = _blocks(jp)
    rng = np.random.default_rng(2)
    sx = rng.uniform(xtr.min(0), xtr.max(0), (48, F)).astype(np.float32)
    sy = rng.uniform(ytr.min(0), ytr.max(0), (48, 13)).astype(np.float32)
    datasets = [(xtr, ytr), (np.vstack([sx, xtr]), np.vstack([sy, ytr]))]
    key = jax.random.PRNGKey(9)
    want = jax_sweep.run_sweep_multi(datasets, xte, yte, rf, fac, JaxAEConfig(**CFG), LATENTS,
                                     key=key, strategy_names=jp.hf_names,
                                     dataset_names=["real", "gen_a"])
    keys = [k for dk in jax.random.split(key, 2) for k in jax.random.split(dk, len(LATENTS))]
    init, perms = _lane_draws(keys, CFG["epochs"], int(216 * 0.75))
    init, src = _seams(init, perms, (2, len(LATENTS)))
    got = sweep.run_sweep_multi(datasets, xte, yte, rf, fac, AEConfig(**CFG), LATENTS,
                                strategy_names=jp.hf_names, dataset_names=["real", "gen_a"],
                                init_params=init, perm_source=src, device="cpu")
    assert got.dataset_names == want.dataset_names
    assert got.chunk_stats == want.chunk_stats
    for g, w in zip(got.results, want.results):
        _assert_sweep(g, w)
    assert got["gen_a"] is got.results[1]


# ----------------------------------------------------------------- save
def _result_pair(seed: int):
    """One set of arrays as a port and as a JAX SweepResult (NaN after a
    lane's stop, a NaN Sharpe)."""
    rng = np.random.default_rng(seed)
    l, p, s, e = 3, 5, 4, 6

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    arrays = dict(latent_dims=[1, 2, 21], strategy_names=["HEDG", "HEDG_A", "B", "C"],
                  is_r2=f32(l), is_rmse=np.abs(f32(l)), oos_r2_mean=f32(l),
                  oos_r2_max=f32(l), oos_rmse_mean=np.abs(f32(l)), ante=f32(l, p, s),
                  post=f32(l, p, s), turnover=np.abs(f32(l, s)) * 10,
                  sharpe_ante=f32(l, s), sharpe_post=f32(l, s),
                  stop_epoch=np.array([4, 6, 2], np.int32), train_loss=f32(l, e),
                  val_loss=f32(l, e))
    arrays["train_loss"][2, 2:] = np.nan
    arrays["sharpe_ante"][1, 1] = np.nan
    arrays["is_r2"][0] = np.float32(1e-8)
    return sweep.SweepResult(**arrays), jax_sweep.SweepResult(**arrays)


def _same_files(a: Path, b: Path) -> list:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        if (a / n).is_dir():
            _same_files(a / n, b / n)
        else:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return names


def test_sweep_result_save_is_byte_equal_to_jax(tmp_path):
    got, want = _result_pair(0)
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "jax"))
    names = _same_files(tmp_path / "port", tmp_path / "jax")
    assert "fit_metrics.csv" in names and "summary.json" in names and len(names) == 9
    m_got, m_want = _result_pair(1)
    sweep.MultiSweepResult(["real", "gen_x"], [got, m_got], None).save(str(tmp_path / "pm"))
    jax_sweep.MultiSweepResult(["real", "gen_x"], [want, m_want], None).save(str(tmp_path / "jm"))
    _same_files(tmp_path / "pm", tmp_path / "jm")


def test_stats_table_csv_is_byte_equal_to_pandas(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(3)
    cols = {"Omega(0%)": rng.normal(size=4).astype(np.float32),
            "cVaR(95%)": rng.normal(size=4), "HK_p": np.array([0.1, np.nan, 1e-9, 2.0])}
    names = ["HEDG", "HEDG_CVARB", "X", "Y"]
    report.StatsTable(names, cols).to_csv(str(tmp_path / "port.csv"))
    pd.DataFrame(cols, index=names).to_csv(str(tmp_path / "pandas.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


# ------------------------------------------------------------ the verb
def _french_csv(path: Path) -> None:
    """A synthetic daily French 3-factor file over the CLI's stats window."""
    rng = np.random.default_rng(4)
    days = [d for d in np.arange(np.datetime64("2010-04-01"), np.datetime64("2022-05-01"))
            if np.is_busday(d)]
    lines = ["Date,Mkt-RF,SMB,HML,RF"]
    lines += [str(d).replace("-", "") + "," + ",".join(f"{v:.2f}" for v in rng.normal(0, 1, 3))
              + ",0.01" for d in days]
    path.write_text("\n".join(lines) + "\n")


def _run(capsys, argv) -> str:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _check_outputs(out: Path, latents, stats: bool) -> None:
    for name in ("fit_metrics.csv", "sharpe_ante.csv", "sharpe_post.csv", "turnover.csv",
                 "summary.json"):
        assert (out / name).is_file(), name
    for name in ("ante", "post"):
        assert np.isfinite(np.load(out / f"{name}.npy")).all()
    assert np.load(out / "train_loss.npy").shape[0] == len(latents)
    lines = (out / "fit_metrics.csv").read_text().splitlines()
    assert lines[0].startswith("latent_dim,IS_R2") and len(lines) == len(latents) + 1
    if stats:
        for name in ("replication", "replication_ante", "benchmark"):
            head = (out / f"stats_{name}.csv").read_text().splitlines()[0]
            assert "Sharpe" in head and "HK_p" in head and "GRS_p" in head


def test_sweep_verb_real_only(tmp_path, capsys):
    ff3 = tmp_path / "ff3.csv"
    _french_csv(ff3)
    out = tmp_path / "real"
    text = _run(capsys, ["sweep", "--device", "cpu", "--cleaned-dir", CLEANED,
                         "--latents", "1:3", "--epochs", "8", "--chunk-epochs", "3",
                         "--out", str(out), "--stats", "--ff3", str(ff3),
                         "--ff5", str(tmp_path / "missing.csv")])
    summary = json.loads(text[:text.index("\nstats:")])
    assert summary == json.loads((out / "summary.json").read_text())
    assert summary["best_oos_r2"]["latent"] in (1, 2, 3)
    _check_outputs(out, [1, 2, 3], stats=True)
    stats = json.loads((out / "chunk_stats.json").read_text())
    assert stats["epochs_total"] == 8 and stats["chunk_epochs"] == 3 and stats["lanes"] == 3
    head = (out / "stats_replication.csv").read_text().splitlines()[0]
    assert "FF3F_alpha" in head and "FF5F_alpha" not in head


def test_sweep_verb_from_train_gan_checkpoints(tmp_path, capsys):
    ck = tmp_path / "ck"
    _run(capsys, ["train-gan", "--device", "cpu", "--preset", "mtss_wgan_gp", "--epochs", "2",
                  "--cleaned-dir", CLEANED, "--checkpoint-dir", str(ck), "--quiet"])
    ckpt = ck / "ckpt_2"
    assert ckpt.is_dir()
    common = ["sweep", "--device", "cpu", "--cleaned-dir", CLEANED, "--latents", "1:3",
              "--epochs", "8", "--preset", "mtss_wgan_gp", "--n-gen-windows", "2"]
    # one checkpoint: the dense augmented path
    text = _run(capsys, common + ["--out", str(tmp_path / "one"), "--gan-checkpoint",
                                  str(ckpt)])
    assert text.startswith("augmented training set: 264 rows (96 synthetic)")
    _check_outputs(tmp_path / "one", [1, 2, 3], stats=False)
    assert (tmp_path / "one" / "chunk_stats.json").is_file()
    # two: the padded multi path, one subdir a dataset
    other = tmp_path / "ck_b" / "ckpt_b"
    shutil.copytree(ckpt, other)
    text = _run(capsys, common + ["--out", str(tmp_path / "two"), "--gan-checkpoint",
                                  str(ckpt), "--gan-checkpoint", str(other), "--stats"])
    doc = json.loads(text[:text.index("\nstats:")])
    assert set(doc) == {"real", "gen_ckpt_2", "gen_ckpt_b", "chunk_stats"}
    assert doc["chunk_stats"]["lanes"] == 9
    assert json.loads((tmp_path / "two" / "chunk_stats.json").read_text()) == doc["chunk_stats"]
    for name in ("real", "gen_ckpt_2", "gen_ckpt_b"):
        _check_outputs(tmp_path / "two" / name, [1, 2, 3], stats=True)


def test_the_sweep_path_imports_no_pandas(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from hfrep_tpu_torch.experiments.cli import main;"
            "import hfrep_tpu_torch.experiments.augment;"
            "rc = main(['sweep', '--device', 'cpu', '--cleaned-dir', sys.argv[2],"
            " '--latents', '1:2', '--epochs', '3', '--out', sys.argv[3], '--stats',"
            " '--ff3', sys.argv[4]]);"
            "bad = [m for m in ('pandas', 'matplotlib', 'jax', 'h5py', 'tensorflow')"
            " if m in sys.modules];"
            "assert rc == 0 and not bad, bad;"
            "print('ok')")
    ff3 = tmp_path / "ff3.csv"
    _french_csv(ff3)
    res = subprocess.run([sys.executable, "-c", code, str(ROOT), CLEANED,
                          str(tmp_path / "out"), str(ff3)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr
