"""The port's CPU-only extras against the JAX package: the Keras ``.h5``
bridge (``hfrep_tpu_torch.utils.keras_{import,export}``), ``sample-h5``,
``train-gan --export-h5``, ``sweep --h5-generator`` and ``--plots``,
``eval-gan --eyeball``, ``GanEval.to_frame`` and the report charts.

* An .h5 written by the unchanged JAX exporter loads through the port's
  ``load_keras_generator``; its output equals JAX's importer's on the
  same noise (atol 1e-5), and its layer list and weights are JAX's.
* An .h5 written by the port's exporter loads through
  ``tf.keras.models.load_model``; its prediction equals the port's
  generator (atol 1e-5); it round-trips through the port's importer.
* ``sample-h5`` of both packages on one file gives the same cube, the
  JAX verb's noise fed to the port.
* ``to_frame`` equals JAX's frame; each chart is written under ``Agg``
  and its line data equal the JAX package's figure's.

The tests that write an .h5 skip where TensorFlow is missing, as the JAX
package's own ``tests/test_keras_export.py`` does.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu import config as jax_config
from hfrep_tpu.experiments.cli import main as jax_main
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.utils.keras_export import export_keras_generator as jax_export
from hfrep_tpu.utils.keras_import import load_keras_generator as jax_load
from hfrep_tpu_torch import config as port_config
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.utils.bridge import from_flax

CLEANED = "results/rederived_cleaned"


def _has_tf():
    try:
        import tensorflow  # noqa: F401
        return True
    except ImportError:
        return False


needs_tf = pytest.mark.skipif(not _has_tf(), reason="tensorflow unavailable")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_artifact(tmp_path, family="mtss_wgan_gp", hidden=8, window=6, features=5, seed=0):
    """(path, JAX params, model config) of an .h5 the JAX exporter wrote."""
    mcfg = jax_config.ModelConfig(family=family, hidden=hidden, window=window,
                                  features=features)
    pair = jax_build_gan(mcfg)
    key = jax.random.PRNGKey(seed)
    params = pair.generator.init(key, jnp.zeros((1, window, features)))["params"]
    path = jax_export(mcfg, params, str(tmp_path / f"jax_{family}.h5"))
    return path, params, mcfg


# ---------------------------------------------------------------- import
@needs_tf
@pytest.mark.parametrize("family", ["mtss_wgan_gp", "gan"])
def test_jax_exported_h5_loads_through_the_port(tmp_path, family):
    from hfrep_tpu_torch.utils.keras_import import load_keras_generator

    path, _, mcfg = _jax_artifact(tmp_path, family)
    jmodule, jparams, jshape = jax_load(path)
    module, params, shape = load_keras_generator(path, device="cpu")
    assert shape == jshape == (mcfg.window, mcfg.features)
    assert module.specs == jmodule.specs
    # the layer list and weights are JAX's importer's tree, leaf for leaf
    ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jparams))
    got = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert np.array_equal(np.asarray(a), b)
    z = np.random.default_rng(1).standard_normal((3,) + shape).astype(np.float32)
    want = np.asarray(jmodule.apply({"params": jparams}, jnp.asarray(z)))
    with torch.no_grad():
        out = module(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, want, atol=1e-5)


def test_unsupported_activation_fails_at_parse_time(tmp_path):
    import h5py

    from hfrep_tpu_torch.utils.keras_import import parse_model_config

    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer", "config": {"batch_input_shape": [None, 8, 3]}},
        {"class_name": "Activation", "config": {"activation": "gelu"}},
    ]}}
    path = str(tmp_path / "bad.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
    with pytest.raises(ValueError, match="bad.h5.*gelu"):
        parse_model_config(path)
    cfg["config"]["layers"][1] = {"class_name": "LSTM", "config": {
        "units": 4, "return_sequences": False}}
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
    with pytest.raises(ValueError, match="return_sequences"):
        parse_model_config(path)


# ---------------------------------------------------------------- export
@needs_tf
@pytest.mark.parametrize("family", ["mtss_wgan_gp", "gan"])
def test_port_exported_h5_loads_in_keras_and_round_trips(tmp_path, family):
    import tensorflow as tf

    from hfrep_tpu_torch.utils.keras_export import export_keras_generator
    from hfrep_tpu_torch.utils.keras_import import load_keras_generator

    mcfg = port_config.ModelConfig(family=family, hidden=8, window=5, features=4)
    g = torch.Generator()
    g.manual_seed(3)
    gen = build_gan(mcfg, device="cpu", generator=g).generator
    path = export_keras_generator(mcfg, gen, str(tmp_path / "gen.h5"))
    z = np.random.default_rng(2).standard_normal((3, 5, 4)).astype(np.float32)
    with torch.no_grad():
        want = gen(torch.from_numpy(z)).numpy()
    model = tf.keras.models.load_model(path, compile=False)
    np.testing.assert_allclose(model.predict(z, verbose=0), want, atol=1e-5)
    module, _, shape = load_keras_generator(path, device="cpu")
    assert shape == (5, 4)
    with torch.no_grad():
        np.testing.assert_allclose(module(torch.from_numpy(z)).numpy(), want, atol=1e-5)
    # and through the JAX package's importer
    jmodule, jparams, _ = jax_load(path)
    np.testing.assert_allclose(np.asarray(jmodule.apply({"params": jparams}, jnp.asarray(z))),
                               want, atol=1e-5)


@needs_tf
def test_jax_params_bridged_export_the_same_artifact(tmp_path):
    """The JAX params bridged into the port's generator export weights
    equal to the JAX exporter's."""
    from hfrep_tpu_torch.utils.keras_export import export_keras_generator
    from hfrep_tpu_torch.utils.keras_import import load_keras_weights, parse_model_config

    path, params, jm = _jax_artifact(tmp_path)
    mcfg = port_config.ModelConfig(family=jm.family, hidden=jm.hidden, window=jm.window,
                                   features=jm.features)
    gen = from_flax(jax.tree_util.tree_map(np.asarray, params),
                    build_gan(mcfg, device="cpu").generator)
    mine = export_keras_generator(mcfg, gen, str(tmp_path / "port.h5"))
    a = load_keras_weights(path, parse_model_config(path)[0])
    b = load_keras_weights(mine, parse_model_config(mine)[0])
    for (pa, x), (pb, y) in zip(jax.tree_util.tree_leaves_with_path(a),
                                jax.tree_util.tree_leaves_with_path(b)):
        assert pa == pb and np.array_equal(x, y)


# ------------------------------------------------------------- the verbs
@needs_tf
def test_sample_h5_matches_jax_on_the_same_noise(tmp_path, capsys):
    from hfrep_tpu_torch.core.data import load_panel
    from hfrep_tpu_torch.experiments.augment import sample_keras_generator

    path, _, _ = _jax_artifact(tmp_path, hidden=8, window=12, features=36)
    assert jax_main(["sample-h5", "--h5", path, "--out", str(tmp_path / "jax.npy"),
                     "--n-windows", "3", "--cleaned-dir", CLEANED, "--seed", "5"]) == 0
    want = np.load(tmp_path / "jax.npy")
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (3, 12, 36), jnp.float32))
    panel = load_panel(CLEANED, device="cpu")
    aug = sample_keras_generator(path, None, panel, n_windows=3, noise=torch.from_numpy(noise.copy()),
                                 device="cpu")
    assert aug.rf is not None and aug.factors.shape == (36, 22) and aug.hf.shape == (36, 13)
    np.testing.assert_allclose(aug.raw_windows.numpy(), want, atol=1e-5, rtol=1e-5)
    capsys.readouterr()
    assert main(["sample-h5", "--h5", path, "--out", str(tmp_path / "port.npy"),
                 "--n-windows", "3", "--cleaned-dir", CLEANED, "--device", "cpu"]) == 0
    assert "samples: " in capsys.readouterr().out
    cube = np.load(tmp_path / "port.npy")
    assert cube.shape == (3, 12, 36) and np.isfinite(cube).all()


@pytest.fixture
def tiny_preset(monkeypatch):
    cfg = port_config.ExperimentConfig(
        data=port_config.DataConfig(n_sample=40, window=12),
        model=port_config.ModelConfig(family="mtss_wgan_gp", hidden=8, window=12,
                                      features=35),
        train=port_config.TrainConfig(batch_size=8, n_critic=1, steps_per_call=2, epochs=2),
        name="tiny")
    monkeypatch.setitem(port_config.PRESETS, "tiny", cfg)
    return "tiny"


@needs_tf
def test_train_gan_export_then_sweep_from_the_h5_with_plots(tmp_path, tiny_preset, capsys):
    import tensorflow as tf

    h5 = tmp_path / "gen.h5"
    assert main(["train-gan", "--preset", tiny_preset, "--cleaned-dir", CLEANED, "--device",
                 "cpu", "--quiet", "--epochs", "2", "--export-h5", str(h5)]) == 0
    assert f"keras artifact: {h5}" in capsys.readouterr().out
    assert tf.keras.models.load_model(str(h5), compile=False).output_shape == (None, 12, 35)
    out = tmp_path / "sweep"
    assert main(["sweep", "--device", "cpu", "--cleaned-dir", CLEANED, "--latents", "1:3",
                 "--epochs", "6", "--h5-generator", str(h5), "--n-gen-windows", "2",
                 "--out", str(out), "--plots"]) == 0
    text = capsys.readouterr().out
    assert text.startswith("augmented training set: 192 rows (24 synthetic)")
    for name in ("cumulative_returns.png", "ae_loss_curves.png", "omega_curves.png"):
        assert (out / name).stat().st_size > 0 and f"plot: {out / name}" in text
    with pytest.raises(SystemExit):
        main(["sweep", "--device", "cpu", "--out", str(out), "--h5-generator", str(h5),
              "--gan-checkpoint", str(tmp_path)])


def test_eval_gan_eyeball(tmp_path, tiny_preset, capsys):
    from hfrep_tpu_torch.core.data import load_panel

    panel = load_panel(CLEANED, device="cpu")
    lo, hi = panel.joined().amin(0).numpy(), panel.joined().amax(0).numpy()
    g = np.random.default_rng(4)
    np.save(tmp_path / "cube.npy",
            (lo + (hi - lo) * g.uniform(0.1, 0.9, (16, 12, 35))).astype(np.float32))
    png = tmp_path / "eye.png"
    assert main(["eval-gan", "--samples", str(tmp_path / "cube.npy"), "--preset", tiny_preset,
                 "--cleaned-dir", CLEANED, "--device", "cpu", "--eyeball", str(png)]) == 0
    assert f"eyeball plot: {png}" in capsys.readouterr().out and png.stat().st_size > 0


# -------------------------------------------------------- frames, charts
def _cubes(n=12, w=6, f=4, seed=0):
    g = np.random.default_rng(seed)
    return (g.normal(size=(n, w, f)).astype(np.float32),
            (0.8 * g.normal(size=(n, w, f)) + 0.1).astype(np.float32),
            g.normal(size=(3 * n, w, f)).astype(np.float32))


def test_to_frame_equals_jax():
    import pandas as pd

    from hfrep_tpu.metrics.gan_eval import GanEval as JaxGanEval
    from hfrep_tpu_torch.metrics.gan_eval import GanEval

    real, fake, ds = _cubes()
    jres = JaxGanEval(real, fake, ds, model_name=["m"]).run_all()
    mine = GanEval(real, fake, ds, model_name=["m"])
    res = mine.run_all()
    pd.testing.assert_index_equal(mine.to_frame(res).index, JaxGanEval(
        real, fake, ds, model_name=["m"]).to_frame(jres).index)
    # the frame of the JAX values through the port's to_frame is JAX's frame
    pd.testing.assert_frame_equal(mine.to_frame(jres),
                                  JaxGanEval(real, fake, ds, model_name=["m"]).to_frame(jres))
    np.testing.assert_allclose(mine.to_frame(res)["m"].to_numpy(),
                               np.array(list(jres.values())), rtol=1e-3, atol=1e-5)


@pytest.fixture
def captured_lines(monkeypatch):
    """Every saved figure's line data, axis by axis."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    seen = []
    real_save = Figure.savefig

    def save(self, *a, **kw):
        seen.append([[line.get_xydata().copy() for line in ax.lines] for ax in self.axes])
        return real_save(self, *a, **kw)

    monkeypatch.setattr(Figure, "savefig", save)
    return seen


def _same_lines(a, b):
    assert len(a) == len(b)
    for ax_a, ax_b in zip(a, b):
        assert len(ax_a) == len(ax_b)
        for la, lb in zip(ax_a, ax_b):
            np.testing.assert_allclose(la, lb, rtol=1e-6, atol=1e-9, equal_nan=True)


def test_report_charts_draw_jax_lines(tmp_path, captured_lines):
    from hfrep_tpu.experiments import report as jreport
    from hfrep_tpu_torch.experiments import report

    g = np.random.default_rng(7)
    rep_r, act = 0.02 * g.normal(size=(40, 5)), 0.02 * g.normal(size=(40, 5))
    ante = 0.02 * g.normal(size=(40, 5))
    names = [f"s{i}" for i in range(5)]
    tl = np.abs(g.normal(size=(3, 20))) + 0.1
    tl[1, 12:] = np.nan
    vl = tl * 1.1
    calls = [
        ("multiplot", (rep_r, act, names), {"ante": ante}),
        ("multiplot", (rep_r, act, names), {"reference_compat": True}),
        ("ae_loss_curves", (tl, vl, [1, 2, 3]), {}),
        ("omega_curve_grid", (rep_r, act, names), {}),
    ]
    for i, (fn, args, kw) in enumerate(calls):
        mine = getattr(report, fn)(*args, str(tmp_path / f"p{i}.png"), **kw)
        theirs = getattr(jreport, fn)(*args, str(tmp_path / f"j{i}.png"), **kw)
        assert (tmp_path / f"p{i}.png").stat().st_size > 0 and mine.endswith(f"p{i}.png")
        assert theirs.endswith(f"j{i}.png")
        _same_lines(captured_lines[-2], captured_lines[-1])


def test_eyeball_draws_jax_lines(tmp_path, captured_lines):
    from hfrep_tpu.metrics.gan_eval import GanEval as JaxGanEval
    from hfrep_tpu_torch.metrics.gan_eval import GanEval

    real, fake, ds = _cubes(f=5)
    titles = [f"f{i}" for i in range(5)]
    GanEval(real, fake, ds, subplot_title=titles).eyeball(str(tmp_path / "p.png"))
    JaxGanEval(real, fake, ds, subplot_title=titles).eyeball(str(tmp_path / "j.png"))
    assert (tmp_path / "p.png").stat().st_size > 0
    _same_lines(captured_lines[0], captured_lines[1])
