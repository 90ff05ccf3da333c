"""The port's scenario factory against the JAX package on the CPU: the
conditional GAN (``models/conditional.py``, ``init_conditional_state``,
``make_conditional_step``), ``scenario/{regimes,conditional,walkforward,
universe}.py``, ``utils/fixture_data.py``, the trained serve fixture head
and the ``scenario`` verb.

Draws: the conditional epochs run JAX's own draws, derived outside the
JAX package as its conditional step takes them (bce: ``split(key, 3)``
into the batch indices and two noises; the Wasserstein families, for
critic iteration i, ``split(fold_in(key, i), 3)`` into indices, noise
and α) and fed through :class:`~hfrep_tpu_torch.train.steps.Draws`; the
AE grids run JAX's lane draws through the engine's ``init_params`` /
``perm_source`` seams (as ``tests/test_torch_replication.py`` derives
them).  Bars: the conditional epoch d_loss and g_loss rtol 1e-4, params
atol 1e-5 + rtol 1e-4 (the JAX package's epoch bar); the AE grids params
atol 1e-5 + rtol 1e-4, losses rtol 1e-4, stop epochs equal; bank samples
on JAX's noise atol 1e-5 + rtol 1e-4; regimes, fixture data, universe
synthesis and the walk-forward CSV and JSON bytes bitwise.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.core.data import load_panel as jax_load_panel
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu.models.registry import build_conditional_gan as jax_build_conditional_gan
from hfrep_tpu.scenario import conditional as jax_cond
from hfrep_tpu.scenario import regimes as jax_reg
from hfrep_tpu.scenario import universe as jax_universe
from hfrep_tpu.scenario import walkforward as jax_wf
from hfrep_tpu.train.states import init_conditional_state as jax_init_conditional_state
from hfrep_tpu.train.steps import make_conditional_step as jax_make_conditional_step
from hfrep_tpu.utils import fixture_data as jax_fixture
from hfrep_tpu_torch.config import AEConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.models.conditional import (ConditionalDiscriminator,
                                                ConditionalGenerator, build_conditional_gan,
                                                concat_condition)
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.scenario import conditional as cond_mod
from hfrep_tpu_torch.scenario import regimes as reg
from hfrep_tpu_torch.scenario import universe, walkforward
from hfrep_tpu_torch.train.states import init_conditional_state
from hfrep_tpu_torch.train.steps import Draws, make_conditional_step
from hfrep_tpu_torch.utils import checkpoint as ckpt
from hfrep_tpu_torch.utils import fixture_data
from hfrep_tpu_torch.utils.bridge import from_flax, gan_state_from_jax, to_flax

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
#: the conditional epoch's small widths: window, features, regimes, batch, hidden
W, F, C, B, H = 6, 4, 3, 8, 16
N_WINDOWS = 30


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("family", ["gan", "wgan", "wgan_gp", "mtss_gan", "mtss_wgan",
                                    "mtss_wgan_gp"])
def test_cond_off_is_the_unconditional_pair(family):
    """cond_dim 0: the literal unconditional classes with the same
    parameters from the same seed, not a wrapper."""
    cfg = ModelConfig(family=family, features=F, window=W, hidden=H)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    pair = build_conditional_gan(cfg, 0, device="cpu", generator=g1)
    ref = build_gan(cfg, device="cpu", generator=g2)
    assert type(pair.generator) is type(ref.generator)
    assert type(pair.discriminator) is type(ref.discriminator)
    assert (pair.loss, pair.family) == (ref.loss, ref.family)
    for a, b in zip(pair.generator.state_dict().values(), ref.generator.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["wgan_gp", "mtss_wgan_gp", "mtss_gan"])
def test_conditional_pair_on_jax_params_matches_jax(family):
    """JAX's conditional init through the bridge (trees nested under
    ``body``): the generator and critic outputs on the same inputs."""
    mcfg = JaxModelConfig(family=family, features=F, window=W, hidden=H)
    jpair = jax_build_conditional_gan(mcfg, C)
    st = jax_init_conditional_state(jax.random.PRNGKey(0), mcfg,
                                    JaxTrainConfig(lstm_backend="xla"), jpair, C)
    pair = build_conditional_gan(ModelConfig(family=family, features=F, window=W, hidden=H),
                                 C, device="cpu")
    assert isinstance(pair.generator, ConditionalGenerator)
    assert isinstance(pair.discriminator, ConditionalDiscriminator)
    state = gan_state_from_jax(_np(st), pair)
    first = state.generator.body.lstm0 if family.startswith("mtss") else state.generator.body.dense0
    assert first.kernel.shape[0] == F + C
    g = np.random.default_rng(1)
    z = g.normal(size=(5, W, F)).astype(np.float32)
    c = np.eye(C, dtype=np.float32)[g.integers(0, C, 5)]
    want = jpair.generator.apply({"params": st.g_params}, z, c, backend="xla")
    got = state.generator(torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    want = jpair.discriminator.apply({"params": st.d_params}, z, c, backend="xla")
    got = state.discriminator(torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    # the round trip back to JAX's tree
    for a, b in zip(jax.tree_util.tree_leaves(_np(st.g_params)),
                    jax.tree_util.tree_leaves(to_flax(state.generator))):
        np.testing.assert_array_equal(a, b)


def test_concat_condition_tiles_and_refuses_misaligned():
    x = torch.zeros((2, 3, 4))
    out = concat_condition(x, torch.tensor([1.0, 0.0]))
    assert out.shape == (2, 3, 6) and torch.equal(out[1, 2, 4:], torch.tensor([1.0, 0.0]))
    with pytest.raises(ValueError, match="does not align"):
        concat_condition(x, torch.zeros((3, 2)))
    pair = build_conditional_gan(ModelConfig(family="gan", features=4, window=3, hidden=8), 2,
                                 device="cpu")
    with pytest.raises(ValueError, match="cond_dim"):
        pair.generator(x, torch.zeros((2, 3)))


# ------------------------------------------------------ the conditional step
def _step_data():
    g = np.random.default_rng(1)
    ds = g.uniform(size=(N_WINDOWS, W, F)).astype(np.float32)
    cond = np.eye(C, dtype=np.float32)[g.integers(0, C, N_WINDOWS)]
    return ds, cond


def _jax_draws(loss: str, key, n_critic: int, n: int) -> Draws:
    """The draws JAX's conditional step takes from ``key``."""
    if loss == "bce":
        k_idx, k1, k2 = jax.random.split(key, 3)
        idx = np.array(jax.random.randint(k_idx, (B,), 0, n))
        noises = np.stack([np.array(jax.random.normal(k, (B, W, F))) for k in (k1, k2)])
        return Draws(torch.from_numpy(idx).long(), torch.from_numpy(noises))
    idx, noises, alphas = [], [], []
    for i in range(n_critic):
        k_idx, k_z, k_a = jax.random.split(jax.random.fold_in(key, i), 3)
        idx.append(np.asarray(jax.random.randint(k_idx, (B,), 0, n)))
        noises.append(np.asarray(jax.random.normal(k_z, (B, W, F))))
        alphas.append(np.asarray(jax.random.uniform(k_a, (B, 1, 1))))
    return Draws(torch.from_numpy(np.stack(idx)).long(), torch.from_numpy(np.stack(noises)),
                 torch.from_numpy(np.stack(alphas)) if loss == "wgan_gp" else None)


def _assert_params(module, jax_tree, what):
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(_np(jax_tree)),
                                 jax.tree_util.tree_leaves(to_flax(module))):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("family,stack", [("gan", "auto"), ("wgan", "auto"),
                                          ("wgan_gp", "auto"), ("mtss_wgan_gp", "auto"),
                                          ("mtss_wgan_gp", "chained")])
def test_conditional_step_matches_jax(family, stack):
    """Two JAX epochs; the port runs the second from JAX's state after the
    first (nonzero optimizer slots) on JAX's draws.  n_critic 2 for the
    Wasserstein families, so the generator update's reuse of the last
    iteration's indices and noise shows.  MTSS: the critic's fused stack
    and the chained pair."""
    mcfg = JaxModelConfig(family=family, features=F, window=W, hidden=H)
    tc = dict(batch_size=B, n_critic=2, lstm_backend="xla")
    jpair = jax_build_conditional_gan(mcfg, C)
    ds, cond = _step_data()
    jstep = jax.jit(jax_make_conditional_step(jpair, JaxTrainConfig(**tc), jnp.asarray(ds),
                                              jnp.asarray(cond)))
    st = jax_init_conditional_state(jax.random.PRNGKey(0), mcfg, JaxTrainConfig(**tc),
                                    jpair, C)
    st, _ = jstep(st, jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(5)
    want, wm = jstep(st, key)

    pair = build_conditional_gan(ModelConfig(family=family, features=F, window=W, hidden=H),
                                 C, device="cpu")
    state = gan_state_from_jax(_np(st), pair)
    if family.startswith("mtss"):
        state.discriminator.body.stack = stack
    step = make_conditional_step(pair, TrainConfig(**tc), torch.from_numpy(ds),
                                 torch.from_numpy(cond))
    state, m = step(state, _jax_draws(pair.loss, key, 2, N_WINDOWS))
    assert set(m) == {"d_loss", "g_loss"}
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-4, err_msg=k)
    _assert_params(state.generator, want.g_params, "g")
    _assert_params(state.discriminator, want.d_params, "d")
    assert state.step == int(want.step)


def test_conditional_step_rejects_misaligned_conditions():
    pair = build_conditional_gan(ModelConfig(family="gan", features=F, window=W, hidden=H), C,
                                 device="cpu")
    ds, cond = _step_data()
    with pytest.raises(ValueError, match="do not align"):
        make_conditional_step(pair, TrainConfig(), torch.from_numpy(ds),
                              torch.from_numpy(cond[:-1]))


def _train_inputs():
    g = np.random.default_rng(2)
    w = g.normal(size=(20, 5, 4)).astype(np.float32)
    c = reg.one_hot(g.integers(0, 2, 20), 2)
    return w, c


def test_train_conditional_matches_jax_and_is_epoch_exact():
    """3 epochs at 2 a call (the last call clamped to 1): the bundle's
    generator equals JAX's on JAX's init and draws, and exactly epochs 0,
    1, 2 drew."""
    w, c = _train_inputs()
    jm = JaxModelConfig(family="wgan_gp", features=4, window=5, hidden=8)
    jt = JaxTrainConfig(batch_size=8, n_critic=1, steps_per_call=2, lstm_backend="xla")
    want = jax_cond.train_conditional(jm, jt, w, c, 3, seed=1)
    init = jax_init_conditional_state(jax.random.PRNGKey(1), jm, jt, want.pair, 2)
    pm = ModelConfig(family="wgan_gp", features=4, window=5, hidden=8)
    pt = TrainConfig(batch_size=8, n_critic=1, steps_per_call=2)
    state = gan_state_from_jax(_np(init), build_conditional_gan(pm, 2, device="cpu"))
    key = jax.random.PRNGKey(2)
    drawn = []

    def source(e):
        drawn.append(e)
        done = e - e % pt.steps_per_call          # the call's first epoch
        ek = jax.random.fold_in(jax.random.fold_in(key, done), e - done)
        k_idx, k_z, k_a = jax.random.split(jax.random.fold_in(ek, 0), 3)
        return Draws(torch.from_numpy(np.array(jax.random.randint(k_idx, (1, 8), 0, 20))).long(),
                     torch.from_numpy(np.array(jax.random.normal(k_z, (1, 8, 5, 4)))),
                     torch.from_numpy(np.array(jax.random.uniform(k_a, (1, 8, 1, 1)))))

    got = cond_mod.train_conditional(pm, pt, w, c, 3, seed=1, device="cpu", state=state,
                                     draw_source=source)
    assert drawn == [0, 1, 2]
    _assert_params(got.generator, want.params, "g")
    assert (got.window, got.features, got.n_regimes, got.train_epochs) == (5, 4, 2, 3)


def test_train_conditional_is_deterministic_and_zero_epochs_is_the_init():
    w, c = _train_inputs()
    mcfg = ModelConfig(family="gan", features=4, window=5, hidden=8)
    tcfg = TrainConfig(batch_size=8, n_critic=1, steps_per_call=2)
    b1 = cond_mod.train_conditional(mcfg, tcfg, w, c, 3, seed=1, device="cpu")
    b2 = cond_mod.train_conditional(mcfg, tcfg, w, c, 3, seed=1, device="cpu")
    for a, b in zip(b1.generator.parameters(), b2.generator.parameters()):
        assert torch.equal(a, b)
    b0 = cond_mod.train_conditional(mcfg, tcfg, w, c, 0, seed=1, device="cpu")
    init = init_conditional_state(1, mcfg, 2, device="cpu")
    for a, b in zip(b0.generator.parameters(), init.generator.parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(b1.generator.parameters(),
                                                     b0.generator.parameters()))


# ------------------------------------------------------- regimes, fixtures
def test_regimes_are_bitwise_jax():
    x = np.asarray(jax_load_panel(CLEANED).factors, np.float32)
    for window, n in ((12, 3), (6, 4), (24, 2)):
        np.testing.assert_array_equal(reg.trailing_vol(x, window), jax_reg.trailing_vol(x, window))
        lab = reg.label_regimes(x, window, n)
        np.testing.assert_array_equal(lab, jax_reg.label_regimes(x, window, n))
        assert lab.dtype == np.int32 and set(np.unique(lab)) == set(range(n))
        np.testing.assert_array_equal(reg.window_conditions(lab, 24, n),
                                      jax_reg.window_conditions(lab, 24, n))
        np.testing.assert_array_equal(reg.regime_counts(lab, n), jax_reg.regime_counts(lab, n))
    for bad in (lambda m: m.label_regimes(x, 12, 1), lambda m: m.trailing_vol(x[:1]),
                lambda m: m.one_hot([0, 3], 3), lambda m: m.window_conditions(np.zeros(3), 5, 2)):
        with pytest.raises(ValueError):
            bad(jax_reg)
        with pytest.raises(ValueError):
            bad(reg)


def test_fixture_data_is_bitwise_jax(tmp_path):
    g1, g2 = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(fixture_data.low_rank_returns(g1, 40, 7),
                                  jax_fixture.low_rank_returns(g2, 40, 7))
    np.testing.assert_array_equal(fixture_data.scaled_panel(96, 16, seed=17).numpy(),
                                  np.asarray(jax_fixture.scaled_panel(96, 16, seed=17)))
    np.testing.assert_array_equal(fixture_data.keyed_scaled_panel(3, 1, 2, 30, 5),
                                  jax_fixture.keyed_scaled_panel(3, 1, 2, 30, 5))
    fac = jax_fixture.low_rank_returns(np.random.default_rng(1), 50, 6)
    for a, b in zip(fixture_data.fund_cross_section(fac, 4, 9),
                    jax_fixture.fund_cross_section(fac, 4, 9)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(fixture_data.universe_arrays(2, 7, 80, 5),
                    jax_fixture.universe_arrays(2, 7, 80, 5)):
        np.testing.assert_array_equal(a, b)
    fixture_data.write_cleaned_fixture(tmp_path / "port", months=30, seed=5)
    jax_fixture.write_cleaned_fixture(tmp_path / "jax", months=30, seed=5)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 5
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# --------------------------------------------------------------- the bank
@pytest.fixture(scope="module")
def bundle():
    return cond_mod.fixture_bundle(feats=6, window=12, n_regimes=3, epochs=2, device="cpu")


def test_bank_samples_on_jax_noise_equal_jax_s():
    """JAX's fixture bundle's params in the port's generator, the block's
    noise JAX's: the samples agree.  The port's own noise is another
    stream (a CPU torch generator), so its digests are not JAX's."""
    jb = jax_cond.fixture_bundle(feats=6, window=12, n_regimes=3, epochs=2)
    pair = build_conditional_gan(ModelConfig(family="gan", features=6, window=12, hidden=16),
                                 3, device="cpu")
    from_flax(_np(jb.params), pair.generator)
    pb = cond_mod.ConditionalBundle(pair=pair, generator=pair.generator, window=12, features=6,
                                    n_regimes=3, family="gan", train_epochs=2, seed=0,
                                    device=torch.device("cpu"))
    sample, jsample = cond_mod._sample_fn(pb), jax_cond._sample_fn(jb)
    for ss, regime, seq in ((3, 0, 0), (3, 2, 5), (11, 1, 1)):
        want = jax_cond._block_samples(jb, jsample, ss, regime, seq, 4)
        noise = np.array(jax.random.normal(jax_cond.block_key(ss, regime, seq), (4, 12, 6)))
        got = cond_mod._block_samples(pb, sample, ss, regime, seq, 4, noise=noise)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        assert cond_mod.replay_block_digest(pb, ss, regime, seq, 4) != \
            jax_cond.replay_block_digest(jb, ss, regime, seq, 4)


def test_bank_deterministic_and_replayable(bundle, tmp_path):
    m = cond_mod.generate_bank(bundle, tmp_path / "bank", blocks=2, block_size=4, stream_seed=3)
    assert m["generated"] == 6 and len(m["block_digests"]) == 6
    assert cond_mod.replay_block_digest(bundle, 3, 1, 0, 4) == m["block_digests"]["r1_00000"]
    m2 = cond_mod.generate_bank(bundle, tmp_path / "bank", blocks=2, block_size=4,
                                stream_seed=3)
    assert m2["generated"] == 0, "verified blocks must be kept"
    assert m2["aggregate_digest"] == m["aggregate_digest"]
    manifest = json.loads((tmp_path / "bank" / "bank.json").read_text())
    assert manifest["aggregate_digest"] == m["aggregate_digest"]
    assert manifest["aggregate_digest"] == ckpt.aggregate_digest(manifest["block_digests"])
    # a fresh bank in another dir: the same bytes
    m3 = cond_mod.generate_bank(bundle, tmp_path / "again", blocks=2, block_size=4,
                                stream_seed=3)
    assert m3["block_digests"] == m["block_digests"]
    arr = np.load(tmp_path / "bank" / "blocks" / "r2_00001" / "samples.npy")
    assert arr.shape == (4, 12, 6) and arr.dtype == np.float32 and np.isfinite(arr).all()


def test_rotted_block_regenerates(bundle, tmp_path):
    out = tmp_path / "bank"
    m = cond_mod.generate_bank(bundle, out, blocks=1, block_size=4, stream_seed=3)
    (out / "blocks" / "r0_00000" / "samples.npy").write_bytes(b"rot")
    m2 = cond_mod.generate_bank(bundle, out, blocks=1, block_size=4, stream_seed=3)
    assert m2["generated"] == 1, "a rotted block must regenerate"
    assert m2["block_digests"] == m["block_digests"]


def test_foreign_bank_refused_and_unknown_regime_raises(bundle, tmp_path):
    out = tmp_path / "bank"
    cond_mod.generate_bank(bundle, out, blocks=1, block_size=4, stream_seed=3)
    for kw in (dict(block_size=4, stream_seed=4), dict(block_size=8, stream_seed=3)):
        with pytest.raises(ValueError, match="DIFFERENT bank"):
            cond_mod.generate_bank(bundle, out, blocks=1, **kw)
    with pytest.raises(ValueError, match="outside"):
        cond_mod.generate_bank(bundle, tmp_path / "other", regimes=[7], blocks=1, block_size=2)


def test_scenario_item_panel_is_pure_and_regime_keyed():
    a = cond_mod.scenario_item_panel(5, 0, 1, regime=0, rows=24, feats=6, device="cpu")
    b = cond_mod.scenario_item_panel(5, 0, 1, regime=0, rows=24, feats=6, device="cpu")
    c = cond_mod.scenario_item_panel(5, 0, 1, regime=1, rows=24, feats=6, device="cpu")
    assert a.shape == (24, 6) and np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() == 0.0 and a.max() == 1.0


def test_sliding_windows_match_jax():
    x = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    np.testing.assert_array_equal(cond_mod.sliding_windows(x, 7), jax_cond.sliding_windows(x, 7))
    with pytest.raises(ValueError):
        cond_mod.sliding_windows(x, 31)


# --------------------------------------------------------- walk-forward
SMALL = dict(n_factors=6, latent_dim=4, epochs=6, batch_size=16, chunk_epochs=3,
             ols_window=6, patience=2)
LATENTS = [1, 2, 4]


@pytest.fixture(scope="module")
def small_universe():
    return jax_fixture.universe_arrays(0, funds=6, months=64, n_factors=6)


def _lane_draws(keys, f: int, m: int, epochs: int, n_train: int):
    """JAX's draws of each lane key: Keras-default init and the epochs'
    permutations (``tests/test_torch_replication.py``'s derivation)."""
    enc, dec, perms = [], [], []
    perm = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n_train)))
    for k in keys:
        k, init_key = jax.random.split(k)
        p = JaxAutoencoder(n_features=f, latent_dim=m).init(init_key, jnp.zeros((1, f)))["params"]
        enc.append(np.asarray(p["encoder_kernel"]))
        dec.append(np.asarray(p["decoder_kernel"]))
        perms.append(np.asarray(perm(jax.random.split(k, epochs))).astype(np.int64))
    return {"encoder_kernel": np.stack(enc), "decoder_kernel": np.stack(dec)}, np.stack(perms)


def _seams(init, perms, lead):
    init = {k: v.reshape(lead + v.shape[1:]) for k, v in init.items()}
    perms = torch.from_numpy(perms.reshape(lead + perms.shape[1:]))
    return init, (lambda pos, n: perms[..., pos:pos + n, :])


def _assert_grid(got, want):
    np.testing.assert_array_equal(got.stop_epoch.numpy(), np.asarray(want.stop_epoch))
    for k in ("encoder_kernel", "decoder_kernel"):
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want.params[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    for k in ("train_loss", "val_loss"):
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)


def _wf_seams(cfg, spec, key):
    """The walk-forward grid's JAX draws: ``split(key, n_windows)``, each
    window's ``split(dk, L)`` lanes, permutations of the longest window's
    fit rows."""
    keys = [k for dk in jax.random.split(key, spec.n_windows)
            for k in jax.random.split(dk, len(LATENTS))]
    n_train = int(spec.train_rows(spec.n_windows - 1) * (1 - cfg.val_split))
    init, perms = _lane_draws(keys, cfg.n_factors, max(LATENTS), cfg.epochs, n_train)
    return _seams(init, perms, (spec.n_windows, len(LATENTS)))


@pytest.mark.parametrize("lr", [1e-3, 0.05])
def test_walkforward_grid_matches_jax(small_universe, lr):
    """Ragged expanding windows through the padded multi grid, on JAX's
    draws; at lr 0.05 lanes stop, freeze and go NaN."""
    x, _, _ = small_universe
    spec = walkforward.WalkForwardSpec(start=24, n_windows=3, horizon=10, step=3)
    jspec = jax_wf.WalkForwardSpec(start=24, n_windows=3, horizon=10, step=3)
    jcfg, cfg = JaxAEConfig(**SMALL, lr=lr), AEConfig(**SMALL, lr=lr)
    key = jax.random.PRNGKey(jcfg.seed)
    want, wstats, wrows = jax_wf._train_grid(key, x, jspec, jcfg, LATENTS)
    init, src = _wf_seams(cfg, spec, key)
    got, stats, rows = walkforward._train_grid(0, x, spec, cfg, LATENTS, init_params=init,
                                               perm_source=src, device="cpu")
    np.testing.assert_array_equal(rows.numpy(), np.asarray(wrows))
    _assert_grid(got, want)
    assert stats == wstats


def test_walkforward_csvs_and_manifest_are_bytes_of_jax_s(tmp_path):
    g = np.random.default_rng(8)
    post = g.normal(size=(5, 3, 7)).astype(np.float32)
    ante = g.normal(size=(5, 3, 7)).astype(np.float32)
    digests = {f"w_{w:04d}": f"{w:064x}" for w in range(5)}
    spec = walkforward.WalkForwardSpec(start=40, n_windows=5, horizon=12, step=2)
    jspec = jax_wf.WalkForwardSpec(start=40, n_windows=5, horizon=12, step=2)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    mp = walkforward._assemble(tmp_path / "p", spec, AEConfig(), LATENTS, digests, post, ante)
    mj = jax_wf._assemble(tmp_path / "j", jspec, JaxAEConfig(), LATENTS, digests, post, ante)
    assert mp == mj
    for name in ("walkforward.csv", "walkforward_ante.csv", "walkforward.json"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_walkforward_run_artifacts_rerun_and_foreign_state(small_universe, tmp_path):
    x, y, rf = small_universe
    spec = walkforward.WalkForwardSpec(start=24, n_windows=4, horizon=10, step=2)
    cfg = AEConfig(**SMALL)
    out = tmp_path / "wf"
    r = walkforward.run_walkforward(x, y, rf, spec, cfg, LATENTS, out, device="cpu")
    assert r["surface_post"].shape == (4, 3, y.shape[1])
    assert np.isfinite(r["surface_post"]).all() and np.isfinite(r["surface_ante"]).all()
    assert r["stats"]["lanes"] == 12 and 0.0 <= r["stats"]["pad_waste_frac"] < 1.0
    man = json.loads((out / "walkforward.json").read_text())
    assert man["aggregate_digest"] == ckpt.aggregate_digest(man["windows"])
    assert len(man["windows"]) == 4 and not (out / "_resume").exists()
    for name in man["windows"]:
        ckpt.verify(out / "windows" / name)
    first = {n: (out / n).read_bytes() for n in ("walkforward.csv", "walkforward_ante.csv",
                                                  "walkforward.json")}
    # a re-run keeps the published window scores and writes the same bytes
    walkforward.run_walkforward(x, y, rf, spec, cfg, LATENTS, out, resume=True, device="cpu")
    assert all((out / n).read_bytes() == b for n, b in first.items())
    # scores of another walk-forward are refused
    with pytest.raises(ValueError, match="DIFFERENT walk-forward"):
        walkforward.run_walkforward(x, y, rf, spec, AEConfig(**{**SMALL, "epochs": 5}),
                                    LATENTS, out, device="cpu")


def test_walkforward_reuses_a_persisted_grid_and_refuses_a_foreign_one(small_universe,
                                                                       tmp_path):
    x, y, rf = small_universe
    spec = walkforward.WalkForwardSpec(start=24, n_windows=2, horizon=10, step=2)
    cfg = AEConfig(**SMALL)
    grid, _, _ = walkforward._train_grid(0, x, spec, cfg, LATENTS, device="cpu")
    run_cfg = AEConfig(**{**SMALL, "latent_dim": max(LATENTS)})
    fp = walkforward._fingerprint(spec, run_cfg, LATENTS, x, y, rf)
    walkforward._save_grid(tmp_path / "wf" / "_resume" / walkforward.TRAINED_GRID, grid, fp)
    back = walkforward._load_grid(tmp_path / "wf" / "_resume" / walkforward.TRAINED_GRID, fp,
                                  torch.device("cpu"))
    for k in grid.params:
        assert torch.equal(back.params[k], grid.params[k])
    assert walkforward._load_grid(tmp_path / "wf" / "_resume" / walkforward.TRAINED_GRID,
                                  {**fp, "data": "other"}, torch.device("cpu")) is None
    # the run picks the persisted grid up: no training (no chunk stats)
    r = walkforward.run_walkforward(x, y, rf, spec, cfg, LATENTS, tmp_path / "wf",
                                    device="cpu")
    assert r["stats"]["chunk_stats"] is None


def test_walkforward_validation_matches_jax(small_universe):
    x, y, rf = small_universe
    cfg, jcfg = AEConfig(**SMALL), JaxAEConfig(**SMALL)
    for kw in (dict(start=1, n_windows=2, horizon=10), dict(start=24, n_windows=2, horizon=6),
               dict(start=24, n_windows=40, horizon=10), dict(start=0, n_windows=2, horizon=10)):
        with pytest.raises(ValueError) as jerr:
            jax_wf.validate_spec(jax_wf.WalkForwardSpec(**kw), jcfg, 64)
        with pytest.raises(ValueError) as perr:
            walkforward.validate_spec(walkforward.WalkForwardSpec(**kw), cfg, 64)
        assert str(perr.value) == str(jerr.value).replace("hfrep_tpu.", "hfrep_tpu_torch.")
    with pytest.raises(ValueError, match="disagree"):
        walkforward.run_walkforward(x, y[:-1], rf, walkforward.WalkForwardSpec(24, 2, 10),
                                    cfg, LATENTS, "/nonexistent/unused", device="cpu")


# ----------------------------------------------------------- the universe
def test_universe_synthesis_is_bitwise_jax():
    for kw in (dict(funds=9, months=120, n_factors=5, seed=2), dict(funds=64, months=360)):
        a = universe.synthesize_universe(universe.UniverseSpec(**kw))
        b = jax_universe.synthesize_universe(jax_universe.UniverseSpec(**kw))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_factor_sampler_replaces_factors_only(bundle):
    spec = universe.UniverseSpec(funds=5, months=30, n_factors=6, seed=1)
    base = universe.synthesize_universe(spec)
    sampled = universe.synthesize_universe(spec, universe.generator_factor_sampler(bundle, 1))
    assert sampled.factors.shape == (30, 6) and not np.array_equal(sampled.factors, base.factors)
    again = universe.synthesize_universe(spec, universe.generator_factor_sampler(bundle, 1))
    np.testing.assert_array_equal(sampled.factors, again.factors)
    want = fixture_data.fund_cross_section(sampled.factors, 1, 5)
    np.testing.assert_array_equal(sampled.hfd, want[0])
    with pytest.raises(ValueError, match="universe wants"):
        universe.synthesize_universe(universe.UniverseSpec(funds=5, months=30, n_factors=4),
                                     universe.generator_factor_sampler(bundle))


# ------------------------------------------------------ the serve fixture
def test_trained_serve_fixture_head_matches_jax():
    """The fixture head trained on JAX's draws equals the JAX fixture's."""
    from hfrep_tpu.serve.fixture import fixture_ae_model as jax_fixture_ae_model
    from hfrep_tpu_torch.serve.fixture import fixture_ae_model, train_fixture_head

    want = jax_fixture_ae_model(feats=16, rows=96, latent=8, epochs=30, seed=0)
    key = jax.random.PRNGKey(0)
    init, perms = _lane_draws([key], 16, 8, 30, int(96 * 0.75))
    init, src = _seams(init, perms, ())
    cfg, res = train_fixture_head(16, 96, 8, 30, 0, "cpu", init_params=init, perm_source=src)
    assert (cfg.n_factors, cfg.latent_dim, cfg.batch_size, cfg.patience) == (16, 8, 32, 3)
    for k in ("encoder_kernel", "decoder_kernel"):
        np.testing.assert_allclose(res.params[k].numpy(), np.asarray(want.params[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    model = fixture_ae_model(device="cpu")
    assert model.module.encoder_kernel.shape == (16, 8)
    assert fixture_ae_model(device="cpu") is model                # cached


# --------------------------------------------------------------- the verb
def test_scenario_verb_modes_in_process(tmp_path, capsys):
    base = ["scenario", "--device", "cpu"]
    assert main(base + ["bank", "--fixture", "--out", str(tmp_path / "bank"),
                        "--train-epochs", "3", "--blocks", "2", "--block-size", "4",
                        "--family", "mtss_wgan_gp"]) == 0
    doc = json.loads(capsys.readouterr().out.split("\nbank: ")[0])
    assert doc["blocks"] == 6 and doc["generated"] == 6 and sum(doc["regime_months"]) == 96
    manifest = json.loads((tmp_path / "bank" / "bank.json").read_text())
    assert manifest["family"] == "mtss_wgan_gp" and manifest["window"] == 24
    assert main(base + ["bank", "--fixture", "--out", str(tmp_path / "bank"),
                        "--train-epochs", "3", "--blocks", "2", "--block-size", "4",
                        "--family", "mtss_wgan_gp", "--resume"]) == 0
    again = json.loads(capsys.readouterr().out.split("\nbank: ")[0])
    assert again["generated"] == 0 and again["aggregate_digest"] == doc["aggregate_digest"]
    wf = ["--latents", "1:2", "--start", "24", "--windows", "3", "--horizon", "30",
          "--epochs", "4", "--ols-window", "6"]
    assert main(base + ["walkforward", "--fixture", "--out", str(tmp_path / "wf")] + wf) == 0
    out = capsys.readouterr().out
    assert json.loads(out.split("\nsurface: ")[0])["stats"]["lanes"] == 6
    assert main(base + ["universe", "--out", str(tmp_path / "uni"), "--funds", "5",
                        "--months", "100", "--n-factors", "6", "--start", "40"] + wf[:-2]
                + ["--ols-window", "6"]) == 0
    doc = json.loads(capsys.readouterr().out.split("\nsurface: ")[0])
    assert doc["stats"]["funds"] == 5 and doc["stats"]["months"] == 100
    for d in ("wf", "uni"):
        lines = (tmp_path / d / "walkforward.csv").read_text().splitlines()
        assert lines[0] == "train_rows,latent_1,latent_2" and len(lines) == 4
        assert all(np.isfinite(float(c)) for row in lines[1:] for c in row.split(","))


def test_the_card_path_imports_no_pandas_or_matplotlib(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from hfrep_tpu_torch.experiments.cli import main;"
            "import hfrep_tpu_torch.metrics, hfrep_tpu_torch.scenario;"
            "assert main(['scenario', 'bank', '--fixture', '--device', 'cpu', '--out', "
            "sys.argv[2] + '/b', '--train-epochs', '1', '--blocks', '1', "
            "'--block-size', '2']) == 0;"
            "assert main(['scenario', 'universe', '--device', 'cpu', '--out', "
            "sys.argv[2] + '/u', '--funds', '4', '--months', '60', '--n-factors', '4', "
            "'--start', '20', '--windows', '2', '--horizon', '10', '--ols-window', '4', "
            "'--latents', '1:2', '--epochs', '2']) == 0;"
            "from hfrep_tpu_torch.metrics.gan_eval import GanEval;"
            "import numpy as np; c = np.random.default_rng(0).uniform(size=(8, 6, 3));"
            "GanEval(c, c[::-1], c).run_all();"
            "bad = [m for m in ('pandas', 'matplotlib', 'jax', 'h5py', 'tensorflow')"
            " if m in sys.modules];"
            "assert not bad, bad;"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tmp_path)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
