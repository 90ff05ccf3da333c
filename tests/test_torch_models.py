"""The port's models and layers (``hfrep_tpu_torch``) against the JAX package.

JAX params, made by the JAX package's own init, cross into the port
through ``utils.bridge``; the same numpy inputs go through both.  Bars:
f32 atol 1e-5, rtol 1e-4; bf16 policy atol 3e-2 after scaling by
max|ref|.  The JAX generator runs its scan path and, for the LSTM body,
also the Pallas kernel in interpret mode.
"""

from __future__ import annotations

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu import config as jax_config
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu.models.registry import build_gan
from hfrep_tpu_torch import config as port_config
from hfrep_tpu_torch.config import ModelConfig
from hfrep_tpu_torch.core.precision import Policy, policy_from
from hfrep_tpu_torch.models.autoencoder import Autoencoder, latent_mask
from hfrep_tpu_torch.models.generators import DenseGenerator, LSTMGenerator
from hfrep_tpu_torch.models.registry import FAMILIES, build_generator
from hfrep_tpu_torch.ops.layers import KerasLayerNorm, leaky_relu
from hfrep_tpu_torch.ops.lstm import KerasLSTM
from hfrep_tpu_torch.utils.bridge import from_flax, to_flax

H, F, W, B = 16, 5, 8, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _scaled_close(got, ref, bar=3e-2):
    scale = max(float(np.max(np.abs(ref))), 1e-6)
    np.testing.assert_allclose(got / scale, ref / scale, atol=bar)


def _gen_case(family, dtype="float32", seed=0):
    jcfg = JaxModelConfig(family=family, hidden=H, features=F, window=W, dtype=dtype)
    gen = build_gan(jcfg).generator
    z = np.random.default_rng(seed).normal(size=(B, W, F)).astype(np.float32)
    params = gen.init(jax.random.PRNGKey(seed), jnp.asarray(z))["params"]
    pcfg = ModelConfig(family=family, hidden=H, features=F, window=W, dtype=dtype)
    port = from_flax(_np_tree(params), build_generator(pcfg, device="cpu"))
    return gen, params, port, z


@pytest.mark.parametrize("family", ["mtss_wgan_gp", "wgan_gp"])
def test_generator_f32_matches_jax(family):
    gen, params, port, z = _gen_case(family)
    ref = np.asarray(gen.apply({"params": params}, jnp.asarray(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(z)).numpy()
    assert got.shape == (B, W, F)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    if family.startswith("mtss"):
        pallas = np.asarray(gen.apply({"params": params}, jnp.asarray(z),
                                      backend="pallas"))
        np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", ["mtss_wgan_gp", "wgan_gp"])
def test_generator_bf16_policy_matches_jax(family):
    """The LSTM body is held against the JAX generator on its Pallas
    kernel, whose bf16 contract (f32 state, bf16 operand streams) the
    port's recurrence shares; the scan path keeps its state in bf16."""
    gen, params, port, z = _gen_case(family, dtype="bfloat16", seed=1)
    backend = "pallas" if family.startswith("mtss") else None
    ref = gen.apply({"params": params}, jnp.asarray(z), backend=backend)
    with torch.no_grad():
        out = port(torch.from_numpy(z))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _scaled_close(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_autoencoder_with_mask_matches_jax(dtype):
    g = np.random.default_rng(4)
    x = (0.1 * g.normal(size=(2, 12, 6))).astype(np.float32)
    jdt = None if dtype is None else jnp.dtype(dtype)
    jae = JaxAutoencoder(n_features=6, latent_dim=4, dtype=jdt)
    params = jae.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    jmask = (jnp.arange(4) < 3).astype(jnp.float32)
    ref = np.asarray(jae.apply({"params": params}, jnp.asarray(x), jmask), np.float32)
    ae = from_flax(_np_tree(params), Autoencoder(
        6, 4, dtype=None if dtype is None else torch.bfloat16, device="cpu"))
    mask = latent_mask(3, 4, device="cpu")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    with torch.no_grad():
        got = ae(torch.from_numpy(x), mask).float().numpy()
    if dtype is None:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    else:
        _scaled_close(got, ref)
    with torch.no_grad():
        z = ae.encode(torch.from_numpy(x), mask)
    assert float(z[..., 3:].abs().max()) == 0.0       # masked lane is zero


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_eps_and_variance_match_flax(dtype):
    """Keras eps 1e-3 and Flax's f32 statistics; inputs with a small
    spread, where the eps dominates the variance."""
    g = np.random.default_rng(5)
    x = (0.05 * g.normal(size=(4, 7, 10))).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-3, dtype=dtype)
    xin = jnp.asarray(x).astype(dtype)
    params = ln.init(jax.random.PRNGKey(0), xin)["params"]
    params = {"scale": params["scale"] * 1.5, "bias": params["bias"] + 0.25}
    ref = np.asarray(ln.apply({"params": params}, xin), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    port = from_flax({"LayerNorm_0": _np_tree(params)},
                     KerasLayerNorm(10, dtype=tdt, device="cpu"))
    with torch.no_grad():
        out = port(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    if dtype == jnp.float32:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)
    else:
        _scaled_close(out.float().numpy(), ref)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_leaky_relu_matches_jax_bitwise(dtype):
    from hfrep_tpu.ops.layers import leaky_relu as jax_leaky_relu

    x = np.random.default_rng(6).normal(size=(64,)).astype(np.float32)
    ref = np.asarray(jax_leaky_relu(jnp.asarray(x).astype(dtype)), np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = leaky_relu(torch.from_numpy(x).to(tdt)).float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("family", ["mtss_gan", "gan"])
def test_bridge_round_trip_is_exact(family):
    gen, params, port, _ = _gen_case(family)
    tree = _np_tree(params)
    back = to_flax(port)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_bridge_refuses_mismatches():
    port = LSTMGenerator(F, hidden=H, device="cpu")
    tree = to_flax(port)
    bad = dict(tree, KerasLSTM_0=dict(tree["KerasLSTM_0"],
                                      kernel=np.zeros((F + 1, 4 * H), np.float32)))
    with pytest.raises(ValueError, match="JAX shape"):
        from_flax(bad, port)
    with pytest.raises(KeyError, match="KerasLSTM_7"):
        from_flax({"KerasLSTM_7": {}}, port)
    with pytest.raises(KeyError, match="no parameter"):
        from_flax({"KerasDense_0": {"Dense_0": {"gain": np.zeros(3)}}}, port)


def test_keras_default_init():
    g = torch.Generator()
    g.manual_seed(3)
    lstm = KerasLSTM(F, H, device="cpu", generator=g)
    rec = lstm.recurrent_kernel.detach()
    torch.testing.assert_close(rec @ rec.T, torch.eye(H), atol=1e-5, rtol=0)
    bias = lstm.bias.detach()
    assert bias[H:2 * H].eq(1).all() and bias[:H].eq(0).all() and bias[2 * H:].eq(0).all()
    limit = np.sqrt(6.0 / (F + 4 * H))
    assert float(lstm.kernel.detach().abs().max()) <= limit
    g2 = torch.Generator()
    g2.manual_seed(3)
    again = KerasLSTM(F, H, device="cpu", generator=g2)
    assert torch.equal(again.kernel, lstm.kernel)
    assert torch.equal(again.recurrent_kernel, lstm.recurrent_kernel)


def test_registry_families_and_policy():
    assert set(FAMILIES) == {"gan", "wgan", "wgan_gp", "mtss_gan", "mtss_wgan",
                             "mtss_wgan_gp"}
    assert isinstance(build_generator(ModelConfig(family="mtss_wgan", hidden=H,
                                                  features=F), device="cpu"),
                      LSTMGenerator)
    assert isinstance(build_generator(ModelConfig(family="wgan", hidden=H,
                                                  features=F), device="cpu"),
                      DenseGenerator)
    with pytest.raises(KeyError, match="unknown GAN family"):
        build_generator(ModelConfig(family="vae"), device="cpu")
    p32 = policy_from("float32")
    x = torch.ones(2, dtype=torch.bfloat16)
    assert not p32.mixed and p32.compute(x) is x and p32.accum(x) is x
    p16 = policy_from("bfloat16")
    assert p16.mixed and p16.compute({"a": torch.ones(2)})["a"].dtype == torch.bfloat16
    assert p16.accum([x])[0].dtype == torch.float32
    assert p16.describe() == {"compute": "bfloat16", "param": "float32",
                              "output": "float32"}
    assert Policy().describe()["compute"] == "float32"


def test_config_copy_matches_jax_presets():
    """The port keeps its own copy of ``config.py``; every preset must
    mean the same model (the data directory is the port's own)."""
    assert sorted(port_config.PRESETS) == sorted(jax_config.PRESETS)
    for name in jax_config.PRESETS:
        a = dataclasses.asdict(jax_config.get_preset(name))
        b = dataclasses.asdict(port_config.get_preset(name))
        a["data"].pop("cleaned_dir")
        b["data"].pop("cleaned_dir")
        assert a == b, name
