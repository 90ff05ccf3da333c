"""The port's precision policy (``core/precision.py``, the GAN steps' bf16
path, the AE engine's bf16 policy and the ``--dtype`` flags) against the
JAX package, mirroring ``tests/test_precision.py``.

* the float32 policy is the identity, and the float32 AE path dispatches
  no cast at all (its graph is the one the float32 pins hold);
* one bf16 epoch of the port against JAX's bf16 epoch (``lstm_backend=
  "xla"``), from JAX's init on JAX's draws (the ``Draws`` seam), for
  ``mtss_wgan_gp`` on both critic routes and for the BCE family
  ``mtss_gan``.  Each route follows its own JAX counterpart: the chained
  critic is JAX's two scans, and the fused stack adds b2 in float32 where
  the scan rounds ``h1.k2 + b2`` to bf16, a difference inside the bars;
* the bf16 trajectory against the float32 one from the same init, at
  JAX's own bars (rtol 5e-2, atol 5e-2);
* the AE at bf16 against JAX's on JAX's init and permutations (the
  ``init_params`` / ``perm_source`` seams), the losses at JAX's AE bf16
  bar (rtol 5e-2, atol 1e-4), and the evaluation sites (OOS prefixes,
  ex-ante weights) at bf16;
* ``train-gan --dtype bfloat16`` and ``sweep --dtype bfloat16`` in
  process beside the JAX verbs on a tiny preset.

Bars of the bf16 comparisons: losses rtol 5e-2 (``tests/test_precision.py``'s
bf16 bar); parameters |port - JAX| <= 1e-2 max(1, max|JAX|), the bar
``chip_smoke.py`` holds bf16 kernels to (one bf16 rounding of an h or a
gradient that flips is carried through the epoch).  An epoch's losses are
taken before its updates and its first updates move a parameter by about
lr, so those two bars cannot see a wrong gradient; what the gradients
decide is held too: the update p1 - p0 of each parameter within 0.25 of
JAX's in relative L2 (RMSprop and Adam normalise each entry, so a
gradient entry near zero whose sign bf16 rounding flips moves the
update by up to twice its size: the worst seen is 0.16, a gradient of
the wrong sign gives 2.0), and each optimizer slot within 0.2 of max|JAX|
(RMSprop's ν is (1 - decay) g² after the first update, Adam's μ
(1 - b1) g: the worst seen is 0.09, a penalty with no gradient gives
about 1.0 on the critic's).  ``test_bf16_epoch_bars_catch_a_wrong_gradient``
plants both faults and sees them fail.  The OOS metrics
rtol 5e-2 atol 1e-3 and the ex-ante outputs, which go through a
pseudo-inverse of bf16-rounded factors, 5e-2 scaled by max(1, max|JAX|).
The port runs on the CPU (its kernels' plain versions).
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hfrep_tpu import config as jax_config
from hfrep_tpu.config import AEConfig as JaxAEConfig
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.core import scaler as jax_scaler
from hfrep_tpu.core.data import load_panel as jax_load_panel
from hfrep_tpu.core.precision import policy_from as jax_policy_from
from hfrep_tpu.experiments.cli import main as jax_main
from hfrep_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from hfrep_tpu.models.autoencoder import latent_mask as jax_latent_mask
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.replication import engine as jax_engine
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu.train.steps import make_train_step as jax_make_train_step
from hfrep_tpu_torch import config as port_config
from hfrep_tpu_torch.config import AEConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.core.precision import policy_from
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.models.autoencoder import ae_apply, latent_mask
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.replication import engine
from hfrep_tpu_torch.train import (Draws, init_gan_state, make_multi_step, make_train_step,
                                   sample_draws)
from hfrep_tpu_torch.train import states, steps
from hfrep_tpu_torch.utils import checkpoint as ckpt
from hfrep_tpu_torch.utils.bridge import _slots_from_optax, from_flax, gan_state_from_flax, to_flax

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
H, W, F, B, NC, N_ROWS = 8, 6, 5, 4, 2, 16
LOSS_RTOL, PARAM_BAR, UPDATE_BAR, SLOT_BAR = 5e-2, 1e-2, 0.25, 0.2
AE_F, AE_LATENTS = 22, [1, 3, 21]
AE_CFG = dict(epochs=20, chunk_epochs=5, patience=3)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


class _Ops(TorchDispatchMode):
    """The aten ops a region dispatches (``names``) and the dtypes of
    their results (``dtypes``)."""

    def __init__(self):
        super().__init__()
        self.names, self.dtypes = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func.overloadpacket.__name__))
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.dtypes.add(t.dtype)
        return out


# ------------------------------------------------------------ the Policy
def test_fp32_policy_is_the_identity():
    pol = policy_from("float32")
    x = torch.ones((4, 3))
    tree = {"a": x, "b": torch.zeros((2,))}
    assert not pol.mixed
    assert pol.accum(x) is x and pol.compute(x) is x and pol.accum(tree) is tree
    assert pol.describe() == jax_policy_from("float32").describe()


def test_bf16_policy_casts_and_keeps_f32_accumulation():
    pol = policy_from("bfloat16")
    assert pol.mixed
    x = torch.ones((4,))
    assert pol.compute(x).dtype == torch.bfloat16
    assert pol.accum(x.to(torch.bfloat16)).dtype == torch.float32
    assert pol.describe() == jax_policy_from("bfloat16").describe() == {
        "compute": "bfloat16", "param": "float32", "output": "float32"}
    # cuBLAS reduces bf16 GEMMs in float32 since the package's import
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_registry_attaches_policy():
    mcfg = ModelConfig(family="mtss_wgan_gp", features=F, window=W, hidden=H)
    assert not build_gan(mcfg, device="cpu").policy.mixed
    pair = build_gan(dataclasses.replace(mcfg, dtype="bfloat16"), device="cpu")
    jpair = jax_build_gan(JaxModelConfig(family="mtss_wgan_gp", features=F, window=W,
                                         hidden=H, dtype="bfloat16"))
    assert pair.policy.mixed and jpair.policy.mixed
    assert pair.policy.describe() == jpair.policy.describe()
    assert all(p.dtype == torch.float32 for p in pair.generator.parameters())
    assert all(p.dtype == torch.float32 for p in pair.discriminator.parameters())


def test_bf16_step_computes_in_bf16_keeps_fp32_state():
    mcfg = ModelConfig(family="mtss_wgan_gp", features=F, window=W, hidden=H,
                       dtype="bfloat16")
    tcfg = TrainConfig(batch_size=B, n_critic=NC)
    pair = build_gan(mcfg, device="cpu")
    state = init_gan_state(0, mcfg, device="cpu")
    data = torch.from_numpy(np.random.default_rng(11).uniform(0, 1, (N_ROWS, W, F))
                            .astype(np.float32))
    g = torch.Generator()
    g.manual_seed(1)
    ops = _Ops()
    with ops:
        state, m = make_multi_step(pair, dataclasses.replace(tcfg, steps_per_call=1),
                                   data)(state, generator=g)
    # the step computes in bf16 (the fp32 step's ops make none: the
    # identity policy above)
    assert torch.bfloat16 in ops.dtypes
    for module in (state.generator, state.discriminator):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    for slots in (state.g_opt, state.d_opt):
        for v in slots.values():
            for t in (v.values() if isinstance(v, dict) else [v]):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    assert t.dtype == torch.float32
    assert m["d_loss"].dtype == torch.float32 and torch.isfinite(m["d_loss"]).all()


# ------------------------------------------- one bf16 epoch against JAX's
def _jax_draws(loss: str, key) -> Draws:
    """The draws the JAX ``make_train_step`` derives from ``key``."""
    if loss == "bce":
        k_idx, k_z1, k_z2 = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (B,), 0, N_ROWS)
        noises = jnp.stack([jax.random.normal(k, (B, W, F)) for k in (k_z1, k_z2)])
        return Draws(idx=_t(idx, torch.long), noises=_t(noises))
    with_alpha = loss == "wgan_gp"
    ks = [jax.random.split(jax.random.fold_in(key, i), 3 if with_alpha else 2)
          for i in range(NC)]
    idx = jnp.stack([jax.random.randint(k[0], (B,), 0, N_ROWS) for k in ks])
    noises = jnp.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])
    alphas = (jnp.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])
              if with_alpha else None)
    return Draws(idx=_t(idx, torch.long), noises=_t(noises),
                 alphas=None if alphas is None else _t(alphas))


def _bf16_epoch_errs(family: str, stack: str) -> dict:
    """One bf16 epoch of the port against JAX's from JAX's init on JAX's
    draws, the worst of each measure over every parameter: ``loss`` the
    relative loss error, ``param`` |port - JAX| / max(1, max|JAX|),
    ``update`` the update's direction |Δport - ΔJAX|_2 / |ΔJAX|_2 with
    Δ = p1 - p0, and ``slot`` the optimizer slots |port - JAX| /
    max|JAX| (the gradients' size, and for Adam's μ their sign)."""
    model = dict(family=family, hidden=H, window=W, features=F, dtype="bfloat16")
    jm = JaxModelConfig(**model)
    jt = JaxTrainConfig(batch_size=B, n_critic=NC, lstm_backend="xla")
    key = jax.random.PRNGKey(3)
    dataset = jax.random.uniform(key, (N_ROWS, W, F))
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(key, jm, jt, jpair)
    pair = build_gan(ModelConfig(**model), device="cpu")
    pair.discriminator.stack = stack
    state = gan_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate.g_params),
                                jax.tree_util.tree_map(np.asarray, jstate.d_params), pair)
    p0 = {name: {k: p.detach().clone() for k, p in module.named_parameters()}
          for name, module in (("g", state.generator), ("d", state.discriminator))}
    ekey = jax.random.PRNGKey(4)
    jstate1, jm1 = jax.jit(jax_make_train_step(jpair, jt, dataset))(jstate, ekey)
    state, m = make_train_step(pair, TrainConfig(batch_size=B, n_critic=NC),
                               _t(dataset))(state, _jax_draws(pair.loss, ekey))
    assert set(m) == set(jm1)
    errs = {"loss": 0.0, "param": 0.0, "update": 0.0, "slot": 0.0}
    for k in jm1:
        assert m[k].dtype == torch.float32
        errs["loss"] = max(errs["loss"], abs(float(m[k]) - float(jm1[k]))
                           / max(abs(float(jm1[k])), 1e-30))
    jstate1 = jax.tree_util.tree_map(np.asarray, jstate1)
    for name, module, tree, slots, jopt in (
            ("g", state.generator, jstate1.g_params, state.g_opt, jstate1.g_opt),
            ("d", state.discriminator, jstate1.d_params, state.d_opt, jstate1.d_opt)):
        got = jax.tree_util.tree_leaves_with_path(to_flax(module))
        ref = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (_, a), (_, r) in zip(got, ref):
            assert a.dtype == np.float32
            errs["param"] = max(errs["param"], _scaled_err(a, r))
        ref_module = from_flax(tree, copy.deepcopy(module))
        ref_slots = _slots_from_optax(jopt, module, pair.loss)
        for (k, a), (_, r) in zip(module.named_parameters(), ref_module.named_parameters()):
            da = a.detach().double() - p0[name][k].double()
            dr = r.detach().double() - p0[name][k].double()
            errs["update"] = max(errs["update"], float((da - dr).norm() / dr.norm()))
            for slot in ("mu", "nu"):
                if slot in ref_slots:
                    x, y = slots[slot][k].double(), ref_slots[slot][k].double()
                    errs["slot"] = max(errs["slot"],
                                       float((x - y).abs().max() / y.abs().max()))
    return errs


@pytest.mark.parametrize("family,stack", [("mtss_wgan_gp", "auto"),
                                          ("mtss_wgan_gp", "chained"),
                                          ("mtss_gan", "auto")])
def test_bf16_epoch_matches_jax(family, stack):
    errs = _bf16_epoch_errs(family, stack)
    assert errs["loss"] <= LOSS_RTOL, errs
    assert errs["param"] <= PARAM_BAR, errs
    assert errs["update"] <= UPDATE_BAR, errs
    assert errs["slot"] <= SLOT_BAR, errs


def _negated(update):
    def wrong(self, params, grads, slots):
        return update(self, params, {k: -g for k, g in grads.items()}, slots)
    return wrong


def _plant(monkeypatch, plant: str) -> None:
    """A wrong gradient: ``"sign"`` negates every optimizer update's
    gradients; ``"penalty"`` keeps the penalty's value in the critic's
    loss and drops its gradient."""
    if plant == "sign":
        for cls in (states.RMSprop, states.Adam):
            monkeypatch.setattr(cls, "update", _negated(cls.update))
    else:
        penalty = steps.gradient_penalty
        monkeypatch.setattr(steps, "gradient_penalty",
                            lambda d, x, sq_sum=None: penalty(d, x, sq_sum).detach())


@pytest.mark.parametrize("family,stack,plant", [("mtss_wgan_gp", "auto", "sign"),
                                                ("mtss_wgan_gp", "auto", "penalty"),
                                                ("mtss_wgan_gp", "chained", "penalty"),
                                                ("mtss_gan", "auto", "sign")])
def test_bf16_epoch_bars_catch_a_wrong_gradient(monkeypatch, family, stack, plant):
    """The bars above hold what the gradients decide: a planted gradient
    of the wrong sign (every optimizer update negated), or a penalty whose
    value stays in the loss but whose gradient is gone, fails them, though
    the losses, taken before the updates, still pass."""
    _plant(monkeypatch, plant)
    errs = _bf16_epoch_errs(family, stack)
    assert errs["loss"] <= LOSS_RTOL, errs
    assert errs["update"] > UPDATE_BAR or errs["slot"] > SLOT_BAR, errs


@pytest.mark.parametrize("stack,plant", [("auto", None), ("auto", "sign"),
                                         ("chained", "penalty")])
def test_chip_smoke_bf16_epoch_parity_catches_a_wrong_gradient(monkeypatch, stack, plant):
    """``chip_smoke.epoch_parity``'s bf16 branch (card against CPU) run
    here with both sides on the CPU, the "card" side's step planted with
    a wrong gradient: the same epoch passes, a planted one fails, and the
    param bar alone (which the planted epochs pass) would not see it."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    mcfg = ModelConfig(family="mtss_wgan_gp", features=F, window=W, hidden=H, dtype="bfloat16")
    tcfg = TrainConfig(batch_size=B, n_critic=NC)
    pair = build_gan(mcfg, device="cpu")
    state = init_gan_state(0, mcfg, device="cpu")
    state.discriminator.stack = stack
    data = torch.from_numpy(np.random.default_rng(11).uniform(0, 1, (N_ROWS, W, F))
                            .astype(np.float32))
    g = torch.Generator()
    g.manual_seed(1)
    state, _ = make_train_step(pair, tcfg, data)(state, sample_draws(g, pair, tcfg, data))

    def step_on(dev):
        step = make_train_step(pair, tcfg, data)
        if dev == "cpu" or plant is None:
            return step

        def planted(state, draws):
            with pytest.MonkeyPatch.context() as mp:
                _plant(mp, plant)
                return step(state, draws)

        return planted

    r = chip_smoke.epoch_parity(torch, step_on, state, sample_draws(g, pair, tcfg, data),
                                bf16=True)
    assert r["param_scaled_err"] <= chip_smoke.BF16_PARAM_BAR, r
    assert r["ok"] is (plant is None), r
    if plant is None:
        assert r["update_rel_l2"] == r["slot_scaled_err"] == 0.0, r


# ----------------------------------------------- bf16 against float32
@pytest.mark.parametrize("family", ["gan", "wgan", "mtss_wgan_gp"])
def test_bf16_tracks_fp32_trajectory(family):
    """Three epochs from one init (the init never runs in the compute
    dtype: bitwise the same), the losses within JAX's own tolerance."""
    data = torch.from_numpy(np.random.default_rng(11).uniform(0, 1, (64, 8, 5))
                            .astype(np.float32))
    tcfg = TrainConfig(epochs=6, batch_size=4, n_critic=2, steps_per_call=3)
    losses, inits = {}, {}
    for dtype in ("float32", "bfloat16"):
        mcfg = ModelConfig(family=family, features=5, window=8, hidden=8, dtype=dtype)
        pair = build_gan(mcfg, device="cpu")
        state = init_gan_state(0, mcfg, device="cpu")
        inits[dtype] = [p.detach().clone() for p in state.generator.parameters()]
        g = torch.Generator()
        g.manual_seed(7)
        state, m = make_multi_step(pair, tcfg, data)(state, generator=g)
        losses[dtype] = m["d_loss"].numpy()
    for a, b in zip(inits["float32"], inits["bfloat16"]):
        assert torch.equal(a, b)
    assert np.isfinite(losses["bfloat16"]).all()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------- the AE engine
@pytest.fixture(scope="module")
def panel():
    p = jax_load_panel(CLEANED)
    xtr, xte, ytr, yte = (np.asarray(a) for a in p.train_test_split())
    _, xs = jax_scaler.fit_transform(jnp.asarray(xtr))
    return {"x_train": xtr, "x_test": xte, "y_train": ytr, "y_test": yte,
            "x_scaled": np.asarray(xs), "rf": np.asarray(p.rf)[xtr.shape[0]:],
            "factors": np.asarray(p.factors)}


def _lane_draws(keys, m: int, epochs: int, n_train: int):
    """JAX's draws of each lane key (``_ae_init`` / ``_ae_epoch_step``)."""
    enc, dec, perms = [], [], []
    perm = jax.jit(jax.vmap(lambda k: jax.random.permutation(k, n_train)))
    for k in keys:
        k, init_key = jax.random.split(k)
        p = JaxAutoencoder(n_features=AE_F, latent_dim=m).init(
            init_key, jnp.zeros((1, AE_F)))["params"]
        enc.append(np.asarray(p["encoder_kernel"]))
        dec.append(np.asarray(p["decoder_kernel"]))
        perms.append(np.asarray(perm(jax.random.split(k, epochs))).astype(np.int64))
    init = {"encoder_kernel": np.stack(enc), "decoder_kernel": np.stack(dec)}
    return init, np.stack(perms)


def _seams(init, perms, lead):
    init = {k: v.reshape(lead + v.shape[1:]) for k, v in init.items()}
    perms = torch.from_numpy(perms.reshape(lead + perms.shape[1:]))
    return init, (lambda pos, n: perms[..., pos:pos + n, :])


def _assert_ae(got, want):
    """No lane stops in these 20 epochs at lr 1e-3, so every loss is finite
    on both sides; the losses at JAX's AE bf16 bar."""
    for k in ("train_loss", "val_loss"):
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert np.isfinite(g).all() and np.isfinite(w).all(), k
        np.testing.assert_allclose(g, w, rtol=5e-2, atol=1e-4, err_msg=k)
    for k, v in got.params.items():
        assert v.dtype == torch.float32
        assert _scaled_err(v.numpy(), np.asarray(want.params[k])) <= PARAM_BAR, k


def test_bf16_single_lane_training_matches_jax(panel):
    jcfg, cfg = JaxAEConfig(dtype="bfloat16", **AE_CFG), AEConfig(dtype="bfloat16", **AE_CFG)
    key = jax.random.PRNGKey(3)
    x = panel["x_scaled"]
    want = jax.jit(lambda k: jax_engine.train_autoencoder(k, jnp.asarray(x), jcfg))(key)
    init, perms = _lane_draws([key], jcfg.latent_dim, jcfg.epochs, int(x.shape[0] * 0.75))
    init, src = _seams(init, perms, ())
    got = engine.train_autoencoder(0, x, cfg, init_params=init, perm_source=src,
                                   device="cpu")
    _assert_ae(got, want)


def test_bf16_lane_sweep_matches_jax(panel):
    jcfg, cfg = JaxAEConfig(dtype="bfloat16", **AE_CFG), AEConfig(dtype="bfloat16", **AE_CFG)
    key = jax.random.PRNGKey(5)
    x = panel["x_scaled"]
    want, _ = jax_engine.sweep_autoencoders_chunked(key, jnp.asarray(x), jcfg, AE_LATENTS)
    init, perms = _lane_draws(jax.random.split(key, len(AE_LATENTS)), max(AE_LATENTS),
                              jcfg.epochs, int(x.shape[0] * 0.75))
    init, src = _seams(init, perms, (len(AE_LATENTS),))
    got, _ = engine.sweep_autoencoders_chunked(0, x, cfg, AE_LATENTS, init_params=init,
                                               perm_source=src, device="cpu")
    _assert_ae(got, want)


def test_ae_bf16_tracks_fp32():
    """JAX's ``test_ae_bf16_tracks_fp32`` on the port: one seed, both
    policies; the validation losses within rtol 5e-2, atol 1e-4."""
    x = np.random.default_rng(5).normal(0, 0.05, (40, 6)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = AEConfig(n_factors=6, latent_dim=4, epochs=12, batch_size=16, seed=0,
                       dtype=dtype)
        out[dtype] = engine.train_autoencoder(0, x, cfg, device="cpu").val_loss.numpy()
    finite = np.isfinite(out["float32"])
    np.testing.assert_allclose(out["bfloat16"][finite], out["float32"][finite],
                               rtol=5e-2, atol=1e-4)


@pytest.fixture(scope="module")
def jax_lanes(panel):
    """JAX-trained params of three latent lanes (40 epochs, float32)."""
    res = jax_engine.sweep_autoencoders(jax.random.PRNGKey(123),
                                        jnp.asarray(panel["x_scaled"]),
                                        JaxAEConfig(epochs=40), [1, 7, 21])
    return {k: np.asarray(v) for k, v in res.params.items()}, [1, 7, 21]


@pytest.mark.parametrize("lane", [0, 2])
def test_bf16_oos_prefix_metrics_and_ante_weights_match_jax(panel, jax_lanes, lane):
    params, lats = jax_lanes
    p = {k: v[lane] for k, v in params.items()}
    d = lats[lane]
    jcfg, cfg = JaxAEConfig(dtype="bfloat16"), AEConfig(dtype="bfloat16")
    jmodel = jax_engine._ae_model(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jmask, mask = jax_latent_mask(d, 21), latent_mask(d, 21, device="cpu")
    xte = panel["x_test"]
    jr2, jrmse = jax_engine.oos_prefix_metrics(jmodel, jnp.asarray(xte), jp, jmask)
    r2, rmse = engine.oos_prefix_metrics(_t(xte), tp, mask, cfg.leaky_slope,
                                         engine.compute_dtype(cfg))
    assert r2.dtype == rmse.dtype == torch.float32
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(rmse.numpy(), np.asarray(jrmse), rtol=5e-2, atol=1e-3)
    args = (jnp.asarray(xte), jnp.asarray(panel["y_test"]), jnp.asarray(panel["rf"]))
    jante, jw = jax_engine.ante_weights(jmodel, jcfg, jp, jmask, *args, jcfg.ols_window)
    ante, w = engine.ante_weights(cfg, tp, mask, _t(xte), _t(panel["y_test"]),
                                  panel["rf"], cfg.ols_window)
    assert ante.dtype == w.dtype == torch.float32
    assert _scaled_err(ante.numpy(), np.asarray(jante)) < 5e-2
    assert _scaled_err(w.numpy(), np.asarray(jw)) < 5e-2


def test_bf16_engine_api_matches_jax(panel, jax_lanes):
    """``ReplicationEngine`` at bf16: in-sample fit through ``_apply``,
    the OOS metrics and the strategy against JAX's engine at bf16."""
    params, _ = jax_lanes
    lane = {k: v[2] for k, v in params.items()}
    args = (panel["x_train"], panel["y_train"], panel["x_test"], panel["y_test"])
    je = jax_engine.ReplicationEngine(*args, JaxAEConfig(dtype="bfloat16"))
    pe = engine.ReplicationEngine(*args, AEConfig(dtype="bfloat16"), device="cpu")
    je.use_params({k: jnp.asarray(v) for k, v in lane.items()}, jax_latent_mask(21, 21))
    pe.use_params(lane, latent_mask(21, 21, device="cpu"))
    np.testing.assert_allclose(pe.model_IS_r2(), je.model_IS_r2(), rtol=5e-2)
    np.testing.assert_allclose(pe.model_IS_RMSE(), je.model_IS_RMSE(), rtol=5e-2)
    np.testing.assert_allclose(pe.model_OOS_r2(), je.model_OOS_r2(), rtol=5e-2, atol=1e-3)
    assert _scaled_err(pe.ante(panel["rf"]), je.ante(panel["rf"])) < 5e-2
    assert _scaled_err(pe.post(panel["factors"]), je.post(panel["factors"])) < 5e-2


def test_fp32_ae_path_builds_no_cast(panel):
    """The float32 policy applies the model with no cast: the products'
    operands go to ``mm`` as they are, and nothing in the training grid or
    the evaluation sites makes a bf16 tensor (JAX's "no bf16 in the
    jaxpr" pin); the bf16 policy casts both operands of both products."""
    cfg = AEConfig(epochs=2, chunk_epochs=0)
    x, mask = _t(panel["x_scaled"]), latent_mask(5, 21, device="cpu")
    enc = torch.rand(22, 21)
    dec = torch.rand(21, 22)
    for dtype, casts in ((None, 0), (torch.bfloat16, 4)):
        ops = _Ops()
        with ops:
            ae_apply(x, enc, dec, mask, 0.2, dtype)
        assert ops.names.count("_to_copy") == casts, (dtype, ops.names)
    assert engine.compute_dtype(cfg) is None
    ops = _Ops()
    with ops:
        engine.train_autoencoder(0, x, cfg, device="cpu")
        engine.evaluate_params(cfg, x, _t(panel["x_test"]), _t(panel["y_test"]),
                               panel["rf"], panel["factors"],
                               {"encoder_kernel": enc, "decoder_kernel": dec}, mask)
    assert torch.bfloat16 not in ops.dtypes


# ----------------------------------------------------------------- the verbs
@pytest.fixture
def tiny_preset(monkeypatch):
    """One tiny preset at test widths over the committed panel's 35
    features, in both packages' ``PRESETS``."""
    model = dict(family="mtss_wgan_gp", hidden=H, window=W, features=35)
    train = dict(batch_size=B, n_critic=NC, steps_per_call=2, checkpoint_every=2, epochs=4)
    monkeypatch.setitem(port_config.PRESETS, "tiny", port_config.ExperimentConfig(
        data=port_config.DataConfig(n_sample=48, window=W), model=ModelConfig(**model),
        train=TrainConfig(**train), name="tiny"))
    monkeypatch.setitem(jax_config.PRESETS, "tiny", jax_config.ExperimentConfig(
        data=jax_config.DataConfig(n_sample=48, window=W), model=JaxModelConfig(**model),
        train=JaxTrainConfig(lstm_backend="xla", **train), name="tiny"))
    return "tiny"


def _float_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _float_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _float_leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
        return [tree]
    return []


def test_train_gan_dtype_bfloat16_beside_jax(tmp_path, tiny_preset, capsys):
    """Both verbs train the tiny preset under ``--dtype bfloat16`` with
    checkpoints: exit 0, finite losses, a checkpoint whose floating
    leaves are all float32 (master weights and slots), and a resume that
    is bit for bit the straight run."""
    common = ["train-gan", "--preset", tiny_preset, "--cleaned-dir", CLEANED, "--quiet",
              "--dtype", "bfloat16", "--n-samples", "2"]
    assert jax_main(common + ["--checkpoint-dir", str(tmp_path / "j")]) == 0
    jout = capsys.readouterr().out
    a, b = tmp_path / "a", tmp_path / "b"
    port = common + ["--device", "cpu"]
    assert main(port + ["--checkpoint-dir", str(a), "--samples-out", str(a / "s.npy")]) == 0
    out = capsys.readouterr().out
    for text in (jout, out):
        assert "trained mtss_wgan_gp for 4 epochs (" in text
    leaves = _float_leaves(ckpt.restore(str(a / "ckpt_4")))
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    cube = np.load(a / "s.npy")
    assert cube.shape == (2, W, 35) and np.isfinite(cube).all()
    # a resume from ckpt_2 completes the schedule as the straight run did
    assert main(port + ["--epochs", "2", "--checkpoint-dir", str(b)]) == 0
    assert main(port + ["--resume", "--checkpoint-dir", str(b),
                        "--samples-out", str(b / "s.npy")]) == 0
    assert f"resumed from {b}/ckpt_2 (epoch 2)" in capsys.readouterr().out
    assert np.array_equal(np.load(b / "s.npy"), cube)
    straight, resumed = (ckpt.restore(str(d / "ckpt_4")) for d in (a, b))
    sl, rl = _float_leaves(straight), _float_leaves(resumed)
    assert len(sl) == len(rl) and all(torch.equal(x, y) for x, y in zip(sl, rl))


def test_sweep_dtype_bfloat16_beside_jax(tmp_path, capsys):
    """Both verbs' bf16 sweep, real only: the same files with the same
    columns and rows, every number finite."""
    common = ["sweep", "--cleaned-dir", CLEANED, "--latents", "1:3", "--epochs", "8",
              "--dtype", "bfloat16"]
    assert jax_main(common + ["--out", str(tmp_path / "j")]) == 0
    jdoc = capsys.readouterr().out
    assert main(common + ["--device", "cpu", "--out", str(tmp_path / "p")]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == set(json.loads(jdoc[jdoc.index("{"):jdoc.rindex("}") + 1]))
    jfiles = sorted(p.name for p in (tmp_path / "j").iterdir() if p.suffix == ".csv")
    files = sorted(p.name for p in (tmp_path / "p").iterdir() if p.suffix == ".csv")
    assert files == jfiles and files
    for name in files:
        got = (tmp_path / "p" / name).read_text().splitlines()
        want = (tmp_path / "j" / name).read_text().splitlines()
        assert got[0] == want[0] and len(got) == len(want), name
        nums = [float(v) for line in got[1:] for v in line.split(",")[1:] if v]
        assert all(np.isfinite(nums)), name
