"""The port's training (``hfrep_tpu_torch.train``) against the JAX package.

One epoch per family, and then three epochs through ``make_multi_step``,
from the same starting params (JAX's own init, bridged) and the same
draws: the test derives each JAX epoch's draws outside the JAX package,
exactly as ``_critic_loop_inputs`` and ``bce_step`` derive them, and
hands them to the port's step.  The JAX step runs with
``lstm_backend="xla"`` (the scan), which the JAX suite pins equal to its
Pallas epoch; the port runs on ``device="cpu"``, i.e. through the plain
versions of its kernels under the same nested autograd.  Bars: d_loss
and g_loss rtol 1e-4; every param after the step atol 1e-5, rtol 1e-4;
critics' forward atol 1e-5; the optimizers against optax atol 1e-7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu.train.steps import make_multi_step as jax_make_multi_step
from hfrep_tpu.train.steps import make_train_step as jax_make_train_step
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.models import discriminators as port_disc
from hfrep_tpu_torch.models.registry import FAMILIES, GanPair, build_discriminator, build_gan
from hfrep_tpu_torch.train import Draws, init_gan_state, make_multi_step, make_train_step
from hfrep_tpu_torch.train.states import Adam, RMSprop
from hfrep_tpu_torch.train.steps import sample_draws
from hfrep_tpu_torch.utils.bridge import from_flax, gan_state_from_flax, to_flax

H, W, F, B, NC, N_ROWS = 8, 6, 5, 4, 2, 16
EPOCH_FAMILIES = ["mtss_wgan_gp", "mtss_wgan", "mtss_gan", "wgan_gp"]
#: the MTSS plain-stack critics run fused by default; each also runs on
#: the chained route it can ask for (``stack="chained"``)
CHAINED = ["mtss_wgan_gp", "mtss_gan"]


def _routes(families):
    """(family, stack) cases: the default route keeps the family's id."""
    return ([pytest.param(f, "auto", id=f) for f in families]
            + [pytest.param(f, "chained", id=f"{f}-chained") for f in CHAINED])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _jax_draws(loss: str, key) -> Draws:
    """The draws ``make_train_step`` derives from ``key`` for ``loss``."""
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


def _case(family, steps_per_call=1, stack="auto"):
    jm = JaxModelConfig(family=family, hidden=H, window=W, features=F)
    jt = JaxTrainConfig(batch_size=B, n_critic=NC, lstm_backend="xla",
                        steps_per_call=steps_per_call)
    key = jax.random.PRNGKey(3)
    dataset = jax.random.uniform(key, (N_ROWS, W, F))
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(key, jm, jt, jpair)
    pm = ModelConfig(family=family, hidden=H, window=W, features=F)
    pt = TrainConfig(batch_size=B, n_critic=NC, steps_per_call=steps_per_call)
    pair = build_gan(pm, device="cpu")
    if stack != "auto":
        pair.discriminator.stack = stack
    state = gan_state_from_flax(_np(jstate.g_params), _np(jstate.d_params), pair)
    return jpair, jt, dataset, jstate, pair, pt, _t(dataset), state


def _assert_params(state, jstate):
    for name, module, tree in (("g", state.generator, jstate.g_params),
                               ("d", state.discriminator, jstate.d_params)):
        got = jax.tree_util.tree_leaves_with_path(to_flax(module))
        ref = jax.tree_util.tree_leaves_with_path(_np(tree))
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (path, a), (_, r) in zip(got, ref):
            np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("family,stack", _routes(EPOCH_FAMILIES))
def test_one_epoch_matches_jax(family, stack):
    jpair, jt, dataset, jstate, pair, pt, tds, state = _case(family, stack=stack)
    key = jax.random.PRNGKey(4)
    jstate1, jm = jax.jit(jax_make_train_step(jpair, jt, dataset))(jstate, key)
    state, m = make_train_step(pair, pt, tds)(state, _jax_draws(pair.loss, key))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(jstate1.step) == 1
    _assert_params(state, jstate1)


@pytest.mark.parametrize("family,stack", _routes(["mtss_wgan_gp", "mtss_gan"]))
def test_three_epochs_through_multi_step_match_jax(family, stack):
    """Keys folded per epoch as the JAX scan folds them; the second and
    third epochs start from nonzero optimizer slots."""
    jpair, jt, dataset, jstate, pair, pt, tds, state = _case(family, steps_per_call=3,
                                                              stack=stack)
    key = jax.random.PRNGKey(9)
    jstate3, jm = jax_make_multi_step(jpair, jt, dataset)(jstate, key)
    draws = [_jax_draws(pair.loss, jax.random.fold_in(key, i)) for i in range(3)]
    state, m = make_multi_step(pair, pt, tds)(state, draws)
    for k in jm:
        assert m[k].shape == (3,)
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(jstate3.step) == 3
    _assert_params(state, jstate3)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_critic_forward_matches_jax(family):
    jm = JaxModelConfig(family=family, hidden=H, window=W, features=F)
    critic = jax_build_gan(jm).discriminator
    x = np.random.default_rng(1).normal(size=(3, W, F)).astype(np.float32)
    params = critic.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    ref = np.asarray(critic.apply({"params": params}, jnp.asarray(x)))
    port = from_flax(_np(params), build_discriminator(
        ModelConfig(family=family, hidden=H, window=W, features=F), device="cpu"))
    assert type(port).__name__ == type(critic).__name__
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", CHAINED)
def test_critic_params_identical_across_routes(family, monkeypatch):
    """The port's counterpart of test_pallas_stack.py's
    ``test_critic_params_identical_across_backends``: bridged JAX params
    load into the fused and the chained critic alike (the parameters stay
    on lstm0/lstm1), and both routes score alike."""
    jm = JaxModelConfig(family=family, hidden=H, window=W, features=F)
    critic = jax_build_gan(jm).discriminator
    x = np.random.default_rng(8).normal(size=(2, W, F)).astype(np.float32)
    params = _np(critic.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"])
    cfg = ModelConfig(family=family, hidden=H, window=W, features=F)
    fused = from_flax(params, build_discriminator(cfg, device="cpu"))
    chained = from_flax(params, build_discriminator(cfg, device="cpu"))
    chained.stack = "chained"
    for port in (fused, chained):
        tree = to_flax(port)
        assert (jax.tree_util.tree_structure(tree)
                == jax.tree_util.tree_structure(params))
        for a, r in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
            assert np.array_equal(a, r)
    fused_calls = []
    fused_stack = port_disc.keras_lstm_stack
    monkeypatch.setattr(port_disc, "keras_lstm_stack",
                        lambda *a, **k: fused_calls.append(1) or fused_stack(*a, **k))
    with torch.no_grad():
        out_f = fused(torch.from_numpy(x)).numpy()
        assert len(fused_calls) == 1
        out_c = chained(torch.from_numpy(x)).numpy()
        assert len(fused_calls) == 1
    np.testing.assert_allclose(out_f, out_c, atol=1e-6)
    with pytest.raises(ValueError, match="stack must be one of"):
        port_disc._plain_stack(fused.lstm0, fused.lstm1, torch.from_numpy(x), "pallas")


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizers_match_optax(kind):
    g = np.random.default_rng(6)
    p0 = {"a": g.normal(size=(4, 3)).astype(np.float32),
          "b": g.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (g.normal(size=v.shape) * 10.0 ** g.integers(-4, 1)).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    if kind == "rmsprop":
        tx, port = optax.rmsprop(5e-5, decay=0.9, eps=1e-7), RMSprop(5e-5, decay=0.9, eps=1e-7)
    else:
        tx = optax.adam(2e-4, b1=0.5, b2=0.999, eps=1e-7)
        port = Adam(2e-4, b1=0.5, b2=0.999, eps=1e-7)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    slots = port.init(tp)
    for gr in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        port.update(tp, {k: torch.from_numpy(v) for k, v in gr.items()}, slots)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)


def test_registry_builds_every_family_with_its_loss():
    losses = {"gan": "bce", "mtss_gan": "bce", "wgan": "wgan_clip",
              "mtss_wgan": "wgan_clip", "wgan_gp": "wgan_gp", "mtss_wgan_gp": "wgan_gp"}
    for family, loss in losses.items():
        pair = build_gan(ModelConfig(family=family, hidden=H, window=W, features=F),
                         device="cpu")
        assert isinstance(pair, GanPair) and pair.loss == loss == FAMILIES[family][2]
        assert pair.family == family and not pair.policy.mixed
    assert isinstance(build_discriminator(ModelConfig(family="mtss_wgan_gp", hidden=H,
                                                      window=W, features=F), device="cpu"),
                      port_disc.LSTMFlatCritic)
    with pytest.raises(KeyError, match="unknown GAN family"):
        build_gan(ModelConfig(family="vae"), device="cpu")


def test_sample_draws_and_seeded_init():
    mcfg = ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F)
    tcfg = TrainConfig(batch_size=B, n_critic=NC, steps_per_call=2)
    a = init_gan_state(7, mcfg, device="cpu")
    b = init_gan_state(7, mcfg, device="cpu")
    for x, y in zip(a.discriminator.parameters(), b.discriminator.parameters()):
        assert torch.equal(x, y)
    assert a.step == 0 and set(a.d_opt) == {"nu"}
    ds = torch.rand(N_ROWS, W, F)
    pair = build_gan(mcfg, device="cpu")
    g = torch.Generator()
    g.manual_seed(0)
    d = sample_draws(g, pair, tcfg, ds)
    assert d.idx.shape == (NC, B) and d.noises.shape == (NC, B, W, F)
    assert d.alphas.shape == (NC, B, 1, 1)
    state, m = make_multi_step(pair, tcfg, ds)(a, generator=g)
    assert state.step == 2 and m["d_loss"].shape == (2,)
    assert bool(torch.isfinite(m["d_loss"]).all() and torch.isfinite(m["g_loss"]).all())
    copy = state.to("cpu")
    assert copy.generator is not state.generator
    assert torch.equal(next(copy.generator.parameters()), next(state.generator.parameters()))


def test_training_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs there")
    mcfg = ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_gan(mcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gan_state(0, mcfg)
