"""The port's training health (``hfrep_tpu_torch.obs.health``) against
``tests/test_obs_health.py``'s contracts and the JAX package's values.

Case for case with the JAX suite: health defaults off and the env var
arms it; a step built with health off is the plain step (no health key);
with health on the trajectory is bit-identical to health off over both
critic routes and the three loss families at n_critic 1 and 5; the
conditional step's keys; the chunked AE drive bit-identical with its
``health/ae_*`` gauges, its kill and resume bit-identical with health
on, a snapshot refusing a resume across a health toggle, the AE and the
trainer tripwires (``NumericFault`` with a forensic dump).  Parity: the
five ``health_*`` values of one epoch against the JAX step's from the
same params and draws (``lstm_backend="xla"``, the JAX draws through the
``Draws`` seam) at the gradient bars, atol 1e-5 and rtol 1e-4.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hfrep_tpu_torch.obs as obs_pkg
import hfrep_tpu_torch.resilience as res
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.models.registry import build_gan as jax_build_gan
from hfrep_tpu.obs import health as jax_health
from hfrep_tpu.train.states import init_gan_state as jax_init_gan_state
from hfrep_tpu.train.steps import make_train_step as jax_make_train_step
from hfrep_tpu_torch.config import (AEConfig, DataConfig, ExperimentConfig, ModelConfig,
                                    TrainConfig)
from hfrep_tpu_torch.models.registry import build_gan
from hfrep_tpu_torch.obs import health
from hfrep_tpu_torch.replication.engine import (sweep_autoencoders_chunked,
                                                train_autoencoder_chunked)
from hfrep_tpu_torch.train import Draws, make_multi_step, make_train_step
from hfrep_tpu_torch.train.states import init_gan_state
from hfrep_tpu_torch.train.steps import sample_draws
from hfrep_tpu_torch.utils.bridge import gan_state_from_flax
from hfrep_tpu_torch.utils.fixture_data import scaled_panel


@pytest.fixture(autouse=True)
def _health_off():
    """Every test starts and ends with health off, in both packages."""
    torch.set_num_threads(1)
    health.configure(None)
    jax_health.configure(None)
    yield
    health.configure(None)
    jax_health.configure(None)
    res.clear_plan()


def _dataset(seed=0, n=32, w=6, f=4) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(n, w, f).astype(np.float32))


def _small_cfgs(family, n_critic=1):
    mcfg = ModelConfig(family=family, hidden=8, features=4, window=6)
    tcfg = TrainConfig(batch_size=8, n_critic=n_critic, steps_per_call=2)
    return mcfg, tcfg


def _run_steps(family, on, n_critic=1, epochs=3, stack="auto"):
    health.configure(health.HealthConfig() if on else None)
    mcfg, tcfg = _small_cfgs(family, n_critic)
    state = init_gan_state(0, mcfg, device="cpu")
    pair = build_gan(mcfg, device="cpu")
    if stack != "auto":
        state.discriminator.stack = stack
    ds = _dataset()
    step = make_train_step(pair, tcfg, ds)
    gen = torch.Generator()
    gen.manual_seed(1)
    metrics = None
    for _ in range(epochs):
        state, metrics = step(state, sample_draws(gen, pair, tcfg, ds))
    return state, {k: v.detach().clone() for k, v in metrics.items()}


def _state_tensors(state):
    out = [p.detach() for p in state.generator.parameters()]
    out += [p.detach() for p in state.discriminator.parameters()]
    for slots in (state.g_opt, state.d_opt):
        for k in sorted(slots):
            v = slots[k]
            out += ([v[n] for n in sorted(v)] if isinstance(v, dict) else [torch.tensor(v)])
    return out


# ------------------------------------------------------------ off = plain
def test_health_defaults_off():
    assert health.active() is None


def test_env_arms_config(monkeypatch):
    monkeypatch.setattr(health, "_active", None)
    monkeypatch.setattr(health, "_env_consumed", False)
    monkeypatch.setenv(health.ENV_HEALTH, "abort")
    cfg = health.active()
    assert cfg is not None and cfg.abort_on_nonfinite
    health.configure(None)
    monkeypatch.setattr(health, "_active", None)
    monkeypatch.setattr(health, "_env_consumed", False)
    monkeypatch.setenv(health.ENV_HEALTH, "off")
    assert health.active() is None


@pytest.mark.parametrize("family,n_critic", [("gan", 1), ("wgan", 5),
                                             ("mtss_wgan_gp", 2), ("mtss_wgan_gp", 1)])
def test_off_step_stable_across_toggle(family, n_critic):
    """A step built with health off returns the plain metrics, before and
    after a configure on/off cycle; one built with health on adds the
    five keys and nothing else."""
    _, m_before = _run_steps(family, on=False, n_critic=n_critic, epochs=1)
    _, m_on = _run_steps(family, on=True, n_critic=n_critic, epochs=1)
    _, m_after = _run_steps(family, on=False, n_critic=n_critic, epochs=1)
    assert set(m_before) == set(m_after)
    assert not any(k.startswith("health_") for k in m_after)
    assert set(m_on) == set(m_before) | set(health.STEP_KEYS)


@pytest.mark.parametrize("family,n_critic,stack", [
    ("gan", 1, "auto"), ("wgan", 5, "auto"), ("mtss_wgan_gp", 1, "auto"),
    ("mtss_wgan_gp", 5, "auto"), ("mtss_wgan_gp", 1, "chained"),
    ("mtss_wgan_gp", 5, "chained"), ("mtss_gan", 1, "chained"),
    ("mtss_wgan", 5, "auto")])
def test_trajectory_bit_identical_on_vs_off(family, n_critic, stack):
    s_off, m_off = _run_steps(family, on=False, n_critic=n_critic, stack=stack)
    s_on, m_on = _run_steps(family, on=True, n_critic=n_critic, stack=stack)
    for a, b in zip(_state_tensors(s_off), _state_tensors(s_on)):
        assert torch.equal(a, b), f"{family}: health perturbed the trajectory"
    assert s_off.step == s_on.step
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k in health.STEP_KEYS:
        assert k not in m_off
        assert k in m_on and np.isfinite(float(m_on[k]))
    assert float(m_on["health_nonfinite"]) == 0.0
    assert float(m_on["health_g_grad_norm"]) > 0.0
    assert float(m_on["health_d_grad_norm"]) > 0.0
    assert float(m_on["health_update_norm"]) > 0.0


def test_multi_step_stacks_health_per_epoch():
    health.configure(health.HealthConfig())
    mcfg, tcfg = _small_cfgs("mtss_wgan_gp", 2)
    pair = build_gan(mcfg, device="cpu")
    state = init_gan_state(0, mcfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    _, m = make_multi_step(pair, tcfg, _dataset())(state, generator=gen)
    for k in health.STEP_KEYS:
        assert m[k].shape == (tcfg.steps_per_call,)


def test_conditional_step_health_keys():
    from hfrep_tpu_torch.models.conditional import build_conditional_gan
    from hfrep_tpu_torch.train.states import init_conditional_state
    from hfrep_tpu_torch.train.steps import make_conditional_step

    mcfg = ModelConfig(family="mtss_wgan_gp", hidden=8, features=4, window=6)
    tcfg = TrainConfig(batch_size=8, n_critic=2, steps_per_call=1)
    ds = _dataset()
    cond = torch.from_numpy(np.eye(3, dtype=np.float32)[np.arange(ds.shape[0]) % 3])

    def run(on):
        health.configure(health.HealthConfig() if on else None)
        pair = build_conditional_gan(mcfg, 3, device="cpu")
        state = init_conditional_state(0, mcfg, 3, device="cpu")
        gen = torch.Generator()
        gen.manual_seed(2)
        return make_conditional_step(pair, tcfg, ds, cond)(
            state, sample_draws(gen, pair, tcfg, ds))

    s_on, m = run(True)
    for k in health.STEP_KEYS:
        assert k in m
    assert float(m["health_nonfinite"]) == 0.0
    s_off, m2 = run(False)
    assert set(m2) == {"d_loss", "g_loss"}
    for a, b in zip(_state_tensors(s_off), _state_tensors(s_on)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ JAX parity
H, W, F, B, N_ROWS = 8, 6, 5, 4, 16


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _jax_draws(loss: str, key, nc: int) -> Draws:
    """The draws ``make_train_step`` derives from ``key`` for ``loss``."""
    if loss == "bce":
        k_idx, k_z1, k_z2 = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (B,), 0, N_ROWS)
        noises = jnp.stack([jax.random.normal(k, (B, W, F)) for k in (k_z1, k_z2)])
        return Draws(idx=_t(idx, torch.long), noises=_t(noises))
    with_alpha = loss == "wgan_gp"
    ks = [jax.random.split(jax.random.fold_in(key, i), 3 if with_alpha else 2)
          for i in range(nc)]
    idx = jnp.stack([jax.random.randint(k[0], (B,), 0, N_ROWS) for k in ks])
    noises = jnp.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])
    alphas = (jnp.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])
              if with_alpha else None)
    return Draws(idx=_t(idx, torch.long), noises=_t(noises),
                 alphas=None if alphas is None else _t(alphas))


@pytest.mark.parametrize("family,nc,stack", [
    ("mtss_wgan_gp", 2, "auto"), ("mtss_wgan_gp", 2, "chained"),
    ("mtss_wgan", 2, "auto"), ("mtss_gan", 1, "auto"), ("wgan_gp", 1, "auto")])
def test_health_values_match_jax(family, nc, stack):
    jm = JaxModelConfig(family=family, hidden=H, window=W, features=F)
    jt = JaxTrainConfig(batch_size=B, n_critic=nc, lstm_backend="xla")
    key = jax.random.PRNGKey(3)
    dataset = jax.random.uniform(key, (N_ROWS, W, F))
    jpair = jax_build_gan(jm)
    jstate = jax_init_gan_state(key, jm, jt, jpair)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pair = build_gan(ModelConfig(family=family, hidden=H, window=W, features=F),
                     device="cpu")
    if stack != "auto":
        pair.discriminator.stack = stack
    state = gan_state_from_flax(np_tree(jstate.g_params), np_tree(jstate.d_params), pair)
    if stack != "auto":
        state.discriminator.stack = stack
    step_key = jax.random.PRNGKey(4)
    jax_health.configure(jax_health.HealthConfig())
    _, jmet = jax.jit(jax_make_train_step(jpair, jt, dataset))(jstate, step_key)
    health.configure(health.HealthConfig())
    _, m = make_train_step(pair, TrainConfig(batch_size=B, n_critic=nc), _t(dataset))(
        state, _jax_draws(pair.loss, step_key, nc))
    assert set(m) == set(jmet)
    for k in health.STEP_KEYS:
        np.testing.assert_allclose(float(m[k]), float(jmet[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_jax_leaf_order_is_the_bridge_order():
    """``jax_order`` lists a critic's parameters in the order
    ``jax.tree_util.tree_leaves`` visits the JAX params."""
    from hfrep_tpu_torch.utils.bridge import to_flax

    for family in ("mtss_wgan_gp", "gan"):
        pair = build_gan(ModelConfig(family=family, hidden=H, window=W, features=F),
                         device="cpu")
        for module in (pair.generator, pair.discriminator):
            params = dict(module.named_parameters())
            ref = jax.tree_util.tree_leaves(to_flax(module))
            got = [params[k].detach().numpy() for k in health.jax_order(module)]
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                assert a.shape == b.shape and np.array_equal(a, b)


# ------------------------------------------------------------- AE engine
def _ae_cfg(**kw):
    base = dict(n_factors=5, latent_dim=3, epochs=12, batch_size=16, patience=2,
                chunk_epochs=4)
    base.update(kw)
    return AEConfig(**base)


def _gauges(run_dir):
    names = set()
    for line in (run_dir / "events.jsonl").read_text().splitlines():
        if line:
            rec = json.loads(line)
            if rec.get("kind") == "gauge":
                names.add(rec["name"])
    return names


def _equal_results(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for x, y in ((a.train_loss, b.train_loss), (a.val_loss, b.val_loss),
                 (a.stop_epoch, b.stop_epoch)):
        assert torch.equal(torch.nan_to_num(x, nan=-7.0), torch.nan_to_num(y, nan=-7.0))


def test_ae_chunked_bit_identical_and_gauges(tmp_path):
    xs = scaled_panel(60, 5, seed=3)
    cfg = _ae_cfg()
    off, off_stats = sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu")
    health.configure(health.HealthConfig())
    with obs_pkg.session(tmp_path / "run", command="t"):
        on, on_stats = sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu")
    assert {"health/ae_grad_norm", "health/ae_nonfinite",
            "health/ae_param_norm"} <= _gauges(tmp_path / "run")
    _equal_results(off, on)
    assert off_stats.epochs_dispatched == on_stats.epochs_dispatched


def test_ae_kill_resume_bit_identical_with_health(tmp_path):
    xs = scaled_panel(60, 5, seed=3)
    cfg = _ae_cfg()
    health.configure(health.HealthConfig())
    base, _ = sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu")
    rd = str(tmp_path / "resume")
    res.install_plan(res.FaultPlan.parse("preempt@chunk=1"))
    try:
        with pytest.raises(res.Preempted):
            sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu", resume_dir=rd)
    finally:
        res.clear_plan()
    resumed, _ = sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu",
                                            resume_dir=rd)
    _equal_results(base, resumed)


def test_ae_snapshot_refuses_cross_health_resume(tmp_path):
    """A health-off snapshot is not adopted by a health-on resume (the
    fingerprint differs): the drive starts afresh, with the same result."""
    xs = scaled_panel(60, 5, seed=3)
    cfg = _ae_cfg()
    rd = str(tmp_path / "resume")
    res.install_plan(res.FaultPlan.parse("preempt@chunk=1"))
    try:
        with pytest.raises(res.Preempted):
            sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu", resume_dir=rd)
    finally:
        res.clear_plan()
    health.configure(health.HealthConfig())
    resumed, stats = sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu",
                                                resume_dir=rd)
    assert stats.chunks_dispatched == 3     # a fresh start, not a resume
    base, _ = sweep_autoencoders_chunked(0, xs, cfg, [1, 2, 3], device="cpu")
    _equal_results(base, resumed)


def test_ae_tripwire_raises_numeric_fault(tmp_path):
    health.configure(health.HealthConfig(abort_on_nonfinite=True, dump_dir=str(tmp_path)))
    xs = np.full((40, 4), np.nan, np.float32)
    cfg = AEConfig(n_factors=4, latent_dim=2, epochs=4, batch_size=16, patience=2,
                   chunk_epochs=2)
    with pytest.raises(health.NumericFault) as ei:
        train_autoencoder_chunked(0, xs, cfg, device="cpu")
    fault = ei.value
    assert fault.site == "chunk" and fault.nonfinite and fault.nonfinite > 0
    assert fault.dump and os.path.isdir(fault.dump)
    assert os.path.exists(os.path.join(fault.dump, "carry.npz"))
    assert os.path.exists(os.path.join(fault.dump, "detail.json"))


# -------------------------------------------------------------- trainer
def test_trainer_emits_gauges_and_tripwire(tmp_path):
    from hfrep_tpu_torch.train.trainer import GanTrainer

    cfg = ExperimentConfig(
        data=DataConfig(),
        model=ModelConfig(family="mtss_wgan_gp", hidden=8, features=4, window=6),
        train=TrainConfig(batch_size=8, n_critic=1, epochs=4, steps_per_call=2,
                          log_every=1))
    # clean data, health on: the gauges land, no fault; mfu is finite
    health.configure(health.HealthConfig())
    with obs_pkg.session(tmp_path / "ok", command="t"):
        tr = GanTrainer(cfg, _dataset(), device="cpu")
        tr.train(epochs=2)
    names = _gauges(tmp_path / "ok")
    for g in ("health/g_grad_norm", "health/d_grad_norm", "health/update_norm",
              "health/param_norm", "health/nonfinite", "mfu"):
        assert g in names
    assert "numeric_fault" not in (tmp_path / "ok" / "events.jsonl").read_text()
    assert any(k.startswith("health_") for k in tr.history[0])

    # NaN data, tripwire armed: NumericFault, a numeric_fault event, a dump
    health.configure(health.HealthConfig(abort_on_nonfinite=True))
    with pytest.raises(health.NumericFault) as ei:
        with obs_pkg.session(tmp_path / "bad", command="t"):
            GanTrainer(cfg, torch.full((32, 6, 4), float("nan")), device="cpu").train(epochs=2)
    assert ei.value.site == "block"
    assert ei.value.dump and os.path.isdir(ei.value.dump)
    assert "numeric_fault" in (tmp_path / "bad" / "events.jsonl").read_text()


def test_conditional_drive_emits_health_and_trips(tmp_path):
    from hfrep_tpu_torch.scenario.conditional import train_conditional

    mcfg = ModelConfig(family="mtss_wgan_gp", hidden=8, features=4, window=6)
    tcfg = TrainConfig(batch_size=8, n_critic=1, steps_per_call=2)
    ds = _dataset().numpy()
    cond = np.eye(3, dtype=np.float32)[np.arange(ds.shape[0]) % 3]
    health.configure(health.HealthConfig())
    with obs_pkg.session(tmp_path / "ok", command="t"):
        train_conditional(mcfg, tcfg, ds, cond, epochs=3, device="cpu")
    assert "health/update_norm" in _gauges(tmp_path / "ok")
    health.configure(health.HealthConfig(abort_on_nonfinite=True, dump_dir=str(tmp_path)))
    with pytest.raises(health.NumericFault) as ei:
        train_conditional(mcfg, tcfg, np.full_like(ds, np.nan), cond, epochs=2, device="cpu")
    assert ei.value.site == "gan_block" and os.path.isdir(ei.value.dump)
