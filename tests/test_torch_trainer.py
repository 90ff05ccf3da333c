"""The port's trainer (``hfrep_tpu_torch/train/trainer.py``), its weights
bridge and the ``train-gan`` / ``serve`` verbs, against the JAX package.

Parity: the JAX ``GanTrainer`` (``lstm_backend="xla"``) and the port's,
from JAX's init bridged into the port, over two blocks of
``steps_per_call`` epochs and a remainder epoch.  JAX's draws reach the
port through the trainer's draw-source seam; the test derives them from
the JAX trainer's key stream outside the JAX package: ``key, init =
split(PRNGKey(seed))``, then per block ``key, sub = split(key)``, epoch i
of a block drawing from ``fold_in(sub, i)`` and a remainder epoch from
``sub`` itself, each epoch's draws as ``make_train_step`` derives them.
Bars: losses rtol 1e-4, params atol 1e-5 + rtol 1e-4 (the port's epoch
tests' bars).  The port runs with ``device="cpu"`` (its kernels' plain
versions); resume is held bitwise.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfrep_tpu.config import ExperimentConfig as JaxExperimentConfig
from hfrep_tpu.config import ModelConfig as JaxModelConfig
from hfrep_tpu.config import TrainConfig as JaxTrainConfig
from hfrep_tpu.core import data as jax_data
from hfrep_tpu.core import scaler as jax_scaler
from hfrep_tpu.train.trainer import GanTrainer as JaxGanTrainer
from hfrep_tpu_torch import config as port_config
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.core import data, scaler
from hfrep_tpu_torch.experiments.cli import main
from hfrep_tpu_torch.obs.metriclog import MetricLogger
from hfrep_tpu_torch.train import Draws
from hfrep_tpu_torch.train.trainer import GanTrainer, seed_mix
from hfrep_tpu_torch.utils.bridge import gan_state_from_jax, to_flax

ROOT = Path(__file__).resolve().parents[1]
CLEANED = str(ROOT / "results" / "rederived_cleaned")
H, W, F, B, NC, N = 8, 6, 5, 4, 2, 32
SEED = 11
#: one family per loss kind: wgan_gp, wgan_clip (RMSprop), bce (Adam)
FAMILIES = ["mtss_wgan_gp", "mtss_wgan", "mtss_gan"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _windows() -> np.ndarray:
    return np.random.default_rng(7).uniform(0, 1, (N, W, F)).astype(np.float32)


def _cfgs(family: str, spc: int = 3, **train_kw):
    model = dict(family=family, hidden=H, window=W, features=F)
    train = dict(batch_size=B, n_critic=NC, steps_per_call=spc, seed=SEED, log_every=1,
                 **train_kw)
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**model),
                               train=JaxTrainConfig(lstm_backend="xla", **train))
    return jcfg, ExperimentConfig(model=ModelConfig(**model), train=TrainConfig(**train))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _jax_draws(loss: str, key) -> Draws:
    """The draws the JAX ``make_train_step`` derives from ``key``."""
    if loss == "bce":
        k_idx, k_z1, k_z2 = jax.random.split(key, 3)
        idx = jax.random.randint(k_idx, (B,), 0, N)
        noises = jnp.stack([jax.random.normal(k, (B, W, F)) for k in (k_z1, k_z2)])
        return Draws(idx=_t(idx, torch.long), noises=_t(noises))
    with_alpha = loss == "wgan_gp"
    ks = [jax.random.split(jax.random.fold_in(key, i), 3 if with_alpha else 2)
          for i in range(NC)]
    idx = jnp.stack([jax.random.randint(k[0], (B,), 0, N) for k in ks])
    noises = jnp.stack([jax.random.normal(k[1], (B, W, F)) for k in ks])
    alphas = (jnp.stack([jax.random.uniform(k[2], (B, 1, 1)) for k in ks])
              if with_alpha else None)
    return Draws(idx=_t(idx, torch.long), noises=_t(noises),
                 alphas=None if alphas is None else _t(alphas))


def _jax_draw_source(loss: str, seed: int, spc: int, n_full: int, n_blocks: int):
    """The port trainer's draw source for the JAX trainer's key stream:
    blocks below ``n_full`` fold the epoch in, the rest are remainders."""
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    subs = []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def source(block: int, i: int) -> Draws:
        sub = subs[block]
        return _jax_draws(loss, jax.random.fold_in(sub, i) if block < n_full else sub)

    return source


def _jax_state_np(jtr):
    return jax.tree_util.tree_map(np.asarray, jtr.state)


def _assert_params(tr, jtr):
    for name, module, tree in (("g", tr.state.generator, jtr.state.g_params),
                               ("d", tr.state.discriminator, jtr.state.d_params)):
        got = jax.tree_util.tree_leaves_with_path(to_flax(module))
        ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, tree))
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (path, a), (_, r) in zip(got, ref):
            np.testing.assert_allclose(a, r, atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


def _assert_history(tr, jtr, epochs):
    """The port's history against the JAX trainer's over ``epochs``."""
    ref = [h for h in jtr.history if h["epoch"] in epochs]
    assert [h["epoch"] for h in tr.history] == [h["epoch"] for h in ref] == epochs
    for a, b in zip(tr.history, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"epoch {a['epoch']} {k}")


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_matches_jax_over_two_blocks_and_a_remainder(family):
    jcfg, cfg = _cfgs(family)
    windows = _windows()
    jtr = JaxGanTrainer(jcfg, jnp.asarray(windows))
    tr = GanTrainer(cfg, torch.from_numpy(windows), device="cpu",
                    draw_source=_jax_draw_source(jtr.pair.loss, SEED, 3, 2, 3))
    tr.state = gan_state_from_jax(_jax_state_np(jtr), tr.pair)
    jtr.train(epochs=7)
    tr.train(epochs=7)
    assert tr.epoch == jtr.epoch == 7 and tr.block == 3
    assert tr.state.step == int(jtr.state.step) == 7
    _assert_history(tr, jtr, list(range(7)))
    _assert_params(tr, jtr)


@pytest.mark.parametrize("family", ["mtss_wgan_gp", "mtss_gan"])
def test_bridged_jax_state_trains_on_as_jax_does(family):
    """A JAX trainer trains 3 epochs; its whole state (params, the
    optimizer's nonzero slots, Adam's count, step) is bridged, and both
    train 3 more epochs on JAX's draws."""
    jcfg, cfg = _cfgs(family)
    windows = _windows()
    jtr = JaxGanTrainer(jcfg, jnp.asarray(windows))
    jtr.train(epochs=3)
    tr = GanTrainer(cfg, torch.from_numpy(windows), device="cpu",
                    draw_source=_jax_draw_source(jtr.pair.loss, SEED, 3, 2, 2))
    tr.state = gan_state_from_jax(_jax_state_np(jtr), tr.pair)
    tr.block, tr.epoch = 1, 3
    assert tr.state.step == 3
    slots = tr.state.g_opt
    assert all(float(v.abs().max()) > 0 for v in slots["nu"].values())
    if family == "mtss_gan":
        assert slots["count"] == 3 and set(slots) == {"mu", "nu", "count"}
    jtr.train(epochs=3)
    tr.train(epochs=3)
    _assert_history(tr, jtr, list(range(3, 6)))
    _assert_params(tr, jtr)


def test_history_contiguous_across_checkpoints_and_remainder(tmp_path):
    """19 epochs at 4 a block: 4 full blocks (checkpoints after 8 and
    16) and 3 remainder epochs; warm and steady timer samples."""
    _, cfg = _cfgs("mtss_wgan_gp", spc=4, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every=8)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_every=2))
    log = tmp_path / "m.jsonl"
    tr = GanTrainer(cfg, torch.from_numpy(_windows()), device="cpu",
                    logger=MetricLogger(str(log)))
    tr.train(epochs=19)
    tr.logger.close()
    assert [h["epoch"] for h in tr.history] == list(range(19))
    assert all(np.isfinite(h["d_loss"]) and np.isfinite(h["g_loss"]) for h in tr.history)
    assert any(w for _, _, w in tr.timer.samples)
    assert any(not w for _, _, w in tr.timer.samples)
    assert sum(n for n, _, _ in tr.timer.samples) == 19
    assert np.isfinite(tr.steps_per_sec) and tr.steps_per_sec > 0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["ckpt_16", "ckpt_8"]
    import json
    assert [json.loads(line)["step"] for line in log.read_text().splitlines()] \
        == list(range(0, 19, 2))


def _params(tr) -> list:
    return [p.detach().clone() for m in (tr.state.generator, tr.state.discriminator)
            for p in m.state_dict().values()]


def _slots(tr) -> list:
    out = []
    for slots in (tr.state.g_opt, tr.state.d_opt):
        for k in sorted(slots):
            v = slots[k]
            out += [v[n].clone() for n in sorted(v)] if isinstance(v, dict) else [v]
    return out


@pytest.mark.parametrize("family", ["mtss_wgan_gp", "mtss_gan"])
def test_resume_is_bitwise(tmp_path, family):
    """6 epochs straight == 3 epochs, save, restore into a new trainer,
    3 more: params, slots (Adam's count too), step, the draw stream's
    state and the history, bit for bit."""
    _, cfg = _cfgs(family, checkpoint_dir=str(tmp_path))
    windows = torch.from_numpy(_windows())
    straight = GanTrainer(cfg, windows, device="cpu")
    straight.train(epochs=6)
    first = GanTrainer(cfg, windows, device="cpu")
    first.train(epochs=3)
    path = first.save_checkpoint()
    resumed = GanTrainer(cfg, windows, device="cpu")
    assert resumed.restore_checkpoint(path) == path
    assert resumed.epoch == 3 and resumed.block == 1 and resumed.state.step == 3
    resumed.train(epochs=3)
    for a, b in zip(_params(straight), _params(resumed)):
        assert torch.equal(a, b)
    for a, b in zip(_slots(straight), _slots(resumed)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    if family == "mtss_gan":
        assert resumed.state.g_opt["count"] == straight.state.g_opt["count"] == 6
    assert resumed.state.step == straight.state.step == 6
    assert torch.equal(resumed.gen.get_state(), straight.gen.get_state())
    assert resumed.history == straight.history[3:]


def test_restore_falls_back_and_degrades_fresh(tmp_path):
    _, cfg = _cfgs("mtss_gan", spc=2, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    windows = torch.from_numpy(_windows())
    tr = GanTrainer(cfg, windows, device="cpu")
    tr.train(epochs=4)                          # ckpt_2, ckpt_4
    newest = tmp_path / "ckpt_4" / "checkpoint.pt"
    newest.write_bytes(newest.read_bytes()[: newest.stat().st_size // 2])
    tr2 = GanTrainer(cfg, windows, device="cpu")
    assert tr2.restore_checkpoint().endswith("ckpt_2") and tr2.epoch == 2
    # an explicit corrupt path falls back through the directory too
    tr3 = GanTrainer(cfg, windows, device="cpu")
    assert tr3.restore_checkpoint(str(tmp_path / "ckpt_4")).endswith("ckpt_2")
    (tmp_path / "ckpt_2" / "checkpoint.pt").write_bytes(b"torn")
    tr4 = GanTrainer(cfg, windows, device="cpu")
    fresh = _params(tr4)
    assert tr4.restore_checkpoint() == "" and tr4.epoch == 0
    assert all(torch.equal(a, b) for a, b in zip(fresh, _params(tr4)))
    # without a directory to fall back through, a named corrupt path raises
    nodir = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=None))
    from hfrep_tpu_torch.utils.checkpoint import CheckpointCorrupt
    with pytest.raises(CheckpointCorrupt):
        GanTrainer(nodir, windows, device="cpu").restore_checkpoint(str(tmp_path / "ckpt_4"))
    with pytest.raises(FileNotFoundError):
        GanTrainer(nodir, windows, device="cpu").restore_checkpoint()


class TestNanGuard:
    """A non-finite block is rolled back and retried on a reseeded stream
    (``tests/test_train.py::TestNanGuard``)."""

    def _trainer(self, **kw):
        _, cfg = _cfgs("mtss_wgan_gp")
        return GanTrainer(cfg, torch.from_numpy(_windows()), device="cpu", **kw)

    def test_recovers_from_transient_nan(self):
        tr = self._trainer(nan_guard=True)
        real_multi = tr._multi
        calls = {"n": 0}

        def flaky(state, draws=None, generator=None):
            calls["n"] += 1
            state2, metrics = real_multi(state, draws, generator)
            if calls["n"] == 1:
                metrics = {k: torch.full_like(v, float("nan")) for k, v in metrics.items()}
            return state2, metrics

        tr._multi = flaky
        before = _params(tr)
        tr.train(epochs=3)              # one steps_per_call block
        assert tr.recoveries == 0       # reset after the successful retry
        assert calls["n"] == 2 and tr.block == 2
        assert tr.epoch == 3 and tr.state.step == 3   # the failed block rolled back
        assert max(float((a - b).abs().max()) for a, b in zip(before, _params(tr))) > 0
        # the retry drew from the stream reseeded from (seed, epoch, 7919 + 1)
        g = torch.Generator()
        g.manual_seed(seed_mix(SEED, 0, 7920))
        for _ in range(3):
            from hfrep_tpu_torch.train.steps import sample_draws
            sample_draws(g, tr.pair, tr.cfg.train, tr.windows)
        assert torch.equal(g.get_state(), tr.gen.get_state())

    def test_gives_up_after_max_recoveries(self):
        tr = self._trainer(nan_guard=True, max_recoveries=2)
        real_multi = tr._multi

        def always_nan(state, draws=None, generator=None):
            state2, metrics = real_multi(state, draws, generator)
            return state2, {k: torch.full_like(v, float("nan")) for k, v in metrics.items()}

        tr._multi = always_nan
        with pytest.raises(FloatingPointError, match="diverged 3 times"):
            tr.train(epochs=3)

    def test_guard_off_keeps_nan(self):
        tr = self._trainer(nan_guard=False)
        real_multi = tr._multi

        def nan_metrics(state, draws=None, generator=None):
            state2, metrics = real_multi(state, draws, generator)
            return state2, {k: torch.full_like(v, float("nan")) for k, v in metrics.items()}

        tr._multi = nan_metrics
        tr.train(epochs=3)              # no raise, NaNs pass through
        assert any(not np.isfinite(h["d_loss"]) for h in tr.history)


def _scaled_dataset():
    """Both packages' GanDataset over one synthetic panel, fitted alike."""
    panel = np.random.default_rng(3).normal(0.0, 2.0, (40, F)).astype(np.float32)
    jparams, jscaled = jax_scaler.fit_transform(jnp.asarray(panel))
    tparams, tscaled = scaler.fit_transform(torch.from_numpy(panel))
    starts = np.arange(N) % (40 - W + 1)
    jwin = jnp.stack([jscaled[s:s + W] for s in starts])
    names = [f"f{i}" for i in range(F)]
    jds = jax_data.GanDataset(windows=jwin, scaler=jparams, panel_scaled=jscaled,
                              feature_names=names)
    tds = data.GanDataset(windows=tscaled[torch.from_numpy(starts)[:, None] + torch.arange(W)],
                          scaler=tparams, panel_scaled=tscaled, feature_names=names)
    return jds, tds, float(panel.max() - panel.min())


def test_generate_equals_jax_on_its_noise():
    jcfg, cfg = _cfgs("mtss_wgan_gp")
    jds, tds, span = _scaled_dataset()
    jtr = JaxGanTrainer(jcfg, jds)
    tr = GanTrainer(cfg, tds, device="cpu")
    tr.state = gan_state_from_jax(_jax_state_np(jtr), tr.pair)
    key = jax.random.PRNGKey(9)
    noise = np.array(jax.random.normal(key, (5, W, F)))
    for unscale in (True, False):
        want = np.asarray(jtr.generate(key, 5, unscale=unscale))
        got = tr.generate(5, noise=torch.from_numpy(noise), unscale=unscale).numpy()
        assert got.shape == (5, W, F)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * (span if unscale else 1.0))


def test_generate_block_is_pure_in_stream_seed_and_seq():
    _, cfg = _cfgs("mtss_wgan_gp")
    tr = GanTrainer(cfg, torch.from_numpy(_windows()), device="cpu")
    a = tr.generate_block(3, 4, stream_seed=5)
    tr.generate(2)                              # no hidden stream state
    b = tr.generate_block(3, 4, stream_seed=5)
    assert a.shape == (4, W, F) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert not torch.equal(a, tr.generate_block(4, 4, stream_seed=5))
    assert not torch.equal(a, tr.generate_block(3, 4, stream_seed=6))
    assert seed_mix(5, 3) == seed_mix(5, 3) != seed_mix(3, 5)
    assert 0 <= seed_mix(-1, 2**70) < 2**64


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None rightly runs there")
    _, cfg = _cfgs("mtss_wgan_gp")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GanTrainer(cfg, torch.from_numpy(_windows()))


@pytest.fixture
def tiny_preset(monkeypatch):
    """A preset at test widths over the committed panel's 35 features."""
    cfg = ExperimentConfig(
        data=port_config.DataConfig(n_sample=48, window=W),
        model=ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=35),
        train=TrainConfig(batch_size=B, n_critic=NC, steps_per_call=2,
                          checkpoint_every=2, epochs=5),
        name="tiny")
    monkeypatch.setitem(port_config.PRESETS, "tiny", cfg)
    return "tiny"


def test_cli_train_gan_then_resume_completes_the_schedule(tmp_path, tiny_preset, capsys):
    base = ["train-gan", "--preset", tiny_preset, "--cleaned-dir", CLEANED,
            "--device", "cpu", "--quiet", "--n-samples", "3"]
    a, b = tmp_path / "a", tmp_path / "b"
    assert main(base + ["--checkpoint-dir", str(a), "--samples-out", str(a / "s.npy")]) == 0
    out = capsys.readouterr().out
    assert "trained mtss_wgan_gp for 5 epochs (" in out and "steps/s)" in out
    assert f"checkpoint: {a}/ckpt_5" in out and "samples: " in out
    assert main(base + ["--epochs", "3", "--checkpoint-dir", str(b)]) == 0
    assert "trained mtss_wgan_gp for 3 epochs" in capsys.readouterr().out
    assert main(base + ["--resume", "--checkpoint-dir", str(b),
                        "--samples-out", str(b / "s.npy")]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {b}/ckpt_3 (epoch 3)" in out
    assert "trained mtss_wgan_gp for 5 epochs (" in out
    # the resumed run's samples are the straight run's, bit for bit
    assert np.array_equal(np.load(a / "s.npy"), np.load(b / "s.npy"))
    assert np.load(a / "s.npy").shape == (3, W, 35)
    assert main(base + ["--resume", "--checkpoint-dir", str(b)]) == 0
    out = capsys.readouterr().out
    assert "trained mtss_wgan_gp for 5 epochs (schedule already complete)" in out


def test_cli_serves_a_trained_generator(tmp_path, tiny_preset, capsys):
    assert main(["train-gan", "--preset", tiny_preset, "--cleaned-dir", CLEANED,
                 "--device", "cpu", "--quiet", "--epochs", "2",
                 "--checkpoint-dir", str(tmp_path)]) == 0
    capsys.readouterr()
    assert main(["serve", "--preset", tiny_preset, "--cleaned-dir", CLEANED,
                 "--device", "cpu", "--gan-checkpoint", str(tmp_path / "ckpt_2"),
                 "--requests", "12", "--sample-every", "2", "--timeout-ms", "60000"]) == 0
    import json
    doc = json.loads(capsys.readouterr().out)
    report = doc["report"]
    assert report["submitted"] == report["terminal"] == report["results"] == 12
    with pytest.raises(SystemExit, match="needs --gan-checkpoint"):
        main(["serve", "--sample-every", "2", "--device", "cpu"])


def test_python_m_entry_point(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "hfrep_tpu_torch", "train-gan", "--epochs", "0",
         "--device", "cpu", "--cleaned-dir", CLEANED],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "trained mtss_wgan_gp for 0 epochs (schedule already complete)" in out.stdout
