"""The port's resilience layer (``hfrep_tpu_torch/resilience``) against the
JAX package's: the ``HFREP_FAULTS`` grammar and its explanations, the
hooks' occurrence semantics and damage, the full-jitter backoff and the
retry policy, the snapshots (``digest_arrays``, ``ChunkSnapshot``,
``ProgressSnapshot``), the drive envelope's exit codes, the trainer's
drain into a final checkpoint, and the engine's chunk-snapshot resume.

Fault plans, explanations, damaged bytes, digests and delays are held
exact; resumed drives bitwise against the straight ones.  Everything
runs on the CPU.
"""

from __future__ import annotations

import random
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import hfrep_tpu.resilience as jres
import hfrep_tpu_torch.resilience as res
from hfrep_tpu.resilience import faults as jfaults
from hfrep_tpu.resilience import snapshot as jsnapshot
from hfrep_tpu.resilience.drive import DRIVE_REGISTRY as JAX_DRIVES
from hfrep_tpu.utils import checkpoint as jckpt
from hfrep_tpu_torch.config import AEConfig, ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.replication import engine
from hfrep_tpu_torch.resilience import drive, faults
from hfrep_tpu_torch.resilience.snapshot import ChunkSnapshot, ProgressSnapshot, digest_arrays
from hfrep_tpu_torch.train.trainer import GanTrainer
from hfrep_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True)
def _pristine_fault_state(monkeypatch):
    """No plan, an unconsumed env read and no requested drain, in both
    packages, before and after every test."""
    for mod in (res, jres):
        mod.clear_plan()
        monkeypatch.setattr(mod, "_env_consumed", False)
    monkeypatch.delenv(res.ENV_FAULTS, raising=False)
    torch.set_num_threads(1)
    yield
    for mod in (res, jres):
        mod.clear_plan()
        mod._DRAIN.requested = False
        mod._DRAIN.reason = None


# ------------------------------------------------------------ fault plans
SPECS = [
    "sigterm@chunk=2",
    "io_fail@ckpt_save=1x2",
    "torn@ckpt=3;preempt@block=5",
    "kill@actor=2",
    "stall@drain_barrier=1;sigterm@snapshot_save=1x4",
    "preempt@actor=1;io_fail@queue_put=2x3;corrupt@result=1",
    " corrupt@bank=7 ; io_fail@serve_result=1 ;",
    "",
]
BAD_SPECS = ["sigterm", "nuke@chunk=1", "sigterm@chunkk=1", "io_fail@chunk=1",
             "torn@actor=1", "sigterm@chunk=0", "sigterm@chunk=x", "kill@block=1"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plans_explain_as_jax_does(spec):
    mine, theirs = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert faults.plan_rows(mine) == jfaults.plan_rows(theirs)
    assert faults.render_plan(mine) == jfaults.render_plan(theirs)
    assert mine.spec() == theirs.spec()
    assert faults.FaultPlan.parse(mine.spec()).spec() == mine.spec()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_as_in_jax(spec):
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(faults.FaultSpecError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_site_registry_is_jax_s():
    for name in ("BOUNDARY_SITES", "IO_SITES", "POST_SAVE_SITES", "ACTOR_SITES", "KINDS",
                 "KIND_EFFECTS"):
        assert getattr(faults, name) == getattr(jfaults, name), name


def test_hooks_fire_at_the_same_occurrences(tmp_path):
    """One scripted sequence of hook calls through both packages' plans:
    the same io calls fail, the same actor items are killed, and the
    post-save damage leaves the same bytes."""
    spec = "io_fail@ckpt_save=2x2;kill@actor=3;torn@ckpt=1;corrupt@ckpt=2"
    outcomes = []
    for pkg, tag in ((faults, "port"), (jfaults, "jax")):
        plan = pkg.FaultPlan.parse(spec)
        seen = []
        for _ in range(4):
            try:
                plan.io("ckpt_save")
                seen.append("ok")
            except OSError:
                seen.append("eio")
        seen += [plan.actor("actor") for _ in range(4)]
        for i in range(2):
            f = tmp_path / tag / f"ck{i}" / "payload.bin"
            f.parent.mkdir(parents=True)
            f.write_bytes(bytes(range(64)))
            plan.post_save("ckpt", f.parent)
            seen.append(f.read_bytes())
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][:8] == ["ok", "eio", "eio", "ok", False, False, True, False]


def test_env_plan_read_once_and_malformed_spec_is_loud(monkeypatch):
    monkeypatch.setenv(res.ENV_FAULTS, "preempt@block=1")
    plan = res.active_plan()
    assert plan is res.active_plan() and plan.spec() == "preempt@block=1"
    res.clear_plan()
    monkeypatch.setattr(res, "_env_consumed", False)
    monkeypatch.setenv(res.ENV_FAULTS, "nope@block=1")
    for _ in range(2):                       # keeps raising, never disarms
        with pytest.raises(res.FaultSpecError):
            with res.graceful_drain():
                pass


# ------------------------------------------------------ backoff and retry
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_backoff_delay_equals_jax_on_the_same_draws(seed):
    for attempt in range(8):
        for kw in ({}, {"base": 0.25, "cap": 5.0}, {"base": 0.1, "factor": 3.0}):
            mine = res.backoff_delay(attempt, rng=random.Random(seed * 100 + attempt).random,
                                     **kw)
            theirs = jres.backoff_delay(attempt,
                                        rng=random.Random(seed * 100 + attempt).random, **kw)
            assert mine == theirs


def test_retry_io_sleeps_as_jax_and_stays_bounded():
    runs = []
    for mod in (res, jres):
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError(5, "EIO")
            return "done"

        assert mod.retry_io(flaky, what="ckpt_save", attempts=4, sleep=sleeps.append,
                            rng=random.Random(3).random) == "done"
        with pytest.raises(OSError):
            mod.retry_io(lambda: (_ for _ in ()).throw(OSError(5, "EIO")), what="x",
                         attempts=2, sleep=sleeps.append, rng=random.Random(4).random)
        runs.append(sleeps)
    assert runs[0] == runs[1] and len(runs[0]) == 3


def test_graceful_drain_catches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with res.graceful_drain():
        signal.raise_signal(signal.SIGTERM)
        assert res.drain_requested()
        with pytest.raises(res.Preempted, match="chunk"):
            res.boundary("chunk")
    assert not res.drain_requested()
    assert signal.getsignal(signal.SIGTERM) == before


def test_watchdog_names_the_wedged_drive():
    import time
    with pytest.raises(res.WatchdogTimeout, match="drive x"):
        with res.watchdog(0.05, "drive x"):
            time.sleep(1.0)


# -------------------------------------------------------------- snapshots
def test_digest_arrays_equals_jax_on_the_same_arrays():
    g = np.random.default_rng(0)
    a = g.normal(size=(4, 3)).astype(np.float32)
    b = g.integers(0, 9, size=(5,)).astype(np.int32)
    tree = {"z": a, "a": [b, np.float32(2.5)]}
    for args in ((a,), (a, b), (a, None, b), (tree,), (tree, None)):
        assert digest_arrays(*args) == jsnapshot.digest_arrays(*args)
    # tensors digest as their host arrays
    assert digest_arrays(torch.from_numpy(a), None) == jsnapshot.digest_arrays(a, None)


def _carry(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"flat": torch.rand((2, 3), generator=g), "count": torch.tensor([1, 2]),
            "stopped": torch.tensor([True, False])}


def test_chunk_snapshot_roundtrip_prev_fallback_and_refusal(tmp_path):
    fp = {"cfg": [1, 2], "kind": "lanes"}
    snap = ChunkSnapshot(tmp_path, fp)
    assert snap.load(_carry(0)) is None and not snap.exists()
    traces = (torch.ones(2, 4), torch.zeros(2, 4), torch.ones(2, 4, dtype=torch.bool))
    snap.save(_carry(1), traces, pos=4, chunks=2, stopped_all=False)
    snap.save(_carry(2), traces, pos=6, chunks=3, stopped_all=True)
    carry, tr, pos, chunks, stopped_all = snap.load(_carry(0))
    assert (pos, chunks, stopped_all) == (6, 3, True)
    for k, v in _carry(2).items():
        assert torch.equal(carry[k], v)
    assert all(torch.equal(a, b) for a, b in zip(tr, traces))
    # the JAX package's integrity layer accepts the port's snapshot
    assert jckpt.verify(snap.path)["pos"] == 6
    # a rotted live snapshot falls back to the previous boundary
    faults.corrupt_file(snap.path / "state.npz")
    assert snap.load(_carry(0))[2] == 4
    # another drive's fingerprint is refused
    assert ChunkSnapshot(tmp_path, {"cfg": [1, 3], "kind": "lanes"}).load(_carry(0)) is None
    snap.clear()
    assert snap.load(_carry(0)) is None


class TestProgressSnapshot:
    """JAX's ``tests/test_orchestrate.py`` progress-snapshot cases."""

    FP = {"source": "s0", "blocks": 4}

    def test_roundtrip_and_clear(self, tmp_path):
        snap = ProgressSnapshot(tmp_path, self.FP, name="gen_s0")
        assert snap.load() is None
        snap.save({"next": 2})
        assert snap.load() == {"next": 2}
        snap.save({"next": 3})
        assert snap.load() == {"next": 3}
        snap.clear()
        assert snap.load() is None

    def test_foreign_fingerprint_refused(self, tmp_path):
        ProgressSnapshot(tmp_path, self.FP, name="g").save({"next": 1})
        assert ProgressSnapshot(tmp_path, {"source": "s1", "blocks": 4}, name="g").load() is None

    def test_corrupt_falls_back_to_prev(self, tmp_path):
        snap = ProgressSnapshot(tmp_path, self.FP, name="g")
        snap.save({"next": 1})
        snap.save({"next": 2})
        faults.corrupt_file(snap.path / "progress.json")
        assert snap.load() == {"next": 1}

    def test_each_package_reads_the_other_s_snapshot(self, tmp_path):
        ProgressSnapshot(tmp_path / "a", self.FP, name="g").save({"next": 3})
        assert jsnapshot.ProgressSnapshot(tmp_path / "a", self.FP, name="g").load() == {"next": 3}
        jsnapshot.ProgressSnapshot(tmp_path / "b", self.FP, name="g").save({"next": 2})
        assert ProgressSnapshot(tmp_path / "b", self.FP, name="g").load() == {"next": 2}


def test_checkpoint_writes_pass_the_fault_hooks(tmp_path):
    """``io_fail@ckpt_save`` is retried (one EIO absorbed), a burst longer
    than the retry policy propagates, and ``torn@ckpt`` damages the
    published payload so that restore falls back."""
    res.install_plan(faults.FaultPlan.parse("io_fail@ckpt_save=1"))
    ckpt.save(str(tmp_path / "ckpt_1"), {"w": torch.ones(3)})
    assert torch.equal(ckpt.restore(str(tmp_path / "ckpt_1"))["w"], torch.ones(3))
    res.install_plan(faults.FaultPlan.parse("io_fail@ckpt_save=1x3"))
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path / "ckpt_2"), {"w": torch.ones(3)})
    res.install_plan(faults.FaultPlan.parse("torn@ckpt=1"))
    ckpt.save(str(tmp_path / "ckpt_3"), {"w": torch.zeros(3)})
    tree, path = ckpt.restore_latest_good(str(tmp_path))
    assert path.endswith("ckpt_1") and torch.equal(tree["w"], torch.ones(3))


# ----------------------------------------------------------- drive envelope
def _spec():
    return drive.DRIVE_REGISTRY["ae_sweep"]


@pytest.mark.parametrize("outcome,code", [
    (lambda: None, 0), (lambda: 3, 3),
    (lambda: (_ for _ in ()).throw(res.Preempted(site="chunk")), drive.EXIT_DRAINED),
    (lambda: (_ for _ in ()).throw(OSError(5, "EIO")), drive.EXIT_IO)])
def test_run_drive_maps_outcomes_to_exit_codes(tmp_path, outcome, code, capsys):
    assert drive.run_drive(_spec(), outcome) == code
    assert drive.run_drive(_spec(), outcome, obs_dir=str(tmp_path / "obs")) == code
    if code == drive.EXIT_DRAINED:
        assert "re-run the same command" in capsys.readouterr().err


def test_run_drive_session_boundary_eio_exits_74(tmp_path):
    res.install_plan(faults.FaultPlan.parse("io_fail@manifest=1x5"))
    assert drive.run_drive(_spec(), lambda: 0, obs_dir=str(tmp_path / "obs")) == drive.EXIT_IO


def test_registry_is_a_subset_of_jax_s_with_its_fields():
    assert set(drive.DRIVE_REGISTRY) <= set(JAX_DRIVES)
    assert {s.family for s in drive.DRIVE_REGISTRY.values()} == \
        {s.family for s in JAX_DRIVES.values()} == set(drive.FAMILIES) | {"telemetry", "canary"}
    for name, spec in drive.DRIVE_REGISTRY.items():
        theirs = JAX_DRIVES[name]
        for f in ("family", "timeout", "boundary_sites", "snapshot", "deterministic",
                  "resumable", "double_buffer", "tier", "hint_sites", "drain_hint"):
            assert getattr(spec, f) == getattr(theirs, f), (name, f)
        known = set(faults.KNOWN_SITES)
        assert set(spec.boundary_sites) | set(spec.hint_sites) <= known


def test_resolve_watchdog_order(monkeypatch):
    spec = _spec()
    assert drive.resolve_watchdog(spec) == drive.DEFAULT_WATCHDOG_SECS
    monkeypatch.setenv(drive.ENV_WATCHDOG, "12")
    assert drive.resolve_watchdog(spec) == 12.0
    assert drive.resolve_watchdog(spec, override=3) == 3.0


# -------------------------------------------------------- trainer drain
H, W, F, B = 8, 6, 5, 4


def _trainer_cfg(ckdir):
    return ExperimentConfig(
        model=ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=F),
        train=TrainConfig(batch_size=B, n_critic=2, steps_per_call=2, seed=11,
                          checkpoint_dir=str(ckdir), checkpoint_every=0))


def test_trainer_drains_into_a_final_checkpoint_and_resumes_bitwise(tmp_path):
    windows = torch.from_numpy(
        np.random.default_rng(7).uniform(0, 1, (32, W, F)).astype(np.float32))
    straight = GanTrainer(_trainer_cfg(tmp_path / "a"), windows, device="cpu")
    straight.train(epochs=7)
    drained = GanTrainer(_trainer_cfg(tmp_path / "b"), windows, device="cpu")
    res.install_plan(faults.FaultPlan.parse("preempt@block=2"))
    with pytest.raises(res.Preempted) as ei:
        drained.train(epochs=7)
    res.clear_plan()
    assert ei.value.site == "block" and ei.value.epoch == 4
    assert ei.value.snapshot.endswith("ckpt_4") and not res.drain_requested()
    resumed = GanTrainer(_trainer_cfg(tmp_path / "b"), windows, device="cpu")
    assert resumed.restore_checkpoint().endswith("ckpt_4") and resumed.epoch == 4
    resumed.train(epochs=3)
    for ma, mb in ((straight.state.generator, resumed.state.generator),
                   (straight.state.discriminator, resumed.state.discriminator)):
        for a, b in zip(ma.state_dict().values(), mb.state_dict().values()):
            assert torch.equal(a, b)
    assert torch.equal(straight.gen.get_state(), resumed.gen.get_state())
    assert resumed.history == straight.history[4:]


def test_train_gan_verb_drains_into_exit_75_and_resumes(tmp_path, monkeypatch, capsys):
    from hfrep_tpu_torch import config as port_config
    from hfrep_tpu_torch.experiments.cli import main

    cleaned = str(Path(__file__).resolve().parents[1] / "results" / "rederived_cleaned")
    cfg = ExperimentConfig(
        data=port_config.DataConfig(n_sample=48, window=W),
        model=ModelConfig(family="mtss_wgan_gp", hidden=H, window=W, features=35),
        train=TrainConfig(batch_size=B, n_critic=2, steps_per_call=2, checkpoint_every=0,
                          epochs=6), name="tiny")
    monkeypatch.setitem(port_config.PRESETS, "tiny", cfg)
    base = ["train-gan", "--preset", "tiny", "--cleaned-dir", cleaned, "--device", "cpu",
            "--quiet", "--checkpoint-dir", str(tmp_path / "ck")]
    monkeypatch.setenv(res.ENV_FAULTS, "sigterm@block=1")
    assert main(base + ["--obs-dir", str(tmp_path / "obs")]) == drive.EXIT_DRAINED
    assert "re-run with --resume" in capsys.readouterr().err
    assert (tmp_path / "ck" / "ckpt_2" / ckpt.META_NAME).exists()
    events = (tmp_path / "obs" / "events.jsonl").read_text()
    assert '"preempt_drain"' in events and '"drive_exit"' in events
    monkeypatch.delenv(res.ENV_FAULTS)
    res.clear_plan()
    monkeypatch.setattr(res, "_env_consumed", False)
    assert main(base + ["--resume"]) == 0
    assert "resumed from" in capsys.readouterr().out


# ---------------------------------------------------- engine chunk resume
F_AE = 6


def _panel():
    return np.random.default_rng(5).uniform(0, 1, (48, F_AE)).astype(np.float32)


def _ae_cfg(**kw):
    base = dict(n_factors=F_AE, latent_dim=3, epochs=16, chunk_epochs=3, batch_size=16,
                patience=3, lr=0.02, seed=4)
    base.update(kw)
    return AEConfig(**base)


def _assert_bitwise(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.stop_epoch, b.stop_epoch)
    for k in ("train_loss", "val_loss"):
        x, y = getattr(a, k), getattr(b, k)
        assert torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())


@pytest.mark.parametrize("kill_after", [1, 3])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_chunked_sweep_killed_and_resumed_is_bitwise_the_straight_drive(
        tmp_path, kill_after, double_buffer):
    cfg = _ae_cfg(double_buffer=double_buffer)
    x = _panel()
    straight, sstats = engine.sweep_autoencoders_chunked(4, x, cfg, [1, 2, 3], device="cpu")
    rd = str(tmp_path / "resume")
    res.install_plan(faults.FaultPlan.parse(f"preempt@chunk={kill_after}"))
    with pytest.raises(res.Preempted) as ei:
        engine.sweep_autoencoders_chunked(4, x, cfg, [1, 2, 3], device="cpu", resume_dir=rd)
    res.clear_plan()
    assert ei.value.epoch == 3 * kill_after and ei.value.snapshot.endswith("chunk_snapshot")
    assert (Path(rd) / "chunk_snapshot" / ckpt.META_NAME).exists()
    resumed, rstats = engine.sweep_autoencoders_chunked(4, x, cfg, [1, 2, 3], device="cpu",
                                                        resume_dir=rd)
    _assert_bitwise(straight, resumed)
    assert rstats.chunks_dispatched == sstats.chunks_dispatched - (
        sstats.overshoot_chunks if double_buffer else 0)
    assert rstats.epochs_dispatched <= sstats.epochs_dispatched
    assert not (Path(rd) / "chunk_snapshot").exists()          # cleared when done


def test_chunk_snapshot_of_another_drive_is_refused(tmp_path):
    cfg = _ae_cfg()
    x = _panel()
    rd = str(tmp_path / "resume")
    res.install_plan(faults.FaultPlan.parse("preempt@chunk=2"))
    with pytest.raises(res.Preempted):
        engine.sweep_autoencoders_chunked(4, x, cfg, [1, 2], device="cpu", resume_dir=rd)
    res.clear_plan()
    # another seed: the snapshot is foreign, the drive starts fresh
    other, _ = engine.sweep_autoencoders_chunked(9, x, cfg, [1, 2], device="cpu", resume_dir=rd)
    fresh, _ = engine.sweep_autoencoders_chunked(9, x, cfg, [1, 2], device="cpu")
    _assert_bitwise(other, fresh)


def test_resume_dir_needs_the_chunked_drive(tmp_path):
    with pytest.raises(ValueError, match="chunked"):
        engine.sweep_autoencoders_chunked(0, _panel(), _ae_cfg(chunk_epochs=0), [1],
                                          device="cpu", resume_dir=str(tmp_path))


def test_sweep_verb_resume_is_bitwise(tmp_path, monkeypatch, capsys):
    """``sweep --resume`` under ``preempt@chunk=2`` exits 75 with its
    snapshot under ``<out>/_resume``; re-running completes with every
    output byte-equal to the undisturbed sweep's."""
    from hfrep_tpu_torch.experiments.cli import main

    cleaned = str(Path(__file__).resolve().parents[1] / "results" / "rederived_cleaned")
    base = ["sweep", "--device", "cpu", "--cleaned-dir", cleaned, "--latents", "1:3",
            "--epochs", "9", "--chunk-epochs", "3"]
    assert main(base + ["--out", str(tmp_path / "a")]) == 0
    out = tmp_path / "b"
    monkeypatch.setenv(res.ENV_FAULTS, "preempt@chunk=2")
    monkeypatch.setattr(res, "_env_consumed", False)      # the env is read once
    assert main(base + ["--out", str(out), "--resume"]) == drive.EXIT_DRAINED
    assert (out / "_resume" / "chunk_snapshot" / ckpt.META_NAME).exists()
    monkeypatch.delenv(res.ENV_FAULTS)
    res.clear_plan()
    monkeypatch.setattr(res, "_env_consumed", False)
    assert main(base + ["--out", str(out), "--resume"]) == 0
    capsys.readouterr()
    assert not (out / "_resume" / "chunk_snapshot").exists()
    for f in ("post.npy", "ante.npy", "fit_metrics.csv", "train_loss.npy"):
        assert (out / f).read_bytes() == (tmp_path / "a" / f).read_bytes(), f
