"""The port's obs stream (``hfrep_tpu_torch/obs``) against the JAX
package's: the instruments, the event records of a scripted sequence of
calls (JAX's keys, apart from times), the manifest, the wall-clock
ledger's reconstruction on the JAX package's committed fixture (ledger,
rendering and perfetto trace byte for byte), the trainer's spans and
ledger windows read by the JAX readers, and the telemetry hooks of the
metric log, the trainer, ``instrument_step`` and ``trace_capture``.
Everything runs on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import hfrep_tpu.obs as jobs
import hfrep_tpu_torch.obs as obs_pkg
import hfrep_tpu_torch.resilience as res
from hfrep_tpu.obs import manifest as jmanifest
from hfrep_tpu.obs import report as jreport
from hfrep_tpu.obs import timeline as jtimeline
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.obs import manifest, timeline
from hfrep_tpu_torch.obs.metriclog import MetricLogger
from hfrep_tpu_torch.resilience import faults
from hfrep_tpu_torch.train.trainer import GanTrainer


@pytest.fixture(autouse=True)
def _pristine():
    """No enabled sink, half-filled ledger window or fault plan leaks."""
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    timeline.reset()
    jtimeline.reset()
    res.clear_plan()
    torch.set_num_threads(1)
    yield
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    timeline.reset()
    jtimeline.reset()
    res.clear_plan()


JAX_FIXTURE = Path(jtimeline.__file__).resolve().parent / "_fixture" / "timeline"


# ------------------------------------------------------------- instruments
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_percentiles_equal_jax_s(tmp_path, seed):
    g = np.random.default_rng(seed)
    samples = np.concatenate([g.lognormal(size=500), [0.0, 0.0, -1.0, 3e-9, 7e4]])
    with obs_pkg.session(tmp_path / "p", manifest=False) as mine, \
            jobs.session(tmp_path / "j", manifest=False, compile_listener=False) as theirs:
        hm, hj = mine.histogram("lat"), theirs.histogram("lat")
        for v in samples:
            hm.observe(float(v))
            hj.observe(float(v))
        for pct in (1, 5, 50, 95, 99, 99.9, 100):
            assert hm.percentile(pct) == hj.percentile(pct), pct
        assert (hm.n, hm.sum, hm.min, hm.max) == (hj.n, hj.sum, hj.min, hj.max)


def test_disabled_obs_is_the_null_sink():
    obs = obs_pkg.get_obs()
    assert obs is obs_pkg.NULL and not obs.enabled
    with obs.span("x"):
        obs.counter("c").inc()
        obs.gauge("g").set(1)
        obs.event("e")
    fn = lambda: 1                                    # noqa: E731
    assert obs_pkg.instrument_step(fn, "s") is fn


def _script(pkg, tl) -> None:
    """One sequence of telemetry calls, the same in both packages."""
    obs = pkg.get_obs()
    obs.event("train_start", family="mtss_wgan_gp", epochs=3, mesh=None)
    obs.counter("checkpoints").inc()
    obs.counter("checkpoints").inc(2, site="ckpt_save")
    obs.gauge("steps_per_sec").set(12.5, drive="gan_block")
    obs.gauge("nan").set(float("nan"))
    obs.histogram("step_time").observe(0.25, warmup=True)
    with obs.span("train", epochs=3):
        with obs.span("checkpoint", epoch=2, path="/x/ckpt_2"):
            pass
        obs.record_span("block", 0.5, steps=2, warmup=False, synced=True)
    tl.account("host_io", 0.01)
    tl.flush_window(0.05, drive="gan_block", steps=2, warmup=False, sync_wait_s=0.02)
    obs.event("preempt_drain", epoch=4, checkpoint=None)


#: fields whose values are measured (wall times, the obs layer's own cost)
_TIMED = ("t", "dur")


def _shape(rec: dict):
    """A record with its measured values blanked: timeline windows and
    gauges carry the obs layer's measured emit cost, run_end a summary
    of them."""
    out = {k: v for k, v in rec.items() if k not in _TIMED}
    if out.get("name") == "timeline_window":
        out["cat_ms"] = sorted(out["cat_ms"])
    if str(out.get("name", "")).startswith("timeline/") and out["type"] == "metric":
        out["value"] = None
    if out.get("name") == "run_end":
        out["summary"] = {k: sorted(v) for k, v in out["summary"].items()}
    return out


def test_event_stream_records_are_jax_s(tmp_path):
    with obs_pkg.session(tmp_path / "p", manifest=False):
        _script(obs_pkg, timeline)
    with jobs.session(tmp_path / "j", manifest=False, compile_listener=False):
        _script(jobs, jtimeline)
    mine = jreport.load_events(tmp_path / "p", strict=True)      # JAX's schema check
    theirs = jreport.load_events(tmp_path / "j", strict=True)
    assert [_shape(r) for r in mine] == [_shape(r) for r in theirs]
    # JAX's ledger reader folds the port's window, and it conserves
    doc = jtimeline.ledger_from_events(mine)
    assert doc["windows"] == 1 and doc["conservation"]["ok"]
    assert doc["categories_ms"]["device_compute"] == 20.0
    assert doc["categories_ms"]["host_io"] == 10.0
    assert timeline.ledger_from_events(mine) == doc


def test_manifest_has_jax_s_keys_and_the_card_facts(tmp_path):
    with obs_pkg.session(tmp_path / "run", command="test") as obs:
        obs.annotate(config={"a": 1})
    doc = jmanifest.read_manifest(tmp_path / "run")
    assert all(k in doc for k in jmanifest.REQUIRED_KEYS)
    assert doc["schema_version"] == jmanifest.SCHEMA_VERSION == manifest.SCHEMA_VERSION
    assert doc["command"] == "test" and doc["config"] == {"a": 1}
    assert doc["versions"]["torch"] == torch.__version__ and "jax" not in doc["versions"]
    assert doc["devices"]["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert doc["host"]["pid"] > 0 and doc["run_id"] == "run"


def test_reused_run_dir_rotates_the_previous_stream(tmp_path):
    for _ in range(2):
        with obs_pkg.session(tmp_path / "run", manifest=False) as obs:
            obs.event("x")
    assert (tmp_path / "run" / "events-1.jsonl").exists()
    assert sum(r["name"] == "run_start"
               for r in timeline.load_events(tmp_path / "run")) == 1


def test_session_crash_and_telemetry_faults_never_kill_the_run(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with obs_pkg.session(tmp_path / "run", manifest=False):
            1 / 0
    assert timeline.load_events(tmp_path / "run")[-1]["name"] == "run_end"
    assert obs_pkg.get_obs() is obs_pkg.NULL
    # an injected EIO on the stream append drops the record, never raises
    res.install_plan(faults.FaultPlan.parse("io_fail@obs_append=2"))
    with obs_pkg.session(tmp_path / "f", manifest=False) as obs:
        obs.event("a")
        obs.event("b")
    names = [r["name"] for r in timeline.load_events(tmp_path / "f")]
    assert "a" not in names and "b" in names and "fault_injected" in names
    # an unusable run dir degrades to telemetry off
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with obs_pkg.session_or_off(blocker / "run", "prog") as obs:
        assert obs is obs_pkg.NULL


# ---------------------------------------------------------------- timeline
def test_fixture_copy_is_jax_s():
    assert (timeline.fixture_dir() / "events.jsonl").read_bytes() == \
        (JAX_FIXTURE / "events.jsonl").read_bytes()


@pytest.mark.parametrize("torn", [False, True])
def test_ledger_render_and_trace_equal_jax_s_on_the_fixture(tmp_path, torn):
    fx = tmp_path / "timeline"
    shutil.copytree(JAX_FIXTURE, fx)
    if torn:                    # a SIGKILL's torn tail: the last window dropped
        text = (fx / "events.jsonl").read_text().splitlines(keepends=True)
        (fx / "events.jsonl").write_text("".join(text[:-2]) + text[-2][:40])
    mine = timeline.ledger_from_events(timeline.load_events(fx))
    theirs = jtimeline.ledger_from_events(jreport.load_events(fx))
    assert mine == theirs
    assert timeline.render_ledger(mine) == jtimeline.render_ledger(theirs)
    assert timeline.build_trace(fx) == jtimeline.build_trace(fx)
    assert timeline.build_trace(timeline.fixture_dir()) == jtimeline.build_trace(JAX_FIXTURE)
    for fmt in ("human", "json"):
        outs = []
        for tl, tag in ((timeline, "p"), (jtimeline, "j")):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                rc = tl.timeline_main(fx, out=str(tmp_path / f"{tag}.json"), fmt=fmt)
            outs.append((rc, buf.getvalue(), (tmp_path / f"{tag}.json").read_bytes()))
        assert outs[0] == outs[1]


def test_timeline_self_test_passes(capsys):
    assert timeline.self_test() == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True


def test_nested_timed_books_exclusive_time():
    import time
    timeline.reset()
    with timeline.timed("host_io") as outer:
        time.sleep(0.002)
        with timeline.timed("checkpoint") as inner:
            time.sleep(0.002)
        with timeline.timed(None):                  # measured, booked nowhere
            timeline.account("queue_wait", 0.0005)
    w = dict(timeline._LEDGER.window)
    assert w["checkpoint"] == inner.s and w["queue_wait"] == 0.0005
    # the outer frame books its duration less its children's, summed in
    # the order they closed
    assert w["host_io"] == outer.s - (inner.s + 0.0005)


def test_trainer_spans_and_block_windows_read_by_jax(tmp_path):
    cfg = ExperimentConfig(
        model=ModelConfig(family="mtss_wgan_gp", hidden=8, window=6, features=5),
        train=TrainConfig(batch_size=4, n_critic=2, steps_per_call=2, seed=3,
                          checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2))
    windows = torch.from_numpy(
        np.random.default_rng(7).uniform(0, 1, (32, 6, 5)).astype(np.float32))
    with obs_pkg.session(tmp_path / "run"):
        tr = GanTrainer(cfg, windows, device="cpu",
                        logger=MetricLogger(echo=False, echo_style="wgan_gp"))
        tr.train(epochs=5)
        tr.generate(3)
    records = jreport.load_events(tmp_path / "run", strict=True)
    spans = [r["name"] for r in records if r["type"] == "span"]
    for name in ("train", "block", "checkpoint", "generate", "compile:multi_step"):
        assert name in spans, name
    events = {r["name"] for r in records if r["type"] == "event"}
    assert {"train_start", "train_end", "parallel_build", "run_end"} <= events
    gauges = {r["name"] for r in records if r["type"] == "metric" and r["kind"] == "gauge"}
    assert {"steps_per_sec", "train/d_loss", "train/g_loss", "timeline/wall_ms"} <= gauges
    doc = jtimeline.ledger_from_events(records)
    assert doc["windows"] == 3 and doc["conservation"]["ok"]    # 2 blocks + 1 remainder
    summary = jreport.summarize(tmp_path / "run")
    assert summary is not None


def test_instrument_step_records_the_first_call_and_counts_the_rest(tmp_path):
    with obs_pkg.session(tmp_path / "run", manifest=False):
        step = obs_pkg.instrument_launch(lambda x: {"y": x + 1}, "toy",
                                         tcfg=TrainConfig(batch_size=7))
        assert step.__wrapped__(1) == {"y": 2}
        for i in range(3):
            step(torch.tensor(float(i)))
    records = timeline.load_events(tmp_path / "run")
    build = next(r for r in records if r["name"] == "parallel_build")
    assert build["step"] == "toy" and build["batch"] == 7
    assert sum(r["name"] == "compile:toy" for r in records) == 1
    assert [r["value"] for r in records if r["name"] == "dispatch:toy"] == [1, 2]


def test_trace_capture_links_the_profile_into_the_run(tmp_path):
    with obs_pkg.session(tmp_path / "run"):
        with obs_pkg.trace_capture(phase="t") as d:
            torch.ones(4) @ torch.ones(4)
    doc = jmanifest.read_manifest(tmp_path / "run")
    assert doc["traces"][0]["path"] == d and doc["traces"][0]["n_traces"] == 1
    assert json.loads((Path(d) / "trace-1.json").read_text())["traceEvents"] is not None
    with obs_pkg.trace_capture() as none:
        assert none is None                        # telemetry off, no dir: a no-op
