"""The port's rollup tier (``hfrep_tpu_torch/obs/rollup.py``) and the
writer-side rotation of its live stream against the JAX package's, on
the CPU: the fold state, the reader seed and the pinned evidence are the
JAX module's byte for byte; the read path gives the raw stream's answers
on a rotated and on a compacted run dir; torn tails, renamed streams and
an injected ``rollup_publish`` fault end as they end in the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import hfrep_tpu.obs as jobs
import hfrep_tpu.obs.rollup as jrollup
import hfrep_tpu.resilience as jres
import hfrep_tpu_torch.obs as obs_pkg
import hfrep_tpu_torch.resilience as res
from hfrep_tpu.obs import report as jreport
from hfrep_tpu.resilience import faults as jfaults
from hfrep_tpu_torch.obs import report, rollup
from hfrep_tpu_torch.resilience import faults

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_FX = REPO_ROOT / "hfrep_tpu" / "obs" / "_fixture"
HIST_FX = JAX_FX / "history"


@pytest.fixture(autouse=True)
def _pristine():
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    res.clear_plan()
    jres.clear_plan()
    yield
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    res.clear_plan()
    jres.clear_plan()


def _cli(pkg: str, *args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_FAULTS",
                        "HFREP_OBS_ROTATE_BYTES")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO_ROOT)
    return subprocess.run([sys.executable, "-m", pkg, *map(str, args)], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=env)


# ------------------------------------------------------- synthetic runs
def _batch_records(k: int):
    """One deterministic soak batch: spans, the three metric kinds, an
    event with a trace ID and a pinned (warmup) span."""
    t = k * 37.0
    return [
        {"v": 1, "t": t + 0.1, "type": "span", "name": "work", "dur": 0.01 + k * 1e-4,
         "depth": 0},
        {"v": 1, "t": t + 0.2, "type": "span", "name": "step", "dur": 0.02, "depth": 0,
         "warmup": True},
        {"v": 1, "t": t + 0.3, "type": "metric", "kind": "gauge", "name": "soak/depth",
         "value": float(k % 7)},
        {"v": 1, "t": t + 0.4, "type": "metric", "kind": "counter", "name": "soak/requests",
         "value": float(k + 1), "delta": 1.0},
        {"v": 1, "t": t + 0.5, "type": "metric", "kind": "histogram",
         "name": "serve/latency_ms", "value": 5.0 + (k * 13 % 40)},
        {"v": 1, "t": t + 0.6, "type": "event", "name": "serve_complete", "trace": f"t-{k}",
         "latency_ms": 5.0 + (k * 13 % 40)},
        {"v": 1, "t": t + 0.7, "type": "span", "name": "block", "dur": 0.5, "depth": 0,
         "steps": 5},
    ]


PER_BATCH = len(_batch_records(0))


def _append_batch(run_dir: Path, k: int) -> None:
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "events.jsonl", "a") as fh:
        for rec in _batch_records(k):
            fh.write(json.dumps(rec, sort_keys=True) + "\n")


def _mk_run(run_dir: Path, batches: int) -> Path:
    for k in range(batches):
        _append_batch(run_dir, k)
    return run_dir


def _twins(tmp_path, batches: int):
    """The same run dir twice: one for each package."""
    a = _mk_run(tmp_path / "port" / "run", batches)
    b = tmp_path / "jax" / "run"
    shutil.copytree(a, b)
    return a, b


def _rollup_bytes(run_dir: Path) -> dict:
    ru = run_dir / "rollup"
    return {p.name: p.read_bytes() for p in sorted(ru.iterdir())} if ru.is_dir() else {}


def _norm(doc, parent) -> str:
    return json.dumps(doc, sort_keys=True, default=str).replace(str(parent), "<P>")


# ------------------------------------------------------------ hist math
def test_hist_math_matches_both_histograms():
    class _Sink:
        def _emit(self, rec):
            pass

    mine, theirs = obs_pkg.Histogram(_Sink(), "x"), jobs.Histogram(_Sink(), "x")
    h, jh = rollup.new_hist(), jrollup.new_hist()
    vals = [0.0, -2.5, 0.004, 1.0, 3.7, 42.0, 42.0, 999.5, 1e6, 0.3, float("nan")]
    for v in vals:
        mine.observe(v)
        theirs.observe(v)
        rollup.hist_observe(h, v)
        jrollup.hist_observe(jh, v)
    rollup.hist_observe(h, "junk")
    jrollup.hist_observe(jh, "junk")
    assert json.dumps(h) == json.dumps(jh)
    for pct in (1, 50, 90, 95, 99, 99.9, 100):
        assert rollup.hist_percentile(h, pct) == mine.percentile(pct) == \
            jrollup.hist_percentile(jh, pct)
    assert rollup.hist_cumulative(h) == jrollup.hist_cumulative(jh)


@pytest.mark.parametrize("split", [0, 7, 20, 40])
def test_hist_merge_equals_single_fold(split):
    vals = [0.1 * i for i in range(40)]
    a, b, whole = rollup.new_hist(), rollup.new_hist(), rollup.new_hist()
    for v in vals[:split]:
        rollup.hist_observe(a, v)
    for v in vals[split:]:
        rollup.hist_observe(b, v)
    for v in vals:
        rollup.hist_observe(whole, v)
    assert rollup.hist_merge(rollup.hist_merge(rollup.new_hist(), a), b) == whole
    assert jrollup.hist_merge(jrollup.hist_merge(jrollup.new_hist(), a), b) == whole


# ------------------------------------------------- cursors & durability
@pytest.mark.parametrize("batches,bucket", [(1, 60.0), (8, 60.0), (13, 7.5), (5, 1000.0)])
def test_ingest_state_bytes_equal_jax(tmp_path, batches, bucket):
    a, b = _twins(tmp_path, batches)
    state, consumed = rollup.ingest(a, bucket_secs=bucket)
    jstate, jconsumed = jrollup.ingest(b, bucket_secs=bucket)
    assert consumed == jconsumed == batches * PER_BATCH
    assert _rollup_bytes(a) == _rollup_bytes(b)
    assert rollup.totals(state) == jrollup.totals(jstate)
    assert rollup.n_records(state) == batches * PER_BATCH
    before = (a / "rollup" / rollup.STATE_NAME).read_bytes()
    assert rollup.ingest(a, bucket_secs=bucket)[1] == 0
    assert (a / "rollup" / rollup.STATE_NAME).read_bytes() == before


def test_ingest_persist_false_leaves_no_state(tmp_path):
    run = _mk_run(tmp_path / "run", 3)
    state, consumed = rollup.ingest(run, persist=False)
    assert consumed == 3 * PER_BATCH and not (run / "rollup").exists()
    assert rollup.load_state(run) is None


def test_incremental_ingest_bit_identical_to_one_shot_and_jax(tmp_path):
    inc, jinc, one = tmp_path / "inc" / "run", tmp_path / "jinc" / "run", tmp_path / "one" / "run"
    for k in range(6):
        _append_batch(inc, k)
        _append_batch(jinc, k)
        rollup.ingest(inc, bucket_secs=60.0)
        jrollup.ingest(jinc, bucket_secs=60.0)
    rollup.ingest(_mk_run(one, 6), bucket_secs=60.0)
    assert _rollup_bytes(inc) == _rollup_bytes(one) == _rollup_bytes(jinc)


def test_torn_tail_held_back_until_completed(tmp_path):
    a, b = _twins(tmp_path, 2)
    line = json.dumps({"v": 1, "t": 99.0, "type": "event", "name": "serve_complete"},
                      sort_keys=True)
    for run, mod in ((a, rollup), (b, jrollup)):
        with open(run / "events.jsonl", "a") as fh:
            fh.write(line[:10])
        assert mod.ingest(run, bucket_secs=60.0)[1] == 2 * PER_BATCH     # held back
        with open(run / "events.jsonl", "a") as fh:
            fh.write(line[10:] + "\n")
        state, consumed = mod.ingest(run, bucket_secs=60.0)
        assert consumed == 1 and mod.n_records(state) == 2 * PER_BATCH + 1
    assert _rollup_bytes(a) == _rollup_bytes(b)


def test_garbage_line_is_skipped_as_jax_skips_it(tmp_path):
    a, b = _twins(tmp_path, 2)
    for run in (a, b):
        with open(run / "events.jsonl", "a") as fh:
            fh.write("{not json\n" + json.dumps({"v": 9, "t": 1, "type": "event",
                                                 "name": "x"}) + "\n")
        _append_batch(run, 2)
    assert rollup.ingest(a)[1] == jrollup.ingest(b)[1] == 3 * PER_BATCH
    assert _rollup_bytes(a) == _rollup_bytes(b)


def test_cursor_follows_rotated_stream_without_double_count(tmp_path):
    a, b = _twins(tmp_path, 4)
    for run, mod in ((a, rollup), (b, jrollup)):
        assert mod.ingest(run, bucket_secs=60.0)[1] == 4 * PER_BATCH
        assert mod.rotate_live(run, 1, force=True).name == "chunk-1.jsonl"
        _append_batch(run, 4)
        state, consumed = mod.ingest(run, bucket_secs=60.0)
        assert consumed == PER_BATCH                                   # no re-read
        assert mod.n_records(state) == 5 * PER_BATCH
    assert _rollup_bytes(a) == _rollup_bytes(b)


@pytest.mark.parametrize("size,force,rotates", [(0, False, False), (10**9, False, False),
                                                (1, False, True), (10**9, True, True)])
def test_rotate_live_rule(tmp_path, size, force, rotates):
    run = _mk_run(tmp_path / "run", 2)
    if size == 0:
        (run / "events.jsonl").write_text("")
    got = rollup.rotate_live(run, size or 1, force=force)
    assert (got is not None) is rotates
    assert (run / "events.jsonl").exists()
    if rotates:
        assert got == run / "rollup" / "chunk-1.jsonl"
        assert (run / "events.jsonl").stat().st_size == 0


def test_next_chunk_index_never_reissues_a_compacted_number(tmp_path):
    a, b = _twins(tmp_path, 3)
    for run, mod in ((a, rollup), (b, jrollup)):
        assert mod.next_chunk_index(run) == 1
        mod.rotate_live(run, 1, force=True)
        mod.compact(run)
        assert not mod.chunk_files(run)
        (run / "rollup" / "pinned-1.jsonl").unlink()                   # only the ledger knows
        assert mod.next_chunk_index(run) == 2
    assert rollup.disk_footprint(a) == jrollup.disk_footprint(b)


# --------------------------------------------------- retention/compaction
def test_compaction_soak_bounds_disk_loses_nothing_and_equals_jax(tmp_path):
    a, b = tmp_path / "port" / "run", tmp_path / "jax" / "run"
    cycles, footprints = 12, []
    for k in range(cycles):
        for run, mod in ((a, rollup), (b, jrollup)):
            _append_batch(run, k)
            mod.rotate_live(run, 64)
            res_ = mod.compact(run, bucket_secs=60.0)
        assert _rollup_bytes(a) == _rollup_bytes(b), k
        assert res_["chunks_total"] == k + 1
        footprints.append(rollup.disk_footprint(a))
    assert not rollup.chunk_files(a)
    state, _ = rollup.ingest(a, bucket_secs=60.0)
    assert rollup.n_records(state) == cycles * PER_BATCH
    assert rollup.totals(state)["counters"]["soak/requests"]["inc"] == float(cycles)
    assert footprints[-1] - footprints[cycles // 2] < 10_000
    assert rollup.summary_seed(a) == jrollup.summary_seed(b)
    assert rollup.evidence_seed(a) == jrollup.evidence_seed(b)


def test_compaction_preserves_summary_and_matches_jax(tmp_path):
    raw = _mk_run(tmp_path / "raw" / "run", 9)
    comp, jcomp = tmp_path / "comp" / "run", tmp_path / "jcomp" / "run"
    shutil.copytree(raw, comp)
    shutil.copytree(raw, jcomp)
    out = rollup.compact(comp, bucket_secs=60.0, rotate_bytes=64, force_rotate=True)
    jout = jrollup.compact(jcomp, bucket_secs=60.0, rotate_bytes=64, force_rotate=True)
    assert _norm(out, comp.parent) == _norm(jout, jcomp.parent)
    assert rollup.pinned_files(comp) and _rollup_bytes(comp) == _rollup_bytes(jcomp)
    assert _norm(report.summarize(raw), raw.parent) == \
        _norm(report.summarize(comp), comp.parent) == \
        _norm(jreport.summarize(jcomp), jcomp.parent)


def test_trace_identical_on_compacted_run(tmp_path):
    raw = _mk_run(tmp_path / "raw" / "run", 5)
    comp = tmp_path / "comp" / "run"
    shutil.copytree(raw, comp)
    rollup.compact(comp, bucket_secs=60.0, rotate_bytes=64, force_rotate=True)
    ta, tc = report.trace_index([raw], ["t-3"]), report.trace_index([comp], ["t-3"])
    assert ta["t-3"] and _norm(ta, raw.parent) == _norm(tc, comp.parent)
    assert _norm(jreport.trace_index([comp], ["t-3"]), comp.parent) == _norm(tc, comp.parent)


def test_gate_verdict_identical_on_compacted_run(tmp_path):
    raw_p, comp_p = tmp_path / "raw", tmp_path / "comp"
    shutil.copytree(HIST_FX / "run_d", raw_p / "run_d")
    shutil.copytree(HIST_FX / "run_d", comp_p / "run_d")
    rollup.compact(comp_p / "run_d", bucket_secs=60.0, rotate_bytes=64, force_rotate=True)
    outs = []
    for parent in (raw_p, comp_p):
        for pkg in ("hfrep_tpu_torch.obs", "hfrep_tpu.obs"):
            proc = _cli(pkg, "gate", parent / "run_d", "--history",
                        HIST_FX / "history.jsonl", "--format", "json")
            assert proc.returncode == 0, proc.stderr
            outs.append(proc.stdout.replace(str(parent), "<P>"))
    assert len(set(outs)) == 1


def test_rotated_uncompacted_run_reads_complete(tmp_path):
    raw = _mk_run(tmp_path / "raw" / "run", 7)
    rot = tmp_path / "rot" / "run"
    shutil.copytree(raw, rot)
    rollup.rotate_live(rot, 1, force=True)
    _append_batch(rot, 7)
    _append_batch(raw, 7)
    assert _norm(report.summarize(raw), raw.parent) == _norm(report.summarize(rot), rot.parent)
    assert _norm(report.trace_index([raw], ["t-2"]), raw.parent) == \
        _norm(report.trace_index([rot], ["t-2"]), rot.parent)
    assert report.load_events(rot) == jreport.load_events(rot)


def test_compact_cli_equals_jax(tmp_path):
    outs = []
    for pkg in ("hfrep_tpu_torch.obs", "hfrep_tpu.obs"):
        run = _mk_run(tmp_path / pkg / "run", 6)
        human = _cli(pkg, "compact", run, "--rotate-bytes", "64", "--bucket-secs", "30")
        _append_batch(run, 6)
        js = _cli(pkg, "compact", run, "--force-rotate", "--format", "json")
        assert human.returncode == js.returncode == 0
        outs.append((human.stdout.replace(str(tmp_path / pkg), "<P>"),
                     js.stdout.replace(str(tmp_path / pkg), "<P>"), _rollup_bytes(run)))
    assert outs[0] == outs[1]


# ------------------------------------------------- writer-side rotation
def _scripted(pkg, run: Path, rotate_bytes: int) -> None:
    """One scripted sequence of sink calls, the same in either package."""
    kw = {} if pkg is obs_pkg else {"compile_listener": False}
    with pkg.session(run, command="rot-test", rotate_bytes=rotate_bytes, **kw) as obs:
        g, c, h = obs.gauge("soak/depth"), obs.counter("soak/n"), obs.histogram("serve/lat")
        for i in range(150):
            g.set(float(i))
            if i % 3 == 0:
                c.inc(2)
            if i % 5 == 0:
                h.observe(1.0 + i)
            if i % 11 == 0:
                obs.event("serve_complete", trace=f"t-{i}")
                obs.record_span("block", 0.01, steps=2)


@pytest.mark.parametrize("rotate_bytes", [600, 5000])
def test_writer_rotation_matches_jax(tmp_path, rotate_bytes):
    mine, theirs = tmp_path / "port" / "run", tmp_path / "jax" / "run"
    _scripted(obs_pkg, mine, rotate_bytes)
    _scripted(jobs, theirs, rotate_bytes)
    chunks = [(p.name, len(p.read_text().splitlines())) for p in rollup.chunk_files(mine)]
    jchunks = [(p.name, len(p.read_text().splitlines())) for p in jrollup.chunk_files(theirs)]
    assert chunks == jchunks and len(chunks) >= 2
    assert len((mine / "events.jsonl").read_text().splitlines()) == \
        len((theirs / "events.jsonl").read_text().splitlines())
    for cf in rollup.chunk_files(mine):
        report.load_jsonl(cf, report.parse_event, strict=True)         # whole lines only
    for run, mod, rep in ((mine, rollup, report), (theirs, jrollup, jreport)):
        raw = rep.summarize(run)
        mod.compact(run)
        assert not mod.chunk_files(run)
        assert json.dumps(rep.summarize(run)) == json.dumps(raw)
        state, _ = mod.ingest(run, persist=False)
        assert mod.totals(state)["gauges"]["soak/depth"]["n"] == 150


def test_rotation_off_by_default_and_env_knob(tmp_path, monkeypatch):
    _scripted(obs_pkg, tmp_path / "off", 0)
    assert not rollup.chunk_files(tmp_path / "off")
    monkeypatch.setenv("HFREP_OBS_ROTATE_BYTES", "700")
    with obs_pkg.session(tmp_path / "env") as obs:
        for i in range(100):
            obs.gauge("g").set(float(i))
    assert [p.name for p in rollup.chunk_files(tmp_path / "env")] == \
        ["chunk-1.jsonl", "chunk-2.jsonl", "chunk-3.jsonl"]
    assert "rotate_bytes" not in json.loads((tmp_path / "env" / "run.json").read_text())


def test_trainer_rotates_under_the_knob(tmp_path, monkeypatch):
    import numpy as np
    import torch

    from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.obs.metriclog import MetricLogger
    from hfrep_tpu_torch.train.trainer import GanTrainer

    torch.set_num_threads(1)
    monkeypatch.setenv("HFREP_OBS_ROTATE_BYTES", "2048")
    cfg = ExperimentConfig(
        model=ModelConfig(family="mtss_wgan_gp", hidden=8, window=6, features=5),
        train=TrainConfig(batch_size=4, n_critic=1, steps_per_call=50, seed=3))
    windows = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (16, 6, 5))
                               .astype(np.float32))
    run = tmp_path / "run"
    with obs_pkg.session(run):
        GanTrainer(cfg, windows, device="cpu",
                   logger=MetricLogger(echo=False, echo_style="wgan_gp")).train(epochs=6)
    chunks = rollup.chunk_files(run)
    assert len(chunks) >= 2
    assert any(r["name"] == "block" for r in report.load_jsonl(chunks[0], report.parse_event,
                                                               strict=True))
    raw = report.summarize(run)
    rollup.compact(run)
    assert report.summarize(run) == raw
    assert {k: v for k, v in raw.items() if k != "mfu"} == \
        {k: v for k, v in jreport.summarize(run).items() if k != "mfu"}


# ------------------------------------------------------------ io faults
@pytest.mark.parametrize("spec", ["io_fail@rollup_publish=1", "io_fail@rollup_publish=2",
                                  "io_fail@rollup_publish=3x2"])
def test_rollup_publish_fault_ends_as_in_jax(tmp_path, spec):
    clean = _mk_run(tmp_path / "clean" / "run", 5)
    rollup.compact(clean, rotate_bytes=64, force_rotate=True)
    outcomes = []
    for pkg, mod, fx in ((res, rollup, faults), (jres, jrollup, jfaults)):
        run = _mk_run(tmp_path / mod.__name__ / "run", 5)
        pkg.install_plan(fx.FaultPlan.parse(spec))
        try:
            mod.compact(run, rotate_bytes=64, force_rotate=True)
            first = "ok"
        except OSError as e:
            first = f"OSError: {e}"
        pkg.clear_plan()
        second = mod.compact(run)                      # the retry completes the pass
        state, _ = mod.ingest(run, persist=False)
        outcomes.append((first, sorted(_rollup_bytes(run)), mod.n_records(state),
                         second["chunks_total"]))
        assert _rollup_bytes(run) == _rollup_bytes(clean)      # nothing lost or doubled
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0].startswith("OSError") and outcomes[0][2] == 5 * PER_BATCH
