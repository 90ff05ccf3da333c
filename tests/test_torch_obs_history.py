"""The port's run-history store and regression engine
(``hfrep_tpu_torch/obs/{history,regress}.py``) against the JAX package's,
on the CPU: the same records, keys, merged multi-host runs, verdicts and
rendered text on the committed history fixture and on synthetic series;
the torn-tail policy and its repair before an append; the bench tail
(``gate_and_ingest``, ``resolve_history``)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from hfrep_tpu.obs import history as jhistory
from hfrep_tpu.obs import regress as jregress
from hfrep_tpu_torch.obs import history, regress
from hfrep_tpu_torch.obs.report import SchemaError

REPO_ROOT = Path(__file__).resolve().parents[1]
HIST_FX = REPO_ROOT / "hfrep_tpu" / "obs" / "_fixture" / "history"
RUNS = ("run_a", "run_b", "run_c", "run_d", "regressed", "multihost/proc0",
        "multihost/proc1")


@pytest.mark.parametrize("rel", RUNS)
def test_summarize_run_equals_jax(rel):
    assert history.summarize_run(HIST_FX / rel) == jhistory.summarize_run(HIST_FX / rel)


def test_merge_and_merged_record_equal_jax():
    mine, theirs = history.merge_run_dirs(HIST_FX / "multihost"), \
        jhistory.merge_run_dirs(HIST_FX / "multihost")
    assert json.dumps(mine, default=str) == json.dumps(theirs, default=str)
    assert mine["hosts"] == 2 and mine["steps_per_sec"] == min(
        h["steps_per_sec"] for h in mine["per_host"].values())
    assert history.merged_record(HIST_FX / "multihost") == \
        jhistory.merged_record(HIST_FX / "multihost")
    assert history.find_proc_dirs(HIST_FX / "multihost") == \
        jhistory.find_proc_dirs(HIST_FX / "multihost")


def test_merge_refuses_a_parent_without_proc_dirs(tmp_path):
    with pytest.raises(SchemaError, match="no per-process run dirs"):
        history.merge_run_dirs(tmp_path)


@pytest.mark.parametrize("manifest", [
    {},
    {"config": {"model": {"family": "mtss_wgan_gp", "window": 48, "features": 35,
                          "hidden": 100}, "train": {"batch_size": 32}},
     "host": {"hostname": "h"}, "devices": {"backend": "cuda"}},
    {"config": {"model": {"family": "gan", "window": 168}}, "mesh": {"dp": 8},
     "devices": {"backend": "cpu"}},
    {"config": {"serve": {"max_batch": 8, "deadline_ms": 30}, "model": {"family": "x"}}},
    {"config": {"serve": {"max_batch": 8, "deadline_ms": 5000}}},
    {"config": {"serve": {"max_batch": 8}}},
    {"config": {"scenario": {"funds": 64, "months": 360, "windows": 24, "latents": 8}}},
    {"config": {"scenario": {"funds": 8}, "serve": {"max_batch": 1}}},
], ids=lambda m: json.dumps(m)[:40])
def test_run_key_equals_jax(manifest):
    assert history.run_key(manifest) == jhistory.run_key(manifest)
    summary = {"run_id": "r", "run_dir": "d", "steps": 3.0, "steps_per_sec": float("nan"),
               "memory_high_water_bytes": 0, "mfu": True,
               "gauges": {"serve/qps": 3.0, "bench/x": float("inf"), "other/y": 1.0,
                          "timeline/wall_ms": 9.5}}
    assert history.record_from_summary(summary, manifest, hosts=2) == \
        jhistory.record_from_summary(summary, manifest, hosts=2)


# ------------------------------------------------------------ the store
def _copy_history(tmp_path, name="h.jsonl") -> Path:
    dst = tmp_path / name
    shutil.copy(HIST_FX / "history.jsonl", dst)
    return dst


@pytest.mark.parametrize("tail,kept", [("", 4), ('{"v": 2, "kind": "ru', 4),
                                       ('{"v": 2, "kind": "run", "run_id": "x", "key": {}, '
                                        '"metrics": {}}', 5)])
def test_load_history_torn_tail_as_jax(tmp_path, capsys, tail, kept):
    path = _copy_history(tmp_path)
    with open(path, "a") as fh:
        fh.write(tail)
    mine, theirs = history.load_history(path), jhistory.load_history(path)
    assert mine == theirs and len(mine) == kept
    if tail and kept == 4:
        assert "dropped torn final line" in capsys.readouterr().err
        with pytest.raises(SchemaError):
            history.load_history(path, strict=True)


@pytest.mark.parametrize("line", ["garbage", '{"v": 1, "kind": "run"}', "[]",
                                  '{"v": 2, "kind": "run", "run_id": "x", "key": {}}'])
def test_mid_file_garbage_raises_as_jax(tmp_path, line):
    path = tmp_path / "h.jsonl"
    path.write_text(line + "\n" + (HIST_FX / "history.jsonl").read_text())
    with pytest.raises(SchemaError) as mine:
        history.load_history(path)
    with pytest.raises(jhistory.SchemaError) as theirs:
        jhistory.load_history(path)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("tail", ['{"v": 2, "kind": "ru',
                                  '{"v": 2, "kind": "run", "run_id": "x", "key": {}, '
                                  '"metrics": {}}'])
def test_append_repairs_a_torn_tail_as_jax(tmp_path, tail):
    rec = history.summarize_run(HIST_FX / "run_d")
    for mod, name in ((history, "p.jsonl"), (jhistory, "j.jsonl")):
        path = _copy_history(tmp_path, name)
        with open(path, "a") as fh:
            fh.write(tail)
        assert mod.append_record(path, rec) is True
        assert mod.append_record(path, rec) is False             # (run_id, created_unix)
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert history.load_history(tmp_path / "p.jsonl", strict=True)[-1] == rec


def test_ingest_and_multihost_ingest_equal_jax(tmp_path):
    lines = []
    for mod, name in ((history, "p.jsonl"), (jhistory, "j.jsonl")):
        path = tmp_path / name
        first = mod.ingest(HIST_FX / "run_c", path)
        again = mod.ingest(HIST_FX / "run_c", path)
        mh = mod.ingest_multihost(HIST_FX / "multihost", path)
        assert first["ingested"] and not again["ingested"] and mh["hosts"] == 2
        lines.append([{k: v for k, v in json.loads(x).items() if k != "ingested_unix"}
                      for x in path.read_text().splitlines()])
    assert lines[0] == lines[1] and len(lines[0]) == 2


# ------------------------------------------------------- the engine
def test_rule_table_equals_jax():
    assert regress.DEFAULT_THRESHOLDS == jregress.DEFAULT_THRESHOLDS
    assert regress.DEFAULT_RULE == jregress.DEFAULT_RULE
    assert (regress.DEFAULT_WINDOW, regress.DEFAULT_MIN_RUNS, regress.MAD_TO_SIGMA) == \
        (jregress.DEFAULT_WINDOW, jregress.DEFAULT_MIN_RUNS, jregress.MAD_TO_SIGMA)


@pytest.mark.parametrize("metric", ["steps_per_sec", "serve/shed_rate", "bench/foo_time_ms",
                                    "bench/x_per_sec", "bench/loss", "bench/new_gauge",
                                    "health/nonfinite", "bench/q_rate", "attrib/dispatch_frac"])
@pytest.mark.parametrize("thresholds", [None, {"steps_per_sec": 0.01},
                                        {"bench/new_gauge": {"direction": "down"}}])
def test_rule_for_equals_jax(metric, thresholds):
    assert regress._rule_for(metric, thresholds) == jregress._rule_for(metric, thresholds)


@pytest.mark.parametrize("values", [[1.0], [1.0, 2.0], [3.0, 1.0, 2.0, 10.0],
                                    [5.0, 5.0, 5.0, 5.0], [1.0, 2.0, 4.0, 8.0, 16.0]])
def test_mad_and_trend_slope_equal_jax(values):
    assert regress.mad(values) == jregress.mad(values)
    assert regress.mad(values, 0.0) == jregress.mad(values, 0.0)
    assert regress.trend_slope(values) == jregress.trend_slope(values)


SERIES = [[], [100.0], [100.0, 101.0], [100.0, 99.0, 101.0, 100.5],
          [100.0, 98.0, 96.0, 94.0, 92.0, 90.0], [1.0] * 9, [100.0, 130.0, 70.0, 100.0, 105.0]]


@pytest.mark.parametrize("series", SERIES, ids=lambda s: str(len(s)))
@pytest.mark.parametrize("metric,observed", [("steps_per_sec", 90.0), ("steps_per_sec", 100.0),
                                             ("step_time_p50_s", 1.2), ("backend_compiles", 3),
                                             ("mfu", None), ("bench/x_ms", float("nan")),
                                             ("steps_per_sec", True)])
@pytest.mark.parametrize("kw", [{}, {"min_runs": 2, "window": 3},
                                {"thresholds": {"steps_per_sec": 0.5}}, {"window": 2}])
def test_check_metric_equals_jax(series, metric, observed, kw):
    assert regress.check_metric(metric, observed, series, **kw) == \
        jregress.check_metric(metric, observed, series, **kw)


@pytest.mark.parametrize("rel", RUNS[:5])
@pytest.mark.parametrize("kw", [{}, {"min_runs": 2}, {"window": 2},
                                {"thresholds": {"steps_per_sec": 0.001}},
                                {"metrics": ["steps_per_sec", "mfu"]}])
def test_check_run_verdict_equals_jax(rel, kw):
    records = history.load_history(HIST_FX / "history.jsonl", strict=True)
    rec = history.summarize_run(HIST_FX / rel)
    mine, theirs = regress.check_run(rec, records, **kw), jregress.check_run(rec, records, **kw)
    assert regress.verdict_json(mine) == jregress.verdict_json(theirs)
    assert regress.render_verdict(mine) == jregress.render_verdict(theirs)


def test_seeded_regression_and_no_data_verdicts():
    records = history.load_history(HIST_FX / "history.jsonl", strict=True)
    bad = regress.check_run(history.summarize_run(HIST_FX / "regressed"), records)
    assert not bad["ok"] and "steps_per_sec" in bad["regressions"]
    clean = regress.check_run(history.summarize_run(HIST_FX / "run_d"), records)
    assert clean["ok"] and clean["n_comparable"] >= 3
    empty = {"run_id": "e", "key": clean["key"], "metrics": {"steps_per_sec": None}}
    nothing = regress.check_run(empty, records)
    assert nothing["no_data"] and not nothing["ok"]
    assert regress.render_verdict(nothing) == jregress.render_verdict(
        jregress.check_run(empty, records))


def test_fold_gauges_equals_jax():
    summaries = [{"gauges": {"serve/shed_rate": 0.1, "serve/qps": 50.0, "bench/a_ms": 3.0,
                             "x": None}},
                 {"gauges": {"serve/shed_rate": 0.3, "serve/qps": 40.0, "bench/a_ms": 2.0}},
                 {}]
    assert history.fold_gauges(summaries) == jhistory.fold_gauges(summaries) == \
        {"serve/shed_rate": 0.3, "serve/qps": 40.0, "bench/a_ms": 3.0}


def test_drift_warns_without_tripping_the_gate():
    key = {"family": "f", "shape": None, "mesh": None, "host": "h", "backend": "cuda"}
    records = [{"run_id": f"r{i}", "created_unix": float(i), "key": key,
                "metrics": {"steps_per_sec": 100.0 - 0.9 * i}} for i in range(8)]
    rec = {"run_id": "now", "created_unix": 99.0, "key": key,
           "metrics": {"steps_per_sec": 94.0}}
    mine, theirs = regress.check_run(rec, records), jregress.check_run(rec, records)
    assert mine == theirs and mine["ok"] and mine["drifts"] == ["steps_per_sec"]


# ------------------------------------------------------- the bench tail
def test_default_store_is_absent_in_the_port():
    assert history.default_store() is None


def test_resolve_history(tmp_path, monkeypatch):
    monkeypatch.delenv("HFREP_HISTORY", raising=False)
    assert history.resolve_history(None) is None
    assert history.resolve_history(str(tmp_path)) is None       # no committed store
    monkeypatch.setenv("HFREP_HISTORY", str(tmp_path / "h.jsonl"))
    assert history.resolve_history(None) == str(tmp_path / "h.jsonl") == \
        jhistory.resolve_history(None)


@pytest.mark.parametrize("run,rc_in", [("run_d", 0), ("regressed", 0), ("run_d", 3)])
def test_gate_and_ingest_equals_jax(tmp_path, capsys, run, rc_in):
    outs = []
    for mod, name in ((history, "p.jsonl"), (jhistory, "j.jsonl")):
        path = _copy_history(tmp_path, name)
        rc = mod.gate_and_ingest(HIST_FX / run, path, rc=rc_in)
        outs.append((rc, [{k: v for k, v in json.loads(x).items() if k != "ingested_unix"}
                          for x in path.read_text().splitlines()],
                     capsys.readouterr().err))
    assert outs[0] == outs[1]
    assert (outs[0][0] == 0) == (run == "run_d" and rc_in == 0)
    assert len(outs[0][1]) == 4 + (outs[0][0] == 0)


def test_gate_and_ingest_refuses_a_corrupt_store(tmp_path):
    path = tmp_path / "h.jsonl"
    path.write_text("garbage\n")
    with pytest.raises(SystemExit) as e:
        history.gate_and_ingest(HIST_FX / "run_d", path)
    assert e.value.code == 2
