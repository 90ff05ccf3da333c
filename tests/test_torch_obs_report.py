"""The port's obs CLI and report (``hfrep_tpu_torch/obs/report.py``,
``__main__.py``) against the JAX package's, on the CPU.

* The port's copies of the committed fixture run dirs are byte-equal to
  the JAX package's.
* On the JAX fixture dirs, read in place: ``summarize`` gives JAX's dict
  (apart from ``run_dir``), ``render`` / ``render_diff`` /
  ``render_trace`` JAX's text, ``trace_index`` JAX's index.
* On streams the port writes on the CPU (a 3-epoch ``GanTrainer`` under
  ``obs.session`` and a small serve drive): both summaries agree apart
  from ``mfu`` (the port quotes its own runs against the H100's peak),
  both ``trace_index`` are equal.
* ``python -m hfrep_tpu_torch.obs CMD`` and ``python -m hfrep_tpu.obs
  CMD`` give equal stdout and exit code for every ported subcommand on
  the fixtures; each subcommand of the second half of the tier is
  refused by argparse (exit 2).
* Importing the tier loads neither ``jax`` nor ``hfrep_tpu``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hfrep_tpu.obs as jobs
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu.obs import report as jreport
from hfrep_tpu.obs import timeline as jtimeline
from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.obs import flops, report, timeline
from hfrep_tpu_torch.obs.metriclog import MetricLogger
from hfrep_tpu_torch.serve.fixture import fixture_ae_model, fixture_server, warm_server
from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
from hfrep_tpu_torch.serve.server import ServeConfig
from hfrep_tpu_torch.train.trainer import GanTrainer

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_FX = REPO_ROOT / "hfrep_tpu" / "obs" / "_fixture"
PORT_FX = REPO_ROOT / "hfrep_tpu_torch" / "obs" / "_fixture"
#: every fixture run dir the ported tier reads (the explain fixture is
#: read by tests/test_torch_obs_explain.py)
RUN_DIRS = (".", "timeline", "history/run_a", "history/run_b", "history/run_c",
            "history/run_d", "history/regressed", "history/multihost/proc0",
            "history/multihost/proc1", "fleet/replica_a", "fleet/replica_b")


@pytest.fixture(autouse=True)
def _pristine():
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    timeline.reset()
    jtimeline.reset()
    torch.set_num_threads(1)
    yield
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    timeline.reset()
    jtimeline.reset()


def _without(doc: dict, *keys) -> dict:
    return {k: v for k, v in doc.items() if k not in keys}


def _cli(pkg: str, *args, cwd=REPO_ROOT):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_FAULTS",
                        "HFREP_OBS_ROTATE_BYTES")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO_ROOT)
    return subprocess.run([sys.executable, "-m", pkg, *map(str, args)], cwd=cwd,
                          capture_output=True, text=True, env=env)


# ---------------------------------------------------------------- fixtures
def _fixture_files():
    return sorted(str(p.relative_to(JAX_FX)) for p in JAX_FX.rglob("*") if p.is_file())


@pytest.mark.parametrize("rel", _fixture_files())
def test_port_fixture_copies_are_byte_equal(rel):
    assert (PORT_FX / rel).read_bytes() == (JAX_FX / rel).read_bytes()


def test_port_fixture_holds_no_file_the_jax_one_lacks():
    mine = sorted(str(p.relative_to(PORT_FX)) for p in PORT_FX.rglob("*") if p.is_file())
    assert mine == _fixture_files()


@pytest.mark.parametrize("rel", RUN_DIRS)
def test_summarize_equals_jax_on_the_fixture(rel):
    mine, theirs = report.summarize(JAX_FX / rel), jreport.summarize(JAX_FX / rel)
    assert json.dumps(mine, default=str) == json.dumps(theirs, default=str)
    assert report.render(mine) == jreport.render(theirs)


@pytest.mark.parametrize("a,b", [(".", "history/run_a"), ("history/run_a", "history/regressed"),
                                 ("history/multihost/proc0", "history/multihost/proc1"),
                                 ("fleet/replica_a", "timeline")])
def test_render_diff_equals_jax(a, b):
    sa, sb = report.summarize(JAX_FX / a), report.summarize(JAX_FX / b)
    assert report.render_diff(sa, sb) == jreport.render_diff(sa, sb)


def test_fixture_mfu_keeps_the_writers_peak():
    """A JAX-written run's MFU is quoted against that package's peak; the
    same stream under a port manifest against the H100's."""
    s = report.summarize(JAX_FX)
    assert s["mfu"] == jreport.summarize(JAX_FX)["mfu"]
    manifest = json.loads((JAX_FX / "run.json").read_text())
    assert report.mfu_peak(manifest) == flops.REFERENCE_PEAK_BF16
    manifest["versions"] = {"python": "3.12", "torch": "2", "numpy": "2", "cuda": "12"}
    assert report.mfu_peak(manifest) == flops.PEAK_BF16


def test_fixture_trace_index_and_render_equal_jax():
    roots = [JAX_FX / "fleet"]
    mine, theirs = report.trace_index(roots), jreport.trace_index(roots)
    assert mine and json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    for tid in sorted(mine)[:5]:
        assert report.render_trace(tid, mine[tid], root=roots[0]) == \
            jreport.render_trace(tid, theirs[tid], root=roots[0])
        assert report.has_terminal(mine[tid]) == jreport.has_terminal(theirs[tid])


@pytest.mark.parametrize("name,stream", [("events.jsonl", True), ("events-3.jsonl", True),
                                         ("events_tail.jsonl", False),
                                         ("events-x.jsonl", False), ("chunk-1.jsonl", False)])
def test_is_stream_file(name, stream):
    assert report.is_stream_file(Path(name)) is stream is jreport.is_stream_file(Path(name))


@pytest.mark.parametrize("line", ['{"v": 1, "t": 1, "type": "span", "name": "x", "dur": 1}',
                                  '{"v": 2, "t": 1, "type": "event", "name": "x"}',
                                  '{"v": 1, "t": 1, "type": "blob"}', '[1]', "not json",
                                  '{"v": 1, "type": "event", "name": "x"}'])
def test_parse_event_refuses_as_jax(line):
    with pytest.raises(report.SchemaError) as mine:
        report.parse_event(line, 3)
    with pytest.raises(jreport.SchemaError) as theirs:
        jreport.parse_event(line, 3)
    assert str(mine.value) == str(theirs.value)


def test_torn_stream_tail_is_dropped_as_jax_drops_it(tmp_path, capsys):
    run = tmp_path / "run"
    shutil.copytree(JAX_FX, run, ignore=shutil.ignore_patterns("history", "fleet",
                                                               "timeline", "explain"))
    text = (run / "events.jsonl").read_text()
    (run / "events.jsonl").write_text(text + text.splitlines()[-1][:17])
    mine, theirs = report.load_events(run), jreport.load_events(run)
    assert mine == theirs and len(mine) == len(text.splitlines())
    assert "dropped torn final line" in capsys.readouterr().err
    with pytest.raises(report.SchemaError):
        report.load_events(run, strict=True)
    with pytest.raises(jreport.SchemaError):
        jreport.load_events(run, strict=True)


# ---------------------------------------------------- streams of the port
@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A 3-epoch ``GanTrainer`` (the flagship family, tiny widths) under an
    obs session on the CPU."""
    run = tmp_path_factory.mktemp("gan") / "run"
    torch.set_num_threads(1)
    cfg = ExperimentConfig(
        model=ModelConfig(family="mtss_wgan_gp", hidden=8, window=6, features=5),
        train=TrainConfig(batch_size=4, n_critic=2, steps_per_call=1, seed=3))
    windows = torch.from_numpy(
        np.random.default_rng(7).uniform(0, 1, (32, 6, 5)).astype(np.float32))
    with obs_pkg.session(run):
        tr = GanTrainer(cfg, windows, device="cpu",
                        logger=MetricLogger(echo=False, echo_style="wgan_gp"))
        tr.train(epochs=3)
    obs_pkg.disable()
    return run


@pytest.fixture(scope="module")
def served_run(tmp_path_factory):
    """A small serve drive on the CPU under an obs session, every request
    with a trace ID."""
    run = tmp_path_factory.mktemp("serve") / "run"
    torch.set_num_threads(1)
    cfg = ServeConfig(max_batch=4, batch_window_ms=3.0, request_timeout_ms=30000.0,
                      max_queue=64, workers=1, row_buckets=(32, 64))
    with obs_pkg.session(run, command="t"):
        server = fixture_server(cfg, preset=None, device="cpu",
                                ae_model=fixture_ae_model(feats=8, device="cpu"))
        panels = make_panels(11, 8, (16, 24), variants=4)
        warm_server(server, panels)
        drive_load(server, 12, panels, timeout_ms=30000.0, trace_prefix="tt-", wave=5)
        server.stop()
    obs_pkg.disable()
    return run


def test_port_train_summary_equals_jax_apart_from_mfu(trained_run):
    mine, theirs = report.summarize(trained_run), jreport.summarize(trained_run)
    assert _without(mine, "mfu") == _without(theirs, "mfu")
    assert mine["backend"] == "cpu" and mine["blocks"]["n"] >= 2
    assert mine["steps_per_sec"] > 0 and mine["compile_secs"] is not None
    # the port's own run: the H100's peak, JAX's arithmetic otherwise
    assert mine["mfu"] == flops.mfu(mine["steps_per_sec"], 6, 5, 8, 4)
    assert mine["mfu"] == pytest.approx(theirs["mfu"] * 197e12 / flops.PEAK_BF16, rel=1e-12)
    assert report.render(_without(mine, "mfu") | {"mfu": 0.5}) == \
        jreport.render(_without(theirs, "mfu") | {"mfu": 0.5})


def test_port_train_history_record_equals_jax(trained_run):
    from hfrep_tpu.obs import history as jhistory
    from hfrep_tpu_torch.obs import history
    mine, theirs = history.summarize_run(trained_run), jhistory.summarize_run(trained_run)
    assert mine["key"] == theirs["key"] and mine["key"]["backend"] == "cpu"
    assert _without(mine, "metrics") == _without(theirs, "metrics")
    assert _without(mine["metrics"], "mfu") == _without(theirs["metrics"], "mfu")
    s = report.summarize(trained_run)
    assert history.record_from_summary(s, json.loads((trained_run / "run.json").read_text())) \
        == jhistory.record_from_summary(s, json.loads((trained_run / "run.json").read_text()))


def test_port_serve_trace_index_equals_jax(served_run):
    mine, theirs = report.trace_index([served_run]), jreport.trace_index([served_run])
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    admitted = [t for t, recs in mine.items()
                if any(r.get("name") == "serve_admit" for r in recs)]
    assert len(admitted) >= 12 and all(report.has_terminal(mine[t]) for t in admitted)
    one = report.trace_events([served_run], "tt-000003")
    names = [r.get("name") for r in one]
    assert names.index("serve_admit") < names.index("serve_dispatch") < \
        names.index("serve_complete")
    assert report.render_trace("tt-000003", one) == jreport.render_trace("tt-000003", one)


def test_port_serve_summary_equals_jax(served_run):
    mine, theirs = report.summarize(served_run), jreport.summarize(served_run)
    assert json.dumps(mine, default=str) == json.dumps(theirs, default=str)


def test_report_cli_on_port_runs_equals_jax(trained_run, served_run):
    for args in (("report", served_run), ("report", "--trace", "tt-000003", served_run),
                 ("report", "--format", "json", "--trace", "tt-000005", served_run),
                 ("timeline", "--format", "json", trained_run)):
        mine, theirs = _cli("hfrep_tpu_torch.obs", *args), _cli("hfrep_tpu.obs", *args)
        assert (mine.returncode, mine.stdout) == (theirs.returncode, theirs.stdout), args


# -------------------------------------------------------------------- CLI
CLI_CASES = [
    ("report", "--self-test"),
    ("gate", "--self-test"),
    ("timeline", "--self-test"),
    ("report", "{fx}"),
    ("report", "--format", "json", "{fx}/history/run_b"),
    ("report", "{fx}/history/run_a", "{fx}/history/regressed"),
    ("report", "--format", "json", "{fx}/history/run_a", "{fx}/history/run_c"),
    ("report", "--merge", "{fx}/history/multihost"),
    ("report", "--merge", "--format", "json", "{fx}/history/multihost"),
    ("report", "--trace", "t-nope", "{fx}/fleet"),
    ("report",),
    ("report", "{fx}/missing_dir"),
    ("gate", "{fx}/history/run_d", "--history", "{fx}/history/history.jsonl"),
    ("gate", "{fx}/history/regressed", "--history", "{fx}/history/history.jsonl"),
    ("gate", "{fx}/history/regressed", "--history", "{fx}/history/history.jsonl",
     "--format", "json"),
    ("gate", "{fx}/history/run_d", "--history", "{fx}/history/history.jsonl",
     "--threshold", "steps_per_sec=0.001", "--format", "json"),
    ("gate", "{fx}/history/run_d", "--history", "{fx}/history/history.jsonl",
     "--window", "2", "--min-runs", "2"),
    ("gate", "{fx}/history/multihost", "--merge", "--history", "{fx}/history/history.jsonl"),
    ("gate", "{fx}/history/run_d"),
    ("gate",),
    ("gate", "{fx}/history/run_d", "--history", "{fx}/history/history.jsonl",
     "--threshold", "bad"),
    ("timeline", "{fx}/timeline"),
    ("timeline", "--format", "json", "{fx}/timeline"),
    ("timeline",),
]


@pytest.mark.parametrize("args", CLI_CASES, ids=lambda a: " ".join(a)[:60])
def test_cli_equals_jax(args):
    argv = [a.format(fx=JAX_FX) for a in args]
    mine, theirs = _cli("hfrep_tpu_torch.obs", *argv), _cli("hfrep_tpu.obs", *argv)
    assert mine.returncode == theirs.returncode, (mine.stderr, theirs.stderr)
    assert mine.stdout == theirs.stdout


def test_cli_timeline_trace_out_equals_jax(tmp_path):
    mine = _cli("hfrep_tpu_torch.obs", "timeline", JAX_FX / "timeline", "-o", tmp_path / "p.json")
    theirs = _cli("hfrep_tpu.obs", "timeline", JAX_FX / "timeline", "-o", tmp_path / "j.json")
    assert (mine.returncode, mine.stdout) == (theirs.returncode, theirs.stdout)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_cli_ingest_and_compact_equal_jax(tmp_path):
    for pkg in ("hfrep_tpu_torch.obs", "hfrep_tpu.obs"):
        d = tmp_path / pkg
        shutil.copytree(JAX_FX / "history", d / "history")
        out = _cli(pkg, "ingest", d / "history" / "run_c", "--history", d / "h.jsonl")
        assert out.returncode == 0
        again = _cli(pkg, "ingest", d / "history" / "run_c", "--history", d / "h.jsonl")
        assert not json.loads(again.stdout)["ingested"]
        merged = _cli(pkg, "ingest", d / "history" / "multihost", "--merge",
                      "--history", d / "h.jsonl")
        assert json.loads(merged.stdout)["hosts"] == 2
        comp = _cli(pkg, "compact", d / "history" / "run_d", "--force-rotate",
                    "--format", "json")
        assert comp.returncode == 0
    a, b = (tmp_path / "hfrep_tpu_torch.obs"), (tmp_path / "hfrep_tpu.obs")
    la = [_without(json.loads(x), "ingested_unix", "run_dir")
          for x in (a / "h.jsonl").read_text().splitlines()]
    lb = [_without(json.loads(x), "ingested_unix", "run_dir")
          for x in (b / "h.jsonl").read_text().splitlines()]
    assert la == lb and len(la) == 2
    for rel in ("rollup/state.json", "rollup/compact.json", "rollup/pinned-1.jsonl"):
        assert (a / "history" / "run_d" / rel).read_bytes() == \
            (b / "history" / "run_d" / rel).read_bytes(), rel


@pytest.mark.parametrize("args", [("explain", "a", "b"), ("profile", "a"), ("crash-drill",),
                                  ("report", "--crash", "a"),
                                  ("gate", "a", "--history", "h", "--explain")],
                         ids=lambda a: " ".join(a))
def test_deferred_subcommands_are_refused(args):
    """The verbs the first part of the tier deferred now parse as the JAX
    CLI parses them (``crash-drill`` with the port's ``--device``), and a
    missing run dir is refused by the verb itself, never by argparse."""
    ns = report.build_parser().parse_args(list(args))
    theirs = jreport.build_parser().parse_args(list(args))
    mine = {k: v for k, v in vars(ns).items() if k != "device"}
    assert mine == vars(theirs)
    if args[0] == "crash-drill":
        assert ns.device == "cuda"
        return
    proc = _cli("hfrep_tpu_torch.obs", *args)
    assert "invalid choice" not in proc.stderr and "unrecognized arguments" not in proc.stderr
    assert proc.returncode == _cli("hfrep_tpu.obs", *args).returncode


def test_self_tests_in_process(capsys):
    assert report.self_test() == 0
    assert report.gate_self_test() == 0
    assert timeline.self_test() == 0
    out = capsys.readouterr().out
    assert "obs self-test OK" in out and '"compaction_byte_identical": true' in out


def test_tier_imports_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import hfrep_tpu_torch.obs.report, hfrep_tpu_torch.obs.rollup\n"
            "import hfrep_tpu_torch.obs.history, hfrep_tpu_torch.obs.regress\n"
            "import hfrep_tpu_torch.obs.tail, hfrep_tpu_torch.obs.fleet\n"
            "import hfrep_tpu_torch.obs.slo, hfrep_tpu_torch.obs.__main__\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'hfrep_tpu' or m.startswith('hfrep_tpu.')]\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    # nor does the CLI's whole run of a report
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, runpy; sys.argv = ['x', 'report', sys.argv[1]]\n"
         "try:\n    runpy.run_module('hfrep_tpu_torch.obs', run_name='__main__')\n"
         "except SystemExit:\n    pass\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hfrep_tpu')))",
         str(JAX_FX)], cwd=REPO_ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
