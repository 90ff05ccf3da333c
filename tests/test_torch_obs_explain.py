"""The port's ``obs explain`` (``hfrep_tpu_torch/obs/explain.py``) and the
verbs that reach it, against the JAX package's, on the CPU.

* The port's copy of the explain fixture is the JAX one's; ``diagnose``,
  ``explain_runs``, ``run_evidence`` and ``history_report`` over the JAX
  package's own fixture dirs give JAX's documents (JAX's
  ``explain_runs`` adds its static-audit notes, which the port does not
  port, so that is compared through ``diagnose``).
* ``run_evidence`` of a rotated and compacted run equals the raw
  stream's.
* Port runs with kernel-library fingerprints: two runs that loaded the
  same libraries give no ``program`` finding; a run whose one library
  digest changed gives one that names that kernel, in both packages;
  compile counts from ``backend_compiles`` rank as JAX's do.
* ``explain``, ``gate --explain`` and ``explain --history`` /
  ``--self-test`` print what the JAX CLI prints, with its exit code.

Every comparison is exact (the same stdlib arithmetic on the same
records).
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
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu.obs import explain as jexplain
from hfrep_tpu.obs import history as jhist
from hfrep_tpu_torch.obs import attrib, explain, history, rollup
from hfrep_tpu_torch.ops import _build

REPO_ROOT = Path(__file__).resolve().parents[1]
JFX = REPO_ROOT / "hfrep_tpu" / "obs" / "_fixture"
HIST = JFX / "history"


@pytest.fixture(autouse=True)
def _pristine():
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    yield
    for pkg in (obs_pkg, jobs):
        pkg.disable()


def _cli(pkg: str, *args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_FAULTS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO_ROOT)
    return subprocess.run([sys.executable, "-m", pkg, *map(str, args)], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=env, timeout=120)


# ------------------------------------------------------- the JAX fixtures
def test_port_fixture_is_jax_s():
    for rel in ("base/events.jsonl", "base/run.json", "regressed/events.jsonl",
                "regressed/run.json"):
        assert (explain.fixture_dir() / rel).read_bytes() == \
            (JFX / "explain" / rel).read_bytes()


@pytest.mark.parametrize("pair", [("base", "regressed"), ("regressed", "base"),
                                  ("base", "base")])
def test_diagnosis_of_jax_fixtures_is_jax_s(pair):
    base, target = (JFX / "explain" / p for p in pair)
    mine = explain.diagnose(explain.run_evidence(target), [explain.run_evidence(base)])
    theirs = jexplain.diagnose(jexplain.run_evidence(target), [jexplain.run_evidence(base)])
    assert mine == theirs
    assert explain.explain_runs([base], target) == mine
    assert explain.render_diagnosis(mine) == jexplain.render_diagnosis(theirs)


@pytest.mark.parametrize("run", ["explain/base", "explain/regressed", "history/run_a",
                                 "history/regressed", "timeline", "."])
def test_run_evidence_is_jax_s(run):
    # through JSON: a NaN summary value (``mfu`` of a run without steady
    # blocks) is equal to itself there
    assert json.dumps(explain.run_evidence(JFX / run), sort_keys=True) == \
        json.dumps(jexplain.run_evidence(JFX / run), sort_keys=True)


def test_history_report_and_gate_failure_are_jax_s():
    records = jhist.load_history(HIST / "history.jsonl")
    assert explain.history_report(records) == jexplain.history_report(records)
    assert explain.render_history_report(explain.history_report(records)) == \
        jexplain.render_history_report(jexplain.history_report(records))
    record = history.summarize_run(HIST / "regressed")
    mine = explain.explain_gate_failure(HIST / "regressed", record, records,
                                        history_path=HIST / "history.jsonl")
    theirs = jexplain.explain_gate_failure(HIST / "regressed", record, records,
                                           history_path=HIST / "history.jsonl")
    assert mine["findings"] == theirs["findings"] and mine["attributed"]
    assert mine["cohort"] == theirs["cohort"]
    assert explain.resolve_run_dir("hfrep_tpu/obs/_fixture/history/run_a") == \
        jexplain.resolve_run_dir("hfrep_tpu/obs/_fixture/history/run_a")


def test_compacted_run_evidence_equals_the_raw_stream_s(tmp_path):
    raw = tmp_path / "raw"
    shutil.copytree(JFX / "explain" / "regressed", raw)
    comp = tmp_path / "comp"
    shutil.copytree(raw, comp)
    rollup.compact(comp, rotate_bytes=64, force_rotate=True)
    assert not (comp / "events.jsonl").exists() or \
        (comp / "events.jsonl").stat().st_size == 0
    want, got = explain.run_evidence(raw), explain.run_evidence(comp)
    for doc in (want, got):
        doc.pop("run_dir")
        doc.pop("run_id")
        doc["summary"].pop("run_dir")
    assert got == want and got["counters"]["backend_compiles"] == 9


# ------------------------------------------ the port's kernel-library runs
def _port_run(tmp_path, monkeypatch, name: str, libs: dict, compiles: int = 0) -> Path:
    paths = {}
    for lib, data in libs.items():
        p = tmp_path / name / "lib" / f"{lib}.so"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        paths[lib] = str(p)
    monkeypatch.setattr(_build, "loaded_paths", lambda: dict(paths))
    monkeypatch.setattr(_build, "build_log", lambda n: "")
    run = tmp_path / name / "run"
    with obs_pkg.session(run):
        obs = obs_pkg.get_obs()
        if compiles:
            obs.counter("backend_compiles").inc(compiles)
        attrib.profile_boundary("compile:multi_step", flops=1e9)
        obs.record_span("compile:multi_step", 0.5, synced=True)
        for _ in range(3):
            obs.record_span("block", 0.1, steps=5, warmup=False)
    return run


LIBS = {"lstm_fwd": b"fwd-v1", "lstm_stack_fwd": b"sfwd-v1", "lstm_stack_bwd": b"sbwd-v1"}


def test_unchanged_libraries_give_no_program_finding(tmp_path, monkeypatch):
    a = _port_run(tmp_path, monkeypatch, "a", LIBS, compiles=3)
    b = _port_run(tmp_path, monkeypatch, "b", LIBS, compiles=3)
    for mod in (explain, jexplain):
        doc = mod.diagnose(mod.run_evidence(b), [mod.run_evidence(a)])
        assert not any(f["kind"] in ("program", "compile", "cost") for f in doc["findings"])


def test_an_edited_library_is_named(tmp_path, monkeypatch):
    a = _port_run(tmp_path, monkeypatch, "a", LIBS)
    b = _port_run(tmp_path, monkeypatch, "b", dict(LIBS, lstm_stack_bwd=b"sbwd-v2"),
                  compiles=9)
    mine = explain.diagnose(explain.run_evidence(b), [explain.run_evidence(a)])
    theirs = jexplain.diagnose(jexplain.run_evidence(b), [jexplain.run_evidence(a)])
    assert mine == theirs and mine["attributed"]
    named = [f["detail"]["program"] for f in mine["findings"] if f["kind"] == "program"]
    assert "compile:multi_step:lstm_stack_bwd" in named
    assert "compile:multi_step:lstm_fwd" not in named
    # a cold build cache (9 nvcc runs) against a warm cohort reads as compiles
    c = _port_run(tmp_path, monkeypatch, "c", LIBS, compiles=9)
    d = _port_run(tmp_path, monkeypatch, "d", LIBS, compiles=1)
    doc = explain.diagnose(explain.run_evidence(c), [explain.run_evidence(d)])
    assert [f["kind"] for f in doc["findings"]][:1] == ["compile"]
    assert "backend_compiles 9 vs cohort median 1" in doc["findings"][0]["summary"]


# -------------------------------------------------------------- the CLIs
CLI_CASES = [
    ("explain", str(JFX / "explain" / "base"), str(JFX / "explain" / "regressed")),
    ("explain", str(JFX / "explain" / "base"), str(JFX / "explain" / "regressed"),
     "--format", "json", "--top", "3"),
    ("explain", str(JFX / "explain" / "base")),
    ("explain", "--history", str(HIST / "history.jsonl"), "--format", "json"),
    ("explain", "--self-test"),
    ("gate", str(HIST / "regressed"), "--history", str(HIST / "history.jsonl"), "--explain"),
    ("gate", str(HIST / "regressed"), "--history", str(HIST / "history.jsonl"), "--explain",
     "--format", "json"),
    ("gate", str(HIST / "run_d"), "--history", str(HIST / "history.jsonl"), "--explain"),
]


@pytest.mark.parametrize("args", CLI_CASES, ids=lambda a: " ".join(Path(x).name for x in a))
def test_cli_prints_what_the_jax_cli_prints(args):
    mine, theirs = _cli("hfrep_tpu_torch.obs", *args), _cli("hfrep_tpu.obs", *args)
    assert mine.returncode == theirs.returncode, mine.stderr
    if "--format" in args and mine.stdout.strip():
        m, t = json.loads(mine.stdout), json.loads(theirs.stdout)
        for doc in (m, t):           # JAX's static-audit annotation is not ported
            for d in (doc, doc.get("explain") or {}):
                if isinstance(d, dict) and "notes" in d:
                    d["notes"] = [n for n in d["notes"] if not n.startswith("static audit")]
        assert m == t
    else:
        keep = lambda text: [ln for ln in text.splitlines() if "static audit" not in ln]  # noqa: E731
        assert keep(mine.stdout) == keep(theirs.stdout)
