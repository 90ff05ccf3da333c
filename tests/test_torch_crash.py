"""The port's crash forensics (``hfrep_tpu_torch/obs/crash.py``) against
the JAX package's ``hfrep_tpu/obs/crash.py``, on the CPU.

* On the same exception and the same run dir (a copy each), both
  packages' bundles hold the same files, the same crash document but
  the pid-and-clock fields, the same event tail and the same redacted
  environment.
* The JAX package's ``verify_bundle`` and checkpoint ``verify`` accept a
  port bundle, and the port's accept a JAX bundle; ``report --crash``
  renders and prints the JAX CLI's JSON.
* The hooks are real: an exception escaping ``obs.session`` is bundled,
  and ``run_drive`` bundles a drain (exit 75) and a persistent storage
  failure (exit 74).
* ``crash-drill --device cpu`` exits 0; with no card the default device
  refuses to run on the CPU.

Every comparison is exact.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hfrep_tpu.obs as jobs
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu import resilience as jres
from hfrep_tpu.obs import crash as jcrash
from hfrep_tpu.utils import checkpoint as jckpt
from hfrep_tpu_torch import resilience as res
from hfrep_tpu_torch.obs import crash
from hfrep_tpu_torch.resilience import drive
from hfrep_tpu_torch.utils import checkpoint as ckpt

REPO_ROOT = Path(__file__).resolve().parents[1]
VOLATILE = ("time_unix", "pid")


@pytest.fixture(autouse=True)
def _pristine(monkeypatch):
    monkeypatch.setenv("HFREP_TEST_API_TOKEN", "s3cret")
    monkeypatch.setenv("HFREP_TEST_PLAIN", "visible")
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    res.clear_plan()
    jres.clear_plan()
    yield
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    res.clear_plan()
    jres.clear_plan()


def _fault() -> BaseException:
    try:
        raise res.Preempted(site="block", epoch=7, snapshot="/ck/ckpt_7")
    except res.Preempted as e:
        return e


class _Sink:
    """Both packages' writers take any object with ``run_dir``, ``event``
    and ``flush``: the same run dir content goes to each."""

    def __init__(self, run_dir):
        self.run_dir = run_dir

    def event(self, name, **attrs):
        with open(Path(self.run_dir) / "events.jsonl", "a") as fh:
            fh.write(json.dumps({"v": 1, "t": 1.5, "type": "event", "name": name,
                                 **attrs}) + "\n")

    def flush(self):
        pass


def _run_dir(root: Path) -> Path:
    run = root / "run_x"
    run.mkdir(parents=True)
    lines = [json.dumps({"v": 1, "t": i * 0.1, "type": "event", "name": f"e{i}"})
             for i in range(250)]
    (run / "events.jsonl").write_text("\n".join(lines) + "\n")
    (run / "events-1.jsonl").write_text(lines[0] + "\n")
    (run / "run.json").write_text(json.dumps({"run_id": "run_x", "schema_version": 2}))
    return run


def test_bundle_equals_jax_s_on_the_same_exception(tmp_path):
    exc = _fault()
    mine_run, their_run = _run_dir(tmp_path / "mine"), _run_dir(tmp_path / "theirs")
    mine = Path(crash.write_crash_bundle(_Sink(mine_run), exc))
    theirs = Path(jcrash.write_crash_bundle(_Sink(their_run), exc))
    assert mine.name == theirs.name == "crash_run_x"
    assert sorted(p.name for p in mine.iterdir()) == sorted(p.name for p in theirs.iterdir())
    a, b = (json.loads((d / "crash.json").read_text()) for d in (mine, theirs))
    assert {k: v for k, v in a.items() if k not in VOLATILE} == \
        {k: v for k, v in b.items() if k not in VOLATILE}
    assert a["type"] == "Preempted" and a["epoch"] == 7 and a["snapshot"] == "/ck/ckpt_7"
    for name in ("events_tail.jsonl", "run.json", "env.json", "traceback.txt"):
        assert (mine / name).read_text() == (theirs / name).read_text(), name
    env = json.loads((mine / "env.json").read_text())
    assert env["HFREP_TEST_API_TOKEN"] == "<redacted>" and env["HFREP_TEST_PLAIN"] == "visible"
    assert "# stream: events-1.jsonl" in (mine / "events_tail.jsonl").read_text()
    meta_a, meta_b = (json.loads((d / "meta.json").read_text()) for d in (mine, theirs))
    assert meta_a["kind"] == meta_b["kind"] == "crash_bundle"
    assert meta_a["exception"] == meta_b["exception"] == "Preempted"
    # each package verifies the other's bundle, both ways
    for bundle in (mine, theirs):
        assert crash.verify_bundle(bundle) == jcrash.verify_bundle(bundle) == []
        ckpt.verify(bundle)
        jckpt.verify(bundle)
    assert crash.find_bundle(mine_run) == mine and crash.find_bundle(mine) == mine
    text = crash.render_bundle(mine)
    assert "Preempted" in text and "context: epoch=7" in text
    # a second crash keeps the first bundle as the .prev sibling
    crash.write_crash_bundle(_Sink(mine_run), ValueError("again"))
    assert json.loads((mine / "crash.json").read_text())["type"] == "ValueError"
    assert ckpt.prev_path(mine).exists()


def test_report_crash_cli_prints_jax_s_document(tmp_path):
    run = _run_dir(tmp_path)
    crash.write_crash_bundle(_Sink(run), _fault())
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), JAX_PLATFORMS="cpu")
    out = {}
    for pkg in ("hfrep_tpu_torch.obs", "hfrep_tpu.obs"):
        for fmt in ("json", "human"):
            proc = subprocess.run([sys.executable, "-m", pkg, "report", "--crash", str(run),
                                   "--format", fmt], cwd=REPO_ROOT, capture_output=True,
                                  text=True, env=env, timeout=120)
            assert proc.returncode == 0, proc.stderr
            out[pkg, fmt] = proc.stdout
    assert json.loads(out["hfrep_tpu_torch.obs", "json"]) == \
        json.loads(out["hfrep_tpu.obs", "json"])
    assert out["hfrep_tpu_torch.obs", "human"] == out["hfrep_tpu.obs", "human"]
    proc = subprocess.run([sys.executable, "-m", "hfrep_tpu_torch.obs", "report", "--crash",
                           str(tmp_path / "nothing")], cwd=REPO_ROOT, capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 1


def test_escaped_exception_is_bundled_by_the_session(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with obs_pkg.session(tmp_path / "run"):
            1 / 0
    bundle = crash.find_bundle(tmp_path / "run")
    assert bundle is not None and crash.verify_bundle(bundle) == []
    assert json.loads((bundle / "crash.json").read_text())["type"] == "ZeroDivisionError"
    with pytest.raises(SystemExit):
        with obs_pkg.session(tmp_path / "clean"):
            raise SystemExit(0)
    assert crash.find_bundle(tmp_path / "clean") is None


@pytest.mark.parametrize("outcome,code,kind", [
    (lambda: (_ for _ in ()).throw(res.Preempted(site="chunk", epoch=2)), drive.EXIT_DRAINED,
     "Preempted"),
    (lambda: (_ for _ in ()).throw(OSError(5, "EIO")), drive.EXIT_IO, "OSError")])
def test_run_drive_bundles_drains_and_storage_failures(tmp_path, outcome, code, kind):
    spec = drive.DRIVE_REGISTRY["ae_sweep"]
    assert drive.run_drive(spec, outcome, obs_dir=str(tmp_path / "obs")) == code
    bundle = crash.find_bundle(tmp_path / "obs")
    assert bundle is not None and crash.verify_bundle(bundle) == []
    assert json.loads((bundle / "crash.json").read_text())["type"] == kind
    # telemetry off: nothing to bundle into, the exit code alone
    assert drive.run_drive(spec, outcome) == code


def test_crash_drill_on_the_cpu(capsys):
    assert crash.drill(device="cpu") == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["self_check"] == "ok" and doc["bundled_exception"] == "NumericFault"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_crash_drill_cli_defaults_to_the_card():
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    proc = subprocess.run([sys.executable, "-m", "hfrep_tpu_torch.obs", "crash-drill",
                           "--device", "cpu"], cwd=REPO_ROOT, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["self_check"] == "ok"
    proc = subprocess.run([sys.executable, "-m", "hfrep_tpu_torch.obs", "crash-drill"],
                          cwd=REPO_ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_analysis_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import hfrep_tpu_torch.obs.attrib, hfrep_tpu_torch.obs.crash\n"
            "import hfrep_tpu_torch.obs.explain, hfrep_tpu_torch.obs.__main__\n"
            "import hfrep_tpu_torch.resilience.drive_fixtures\n"
            "import hfrep_tpu_torch.resilience.chaos_subjects\n"
            "import hfrep_tpu_torch.resilience.chaos_oracles\n"
            "import hfrep_tpu_torch.resilience.chaos, hfrep_tpu_torch.resilience.selftest\n"
            "import hfrep_tpu_torch.resilience.__main__\n"
            "from hfrep_tpu_torch.resilience import drive\n"
            "for s in drive.DRIVE_REGISTRY.values():\n"
            "    s.load_fixture()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hfrep_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
