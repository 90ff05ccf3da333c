"""``python -m hfrep_tpu_torch.resilience selftest --device cpu``: the
kill→resume gate of ``hfrep_tpu_torch/resilience/selftest.py`` at the JAX
package's fixture shapes, in a subprocess with its own timeout, holding
the keys and bounds ``tests/test_resilience.py::
test_resilience_selftest_smoke`` holds the JAX package's selftest to.
Every resume is compared bit for bit inside the selftest."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]


def test_resilience_selftest_on_the_cpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_FAULTS")}
    env.update(PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "hfrep_tpu_torch.resilience", "selftest",
                           "--device", "cpu"], cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["selftest"] == "ok" and doc["device"] == "cpu"
    assert doc["checkpoint_cycle"] == "ok"
    assert doc["lanes21"] == "ok" and doc["multi"] == "ok"
    assert doc["lanes21_lanes"] == 21 and doc["multi_lanes"] == 6
    assert doc["ensemble_kill"] == "ok" and doc["ensemble_drain"] == "ok"
    assert doc["ensemble_kill_restarts"] >= 1 and doc["ensemble_kill_traces"] == "ok"
    assert doc["serving_chaos"] == "ok" and doc["serving_drain"] == "ok"
    assert doc["serving_worker_kills"] >= 1
    assert doc["serving_deadline_misses"] >= 1
    assert doc["serving_breaker_trips"] >= 1
