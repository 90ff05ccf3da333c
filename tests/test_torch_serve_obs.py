"""The port's serve telemetry and drain against the JAX package.

* Under an obs session one ``drive_load`` of N requests with a trace
  prefix yields N trace IDs; every request's events carry its trace, as
  the JAX package's own ``report.trace_events`` reads them from the
  port's stream, and the load is one ``serve_load`` ledger window.
* The event-name sets and the per-request event counts equal the JAX
  package's on the same load; ``event_log_every=k`` samples 1 in k as
  JAX does; a deadline miss emits ``serve_deadline_miss``; the breaker
  and the program cache emit theirs.
* ``drive_load``'s waves call ``on_wave`` with the running count, and a
  raise there stops the load with every offered future resolved.
* The ``serve`` verb of each package, started as a subprocess and sent
  SIGTERM after its "offering" line, drains and exits 75; the port's
  drained document has ``terminal == submitted``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import hfrep_tpu.obs as jobs
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu.obs import report as jreport
from hfrep_tpu.serve.fixture import fixture_server as jax_fixture_server
from hfrep_tpu.serve.fixture import warm_server as jax_warm_server
from hfrep_tpu.serve.loadgen import drive_load as jax_drive_load
from hfrep_tpu.serve.server import ServeConfig as JaxServeConfig
from hfrep_tpu_torch.obs import timeline
from hfrep_tpu_torch.serve.admission import DeadlineExceeded
from hfrep_tpu_torch.serve.fixture import fixture_ae_model, fixture_server, warm_server
from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
from hfrep_tpu_torch.serve.server import ReplicationServer, ServeConfig

REPO_ROOT = Path(__file__).resolve().parents[1]
FEATS = 8
CFG = dict(max_batch=4, batch_window_ms=3.0, request_timeout_ms=30000.0, max_queue=64,
           workers=1, row_buckets=(32, 64), compile_storm=64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _records(run_dir):
    return [json.loads(line) for line in (run_dir / "events.jsonl").read_text().splitlines()
            if line]


def _serve_events(recs):
    return [r for r in recs if r.get("type") == "event"
            and str(r.get("name", "")).startswith("serve_")]


def _port_load(run, n, **cfg):
    with obs_pkg.session(run, command="t"):
        server = fixture_server(ServeConfig(**{**CFG, **cfg}), preset=None, device="cpu",
                                ae_model=fixture_ae_model(feats=FEATS, device="cpu"))
        panels = make_panels(11, FEATS, (16, 24), variants=4)
        warm_server(server, panels)
        rep = drive_load(server, n, panels, timeout_ms=30000.0, trace_prefix="tt-", wave=5)
        server.stop()
    return rep


def _jax_load(run, n, **cfg):
    with jobs.session(run, command="t"):
        server = jax_fixture_server(JaxServeConfig(**{**CFG, **cfg}), feats=FEATS)
        panels = make_panels(11, FEATS, (16, 24), variants=4)
        jax_warm_server(server, panels)
        rep = jax_drive_load(server, n, panels, timeout_ms=30000.0, trace_prefix="tt-",
                             wave=5)
        server.stop()
    return rep


@pytest.fixture(scope="module")
def loads(tmp_path_factory):
    """The same traced load of 24 requests on each package's fixture server."""
    root = tmp_path_factory.mktemp("serve_obs")
    return (root / "port", _port_load(root / "port", 24),
            root / "jax", _jax_load(root / "jax", 24))


def test_every_request_carries_its_trace(loads):
    run, rep, _, _ = loads
    assert rep["submitted"] == rep["terminal"] == rep["results"] == 24
    assert rep["trace_ids"] == [f"tt-{j:06d}" for j in range(24)]
    for tid in rep["trace_ids"]:
        recs = jreport.trace_events([run], tid)
        names = [r.get("name") for r in recs]
        assert jreport.has_terminal(recs), tid
        assert names.count("serve_admit") == 1 and "serve_dispatch" in names
        (comp,) = [r for r in recs if r.get("name") == "serve_complete"]
        assert comp["trace"] == tid and comp["queue_ms"] is not None


def test_one_serve_load_window(loads):
    run, _, _, _ = loads
    windows = [r for r in timeline.load_events(run) if r.get("name") == "timeline_window"
               and r.get("drive") == "serve_load"]
    assert len(windows) == 1 and windows[0]["steps"] == 24


def test_event_names_and_counts_match_jax(loads):
    run, _, jrun, _ = loads
    mine, theirs = _serve_events(_records(run)), _serve_events(_records(jrun))
    assert {r["name"] for r in mine} == {r["name"] for r in theirs}

    def per_trace(recs):
        out = Counter()
        for r in recs:
            for t in ([r["trace"]] if "trace" in r else r.get("traces", [])):
                if t.startswith("tt-"):
                    out[(t, r["name"])] += 1
        return out

    assert per_trace(mine) and per_trace(mine) == per_trace(theirs)
    names = {r.get("name") for r in _records(run) if r.get("kind") == "counter"}
    assert "serve/compiles" in names


def test_event_log_every_samples_one_in_k(tmp_path):
    rep = _port_load(tmp_path / "port", 12, event_log_every=3)
    jrep = _jax_load(tmp_path / "jax", 12, event_log_every=3)
    assert rep["terminal"] == jrep["terminal"] == 12

    def admits(run):
        return sorted(r["request"] for r in _serve_events(_records(run))
                      if r["name"] == "serve_admit")

    got = admits(tmp_path / "port")
    assert got == admits(tmp_path / "jax")
    assert got and all(int(r[1:]) % 3 == 0 for r in got)


def test_deadline_miss_emits_its_event(tmp_path):
    with obs_pkg.session(tmp_path / "run", command="t"):
        server = ReplicationServer(
            ServeConfig(**{**CFG, "batch_window_ms": 200.0}),
            ae_model=fixture_ae_model(feats=FEATS, device="cpu")).start()
        fut = server.replicate(np.zeros((16, FEATS), np.float32), timeout_ms=1.0,
                               trace_id="late")
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        server.stop()
    misses = [r for r in _serve_events(_records(tmp_path / "run"))
              if r["name"] == "serve_deadline_miss"]
    assert len(misses) == 1 and misses[0]["trace"] == "late"
    assert server.outcomes.deadline_missed == 1


def test_breaker_and_cache_events(tmp_path):
    with obs_pkg.session(tmp_path / "run", command="t"):
        server = ReplicationServer(ServeConfig(**{**CFG, "cache_capacity": 1}),
                                   ae_model=fixture_ae_model(feats=FEATS, device="cpu"))
        server._replicate_program(1, 32)
        server._replicate_program(2, 32)        # evicts the first
        server.breaker.record_failure()
        for _ in range(server.cfg.breaker_failures):
            server.breaker.record_failure()
        server.breaker.record_success()
    names = [r["name"] for r in _serve_events(_records(tmp_path / "run"))]
    assert "serve_evict" in names
    assert "serve_breaker_open" in names and "serve_breaker_close" in names


def test_waves_call_on_wave_and_a_raise_stops_the_load():
    server = fixture_server(ServeConfig(**CFG), preset=None, device="cpu",
                            ae_model=fixture_ae_model(feats=FEATS, device="cpu"))
    panels = make_panels(11, FEATS, (16,), variants=2)
    seen = []

    class Stop(Exception):
        pass

    def on_wave(done):
        seen.append(done)
        if done >= 10:
            raise Stop

    try:
        with pytest.raises(Stop):
            drive_load(server, 23, panels, timeout_ms=30000.0, wave=5, on_wave=on_wave)
        assert seen == [5, 10]
        ledger = server.outcomes.as_dict()
        assert ledger["submitted"] == ledger["terminal"] == 10
        seen.clear()
        rep = drive_load(server, 12, panels, timeout_ms=30000.0, wave=5,
                         on_wave=seen.append)
        assert seen == [5, 10, 12] and rep["terminal"] == 12
    finally:
        server.stop()


# ------------------------------------------------------------- the drain
def _sigterm_serve(module, extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO_ROOT))
    env.pop("HFREP_FAULTS", None)
    env.pop("HFREP_OBS_DIR", None)
    p = subprocess.Popen([sys.executable, "-m", module, "serve", "--requests", "6000",
                          "--max-queue", "100000", "--timeout-ms", "600000"] + extra,
        cwd=str(REPO_ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    err = []
    try:
        for line in p.stderr:
            err.append(line)
            if "offering" in line:
                p.send_signal(signal.SIGTERM)
                break
        out, rest = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
    return p.returncode, out, "".join(err) + rest


@pytest.mark.parametrize("pkg", ["hfrep_tpu_torch", "hfrep_tpu"])
def test_sigterm_drains_serve_into_exit_75(pkg):
    rc, out, err = (_sigterm_serve(pkg, ["--device", "cpu"]) if pkg == "hfrep_tpu_torch"
                    else _sigterm_serve("hfrep_tpu.experiments.cli", []))
    assert rc == 75, (rc, err[-2000:])
    doc = json.loads(out[out.index("{"):out.rindex("}") + 1])
    drained = doc["drained"]
    assert drained["reason"] == "SIGTERM" and drained["flushed"]
    assert drained["terminal"] == drained["submitted"] > 0
