"""The port's live and fleet views (``hfrep_tpu_torch/obs/{tail,fleet,slo}.py``)
against the JAX package's, on the CPU: the fleet fixture's rolled-up
states, invariants and federated exposition; the SLO burn rates, their
rendering, the ``slo`` and ``gate --slo`` verbs; the tail aggregate, its
frame and its Prometheus snapshot; each equal to the JAX module's."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from hfrep_tpu.obs import fleet as jfleet
from hfrep_tpu.obs import slo as jslo
from hfrep_tpu.obs import tail as jtail
from hfrep_tpu_torch.obs import fleet, regress, rollup, slo, tail

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_FX = REPO_ROOT / "hfrep_tpu" / "obs" / "_fixture"
FLEET_FX = JAX_FX / "fleet"


def _cli(pkg: str, *args):
    env = {k: v for k, v in os.environ.items()
           if k not in ("HFREP_OBS_DIR", "HFREP_HISTORY", "HFREP_FAULTS",
                        "HFREP_OBS_ROTATE_BYTES")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO_ROOT)
    return subprocess.run([sys.executable, "-m", pkg, *map(str, args)], cwd=REPO_ROOT,
                          capture_output=True, text=True, env=env)


def _both(*args):
    return _cli("hfrep_tpu_torch.obs", *args), _cli("hfrep_tpu.obs", *args)


# ------------------------------------------------------------------ fleet
@pytest.mark.parametrize("bucket", [60.0, 5.0, 1.0])
def test_fleet_states_and_invariants_equal_jax(bucket):
    mine = fleet.fleet_states(FLEET_FX, bucket_secs=bucket)
    theirs = jfleet.fleet_states(FLEET_FX, bucket_secs=bucket)
    assert json.dumps(mine) == json.dumps(theirs)
    inv = fleet.invariants(mine)
    assert inv == jfleet.invariants(theirs)
    assert inv["ledger"]["deficit"] == 2 and inv["ledger"]["bad_replicas"] == ["replica_b"]
    assert fleet.prometheus_text(mine, inv) == jfleet.prometheus_text(theirs)
    assert not list(FLEET_FX.rglob("rollup"))                   # read-only fold


def test_discover_and_labels_equal_jax(tmp_path):
    assert fleet.discover(FLEET_FX) == jfleet.discover(FLEET_FX)
    assert fleet.discover(FLEET_FX / "replica_a") == [FLEET_FX / "replica_a"]
    for d in fleet.discover(FLEET_FX):
        assert fleet.replica_label(FLEET_FX, d) == jfleet.replica_label(FLEET_FX, d)
    assert fleet.replica_label(tmp_path, FLEET_FX) == "fleet"
    assert fleet.fleet_json(FLEET_FX) == jfleet.fleet_json(FLEET_FX)


@pytest.mark.parametrize("times,n,window,storm", [
    ([1.0, 2.0, 3.0], 3, 60.0, True), ([1.0, 100.0, 300.0], 3, 60.0, False),
    ([], 3, 60.0, False), ([5.0, 1.0, 200.0, 230.0, 250.0], 3, 60.0, True),
    ([1.0, 2.0], 3, 60.0, False), ([0.0, 10.0, 20.0, 30.0], 4, 29.0, False)])
def test_restart_storm_rule_equals_jax(times, n, window, storm):
    assert fleet._storm(times, n, window) is storm is jfleet._storm(times, n, window)


def test_storms_breakers_and_pending_in_invariants():
    def state(**facts):
        st = rollup._new_state(60.0)
        st["facts"].update(facts)
        return st
    states = {
        "a": state(restarts={"n": 4, "t": [1.0, 2.0, 3.0, 4.0], "actors": {"x": 4}}),
        "b": state(breaker={"opens": 2, "closes": 1, "state": "open", "last_t": 3.0,
                            "last_reason": "faults"}),
        "c": state(serve_drain={"t": 1.0, "submitted": 5, "terminal": 5}),
    }
    mine, theirs = fleet.invariants(states), jfleet.invariants(states)
    assert mine == theirs
    assert mine["restarts"]["storms"] == ["a"] and mine["breakers"]["open"] == 1
    assert mine["ledger"]["pending"] == 1 and not mine["ok"]


def test_export_fleet_cli_equals_jax(tmp_path):
    mine, theirs = _both("export", "--fleet", FLEET_FX)
    assert (mine.returncode, mine.stdout) == (theirs.returncode, theirs.stdout) == \
        (0, theirs.stdout)
    assert "hfrep_fleet_ledger_deficit 2" in mine.stdout
    assert 'replica="replica_b"' in mine.stdout
    outs = []
    for pkg in ("hfrep_tpu_torch.obs", "hfrep_tpu.obs"):
        root = tmp_path / pkg
        shutil.copytree(FLEET_FX, root)
        proc = _cli(pkg, "export", "--fleet", root, "--watch", "2", "--interval", "0.05",
                    "-o", root / "fleet.prom")
        assert proc.returncode == 0
        outs.append(((root / "fleet.prom").read_text(),
                     [(d / "rollup" / "state.json").read_bytes()
                      for d in sorted(root.iterdir()) if d.is_dir()]))
    assert outs[0] == outs[1]
    assert _cli("hfrep_tpu_torch.obs", "export", "--fleet", tmp_path / "nothing").returncode == 1
    assert _both("export", "--fleet", FLEET_FX / "replica_a", FLEET_FX)[0].returncode == 2


def test_watch_narrates_fleet_gauges(tmp_path):
    import hfrep_tpu_torch.obs as obs_pkg
    root = tmp_path / "fleet"
    shutil.copytree(FLEET_FX, root)
    with obs_pkg.session(tmp_path / "w", manifest=False) as sink:
        inv = fleet.watch(root, interval=0.0, iterations=2, sink=sink)
    assert inv["ledger"]["deficit"] == 2
    from hfrep_tpu_torch.obs import report
    gauges = report.summarize(tmp_path / "w")["gauges"]
    for name in ("fleet/replicas", "fleet/ledger_deficit", "fleet/restart_storms"):
        assert name in gauges and name in regress.DEFAULT_THRESHOLDS


# -------------------------------------------------------------------- slo
@pytest.mark.parametrize("fast,slow", [(2, 5), (5, 30), (1, 1), (3, 100)])
def test_slo_evaluate_equals_jax(fast, slow):
    states = fleet.fleet_states(FLEET_FX)
    mine = slo.evaluate(states, fast_buckets=fast, slow_buckets=slow)
    theirs = jslo.evaluate(jfleet.fleet_states(FLEET_FX), fast_buckets=fast,
                           slow_buckets=slow)
    assert mine == theirs
    assert slo.render(mine) == jslo.render(theirs)


def test_slo_fixture_breaches_the_shed_rate_only():
    by = {r["name"]: r for r in slo.evaluate(fleet.fleet_states(FLEET_FX),
                                             fast_buckets=2, slow_buckets=5)["slos"]}
    assert by["serve_shed_rate"]["breach"]
    assert not by["serve_latency_p95_ms"]["breach"] and not by["serve_error_rate"]["breach"]


@pytest.mark.parametrize("body,msg", [
    ('{"name": "x"}', "must be a JSON list"), ('[1]', "must be objects"),
    ('[{"name": "x", "kind": "p95"}]', "missing"),
    ('[{"name": "x", "kind": "p99", "target": 1}]', "unknown kind"),
    ('[{"name": "x", "kind": "ratio", "target": 1}]', "needs 'bad'")])
def test_load_slos_refuses_as_jax(tmp_path, body, msg):
    path = tmp_path / "slo.json"
    path.write_text(body)
    with pytest.raises(ValueError, match=msg) as mine:
        slo.load_slos(str(path))
    with pytest.raises(ValueError) as theirs:
        jslo.load_slos(str(path))
    assert str(mine.value) == str(theirs.value)


def test_load_slos_from_root_and_defaults(tmp_path):
    assert slo.load_slos() == jslo.load_slos() == slo.DEFAULT_SLOS
    (tmp_path / "slo.json").write_text(json.dumps(
        [{"name": "p", "kind": "p95", "hist": "serve/latency_ms", "target": 1.0}]))
    assert slo.load_slos(root=str(tmp_path)) == jslo.load_slos(root=str(tmp_path))
    doc = slo.evaluate_root(tmp_path)
    assert doc["evaluated"] == 1 and doc["fleet"]["replicas"] == 0


def test_slo_gauges_have_explicit_thresholds():
    import hfrep_tpu_torch.obs as obs_pkg
    result = slo.evaluate(fleet.fleet_states(FLEET_FX), fast_buckets=2, slow_buckets=5)

    class _Sink:
        def __init__(self):
            self.names = []

        def gauge(self, name):
            self.names.append(name)
            return obs_pkg._NULL_INSTRUMENT

    sink = _Sink()
    slo.emit_gauges(sink, result)
    fleet.emit_gauges(sink, fleet.invariants(fleet.fleet_states(FLEET_FX)))
    assert sink.names and all(n in regress.DEFAULT_THRESHOLDS for n in sink.names)


SLO_CASES = [
    ("slo", "--self-test"),
    ("slo", "{fx}"),
    ("slo", "{fx}", "--format", "json", "--fast-buckets", "2", "--slow-buckets", "5"),
    ("slo", "{fx}", "--bucket-secs", "5"),
    ("slo",),
    ("gate", "--slo", "{fx}"),
    ("gate", "--slo", "{fx}", "--format", "json"),
    ("gate", "{hist}/run_d", "--history", "{hist}/history.jsonl", "--slo", "{fx}"),
    ("gate", "{hist}/run_d", "--history", "{hist}/history.jsonl", "--slo", "{fx}",
     "--format", "json"),
    ("export", "{fx}/replica_a", "{fx}/replica_b"),
    ("export", "{fx}"),
]


@pytest.mark.parametrize("args", SLO_CASES, ids=lambda a: " ".join(a)[:50])
def test_live_and_fleet_cli_equal_jax(args):
    argv = [a.format(fx=FLEET_FX, hist=JAX_FX / "history") for a in args]
    mine, theirs = _both(*argv)
    assert mine.returncode == theirs.returncode, (mine.stderr, theirs.stderr)
    assert mine.stdout == theirs.stdout


def test_slo_cli_persist_advances_cursors_as_jax(tmp_path):
    states = []
    for pkg in ("hfrep_tpu_torch.obs", "hfrep_tpu.obs"):
        root = tmp_path / pkg
        shutil.copytree(FLEET_FX, root)
        assert _cli(pkg, "slo", root, "--persist").returncode == 1
        states.append([(d / "rollup" / "state.json").read_bytes()
                       for d in sorted(root.iterdir())])
    assert states[0] == states[1]


# ------------------------------------------------------------------- tail
def _aggs(mod, roots):
    aggs = {}
    for path in mod._discover(roots):
        agg = aggs.setdefault(mod._stream_label(path, roots), mod.TailAggregate())
        for rec in mod._StreamFollower(path).poll():
            agg.consume(rec)
    return aggs


@pytest.mark.parametrize("rel", ["fleet", "fleet/replica_a", ".", "history"])
def test_tail_aggregate_frame_and_exposition_equal_jax(rel):
    roots = [JAX_FX / rel]
    mine, theirs = _aggs(tail, roots), _aggs(jtail, roots)
    assert sorted(mine) == sorted(theirs)
    for label in mine:
        assert vars(mine[label]) == vars(theirs[label])
        assert mine[label].steps_per_sec() == theirs[label].steps_per_sec()
        assert mine[label].queue_depth() == theirs[label].queue_depth()
    # the header line carries the wall clock
    assert tail.render_frame(mine).splitlines()[1:] == jtail.render_frame(theirs).splitlines()[1:]
    assert tail.prometheus_text(mine) == jtail.prometheus_text(theirs)


def test_tail_follows_rotated_chunks_and_waits_for_a_torn_tail(tmp_path):
    run = tmp_path / "run"
    shutil.copytree(FLEET_FX / "replica_a", run)
    rollup.rotate_live(run, 1, force=True)
    lines = (run / "rollup" / "chunk-1.jsonl").read_text().splitlines(keepends=True)
    (run / "events.jsonl").write_text(lines[0] + lines[1][:9])
    roots = [run]
    assert [p.name for p in tail._discover(roots)] == ["chunk-1.jsonl", "events.jsonl"]
    aggs = _aggs(tail, roots)
    assert list(aggs) == ["run"] and aggs["run"].n_records == len(lines) + 1
    assert vars(aggs["run"]) == vars(_aggs(jtail, roots)["run"])
    follower = tail._StreamFollower(run / "events.jsonl")
    assert len(follower.poll()) == 1
    with open(run / "events.jsonl", "a") as fh:
        fh.write(lines[1][9:])
    assert len(follower.poll()) == 1 and follower.poll() == []


@pytest.mark.parametrize("args", [("tail", "--once", "{fx}"), ("tail", "--once", "{fx}/replica_b",
                                                                "{fx}/replica_a")],
                         ids=lambda a: " ".join(a)[:30])
def test_tail_once_cli_equals_jax(args):
    mine, theirs = _both(*[a.format(fx=FLEET_FX) for a in args])
    assert mine.returncode == theirs.returncode == 0
    assert mine.stdout.splitlines()[1:] == theirs.stdout.splitlines()[1:]
    assert mine.stdout.startswith("flight recorder")


def test_export_main_writes_atomically(tmp_path, capsys):
    assert tail.export_main([FLEET_FX], out=str(tmp_path / "x.prom")) == 0
    assert (tmp_path / "x.prom").read_text() == _both("export", FLEET_FX)[0].stdout
    assert tail.export_main([tmp_path / "empty"]) == 1
    assert "no events" in capsys.readouterr().err
    assert tail.tail_main([FLEET_FX], max_frames=1, interval=0.0, out=open(os.devnull, "w")) == 0
