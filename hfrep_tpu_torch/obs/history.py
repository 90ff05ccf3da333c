"""Run-history store: obs run dirs -> a compact append-only ``history.jsonl``
(``hfrep_tpu/obs/history.py``).

The report CLI answers "what did THIS run do" and can diff two dirs by
hand; this module is the memory of past runs:

* :func:`ingest` summarizes one run directory (``run.json`` +
  ``events.jsonl``, torn tails tolerated — crashed runs are exactly the
  ones worth remembering) into ONE index line and appends it to a
  history file;
* :func:`ingest_multihost` first folds the per-process run dirs a
  multi-host launch writes (``<dir>/proc0``, ``proc1``, ...) into one
  logical run (:func:`merge_run_dirs`) and ingests that;
* :func:`load_history` reads the index back, with the same torn-final-
  line tolerance as the event stream (the history file is itself an
  append-only JSONL a killed CI job may tear).

Each line is schema v2 (:data:`HISTORY_SCHEMA_VERSION`) and carries a
**comparability key** — ``(family, shape, mesh, host, backend)`` — so
the regression engine (:mod:`hfrep_tpu_torch.obs.regress`) only ever
baselines a run against runs of the same program shape on the same
hardware; a CPU run can never drag down a card's baseline (the port's
manifests name the backend ``cuda`` or ``cpu``), and a window=168
production-shape run can never blend into a window=48 headline series
(the two differ ~3.5x in steps/sec by design, not by regression).
Per-metric series over that key are what "keyed by (metric, family,
mesh, host)" means — one line per run, one series per metric within it.

Everything here is stdlib-only (no torch import): ingestion runs on
hosts where initializing a backend is either slow or wrong.  The key and
the record are the JAX module's, field for field.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from hfrep_tpu_torch.obs.report import SchemaError, load_jsonl, summarize

HISTORY_SCHEMA_VERSION = 2

#: the summary fields every history record carries (the regression
#: engine's default metric universe; ``None`` where a run lacks one)
METRIC_FIELDS = (
    "steps_per_sec",
    "step_time_p50_s",
    "step_time_p95_s",
    "mfu",
    "memory_high_water_bytes",
    "backend_compiles",
    "compile_secs",
)

#: gauge-name prefixes whose values ride into the record verbatim — the
#: bench probes' ``bench/<name>`` emissions, the serving layer's
#: ``serve/<name>`` gauges, the scenario factory's ``scenario/<name>``
#: gauges, the flight recorder's ``health/<name>`` gauges and the perf
#: microscope's ``attrib/<name>`` dispatch/compute splits become
#: first-class history metrics without the store having to know each
#: probe's vocabulary
GAUGE_PREFIXES = ("bench/", "serve/", "scenario/", "health/", "attrib/",
                  "chaos/", "fleet/", "slo/", "timeline/", "drive/")
BENCH_GAUGE_PREFIX = "bench/"          # back-compat alias

#: deadline-class ladder for the serve shape signature: a 10ms-deadline
#: series and a 1s-deadline series measure different regimes (shed-bound
#: vs batch-bound) and must never share a baseline
_DEADLINE_CLASSES = (10, 25, 50, 100, 250, 500, 1000)


def _num(v) -> Optional[float]:
    """JSON-safe numeric or None (nan/inf collapse to None: a metric the
    run could not measure is absent, not a poisoned baseline sample)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    if v != v or v in (float("inf"), float("-inf")):
        return None
    return v


def _deadline_class(ms) -> str:
    """``deadline_ms`` → its ladder class (``d100`` = the 50–100ms
    band; ``dinf`` beyond the ladder)."""
    v = _num(ms)
    if v is None:
        return "d?"
    for bound in _DEADLINE_CLASSES:
        if v <= bound:
            return f"d{bound}"
    return "dinf"


def _shape_sig(cfg: dict) -> Optional[str]:
    """Compact program-shape signature from the annotated config —
    ``w48f35h100b32`` for the headline bench shape.  Family alone is not
    a shape: a window=168 production run and a window=48 headline run of
    the same family differ ~3.5x in steps/sec by construction, and
    blending their series would bake a baseline no shape ever ran.
    Runs that never annotated a config (manual ``enable()`` callers)
    yield None and compare only with other shapeless runs.

    Serve runs get their OWN signature — ``svb<max_batch><deadline
    class>`` from the annotated ``serve`` section (batch bucket ×
    deadline class, e.g. ``svb8d250``) — so a serving run's latency/QPS
    series can never blend into a training run's steps/sec series even
    when both annotate the same model family.

    Scenario runs likewise — ``scnf<funds>m<months>w<windows>l<latents>``
    from the annotated ``scenario`` section (the svb pattern): a
    walk-forward/universe drive's windows-per-sec series must never
    blend into a GAN training steps/sec series, and two universe sizes
    are different workloads by construction."""
    scenario = cfg.get("scenario") or {}
    if scenario:
        return "scnf{}m{}w{}l{}".format(
            scenario.get("funds", "?"), scenario.get("months", "?"),
            scenario.get("windows", "?"), scenario.get("latents", "?"))
    serve = cfg.get("serve") or {}
    if serve:
        return "svb{}{}".format(serve.get("max_batch", "?"),
                                _deadline_class(serve.get("deadline_ms")))
    model = cfg.get("model") or {}
    train = cfg.get("train") or {}
    parts = (model.get("window"), model.get("features"),
             model.get("hidden"), train.get("batch_size"))
    if all(p is None for p in parts):
        return None
    return "w{}f{}h{}b{}".format(*("?" if p is None else p for p in parts))


def run_key(manifest: dict) -> Dict[str, object]:
    """The comparability key of a run: only runs with an identical key
    share a baseline series.  ``shape`` is the program-shape signature
    (:func:`_shape_sig`); ``mesh`` is the trainer-annotated mesh shape
    dict (None for single-device runs), so a dp=8 pod run and a laptop
    run index different series even on equal family and shape."""
    cfg = manifest.get("config") or {}
    model = cfg.get("model") or {}
    return {
        "family": model.get("family"),
        "shape": _shape_sig(cfg),
        "mesh": manifest.get("mesh"),
        "host": (manifest.get("host") or {}).get("hostname"),
        "backend": (manifest.get("devices") or {}).get("backend"),
    }


def record_from_summary(summary: dict, manifest: dict, *,
                        hosts: int = 1) -> dict:
    """One history line from a (summary, manifest) pair — the pure core
    shared by single-host and merged multi-host ingestion."""
    metrics = {k: _num(summary.get(k)) for k in METRIC_FIELDS}
    if not metrics.get("memory_high_water_bytes"):
        # the summary reports 0 when a run emitted no memory events at
        # all; a literal zero-byte "baseline" would flag every later
        # real measurement as a regression — absent, not zero
        metrics["memory_high_water_bytes"] = None
    for name, value in (summary.get("gauges") or {}).items():
        if str(name).startswith(GAUGE_PREFIXES):
            metrics[str(name)] = _num(value)
    return {
        "v": HISTORY_SCHEMA_VERSION,
        "kind": "run",
        "run_id": summary.get("run_id"),
        "run_dir": summary.get("run_dir"),
        "created_unix": _num(manifest.get("created_unix")),
        "git_sha": (manifest.get("git") or {}).get("sha"),
        "key": run_key(manifest),
        "hosts": int(hosts),
        "steps": _num(summary.get("steps")),
        "metrics": metrics,
    }


def _read_manifest_lenient(run_dir) -> dict:
    from hfrep_tpu_torch.obs.manifest import read_manifest
    try:
        return read_manifest(run_dir)
    except (OSError, json.JSONDecodeError):
        return {}


def summarize_run(run_dir) -> dict:
    """(summary + manifest) -> one un-appended history record."""
    return record_from_summary(summarize(run_dir),
                               _read_manifest_lenient(run_dir))


# -------------------------------------------------- cross-host aggregation
def find_proc_dirs(parent_dir) -> List[Path]:
    """The per-process run dirs of a multi-host launch: every immediate
    subdirectory holding an ``events.jsonl`` (the CLI names them
    ``proc<i>``, but the shape — not the name — is the contract)."""
    parent = Path(parent_dir)
    return sorted(d for d in parent.iterdir()
                  if d.is_dir() and (d / "events.jsonl").exists())


def _fold(values, fold) -> Optional[float]:
    nums = [v for v in values if _num(v) is not None]
    return fold(nums) if nums else None


def fold_gauges(summaries: List[dict]) -> Dict[str, float]:
    """Pod-conservative fold of the per-host gauge vectors: for each
    gauge name, **min** over hosts when higher is better (the slowest
    host is the pod's true rate — same argument as steps/sec) and
    **max** when the gauge is a cost (time, memory, divergence).
    Direction comes from the regression engine's per-metric rules
    (:func:`hfrep_tpu_torch.obs.regress._rule_for` — table entry or name-
    suffix heuristic), so the fold and the gate can never disagree
    about which way a gauge points.  Replaces the leader's-gauges
    shortcut: a ``bench/*`` gauge emitted by every
    host now baselines the pod's worst, not whichever host was proc0."""
    from hfrep_tpu_torch.obs import regress

    votes: Dict[str, List[float]] = {}
    for s in summaries:
        for name, value in (s.get("gauges") or {}).items():
            if _num(value) is not None:
                votes.setdefault(str(name), []).append(float(value))
    return {
        name: (min(vals)
               if regress._rule_for(name, None)["direction"] == "up"
               else max(vals))
        for name, vals in votes.items()}


def merge_run_dirs(parent_dir) -> dict:
    """Fold a multi-host launch's per-process run dirs into ONE logical
    run summary (same shape as :func:`hfrep_tpu_torch.obs.report.summarize`,
    plus ``hosts``/``proc_dirs``).

    Fold rules are pod-conservative — the number the merged run reports
    is the one that gates the whole pod:

    * ``steps_per_sec`` / ``mfu`` — **min** over processes (SPMD runs in
      lockstep; the slowest host is the pod's true rate, and a straggler
      should *look* like a regression, not be averaged away);
    * ``step_time_p50_s`` / ``p95`` — **max** (same argument);
    * ``memory_high_water_bytes`` — **max** (the first host to OOM kills
      every process);
    * ``backend_compiles`` / ``compile_secs`` — **sum** (each process
      compiles its own programs; total host-side compile work);
    * ``steps`` — the leader's (processes disagree only when a launch
      died asymmetrically; the leader's count is then the survivors'
      floor and a warning goes to stderr);
    * gauges — per-name pod-conservative fold over the per-host gauge
      vectors (:func:`fold_gauges`: min where higher is better, max for
      costs).

    Leader (first dir, lowest process index by sort order) supplies the
    identity fields.
    """
    dirs = find_proc_dirs(parent_dir)
    if not dirs:
        raise SchemaError(f"{parent_dir}: no per-process run dirs "
                          "(subdirectories holding events.jsonl) to merge")
    summaries = [summarize(d) for d in dirs]
    leader = summaries[0]

    steps = [s.get("steps") for s in summaries]
    if len({int(v) for v in steps if _num(v) is not None}) > 1:
        print(f"warning: {parent_dir}: processes disagree on step count "
              f"{steps} (asymmetric crash?); using the leader's",
              file=sys.stderr)

    merged = dict(leader)
    merged["run_dir"] = str(parent_dir)
    merged["run_id"] = Path(parent_dir).name
    merged["hosts"] = len(dirs)
    merged["proc_dirs"] = [str(d) for d in dirs]
    merged["n_events"] = sum(s["n_events"] for s in summaries)
    merged["blocks"] = {
        "n": sum(s["blocks"]["n"] for s in summaries),
        "steady": sum(s["blocks"]["steady"] for s in summaries),
        "warmup": sum(s["blocks"]["warmup"] for s in summaries),
    }
    for metric, fold in (("steps_per_sec", min), ("mfu", min),
                         ("step_time_p50_s", max), ("step_time_p95_s", max),
                         ("memory_high_water_bytes", max),
                         ("backend_compiles", sum), ("compile_secs", sum)):
        merged[metric] = _fold([s.get(metric) for s in summaries], fold)
    merged["gauges"] = fold_gauges(summaries)
    merged["per_host"] = {
        Path(d).name: {m: _num(s.get(m)) for m in METRIC_FIELDS}
        for d, s in zip(merged["proc_dirs"], summaries)}
    return merged


def merged_record(parent_dir) -> dict:
    """One history line for a whole multi-host launch.

    The key's ``host`` is pod-derived — ``pod<n>:<lexicographic-min
    hostname>`` over ALL processes — not the leader's hostname: a
    scheduler that places proc0 on a different node each launch would
    otherwise start a fresh series every run (every gate forever
    insufficient-history: the silent-disarm mode the sentinel exists to
    close), and a single ``proc0`` ingested without ``--merge`` (un-folded
    metrics) could collide with the pod's folded baseline."""
    dirs = find_proc_dirs(parent_dir)
    merged = merge_run_dirs(parent_dir)
    manifests = [_read_manifest_lenient(d) for d in dirs]
    record = record_from_summary(merged, manifests[0], hosts=len(dirs))
    hostnames = sorted({h for m in manifests
                        if (h := (m.get("host") or {}).get("hostname"))})
    record["key"]["host"] = (
        f"pod{len(dirs)}:{hostnames[0]}" if hostnames else None)
    return record


# --------------------------------------------------------------- the store
def parse_record(line: str, lineno: int = 0) -> Optional[dict]:
    """Parse + validate one history line; blank lines return None."""
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except json.JSONDecodeError as e:
        raise SchemaError(f"line {lineno}: not JSON ({e})") from e
    if not isinstance(rec, dict):
        raise SchemaError(f"line {lineno}: record must be an object")
    if rec.get("v") != HISTORY_SCHEMA_VERSION:
        raise SchemaError(f"line {lineno}: history schema {rec.get('v')!r}, "
                          f"expected {HISTORY_SCHEMA_VERSION}")
    for field in ("kind", "run_id", "key", "metrics"):
        if field not in rec:
            raise SchemaError(f"line {lineno}: record missing {field!r}")
    return rec


def load_history(history_path, strict: bool = False) -> List[dict]:
    """Parse + validate the history index; ``[]`` when absent.

    Same torn-final-line policy as the event stream — both go through
    :func:`hfrep_tpu_torch.obs.report.load_jsonl`, so the tail handling cannot
    silently diverge between the two append-only files: a torn final
    line is dropped with a warning (``strict=True`` — the self-test —
    raises instead); mid-file garbage or an unknown schema still raises.
    """
    path = Path(history_path)
    if not path.exists():
        return []
    return load_jsonl(path, parse_record, strict=strict,
                      torn_hint="writer was likely killed mid-append")


def _repair_torn_tail(path: Path) -> None:
    """Repair an unterminated final line before appending.  Writing
    straight after it would fuse the new record onto the fragment and
    turn recoverable tail damage into permanent MID-file garbage that
    fails every later load.  Mirror the reader's policy
    (:func:`load_history`): a fragment that parses as a complete record
    is data the reader accepts — it just gains its missing newline; one
    that does not parse is exactly what the reader would drop, so
    truncate it away."""
    try:
        size = path.stat().st_size
    except OSError:
        return
    if not size:
        return
    with open(path, "rb+") as fh:
        fh.seek(-1, 2)
        if fh.read(1) == b"\n":
            return
        fh.seek(0)
        data = fh.read()
        keep = data.rfind(b"\n") + 1       # 0 when no newline at all
        try:
            parse_record(data[keep:].decode())
        except (SchemaError, UnicodeDecodeError):
            fh.truncate(keep)
            print(f"warning: {path}: truncated torn final line before "
                  "append (writer was likely killed mid-append)",
                  file=sys.stderr)
        else:
            fh.write(b"\n")                # complete record, torn newline


def append_record(history_path, record: dict,
                  records: Optional[List[dict]] = None) -> bool:
    """Append one record; returns False (no write) when an identical
    (run_id, created_unix) pair is already indexed — re-running a CI
    ingest step must not double-count a run in its own baseline.

    ``records``: the already-loaded index, when the caller just gated
    against it (the gate paths otherwise parse the whole file twice per
    run, O(n²) over the store's life).
    """
    existing = load_history(history_path) if records is None else records
    for rec in existing:
        if (rec.get("run_id") == record.get("run_id")
                and rec.get("created_unix") == record.get("created_unix")):
            return False
    path = Path(history_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _repair_torn_tail(path)
    with open(path, "a") as fh:
        fh.write(json.dumps(record, default=str) + "\n")
    return True


def ingest(run_dir, history_path) -> dict:
    """Summarize ``run_dir`` and append it to the history index.  The
    returned record gains ``"ingested": bool`` (False = duplicate)."""
    record = summarize_run(run_dir)
    record = dict(record, ingested_unix=round(time.time(), 3))
    record["ingested"] = append_record(history_path, record)
    return record


def ingest_multihost(parent_dir, history_path) -> dict:
    """Fold a multi-host launch's per-process dirs into one logical run
    and append THAT — the pod regresses as a unit, so it baselines as
    a unit."""
    record = merged_record(parent_dir)
    record = dict(record, ingested_unix=round(time.time(), 3))
    record["ingested"] = append_record(history_path, record)
    return record


# ------------------------------------------------- bench-probe plumbing
def default_store() -> Optional[Path]:
    """The repo-committed bench history store
    (``hfrep_tpu_torch/obs/_bench_history/history.jsonl``), or None when
    this checkout does not carry one (none is committed yet: the port has
    no bench).  With it present, a bench probe gates and auto-ingests
    under ``HFREP_OBS_DIR`` alone, without ``HFREP_HISTORY`` as a second
    env var."""
    path = Path(__file__).resolve().parent / "_bench_history" / "history.jsonl"
    return path if path.exists() else None


def resolve_history(obs_dir) -> Optional[str]:
    """The history store a bench probe should gate against:
    ``$HFREP_HISTORY`` when set, else the repo-default store — but the
    default only arms when a run dir is actually being recorded (without
    ``obs_dir`` there is nothing to gate, and the probe should stay a
    plain measurement, not warn about a tripwire nobody armed)."""
    import os
    hist = os.environ.get("HFREP_HISTORY")
    if hist:
        return hist
    if not obs_dir:
        return None
    store = default_store()
    if store:
        print(f"bench: gating against repo-default history {store}",
              file=sys.stderr)
        return str(store)
    return None


def gate_and_ingest(run_dir, history_path, rc: int = 0) -> int:
    """The bench probes' shared perf-sentinel tail: gate ``run_dir``
    against the rolling baseline, ingest it on a fully clean run, and
    return the updated exit code.

    Exit-code split (the caller records ``rc``): a regression — floor or
    history — is 1; a *tooling* failure (corrupt/unreadable store) raises
    ``SystemExit(2)`` so a perf code is never recategorized, except that
    an already-failing ``rc`` outranks the tooling error."""
    from hfrep_tpu_torch.obs import regress

    try:
        record = summarize_run(run_dir)
        records = load_history(history_path)
        verdict = regress.check_run(record, records)
    except (OSError, SchemaError, ValueError) as e:
        print(f"bench: history gate unavailable ({e})", file=sys.stderr)
        raise SystemExit(rc or 2)
    print(regress.render_verdict(verdict), file=sys.stderr)
    if not verdict["ok"]:
        rc = max(rc, 1)
    if rc == 0:
        # index the record in hand (same object the gate judged) — and
        # only a fully clean run: a floor-failed or regressed run must
        # not become a baseline sample
        try:
            append_record(history_path,
                          dict(record, ingested_unix=round(time.time(), 3)),
                          records=records)
        except OSError as e:
            print(f"bench: history ingest failed ({e})", file=sys.stderr)
            raise SystemExit(2)
    return rc
