"""``python -m hfrep_tpu_torch.obs`` — the obs CLI: report / gate / ingest
(``hfrep_tpu/obs/report.py``).

Input is what the telemetry layer writes: ``run.json`` (manifest) and
``events.jsonl`` (span / metric / memory / event stream), the JAX
package's schema v1 record for record.  The headline numbers:

* ``steps/sec`` — steady-state rate from ``block`` spans (warmup spans,
  which carry the first call's kernel build, excluded whenever steady
  ones exist);
* ``p50/p95 step time`` — steps-weighted percentiles of per-epoch time
  across block spans;
* ``MFU`` — recomputed from the manifest's model shape via
  :mod:`hfrep_tpu_torch.obs.flops` at the peak its writer quotes (the
  port's runs: the H100's; see :func:`mfu_peak`), else the run's ``mfu``
  gauge;
* ``memory high-water`` — max over ``memory`` events;
* compile accounting — the ``backend_compiles`` counter (in the port,
  the ``nvcc`` runs of ``ops/_build.py`` while telemetry was on: a warm
  build cache reads ``None``) and compile seconds (the port's
  ``compile:*`` spans: a step's first call, its kernels' build and first
  launch).

Diff mode takes two run dirs and prints both columns plus the ratio.
Stdlib-only at import (no torch), so the CLI is instant.

The other verbs read the analysis tier: ``explain`` and ``gate
--explain`` (:mod:`~hfrep_tpu_torch.obs.explain`), ``profile``
(:mod:`~hfrep_tpu_torch.obs.attrib`), ``report --crash`` and
``crash-drill`` (:mod:`~hfrep_tpu_torch.obs.crash`).
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from hfrep_tpu_torch.obs import EVENT_TYPES, SCHEMA_VERSION

EVENTS_NAME = "events.jsonl"

#: per-type required fields, beyond the common ``v``/``t``/``type``
_REQUIRED_FIELDS = {
    "span": ("name", "dur", "depth"),
    "metric": ("kind", "name", "value"),
    "memory": ("high_water",),
    "event": ("name",),
}


class SchemaError(ValueError):
    """An event line failed schema validation."""


def parse_event(line: str, lineno: int = 0) -> Optional[dict]:
    """Parse + validate one JSONL line; blank lines return None."""
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except json.JSONDecodeError as e:
        raise SchemaError(f"line {lineno}: not JSON ({e})") from e
    if not isinstance(rec, dict):
        raise SchemaError(f"line {lineno}: event must be an object")
    if rec.get("v") != SCHEMA_VERSION:
        raise SchemaError(f"line {lineno}: schema version {rec.get('v')!r}, "
                          f"expected {SCHEMA_VERSION}")
    etype = rec.get("type")
    if etype not in EVENT_TYPES:
        raise SchemaError(f"line {lineno}: unknown event type {etype!r}")
    if not isinstance(rec.get("t"), (int, float)):
        raise SchemaError(f"line {lineno}: missing/invalid timestamp 't'")
    for field in _REQUIRED_FIELDS[etype]:
        if field not in rec:
            raise SchemaError(
                f"line {lineno}: {etype} event missing {field!r}")
    return rec


def load_jsonl(path, parse_line, strict: bool = False,
               torn_hint: str = "writer was likely killed mid-write",
               ) -> List[dict]:
    """The ONE torn-tail-tolerant JSONL loader (events AND the history
    index share it, so the tail policy cannot diverge between them): a
    final line missing its newline that fails ``parse_line`` is dropped
    with a warning — appenders buffer, so a killed writer tears exactly
    there and those files must stay readable.  Anything else — garbage
    mid-file, schema drift on a complete line — still raises
    :class:`SchemaError`; ``strict=True`` raises for the torn tail too
    (the self-tests use it: committed fixtures must be whole)."""
    path = Path(path)
    records = []
    with open(path) as fh:
        lines = fh.readlines()
    for i, line in enumerate(lines, 1):
        try:
            rec = parse_line(line, i)
        except SchemaError:
            if not strict and i == len(lines) and not line.endswith("\n"):
                print(f"warning: {path}: dropped torn final line {i} "
                      f"({torn_hint})", file=sys.stderr)
                break
            raise
        if rec is not None:
            records.append(rec)
    return records


def load_events(run_dir, strict: bool = False) -> List[dict]:
    """Parse + validate this run's event records (torn-tail policy:
    :func:`load_jsonl`).  On a compacted run dir the evidence records
    that ``obs compact`` pinned verbatim (``rollup/pinned-<n>.jsonl``)
    are replayed FIRST — they predate everything in the live stream by
    construction — then any rotated-but-not-yet-compacted chunks
    (``rollup/chunk-<n>.jsonl``: earlier bytes of the SAME stream the
    writer rotated aside mid-run), then the live tail, so readers see
    the same record sequence a raw, never-rotated stream would have
    given them.  High-volume records that compaction folded to
    aggregates are NOT here; ``summarize`` re-seeds their contribution
    from ``rollup/compact.json``."""
    records: List[dict] = []
    # lazy: rollup imports this module for the shared stream discipline
    from hfrep_tpu_torch.obs import rollup as _rollup
    for pf in _rollup.pinned_files(run_dir):
        records.extend(load_jsonl(pf, parse_event, strict=strict,
                                  torn_hint="compactor was likely killed "
                                            "mid-publish"))
    for cf in _rollup.chunk_files(run_dir):
        records.extend(load_jsonl(cf, parse_event, strict=strict,
                                  torn_hint="writer was likely killed "
                                            "mid-rotation"))
    records.extend(load_jsonl(Path(run_dir) / EVENTS_NAME, parse_event,
                              strict=strict,
                              torn_hint="run was likely killed mid-write"))
    return records


# ------------------------------------------------------ trace collection
#: event names that terminate a trace — the zero-orphan contract
#: (``bench_serve --self-test``) asserts every submitted trace reaches
#: one of these
TERMINAL_TRACE_EVENTS = ("serve_complete", "serve_shed",
                         "serve_deadline_miss", "serve_degraded",
                         "serve_fault", "result_publish")


#: a live or rotated event stream — and nothing else: the crash bundle's
#: ``events_tail.jsonl`` is a COPY of stream tails, and matching it
#: would return every pre-crash hop twice on exactly the crashed run
#: dirs the flight recorder targets
_STREAM_NAME_RE = re.compile(r"^events(-\d+)?\.jsonl$")


def is_stream_file(path: Path) -> bool:
    return bool(_STREAM_NAME_RE.match(path.name))


def iter_event_files(run_dirs) -> List[Path]:
    """Every event stream under the given run dirs, recursively —
    rotated streams (``events-<n>.jsonl``) included, because a restarted
    member's pre-kill history is exactly what a cross-restart trace
    reconstruction needs; crash bundles' ``events_tail.jsonl`` copies
    excluded (they would double every pre-crash record)."""
    seen, out = set(), []
    for d in run_dirs:
        d = Path(d)
        files = ([d] if d.is_file()
                 else sorted(f for f in d.rglob("events*.jsonl")
                             if is_stream_file(f)))
        for f in files:
            if f not in seen:
                seen.add(f)
                out.append(f)
    return out


def _stream_rank(path: Path):
    """Ordering of streams within one run dir: rotated (earlier-run)
    streams sort before the live ``events.jsonl``, in rotation order."""
    name = path.name
    if name == EVENTS_NAME:
        return (1, 0)
    try:
        return (0, int(name[len("events-"):-len(".jsonl")]))
    except ValueError:
        return (0, 0)


def trace_index(run_dirs, trace_ids=None) -> Dict[str, List[dict]]:
    """Parse every stream under ``run_dirs`` ONCE and bucket the records
    by trace ID — the bulk form behind zero-orphan checks (calling
    :func:`trace_events` per ID would re-read and re-parse the whole
    run dir per trace).  ``trace_ids=None`` indexes every ID seen.

    Records match by the ``trace`` attr or by membership in a
    batch-level ``traces`` list, and come back annotated with ``_dir``/
    ``_file``/``_rotated``/``_abs`` (absolute unix time via the stream
    dir's manifest; None for rotated streams whose manifest the restart
    overwrote) and sorted into reconstruction order."""
    wanted = None if trace_ids is None else set(trace_ids)
    out: Dict[str, List[dict]] = ({} if wanted is None
                                  else {t: [] for t in wanted})
    for f in iter_event_files(run_dirs):
        try:
            recs = load_jsonl(f, parse_event)
        except (OSError, SchemaError):
            continue
        if f.name == EVENTS_NAME:
            # a compacted dir's pinned evidence records — and any
            # rotated-but-uncompacted chunks — belonged to THIS live
            # stream before rotation: replay them ahead of the live
            # tail under the live stream's own identity, so trace
            # reconstructions stay byte-equal to the raw-dir result
            from hfrep_tpu_torch.obs import rollup as _rollup
            prior_recs: List[dict] = []
            for pf in (_rollup.pinned_files(f.parent)
                       + _rollup.chunk_files(f.parent)):
                try:
                    prior_recs.extend(load_jsonl(pf, parse_event))
                except (OSError, SchemaError):
                    continue
            recs = prior_recs + recs
        base = None
        try:
            base = json.loads(
                (f.parent / "run.json").read_text()).get("created_unix")
        except (OSError, json.JSONDecodeError):
            pass
        rotated = f.name != EVENTS_NAME
        for rec in recs:
            ids = []
            if isinstance(rec.get("trace"), str):
                ids.append(rec["trace"])
            traces = rec.get("traces")
            if isinstance(traces, list):
                ids.extend(t for t in traces if isinstance(t, str))
            hits = {i for i in ids if wanted is None or i in wanted}
            if not hits:
                continue
            r = dict(rec)
            r["_dir"] = str(f.parent)
            r["_file"] = str(f)
            r["_rotated"] = rotated
            r["_dir_base"] = base
            r["_abs"] = ((base + float(rec["t"]))
                         if base is not None and not rotated else None)
            for i in hits:
                out.setdefault(i, []).append(r)
    for recs in out.values():
        recs.sort(key=_trace_sort_key)
    return out


def trace_events(run_dirs, trace_id: str) -> List[dict]:
    """One trace's records in reconstruction order (see
    :func:`trace_index`)."""
    return trace_index(run_dirs, [trace_id]).get(trace_id, [])


def _trace_sort_key(r: dict):
    """Reconstruction order: absolute time where the stream has a
    manifest base; rotated streams (whose manifest the restart
    overwrote) anchor just BEFORE their dir's live stream — their events
    happened before the restart by definition; streams with no manifest
    at all sort last, by dir."""
    if r["_abs"] is not None:
        return (0, r["_abs"], r["_dir"],
                _stream_rank(Path(r["_file"])), float(r["t"]))
    if r["_dir_base"] is not None:          # rotated, base known
        return (0, r["_dir_base"] - 1e-3, r["_dir"],
                _stream_rank(Path(r["_file"])), float(r["t"]))
    return (1, 0.0, r["_dir"], _stream_rank(Path(r["_file"])),
            float(r["t"]))


def has_terminal(records: List[dict]) -> bool:
    return any(r["type"] == "event" and r.get("name") in
               TERMINAL_TRACE_EVENTS for r in records)


def render_trace(trace_id: str, records: List[dict], root=None) -> str:
    """The cross-process critical path, one line per hop with per-hop
    durations (absolute-clock deltas where both ends have a manifest
    base; same-stream ``t`` deltas otherwise; ``?`` across a restart
    whose rotated stream lost its manifest)."""
    if not records:
        return f"trace {trace_id}: no matching events"
    root = Path(root) if root is not None else None
    streams = {r["_file"] for r in records}
    lines = [f"trace {trace_id} — {len(records)} event(s) across "
             f"{len(streams)} stream(s)"]
    prev = None
    for r in records:
        d = Path(r["_dir"])
        label = str(d.relative_to(root)) if root and root in d.parents \
            else d.name
        if r["_rotated"]:
            label += f":{Path(r['_file']).name}"
        delta = ""
        if prev is not None:
            if r["_abs"] is not None and prev.get("_abs") is not None:
                delta = f"  (+{(r['_abs'] - prev['_abs']) * 1e3:.1f} ms)"
            elif r["_file"] == prev["_file"]:
                delta = f"  (+{(float(r['t']) - float(prev['t'])) * 1e3:.1f} ms)"
            else:
                delta = "  (+? across restart)"
        name = r.get("name", r["type"])
        attrs = {k: v for k, v in r.items()
                 if k not in ("v", "t", "type", "name", "trace", "traces")
                 and not k.startswith("_") and v is not None}
        detail = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(f"  [{label:>24s}] t={float(r['t']):8.3f}s "
                     f"{r['type']:6s} {name:20s} {detail}{delta}")
        prev = r
    lines.append("terminal: " + ("yes" if has_terminal(records)
                                 else "NO (orphan trace)"))
    return "\n".join(lines)


def _weighted_percentile(pairs: List[Tuple[float, float]], q: float) -> float:
    """Nearest-rank percentile of (value, weight) pairs."""
    if not pairs:
        return float("nan")
    pairs = sorted(pairs)
    total = sum(w for _, w in pairs)
    if total <= 0:
        return float("nan")
    acc = 0.0
    for v, w in pairs:
        acc += w
        if acc >= q * total:
            return v
    return pairs[-1][0]


def mfu_peak(manifest: dict) -> float:
    """The bf16 peak a run's MFU is quoted against: the one its writer
    quotes.  A run the JAX package wrote (its manifest lists ``jax``
    among the versions) keeps that package's own denominator, so its
    summary is the JAX package's number for number; every other run is
    the port's, quoted against the H100's dense bf16 peak as the
    trainer's ``mfu`` gauge is."""
    from hfrep_tpu_torch.obs import flops
    versions = manifest.get("versions") or {}
    return flops.REFERENCE_PEAK_BF16 if "jax" in versions else flops.PEAK_BF16


def summarize(run_dir, events: Optional[List[dict]] = None) -> dict:
    """One run directory -> headline summary dict (all JSON-safe).
    ``events``: the already-parsed stream, when the caller just loaded
    it."""
    run_dir = Path(run_dir)
    try:
        from hfrep_tpu_torch.obs.manifest import read_manifest
        manifest = read_manifest(run_dir)
    except (OSError, json.JSONDecodeError):
        manifest = {}
    if events is None:
        events = load_events(run_dir)

    # on a compacted run dir, pre-seed the aggregate contribution of the
    # records compaction folded away (metric samples, plain spans).
    # Dict insertion order is deliberate: the seed preserves the raw
    # stream's first-seen order for every name it holds, and everything
    # seen only in the live stream appends after — so gauge/counter/
    # count ordering matches a raw replay exactly.
    from hfrep_tpu_torch.obs import rollup as _rollup
    seed = _rollup.summary_seed(run_dir)

    counts: Dict[str, int] = {}
    blocks: List[dict] = []
    gauges: Dict[str, float] = {}
    counters: Dict[str, float] = {}
    high_water = 0
    compile_spans = 0.0
    seed_events = 0
    if seed:
        for etype in seed.get("type_order") or []:
            counts[etype] = seed["counts"].get(etype, 0)
        gauges.update(seed["gauges"])
        counters.update(seed["counters"])
        seed_events = int(seed["n_events"])
    for rec in events:
        counts[rec["type"]] = counts.get(rec["type"], 0) + 1
        if rec["type"] == "span":
            if rec["name"] == "block" and rec.get("steps"):
                blocks.append(rec)
            elif str(rec["name"]).startswith("compile:"):
                compile_spans += float(rec["dur"])
        elif rec["type"] == "metric":
            if rec["kind"] == "gauge":
                gauges[rec["name"]] = rec["value"]
            elif rec["kind"] == "counter":
                counters[rec["name"]] = rec["value"]
        elif rec["type"] == "memory":
            high_water = max(high_water, int(rec.get("high_water") or 0))

    steady = [b for b in blocks if not b.get("warmup")]
    used = steady or blocks
    steps = sum(float(b["steps"]) for b in used)
    secs = sum(float(b["dur"]) for b in used)
    steps_per_sec = steps / secs if secs > 0 else float("nan")
    per_step = [(float(b["dur"]) / float(b["steps"]), float(b["steps"]))
                for b in used if float(b["steps"]) > 0]
    p50 = _weighted_percentile(per_step, 0.50)
    p95 = _weighted_percentile(per_step, 0.95)

    mfu_val = float("nan")
    model = (manifest.get("config") or {}).get("model") or {}
    train = (manifest.get("config") or {}).get("train") or {}
    if (model.get("family") == "mtss_wgan_gp" and model.get("window")
            and model.get("features")):
        # the analytic FLOPs model is flagship-only (the trainer gates its
        # mfu gauge the same way): other families' epoch structure differs,
        # so recomputing would print a confidently wrong number
        from hfrep_tpu_torch.obs import flops
        mfu_val = flops.mfu(steps_per_sec, int(model["window"]),
                            int(model["features"]),
                            int(model.get("hidden") or flops.H),
                            int(train.get("batch_size") or flops.B),
                            peak=mfu_peak(manifest))
    elif isinstance(gauges.get("mfu"), (int, float)):
        mfu_val = float(gauges["mfu"])

    return {
        "run_dir": str(run_dir),
        "run_id": manifest.get("run_id") or run_dir.name,
        "git_sha": (manifest.get("git") or {}).get("sha"),
        "backend": (manifest.get("devices") or {}).get("backend"),
        "n_events": len(events) + seed_events,
        "event_counts": counts,
        "blocks": {"n": len(blocks), "steady": len(steady),
                   "warmup": len(blocks) - len(steady)},
        "steps": steps,
        "steps_per_sec": steps_per_sec,
        "step_time_p50_s": p50,
        "step_time_p95_s": p95,
        "mfu": mfu_val,
        "memory_high_water_bytes": high_water,
        "backend_compiles": counters.get("backend_compiles"),
        "compile_secs": (gauges.get("backend_compile_secs_total")
                         or compile_spans or None),
        "gauges": gauges,
        "counters": counters,
    }


# ------------------------------------------------------------- rendering
def _fmt(v, unit="") -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if math.isnan(v):
            return "nan"
        if unit == "%":
            return f"{v * 100:.2f}%"
        if unit == "s":
            return f"{v * 1e3:.3f} ms" if v < 1 else f"{v:.3f} s"
        if unit == "B":
            return _fmt_bytes(v)
        return f"{v:.2f}"
    if unit == "B":
        return _fmt_bytes(v)
    return str(v)


def _fmt_bytes(v) -> str:
    v = float(v)
    for suffix in ("B", "KiB", "MiB", "GiB"):
        if v < 1024 or suffix == "GiB":
            return f"{v:.1f} {suffix}" if suffix != "B" else f"{int(v)} B"
        v /= 1024
    return f"{v:.1f} GiB"


_ROWS = (
    ("events", "n_events", ""),
    ("steady blocks", None, ""),
    ("steps", "steps", ""),
    ("steps/sec", "steps_per_sec", ""),
    ("p50 step time", "step_time_p50_s", "s"),
    ("p95 step time", "step_time_p95_s", "s"),
    ("MFU (bf16 peak)", "mfu", "%"),
    ("memory high-water", "memory_high_water_bytes", "B"),
    ("backend compiles", "backend_compiles", ""),
    ("compile secs", "compile_secs", ""),
)


def _row_value(s: dict, key: Optional[str]):
    if key is None:
        return f"{s['blocks']['steady']}/{s['blocks']['n']}"
    return s.get(key)


def render(s: dict) -> str:
    lines = [f"run {s['run_id']}  (backend={s['backend'] or '?'}, "
             f"git={str(s['git_sha'])[:10]})"]
    for label, key, unit in _ROWS:
        v = _row_value(s, key)
        lines.append(f"  {label:18s} {v if key is None else _fmt(v, unit)}")
    return "\n".join(lines)


def render_diff(a: dict, b: dict) -> str:
    lines = [f"{'':20s} {a['run_id'][:22]:>22s} {b['run_id'][:22]:>22s} "
             f"{'ratio':>8s}"]
    for label, key, unit in _ROWS:
        va, vb = _row_value(a, key), _row_value(b, key)
        ratio = ""
        if (key is not None and isinstance(va, (int, float))
                and isinstance(vb, (int, float)) and not isinstance(va, bool)):
            fa, fb = float(va), float(vb)
            if fa and not math.isnan(fa) and not math.isnan(fb):
                ratio = f"{fb / fa:7.2f}x"
        sa = str(va) if key is None else _fmt(va, unit)
        sb = str(vb) if key is None else _fmt(vb, unit)
        lines.append(f"{label:20s} {sa:>22s} {sb:>22s} {ratio:>8s}")
    return "\n".join(lines)


# -------------------------------------------------------------- self-test
def fixture_dir() -> Path:
    """The port's copy of the committed fixture run directory (byte-equal
    to the JAX package's ``hfrep_tpu/obs/_fixture``)."""
    return Path(__file__).resolve().parent / "_fixture"


def history_fixture_dir() -> Path:
    """The committed history fixture: ≥3 clean run dirs + one multi-host
    pair + one seeded-regression run + the pre-built ``history.jsonl``
    index over the clean runs (the perf-regression tripwire's own test)."""
    return fixture_dir() / "history"


def self_test() -> int:
    """Exercise the event-schema parser + summary on the fixture run.

    Returns 0 on success; prints and returns 1 on any mismatch, so a
    schema drift (writer and parser disagreeing) fails before it corrupts
    a real run's telemetry.
    """
    from hfrep_tpu_torch.obs.manifest import REQUIRED_KEYS, read_manifest
    fx = fixture_dir()
    try:
        manifest = read_manifest(fx)
        missing = [k for k in REQUIRED_KEYS if k not in manifest]
        if missing:
            raise SchemaError(f"fixture manifest missing keys: {missing}")
        events = load_events(fx, strict=True)   # validates every line
        if not events:
            raise SchemaError("fixture events.jsonl is empty")
        present = {e["type"] for e in events}
        need = {"span", "metric", "memory"}
        if not need <= present:
            raise SchemaError(f"fixture lacks event types {need - present}")
        s = summarize(fx)
        for key in ("steps_per_sec", "step_time_p50_s", "step_time_p95_s",
                    "mfu"):
            v = s[key]
            if not isinstance(v, float) or math.isnan(v):
                raise SchemaError(f"fixture summary {key} = {v!r}")
        if not s["memory_high_water_bytes"] > 0:
            raise SchemaError("fixture summary has no memory high-water")
    except (OSError, json.JSONDecodeError, SchemaError, KeyError) as e:
        print(f"obs self-test FAILED: {e}", file=sys.stderr)
        return 1
    print(f"obs self-test OK ({s['n_events']} events, "
          f"{s['steps_per_sec']:.1f} steps/s, mfu {s['mfu'] * 100:.2f}%)")
    return 0


def gate_self_test() -> int:
    """Exercise the full history/regression loop on the committed
    fixture: ingest, multi-host merge, baseline math, verdict shape and
    the pass/fail decision — strict mode throughout, with ONE pure-JSON
    result document on stdout (diagnostics go to stderr).  If the
    writer, the store or the engine drift apart, it fails before a real
    run's history is corrupted.
    """
    import tempfile

    from hfrep_tpu_torch.obs import history as hist_mod
    from hfrep_tpu_torch.obs import regress

    fx = history_fixture_dir()
    try:
        records = hist_mod.load_history(fx / "history.jsonl", strict=True)
        if len(records) < 3:
            raise SchemaError(f"fixture history holds {len(records)} "
                              "records, need >= 3 for baseline math")

        # the clean (un-indexed) run gates PASS against the committed
        # index, with the baseline actually ENFORCED (n >= min_runs —
        # an insufficient-history pass would not prove the math)
        clean = hist_mod.summarize_run(fx / "run_d")
        v_clean = regress.check_run(clean, records)
        if not v_clean["ok"]:
            raise SchemaError(
                f"clean fixture run flagged: {v_clean['regressions']}")
        if not any(c["status"] == "ok" and c["metric"] == "steps_per_sec"
                   for c in v_clean["checks"]):
            raise SchemaError("clean run's steps_per_sec was not enforced "
                              "(insufficient history in the fixture index?)")

        # the seeded regression gates FAIL, and the verdict names the
        # metric, baseline, observed value and threshold
        bad = hist_mod.summarize_run(fx / "regressed")
        v_bad = regress.check_run(bad, records)
        if v_bad["ok"] or "steps_per_sec" not in v_bad["regressions"]:
            raise SchemaError("seeded regression not flagged on "
                              f"steps_per_sec: {v_bad['regressions']}")
        (spc,) = [c for c in v_bad["checks"]
                  if c["metric"] == "steps_per_sec"]
        for field in ("metric", "baseline", "observed", "threshold"):
            if spc.get(field) is None:
                raise SchemaError(f"verdict check missing {field!r}")
        if not spc["observed"] < spc["baseline"] - spc["threshold"]:
            raise SchemaError("verdict numbers do not justify the flag")

        # cross-host merge: conservative folds over the committed pair
        merged = hist_mod.merge_run_dirs(fx / "multihost")
        per = merged["per_host"]
        if merged["hosts"] != 2 or len(per) != 2:
            raise SchemaError(f"multihost merge saw {merged['hosts']} hosts")
        rates = [h["steps_per_sec"] for h in per.values()]
        if merged["steps_per_sec"] != min(rates):
            raise SchemaError("merged steps/sec is not the min over hosts")
        if merged["memory_high_water_bytes"] != max(
                h["memory_high_water_bytes"] for h in per.values()):
            raise SchemaError("merged memory high-water is not the max")
        if merged["backend_compiles"] != sum(
                h["backend_compiles"] for h in per.values()):
            raise SchemaError("merged compile count is not the sum")

        # ingest round trip + idempotency into a scratch index
        with tempfile.TemporaryDirectory() as td:
            scratch = Path(td) / "history.jsonl"
            first = hist_mod.ingest(fx / "run_c", scratch)
            again = hist_mod.ingest(fx / "run_c", scratch)
            mh = hist_mod.ingest_multihost(fx / "multihost", scratch)
            if not first["ingested"] or again["ingested"]:
                raise SchemaError("ingest is not idempotent on "
                                  "(run_id, created_unix)")
            if not mh["ingested"] or mh["hosts"] != 2:
                raise SchemaError("multihost ingest did not merge 2 hosts")
            back = hist_mod.load_history(scratch, strict=True)
            if len(back) != 2:
                raise SchemaError(f"scratch index holds {len(back)} records,"
                                  " expected 2")
    except (OSError, json.JSONDecodeError, SchemaError, KeyError,
            ValueError) as e:
        print(f"obs gate self-test FAILED: {e}", file=sys.stderr)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print("obs gate self-test OK", file=sys.stderr)
    print(json.dumps({
        "ok": True,
        "history_records": len(records),
        "clean_run": {"run_id": v_clean["run_id"], "ok": True},
        "regressed_run": {"run_id": v_bad["run_id"], "ok": False,
                          "regressions": v_bad["regressions"],
                          "steps_per_sec": {
                              "baseline": spc["baseline"],
                              "observed": spc["observed"],
                              "threshold": spc["threshold"]}},
        "multihost": {"hosts": merged["hosts"],
                      "steps_per_sec": merged["steps_per_sec"]},
    }))
    return 0


# -------------------------------------------------------------------- CLI
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hfrep_tpu_torch.obs",
        description="summarize / diff / gate telemetry run directories")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("report", help="summarize one run dir or diff two")
    r.add_argument("run_dirs", nargs="*", help="1 run dir (summary) or "
                                               "2 (diff: second vs first)")
    r.add_argument("--format", choices=("human", "json"), default="human")
    r.add_argument("--merge", action="store_true",
                   help="treat each RUN_DIR as a multi-host launch parent "
                        "(proc0/, proc1/, ...) and summarize the folded "
                        "logical run (history.merge_run_dirs)")
    r.add_argument("--trace", metavar="ID", default=None,
                   help="reconstruct one request/item's cross-process "
                        "critical path: every event carrying this trace "
                        "ID across ALL events*.jsonl streams under the "
                        "given run dir(s), rotated streams included, "
                        "with per-hop durations")
    r.add_argument("--crash", action="store_true",
                   help="read the run dir's crash-forensics bundle "
                        "(crash_<run_id>/): exception, traceback tail, "
                        "last events")
    r.add_argument("--self-test", action="store_true",
                   help="validate the committed fixture run dir")

    g = sub.add_parser(
        "gate", help="perf-regression gate: one run vs the run history")
    g.add_argument("run_dir", nargs="?",
                   help="run dir to gate (omit with --self-test)")
    g.add_argument("--history", default=None,
                   help="history.jsonl index (default: $HFREP_HISTORY)")
    g.add_argument("--format", choices=("human", "json"), default="human")
    g.add_argument("--merge", action="store_true",
                   help="RUN_DIR is a multi-host parent; gate the folded run")
    g.add_argument("--ingest", action="store_true",
                   help="append the run to the history AFTER a passing "
                        "gate (a regressed run must not become its own "
                        "baseline)")
    g.add_argument("--min-runs", type=int, default=None, metavar="N",
                   help="comparable runs required before enforcing "
                        "(default 3; fewer passes as insufficient-history)")
    g.add_argument("--window", type=int, default=None, metavar="N",
                   help="rolling baseline window (last N comparable runs)")
    g.add_argument("--threshold", action="append", default=None,
                   metavar="METRIC=REL_TOL",
                   help="set a metric's EXACT relative tolerance (replaces "
                        "the adaptive MAD term), e.g. steps_per_sec=0.08 "
                        "(repeatable)")
    g.add_argument("--self-test", action="store_true",
                   help="exercise ingest/merge/baseline/verdict on the "
                        "committed history fixture (CI gate; pure-JSON "
                        "stdout)")
    g.add_argument("--slo", default=None, metavar="FLEET_ROOT",
                   help="also evaluate the declarative SLO burn rates "
                        "over this fleet root and fail the gate on any "
                        "breach (with no RUN_DIR: pure SLO gating, no "
                        "per-run regression check)")
    g.add_argument("--slos", default=None, metavar="FILE",
                   help="with --slo: objectives JSON (default: "
                        "<root>/slo.json if present, else built-ins)")
    g.add_argument("--explain", action="store_true",
                   help="on a failing gate, diff the offending run "
                        "against the comparable history runs still on "
                        "disk (program fingerprints, compile counts, "
                        "cost-analysis flops, span/attrib deltas) and "
                        "append a ranked diagnosis to the verdict")

    x = sub.add_parser(
        "explain", help="ranked regression diagnosis: diff the LAST run "
                        "dir against the earlier one(s) as baseline "
                        "cohort — program fingerprints, compile counts, "
                        "cost-analysis flops, dispatch-vs-compute and "
                        "span deltas, worst first")
    x.add_argument("run_dirs", nargs="*",
                   help="BASELINE [BASELINE...] TARGET (>= 2; the last "
                        "dir is the offending run; omit with "
                        "--self-test/--history)")
    x.add_argument("--format", choices=("human", "json"), default="human")
    x.add_argument("--top", type=int, default=10, metavar="N",
                   help="keep the N highest-scored findings (default 10)")
    x.add_argument("--history", default=None, metavar="PATH",
                   help="instead of diffing run dirs, report what the "
                        "history STORE alone can attribute: per-metric "
                        "series + an evidence inventory (compile "
                        "counters / memory / resolvable run dirs per "
                        "record)")
    x.add_argument("--self-test", action="store_true",
                   help="exercise the diagnosis loop on the committed "
                        "planted-regression fixture (CI gate; pure-JSON "
                        "stdout)")

    pr = sub.add_parser(
        "profile", help="digest a run dir's captured profiler traces "
                        "(trace_capture artifacts under <run_dir>/traces) "
                        "into per-op / per-region device time tables; "
                        "typed skip when the run captured none")
    pr.add_argument("run_dir")
    pr.add_argument("--format", choices=("human", "json"), default="human")
    pr.add_argument("--top", type=int, default=20, metavar="N",
                    help="ops per capture in the table (default 20)")

    i = sub.add_parser(
        "ingest", help="append a run dir to a history.jsonl index")
    i.add_argument("run_dir")
    i.add_argument("--history", required=True)
    i.add_argument("--merge", action="store_true",
                   help="RUN_DIR is a multi-host parent; ingest the "
                        "folded logical run")

    t = sub.add_parser(
        "tail", help="live one-screen view of a running run dir "
                     "(steps/sec, health/* gauges, queue depth, shed "
                     "rate, breaker state) following the torn-tail-"
                     "tolerant JSONL streams")
    t.add_argument("run_dirs", nargs="+")
    t.add_argument("--interval", type=float, default=1.0,
                   help="refresh period in seconds (default 1.0)")
    t.add_argument("--once", action="store_true",
                   help="render a single frame and exit (CI/scripting)")

    e = sub.add_parser(
        "export", help="Prometheus-exposition-format text snapshot of a "
                       "run dir's gauges/counters/histograms (for "
                       "external scrapers)")
    e.add_argument("run_dirs", nargs="+")
    e.add_argument("-o", "--out", default=None,
                   help="write to this file (atomic tmp+rename) instead "
                        "of stdout")
    e.add_argument("--fleet", action="store_true",
                   help="treat the single argument as a FLEET ROOT: "
                        "discover every run dir beneath it, fold each "
                        "through the durable rollup consumer and emit "
                        "ONE federated exposition — per-replica series "
                        "labeled {replica=...} plus hfrep_fleet_* "
                        "invariant gauges (ledger deficit, breakers, "
                        "restart storms)")
    e.add_argument("--watch", type=int, default=None, metavar="N",
                   help="with --fleet: keep re-ingesting and "
                        "republishing every --interval seconds for N "
                        "passes (advances the durable cursors)")
    e.add_argument("--interval", type=float, default=5.0,
                   help="with --fleet --watch: seconds between passes "
                        "(default 5.0)")

    s = sub.add_parser(
        "slo", help="declarative SLOs with multi-window burn-rate "
                    "alerts over a fleet root (p95 latency, shed rate, "
                    "error rate vs targets; breach = fast AND slow "
                    "windows both burning >= 1.0)")
    s.add_argument("root", nargs="?",
                   help="fleet root (omit with --self-test)")
    s.add_argument("--slos", default=None, metavar="FILE",
                   help="objectives JSON (default: <root>/slo.json if "
                        "present, else the built-in serve objectives)")
    s.add_argument("--fast-buckets", type=int, default=None, metavar="N",
                   help="fast burn window, in rollup buckets (default 5)")
    s.add_argument("--slow-buckets", type=int, default=None, metavar="N",
                   help="slow burn window, in rollup buckets (default 30)")
    s.add_argument("--bucket-secs", type=float, default=None,
                   help="rollup bucket width in seconds (default 60)")
    s.add_argument("--persist", action="store_true",
                   help="advance each replica's durable rollup cursors "
                        "(default: read-only fold)")
    s.add_argument("--format", choices=("human", "json"), default="human")
    s.add_argument("--self-test", action="store_true",
                   help="evaluate the committed two-replica fleet "
                        "fixture: the planted cross-replica silent drop "
                        "and burn-rate breach must be caught (CI gate; "
                        "pure-JSON stdout)")

    cd = sub.add_parser(
        "crash-drill",
        help="the crash-forensics loop end to end: a real obs session "
             "through injected io_fail and nonfinite faults; the crash "
             "bundle must land complete and render")
    cd.add_argument("--device", default="cuda",
                    help="where the drill's AE training runs (default: the card)")

    tl = sub.add_parser(
        "timeline", help="wall-clock ledger: fold a run's "
                         "timeline_window records into the whole-run "
                         "conservation ledger (Σ category ms == wall "
                         "ms), report per-category fractions + achieved "
                         "host/device overlap, and optionally "
                         "reconstruct a Chrome-trace/perfetto timeline "
                         "from the event stream alone (byte-identical "
                         "on a compacted run dir)")
    tl.add_argument("run_dir", nargs="?",
                    help="run dir to account (omit with --self-test)")
    tl.add_argument("-o", "--out", default=None, metavar="TRACE_JSON",
                    help="also write the perfetto trace-event JSON here "
                         "(atomic tmp+rename; open in ui.perfetto.dev "
                         "or chrome://tracing)")
    tl.add_argument("--format", choices=("human", "json"), default="human")
    tl.add_argument("--self-test", action="store_true",
                    help="accumulator conservation algebra + the "
                         "hand-computed fixture ledger + compaction "
                         "byte-identity + torn-tail degradation + the "
                         "obs_self_frac<1%% ceiling (CI gate; pure-JSON "
                         "stdout)")

    c = sub.add_parser(
        "compact", help="bounded retention for long soaks: rotate an "
                        "oversized live stream aside, fold rotated "
                        "chunks into rollup segments + a reader seed, "
                        "pin the evidence records verbatim, delete the "
                        "chunks — gate/explain/--trace verdicts stay "
                        "identical on the compacted dir")
    c.add_argument("run_dirs", nargs="+")
    c.add_argument("--rotate-bytes", type=int, default=None, metavar="N",
                   help="also rotate the live stream first when it "
                        "exceeds N bytes (caller must know no writer "
                        "holds it open; live processes rotate "
                        "themselves via HFREP_OBS_ROTATE_BYTES)")
    c.add_argument("--force-rotate", action="store_true",
                   help="rotate a non-empty live stream regardless of "
                        "size (offline runs only)")
    c.add_argument("--bucket-secs", type=float, default=None,
                   help="rollup bucket width in seconds (default 60)")
    c.add_argument("--format", choices=("human", "json"), default="human")

    return p


def _parse_threshold_overrides(pairs):
    if not pairs:
        return None
    out = {}
    for pair in pairs:
        metric, _, tol = pair.partition("=")
        if not metric or not tol:
            raise ValueError(f"--threshold wants METRIC=REL_TOL, got {pair!r}")
        out[metric] = float(tol)
    return out


def _cmd_report(args) -> int:
    if args.self_test:
        return self_test()
    if args.crash:
        from hfrep_tpu_torch.obs import crash
        if len(args.run_dirs) != 1:
            print("report --crash wants exactly one run dir (or bundle "
                  "dir)", file=sys.stderr)
            return 2
        bundle = crash.find_bundle(args.run_dirs[0])
        if bundle is None:
            print(f"no crash bundle under {args.run_dirs[0]}",
                  file=sys.stderr)
            return 1
        if args.format == "json":
            try:
                print(json.dumps(json.loads(
                    (bundle / "crash.json").read_text()), indent=2))
            except (OSError, json.JSONDecodeError) as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        else:
            print(crash.render_bundle(bundle))
        return 0
    if args.trace:
        if not args.run_dirs:
            print("report --trace wants at least one run dir",
                  file=sys.stderr)
            return 2
        records = trace_events(args.run_dirs, args.trace)
        if args.format == "json":
            print(json.dumps({"trace": args.trace,
                              "terminal": has_terminal(records),
                              "events": records}, indent=2, default=str))
        else:
            print(render_trace(args.trace, records,
                               root=Path(args.run_dirs[0]).resolve()))
        return 0 if records else 1
    if not 1 <= len(args.run_dirs) <= 2:
        print("report wants 1 run dir (summary) or 2 (diff)", file=sys.stderr)
        return 2
    try:
        if args.merge:
            from hfrep_tpu_torch.obs.history import merge_run_dirs
            summaries = [merge_run_dirs(d) for d in args.run_dirs]
        else:
            summaries = [summarize(d) for d in args.run_dirs]
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.format == "json":
        doc = summaries[0] if len(summaries) == 1 else {
            "base": summaries[0], "other": summaries[1]}
        print(json.dumps(doc, indent=2, default=str))
        return 0
    if len(summaries) == 1:
        print(render(summaries[0]))
    else:
        print(render_diff(summaries[0], summaries[1]))
    return 0


def _cmd_gate(args) -> int:
    import os

    from hfrep_tpu_torch.obs import history as hist_mod
    from hfrep_tpu_torch.obs import regress

    if args.self_test:
        return gate_self_test()

    slo_doc = None
    if args.slo:
        from hfrep_tpu_torch.obs import slo as slo_mod
        try:
            slo_doc = slo_mod.evaluate_root(args.slo,
                                            slos_path=args.slos)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: --slo: {e}", file=sys.stderr)
            return 2
        if not args.run_dir:
            # pure SLO gating: no per-run regression half
            if args.format == "json":
                print(json.dumps(slo_doc, indent=2, default=str))
            else:
                print(slo_mod.render(slo_doc))
            ok = slo_doc["ok"] and slo_doc["fleet"]["ok"]
            print("slo gate: " + ("PASS" if ok else "FAIL"),
                  file=sys.stderr)
            return 0 if ok else 1

    if not args.run_dir:
        print("gate wants a run dir (or --self-test / --slo ROOT)",
              file=sys.stderr)
        return 2
    history_path = args.history or os.environ.get("HFREP_HISTORY")
    if not history_path:
        print("gate wants --history PATH (or $HFREP_HISTORY)",
              file=sys.stderr)
        return 2
    try:
        overrides = _parse_threshold_overrides(args.threshold)
        record = (hist_mod.merged_record(args.run_dir) if args.merge
                  else hist_mod.summarize_run(args.run_dir))
        records = hist_mod.load_history(history_path)
        kw = {"thresholds": overrides}
        if args.min_runs is not None:
            kw["min_runs"] = args.min_runs
        if args.window is not None:
            kw["window"] = args.window
        verdict = regress.check_run(record, records, **kw)
    except (OSError, SchemaError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    explain_doc = None
    if args.explain and not verdict["ok"]:
        # the gate's red exit becomes a diagnosis: diff against the
        # comparable history runs still on disk.  Best-effort — a
        # failed explanation must never change the gate's verdict.
        from hfrep_tpu_torch.obs import explain as explain_mod
        try:
            explain_doc = explain_mod.explain_gate_failure(
                args.run_dir, record, records, history_path=history_path,
                window=args.window or regress.DEFAULT_WINDOW)
        except Exception as e:
            print(f"explain failed ({e}); verdict unaffected",
                  file=sys.stderr)
    extra = {}
    if explain_doc is not None:
        extra["explain"] = explain_doc
    if slo_doc is not None:
        extra["slo"] = slo_doc
    if args.format == "json":
        if extra:
            print(json.dumps(dict(verdict, **extra), indent=2,
                             default=str))
        else:
            print(regress.verdict_json(verdict))
    else:
        print(regress.render_verdict(verdict))
        if explain_doc is not None:
            from hfrep_tpu_torch.obs import explain as explain_mod
            print(explain_mod.render_diagnosis(explain_doc))
        if slo_doc is not None:
            from hfrep_tpu_torch.obs import slo as slo_mod
            print(slo_mod.render(slo_doc))
    if verdict["ok"] and args.ingest:
        try:
            ok = hist_mod.append_record(
                history_path, dict(record, ingested_unix=round(time.time(), 3)),
                records=records)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(("ingested into" if ok else "already indexed in")
              + f" {history_path}", file=sys.stderr)
    slo_ok = (slo_doc is None
              or (slo_doc["ok"] and slo_doc["fleet"]["ok"]))
    if not slo_ok:
        print("slo gate: FAIL (burn-rate breach or fleet invariant)",
              file=sys.stderr)
    return 0 if (verdict["ok"] and slo_ok) else 1


def _cmd_ingest(args) -> int:
    from hfrep_tpu_torch.obs import history as hist_mod
    try:
        rec = (hist_mod.ingest_multihost(args.run_dir, args.history)
               if args.merge else hist_mod.ingest(args.run_dir, args.history))
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(rec, indent=2, default=str))
    return 0


def _cmd_explain(args) -> int:
    from hfrep_tpu_torch.obs import explain as explain_mod
    if args.self_test:
        return explain_mod.self_test()
    if args.history:
        from hfrep_tpu_torch.obs import history as hist_mod
        try:
            records = hist_mod.load_history(args.history)
        except (OSError, SchemaError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        doc = explain_mod.history_report(records)
        if args.format == "json":
            print(json.dumps(doc, indent=2, default=str))
        else:
            print(explain_mod.render_history_report(doc))
        return 0
    if len(args.run_dirs) < 2:
        print("explain wants BASELINE [BASELINE...] TARGET run dirs "
              "(or --history / --self-test)", file=sys.stderr)
        return 2
    doc = explain_mod.explain_runs(args.run_dirs[:-1], args.run_dirs[-1],
                                   top=args.top)
    if args.format == "json":
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(explain_mod.render_diagnosis(doc))
    return 0


def _cmd_profile(args) -> int:
    from hfrep_tpu_torch.obs import attrib
    return attrib.profile_main(args.run_dir, top=args.top,
                               fmt=args.format)


def _cmd_tail(args) -> int:
    from hfrep_tpu_torch.obs import tail
    return tail.tail_main(args.run_dirs, interval=args.interval,
                          once=args.once)


def _cmd_export(args) -> int:
    if args.fleet:
        from hfrep_tpu_torch.obs import fleet
        if len(args.run_dirs) != 1:
            print("export --fleet wants exactly one fleet root",
                  file=sys.stderr)
            return 2
        return fleet.export_fleet_main(
            args.run_dirs[0], out=args.out,
            watch_iterations=args.watch, interval=args.interval,
            persist=args.watch is not None)
    from hfrep_tpu_torch.obs import tail
    return tail.export_main(args.run_dirs, out=args.out)


def _cmd_slo(args) -> int:
    from hfrep_tpu_torch.obs import slo as slo_mod
    if args.self_test:
        return slo_mod.self_test()
    if not args.root:
        print("slo wants a fleet root (or --self-test)", file=sys.stderr)
        return 2
    kw = {"slos_path": args.slos, "persist": args.persist}
    if args.fast_buckets is not None:
        kw["fast_buckets"] = args.fast_buckets
    if args.slow_buckets is not None:
        kw["slow_buckets"] = args.slow_buckets
    if args.bucket_secs is not None:
        kw["bucket_secs"] = args.bucket_secs
    try:
        doc = slo_mod.evaluate_root(args.root, **kw)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(slo_mod.render(doc))
        led = doc["fleet"]["ledger"]
        print(f"fleet: {doc['fleet']['replicas']} replica(s), ledger "
              f"{led['submitted']}→{led['terminal']} "
              f"(deficit {led['deficit']}), "
              f"{doc['fleet']['breakers']['open']} breaker(s) open, "
              f"{len(doc['fleet']['restarts']['storms'])} restart "
              f"storm(s)")
    return 0 if (doc["ok"] and doc["fleet"]["ok"]) else 1


def _cmd_compact(args) -> int:
    from hfrep_tpu_torch.obs import rollup
    kw = {}
    if args.bucket_secs is not None:
        kw["bucket_secs"] = args.bucket_secs
    results = []
    rc = 0
    for d in args.run_dirs:
        try:
            res = rollup.compact(d, rotate_bytes=args.rotate_bytes,
                                 force_rotate=args.force_rotate, **kw)
        except OSError as e:
            print(f"error: {d}: {e}", file=sys.stderr)
            rc = 1
            continue
        res["run_dir"] = str(d)
        res["disk_bytes"] = rollup.disk_footprint(d)
        results.append(res)
    if args.format == "json":
        print(json.dumps(results, indent=2, default=str))
    else:
        for res in results:
            print(f"{res['run_dir']}: ingested {res['ingested']} "
                  f"record(s), compacted {len(res['compacted'])} "
                  f"chunk(s) ({res['chunks_total']} total, "
                  f"{res['records_compacted']} records), "
                  f"disk {res['disk_bytes']} B"
                  + (f", rotated {res['rotated']}" if res["rotated"]
                     else ""))
    return rc


def _cmd_timeline(args) -> int:
    from hfrep_tpu_torch.obs import timeline
    if args.self_test:
        return timeline.self_test()
    if not args.run_dir:
        print("timeline wants a run dir (or --self-test)", file=sys.stderr)
        return 2
    return timeline.timeline_main(args.run_dir, out=args.out,
                                  fmt=args.format)


def _cmd_crash_drill(args) -> int:
    from hfrep_tpu_torch.obs import crash
    return crash.drill(device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"report": _cmd_report, "gate": _cmd_gate,
            "ingest": _cmd_ingest, "tail": _cmd_tail,
            "export": _cmd_export, "explain": _cmd_explain,
            "profile": _cmd_profile, "slo": _cmd_slo,
            "compact": _cmd_compact, "timeline": _cmd_timeline,
            "crash-drill": _cmd_crash_drill}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
