"""Perf microscope, read side: ``obs explain``, the ranked diagnosis
(``hfrep_tpu/obs/explain.py``).

The sentinel (``obs gate``) turns a regression into exit code 1; this
module turns exit code 1 into a cause.  Given an offending run and a
baseline cohort (explicit run dirs, or for ``obs gate --explain`` the
comparable runs the history index points at), it diffs every
attribution surface the write side records:

* **program fingerprints** — the ``program_profile`` events and the
  manifest ``programs`` section (:mod:`hfrep_tpu_torch.obs.attrib`).  In
  the port a program is a kernel library (``build/cuda/<name>-<hash>.so``)
  at a compile boundary: a digest the cohort never loaded is an edited
  ``.cu`` or header, the prime suspect for a step-time move;
* **compile accounting** — the ``backend_compiles`` counter (the
  ``nvcc`` runs of :mod:`hfrep_tpu_torch.ops._build`: a cold build cache
  reads as compiles) and per-name ``compile:<step>`` spans;
* **cost** — the boundaries' FLOPs (``cost.flops``: one launch of the
  flagship's training step, :mod:`hfrep_tpu_torch.obs.flops`): the same
  boundary doing other work;
* **dispatch-vs-compute** — the ``attrib/*`` gauges: a dispatch_frac up
  11 points blames the host loop, not the card;
* **the wall-clock ledger** — on unchanged programs, the ``timeline/*``
  category fractions;
* **spans and metrics** — per-name span totals and the headline summary
  numbers, as supporting evidence.

Each surface yields findings scored by kind weight × normalised delta;
the render is one ranked list, human or JSON.  Degraded inputs (empty or
torn streams, runs with no manifest or no fingerprints) yield fewer
findings and explicit notes, never a crash; a diagnosis with no
attributable surface says so (``attributed: false``).  The document is
the JAX module's, so both packages diagnose each other's run dirs.  A
regressed program boundary that also carries an open finding in the
committed program audit (``hfrep_tpu_torch/analysis/audit_snapshot.sarif``,
the JPX rules over the traced graphs) gets a pointer to it
(:func:`annotate_static_audit`).  Stdlib-only, like the whole obs read
path.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from statistics import median
from typing import Dict, List, Optional

from hfrep_tpu_torch.obs.history import _num
from hfrep_tpu_torch.obs.report import SchemaError, load_events, summarize

#: findings below this score are dropped from the ranked list (noise
#: floor: a 1% span move explains nothing)
MIN_SCORE = 0.2

#: metrics worth naming as regression context, with their direction
_CONTEXT_METRICS = (("steps_per_sec", "up"), ("step_time_p50_s", "down"),
                    ("step_time_p95_s", "down"), ("mfu", "up"),
                    ("memory_high_water_bytes", "down"))


# ------------------------------------------------------------- evidence
def run_evidence(run_dir) -> dict:
    """Everything diffable about one run, degraded-tolerantly: a run
    with no events, no manifest or no fingerprints yields empty tables
    plus a note — the diagnosis then says what it could not see."""
    run_dir = Path(run_dir)
    notes: List[str] = []
    try:
        events = load_events(run_dir)
    except (OSError, SchemaError) as e:
        events = []
        notes.append(f"events unreadable: {e}")
    try:
        manifest = json.loads((run_dir / "run.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        manifest = {}
        notes.append(f"manifest unreadable: {e}")

    # programs: manifest index ∪ program_profile events (either side may
    # be missing — crashed before the manifest write, or an old run)
    programs: Dict[str, List[dict]] = {}
    for name, entries in (manifest.get("programs") or {}).items():
        if isinstance(entries, list):
            programs[str(name)] = [e for e in entries if isinstance(e, dict)]
    spans: Dict[str, dict] = {}
    compile_spans: Dict[str, dict] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    # a compacted run dir seeds the aggregates of the plain spans and
    # metric samples compaction folded away (first-seen order preserved;
    # names whose records were all pinned arrive as zero placeholders the
    # pinned replay below then fills) — evidence stays identical to a
    # raw-stream replay
    from hfrep_tpu_torch.obs import rollup as _rollup
    eseed = _rollup.evidence_seed(run_dir)
    if eseed:
        spans.update({k: dict(v) for k, v in eseed["spans"].items()})
        gauges.update(eseed["gauges"])
        counters.update(eseed["counters"])
    for rec in events:
        if rec["type"] == "span":
            if rec.get("warmup"):
                continue        # compile-polluted windows explain nothing
            sname = str(rec["name"])
            agg = spans.setdefault(sname, {"n": 0, "total_s": 0.0})
            agg["n"] += 1
            agg["total_s"] += float(rec["dur"])
            if sname.startswith("compile:"):
                c = compile_spans.setdefault(sname, {"n": 0, "total_s": 0.0})
                c["n"] += 1
                c["total_s"] += float(rec["dur"])
        elif rec["type"] == "metric":
            if rec["kind"] == "counter":
                counters[str(rec["name"])] = rec["value"]
            elif rec["kind"] == "gauge":
                gauges[str(rec["name"])] = rec["value"]
    for rec in events:
        if rec["type"] == "event" and rec.get("name") == "program_profile":
            bname = rec.get("program")
            if not bname:
                continue
            entry = {k: rec.get(k) for k in ("hlo_sha256", "hlo_bytes",
                                             "cost", "memory")}
            seen = programs.setdefault(str(bname), [])
            if entry.get("hlo_sha256") is not None and not any(
                    p.get("hlo_sha256") == entry["hlo_sha256"]
                    for p in seen):
                seen.append(entry)
    if not events:
        notes.append("no events parsed (empty or absent stream)")
    if not programs:
        notes.append("no program fingerprints recorded (pre-microscope "
                     "run, or a jax without lowering introspection)")

    s = None
    try:
        s = summarize(run_dir, events=events)
    except (OSError, SchemaError) as e:
        notes.append(f"summary unavailable: {e}")
    return {
        "run_dir": str(run_dir),
        "run_id": (s or {}).get("run_id") or run_dir.name,
        "programs": programs,
        "spans": spans,
        "compile_spans": compile_spans,
        "counters": counters,
        "gauges": gauges,
        "summary": s or {},
        "notes": notes,
    }


def _digests(ev: dict, name: str) -> set:
    return {p.get("hlo_sha256") for p in ev["programs"].get(name, [])
            if p.get("hlo_sha256")}


def _flops(ev: dict, name: str) -> Optional[float]:
    vals = [_num((p.get("cost") or {}).get("flops"))
            for p in ev["programs"].get(name, [])]
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


def _cohort_median(values) -> Optional[float]:
    vals = [v for v in (_num(x) for x in values) if v is not None]
    return median(vals) if vals else None


# ------------------------------------------------------------- findings
def _finding(kind: str, score: float, summary: str, **detail) -> dict:
    return {"kind": kind, "score": round(float(score), 4),
            "summary": summary, "detail": detail}


def diagnose(target: dict, cohort: List[dict], top: int = 10) -> dict:
    """Rank every attributable delta between ``target`` (evidence of the
    offending run) and the baseline ``cohort`` (evidence dicts; medians
    / digest unions over it are the baseline)."""
    findings: List[dict] = []
    notes = list(target["notes"])
    for ev in cohort:
        for n in ev["notes"]:
            note = f"cohort {ev['run_id']}: {n}"
            if note not in notes:
                notes.append(note)

    # -- program fingerprints: target digests the cohort never compiled
    cohort_names = set()
    for ev in cohort:
        cohort_names |= set(ev["programs"])
    cohort_has_programs = bool(cohort_names)
    for name in sorted(target["programs"]):
        t_dig = _digests(target, name)
        c_dig = set()
        for ev in cohort:
            c_dig |= _digests(ev, name)
        new = t_dig - c_dig
        if not cohort_has_programs:
            continue            # nothing to diff against; noted below
        if name not in cohort_names and t_dig:
            findings.append(_finding(
                "program", 2.5 + 0.25 * len(t_dig),
                f"{name}: program absent from the baseline cohort "
                f"({len(t_dig)} digest(s)) — a compile boundary the "
                "baseline never had",
                program=name, new_digests=sorted(new)))
            continue
        if new:
            t_fl, c_fl = _flops(target, name), _cohort_median(
                [_flops(ev, name) for ev in cohort])
            fl = ""
            detail = {"program": name, "new_digests": sorted(new),
                      "cohort_digests": len(c_dig)}
            if t_fl is not None and c_fl:
                rel = (t_fl - c_fl) / c_fl
                fl = f" (cost-analysis flops {rel:+.1%})"
                detail["flops"] = t_fl
                detail["flops_baseline"] = c_fl
            # base score sits above the compile-storm ceiling on
            # purpose: when both fire, the changed PROGRAM is the
            # thing to read first (the storm is usually its symptom)
            findings.append(_finding(
                "program", 3.5 + 0.5 * len(new),
                f"{name}: {len(new)} new HLO digest(s) not in the "
                f"baseline cohort{fl} — the program itself changed "
                "(recompile / fusion / lowering delta)",
                **detail))
        if len(t_dig) > 1:
            findings.append(_finding(
                "program", 2.0 + 0.5 * (len(t_dig) - 1),
                f"{name}: {len(t_dig)} distinct digests WITHIN the run "
                "— a mid-run recompile at one boundary",
                program=name, digests=sorted(t_dig)))
    missing = [n for n in sorted(cohort_names)
               if n not in target["programs"]]
    if missing and target["programs"]:
        findings.append(_finding(
            "program", 1.0 + 0.2 * len(missing),
            f"{len(missing)} baseline compile boundar"
            f"{'y' if len(missing) == 1 else 'ies'} absent from the "
            f"offending run: {', '.join(missing[:4])}"
            f"{'…' if len(missing) > 4 else ''}",
            missing=missing))

    # -- compile counts: backend counter + per-name compile spans
    t_bc = _num(target["counters"].get("backend_compiles"))
    c_bc = _cohort_median([ev["counters"].get("backend_compiles")
                           for ev in cohort])
    if t_bc is not None and c_bc is not None and t_bc - c_bc > 2:
        findings.append(_finding(
            "compile", 2.5 + 0.5 * math.log2(max(t_bc - c_bc, 2)),
            f"backend_compiles {int(t_bc)} vs cohort median {int(c_bc)} "
            f"(+{int(t_bc - c_bc)}) — a retracing/recompile storm, not "
            "an XLA slowdown",
            observed=t_bc, baseline=c_bc))
    for name in sorted(target["compile_spans"]):
        t_n = target["compile_spans"][name]["n"]
        c_n = _cohort_median([ev["compile_spans"].get(name, {}).get("n")
                              for ev in cohort])
        if c_n is not None and t_n - c_n >= 1:
            findings.append(_finding(
                "compile", 1.5 + 0.5 * (t_n - c_n),
                f"{name}: {int(t_n)} compile span(s) vs cohort median "
                f"{int(c_n)} — the step recompiled where the baseline "
                "compiled once",
                span=name, observed=t_n, baseline=c_n))

    # -- cost-analysis flops drift on unchanged-name programs
    for name in sorted(target["programs"]):
        t_fl = _flops(target, name)
        c_fl = _cohort_median([_flops(ev, name) for ev in cohort])
        if t_fl is None or not c_fl:
            continue
        rel = (t_fl - c_fl) / c_fl
        if abs(rel) > 0.05:
            findings.append(_finding(
                "cost", 1.5 + 5.0 * abs(rel),
                f"{name}: cost-analysis flops {rel:+.1%} vs cohort "
                f"median ({t_fl:.3g} vs {c_fl:.3g}) — the program is "
                "doing different work",
                program=name, flops=t_fl, flops_baseline=c_fl))

    # -- dispatch-vs-compute attribution
    t_frac = _num(target["gauges"].get("attrib/dispatch_frac"))
    c_frac = _cohort_median([ev["gauges"].get("attrib/dispatch_frac")
                             for ev in cohort])
    if t_frac is not None and c_frac is not None:
        dpt = (t_frac - c_frac) * 100.0
        if dpt > 3.0:
            findings.append(_finding(
                "attrib", 1.5 + 0.15 * dpt,
                f"dispatch_frac {t_frac:.2f} vs {c_frac:.2f} "
                f"({dpt:+.0f}pt) — the HOST share of the step wall grew; "
                "suspect dispatch overhead / python loop, not the chip",
                observed=t_frac, baseline=c_frac))
    for gname, label in (("attrib/dispatch_ms", "host-dispatch"),
                         ("attrib/compute_ms", "device-compute")):
        t_v = _num(target["gauges"].get(gname))
        c_v = _cohort_median([ev["gauges"].get(gname) for ev in cohort])
        if t_v is None or not c_v:
            continue
        rel = (t_v - c_v) / c_v
        if rel > 0.15:
            findings.append(_finding(
                "attrib", 0.8 + 2.0 * rel,
                f"{gname} {t_v:.3g} vs {c_v:.3g} ({rel:+.1%}) — the "
                f"{label} share of the boundary window grew",
                gauge=gname, observed=t_v, baseline=c_v))

    # -- wall-clock ledger category deltas, gated on
    # IDENTICAL program fingerprints: when the target compiled exactly
    # the digests the cohort compiled (same boundaries, same HLO), the
    # regression cannot be "the program changed" — the wall clock moved
    # between categories instead, and the cumulative ``timeline/*_frac``
    # gauges say from where to where.  On differing programs the
    # program/compile findings above own the diagnosis and a category
    # delta would only restate their symptom, so the section stays
    # silent there (and on pre-ledger runs without the gauges).
    same_programs = bool(target["programs"]) and cohort_has_programs \
        and set(target["programs"]) == cohort_names
    if same_programs:
        for name in cohort_names:
            c_dig = set()
            for ev in cohort:
                c_dig |= _digests(ev, name)
            if _digests(target, name) != c_dig:
                same_programs = False
                break
    if same_programs:
        from hfrep_tpu_torch.obs.timeline import CATEGORIES
        for cat in CATEGORIES:
            gname = f"timeline/{cat}_frac"
            t_v = _num(target["gauges"].get(gname))
            c_v = _cohort_median([ev["gauges"].get(gname)
                                  for ev in cohort])
            if t_v is None or c_v is None:
                continue
            dpt = (t_v - c_v) * 100.0
            # device_compute is the one GOOD category: it shrinking is
            # the symptom the overhead categories' growth explains
            if cat == "device_compute" or dpt <= 2.0:
                continue
            findings.append(_finding(
                "timeline", 1.2 + 0.12 * dpt,
                f"{gname} {t_v:.3f} vs cohort {c_v:.3f} ({dpt:+.0f}pt) "
                f"on an UNCHANGED program — the wall clock moved into "
                f"{cat}, not into different device work",
                gauge=gname, observed=t_v, baseline=c_v))
        t_ov = _num(target["gauges"].get("timeline/overlap_frac"))
        c_ov = _cohort_median([ev["gauges"].get("timeline/overlap_frac")
                               for ev in cohort])
        if t_ov is not None and c_ov is not None \
                and (c_ov - t_ov) * 100.0 > 5.0:
            findings.append(_finding(
                "timeline", 1.2 + 0.12 * (c_ov - t_ov) * 100.0,
                f"timeline/overlap_frac {t_ov:.3f} vs cohort {c_ov:.3f} "
                f"({(t_ov - c_ov) * 100.0:+.0f}pt) — less host work is "
                "hidden behind device execution than the baseline "
                "managed (pipelining regressed)",
                gauge="timeline/overlap_frac", observed=t_ov,
                baseline=c_ov))

    # -- span movers (supporting evidence; per-occurrence mean so a run
    # with more blocks isn't "slower" by volume alone)
    for name in sorted(target["spans"]):
        if name.startswith("compile:"):
            continue            # already attributed above
        t_s = target["spans"][name]
        t_mean = t_s["total_s"] / t_s["n"] if t_s["n"] else None
        c_means = []
        for ev in cohort:
            c = ev["spans"].get(name)
            if c and c["n"]:
                c_means.append(c["total_s"] / c["n"])
        c_mean = _cohort_median(c_means)
        if t_mean is None or not c_mean:
            continue
        rel = (t_mean - c_mean) / c_mean
        if rel > 0.10:
            findings.append(_finding(
                "span", min(0.5 + 1.5 * rel, 2.0),
                f"span {name}: mean {t_mean * 1e3:.3g} ms vs cohort "
                f"{c_mean * 1e3:.3g} ms ({rel:+.1%})",
                span=name, observed_s=t_mean, baseline_s=c_mean))

    # -- headline metric context (ranked low: it restates the gate)
    t_sum = target["summary"]
    for metric, direction in _CONTEXT_METRICS:
        t_v = _num(t_sum.get(metric))
        c_v = _cohort_median([ev["summary"].get(metric) for ev in cohort])
        if t_v is None or not c_v:
            continue
        rel = (t_v - c_v) / abs(c_v)
        worse = rel < -0.02 if direction == "up" else rel > 0.02
        if worse:
            findings.append(_finding(
                "metric", min(0.3 + abs(rel), 1.0),
                f"{metric} {t_v:.6g} vs cohort median {c_v:.6g} "
                f"({rel:+.1%})",
                metric=metric, observed=t_v, baseline=c_v))

    findings = [f for f in findings if f["score"] >= MIN_SCORE]
    findings.sort(key=lambda f: -f["score"])
    findings = findings[: max(1, int(top))]
    for i, f in enumerate(findings, 1):
        f["rank"] = i
    attributed = any(f["kind"] in ("program", "compile", "cost", "attrib",
                                   "timeline")
                     for f in findings)
    return {
        "v": 1,
        "target": {"run_id": target["run_id"],
                   "run_dir": target["run_dir"]},
        "cohort": [{"run_id": ev["run_id"], "run_dir": ev["run_dir"]}
                   for ev in cohort],
        "attributed": attributed,
        "findings": findings,
        "notes": notes,
    }


#: the committed 0-findings snapshot `python -m hfrep_tpu_torch.analysis
#: audit --format sarif` maintains; results carry ``properties.boundary``
_AUDIT_SNAPSHOT = (Path(__file__).resolve().parents[1]
                   / "analysis" / "audit_snapshot.sarif")


def annotate_static_audit(doc: dict, snapshot_path=None) -> dict:
    """When a regressed program boundary also carries an OPEN finding in
    the committed static program audit (JPX rules over the traced
    graphs), add a one-line pointer: a known precision/host-sync/retrace
    defect at the same boundary is usually the cheaper explanation than
    anything runtime telemetry alone can offer.  Joins the diagnosis's
    program-kind findings (``detail.program``, the runtime boundary
    vocabulary) against the snapshot results' ``properties.boundary``
    (the registry label minus its ``@variant``).  Stdlib json only; a
    missing or malformed snapshot annotates nothing."""
    path = Path(snapshot_path) if snapshot_path else _AUDIT_SNAPSHOT
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return doc
    open_rules: Dict[str, set] = {}
    for run in data.get("runs", []) if isinstance(data, dict) else []:
        for res in run.get("results", []):
            b = (res.get("properties") or {}).get("boundary")
            if b:
                open_rules.setdefault(str(b), set()).add(
                    str(res.get("ruleId") or "?"))
    if not open_rules:
        return doc
    hit: Dict[str, set] = {}
    for f in doc.get("findings", []):
        if f.get("kind") != "program":
            continue
        prog = str((f.get("detail") or {}).get("program") or "")
        for b, rules in open_rules.items():
            # serve boundaries profile per batch bucket (serve:replicate:b32)
            if prog == b or prog.startswith(b + ":"):
                hit.setdefault(b, set()).update(rules)
    for b in sorted(hit):
        doc.setdefault("notes", []).append(
            f"static audit: {b} has open {', '.join(sorted(hit[b]))} "
            f"finding(s) in {path.name} — `python -m hfrep_tpu_torch.analysis "
            "audit` before chasing the runtime delta")
    return doc


def explain_runs(cohort_dirs, target_dir, top: int = 10) -> dict:
    """``obs explain RUN_A RUN_B``'s engine: diagnosis of ``target_dir``
    against the baseline cohort (one or more run dirs), annotated with the
    static audit's open findings at its regressed boundaries."""
    target = run_evidence(target_dir)
    cohort = [run_evidence(d) for d in cohort_dirs]
    return annotate_static_audit(diagnose(target, cohort, top=top))


# ------------------------------------------------------------- rendering
_KIND_GLYPH = {"program": "program", "compile": "compile", "cost": "cost",
               "attrib": "attrib", "span": "span", "metric": "metric"}


def render_diagnosis(doc: dict) -> str:
    cohort = ", ".join(c["run_id"] for c in doc["cohort"]) or "(empty)"
    head = (f"obs explain — {doc['target']['run_id']} vs cohort of "
            f"{len(doc['cohort'])} ({cohort})")
    lines = [head]
    if not doc["findings"]:
        lines.append("  no attributable deltas found")
    for f in doc["findings"]:
        glyph = _KIND_GLYPH.get(f["kind"], f["kind"])[:7]
        lines.append(f"  {f['rank']:2d}. [{glyph:7s}] {f['summary']}")
    if not doc["attributed"]:
        lines.append(
            "UNATTRIBUTED: no program-fingerprint, compile-count, "
            "cost-analysis or dispatch-attribution delta survived the "
            "noise floor — the committed evidence cannot localize this "
            "regression (see notes)")
    for n in doc["notes"]:
        lines.append(f"  note: {n}")
    return "\n".join(lines)


# --------------------------------------------- gate --explain integration
def resolve_run_dir(recorded: str, history_path=None) -> Optional[Path]:
    """A history record's ``run_dir`` string → an existing directory, or
    None.  Records store whatever path ingest saw — absolute, cwd-
    relative (the committed fixtures are repo-relative), or a path on a
    host this machine is not — so try as-is, then relative to the repo
    root, then relative to the history file's parent."""
    if not recorded:
        return None
    candidates = [Path(recorded)]
    repo_root = Path(__file__).resolve().parents[2]
    candidates.append(repo_root / recorded)
    if history_path is not None:
        candidates.append(Path(history_path).resolve().parent / recorded)
    for c in candidates:
        if c.is_dir() and ((c / "events.jsonl").exists()
                           or (c / "run.json").exists()):
            return c
    return None


def explain_gate_failure(run_dir, record: dict, records: List[dict],
                         history_path=None, top: int = 10,
                         window: int = 8) -> dict:
    """The ``obs gate --explain`` tail: resolve the baseline cohort —
    the last ``window`` comparable history records whose run dirs still
    exist on disk — and diagnose the offending run against it.  With no
    resolvable cohort the diagnosis says exactly what was missing
    instead of guessing."""
    key = record.get("key") or {}
    cohort_dirs: List[Path] = []
    unresolved = 0
    for rec in reversed(records):
        if rec.get("key") != key:
            continue
        if (rec.get("run_id") == record.get("run_id")
                and rec.get("created_unix") == record.get("created_unix")):
            continue
        d = resolve_run_dir(str(rec.get("run_dir") or ""), history_path)
        if d is None:
            unresolved += 1
            continue
        if d not in cohort_dirs:
            cohort_dirs.append(d)
        if len(cohort_dirs) >= window:
            break
    doc = explain_runs(cohort_dirs, run_dir, top=top)
    if unresolved:
        doc["notes"].append(
            f"{unresolved} comparable history record(s) reference run "
            "dirs not present on this machine (back-filled or foreign-"
            "host records carry no diffable telemetry)")
    if not cohort_dirs:
        doc["attributed"] = False
        doc["notes"].append(
            "no baseline cohort run dir resolvable from the history "
            "index — fingerprint/attrib diffs need the baseline runs' "
            "telemetry on disk")
    return doc


# ------------------------------------------------- history-series report
def history_report(records: List[dict], key: Optional[dict] = None) -> dict:
    """What the committed history STORE alone can and cannot attribute:
    per-metric series (values, worst drop, OLS slope) plus an explicit
    evidence inventory (how many records carry compile counters /
    memory / run dirs with live telemetry).  This is the honest tool
    for the BENCH_r01–r05 question — back-filled stdout records carry
    rates but no fingerprints, and this says so with numbers."""
    from hfrep_tpu_torch.obs.regress import trend_slope

    if key is not None:
        records = [r for r in records if r.get("key") == key]
    by_metric: Dict[str, List[float]] = {}
    for rec in records:
        for m, v in (rec.get("metrics") or {}).items():
            v = _num(v)
            if v is not None:
                by_metric.setdefault(m, []).append(float(v))
    series = {}
    for m, vals in sorted(by_metric.items()):
        base = median(vals)
        slope = trend_slope(vals)
        series[m] = {
            "n": len(vals), "values": vals,
            "median": round(base, 9),
            "min": min(vals), "max": max(vals),
            "slope_per_run": (round(slope, 9) if slope is not None
                              else None),
            "spread_frac": (round((max(vals) - min(vals)) / abs(base), 6)
                            if base else None),
        }
    n = len(records)
    evidence = {
        "records": n,
        "with_backend_compiles": sum(
            1 for r in records
            if _num((r.get("metrics") or {}).get("backend_compiles"))
            is not None),
        "with_memory": sum(
            1 for r in records
            if _num((r.get("metrics") or {}).get(
                "memory_high_water_bytes")) is not None),
        "with_step_percentiles": sum(
            1 for r in records
            if _num((r.get("metrics") or {}).get("step_time_p50_s"))
            is not None),
        "with_resolvable_run_dir": sum(
            1 for r in records
            if resolve_run_dir(str(r.get("run_dir") or "")) is not None),
    }
    return {"v": 1, "key": key, "series": series, "evidence": evidence}


def render_history_report(doc: dict) -> str:
    ev = doc["evidence"]
    lines = [f"history attribution inventory — {ev['records']} record(s)"]
    lines.append(
        f"  evidence: backend_compiles on {ev['with_backend_compiles']}, "
        f"memory on {ev['with_memory']}, step percentiles on "
        f"{ev['with_step_percentiles']}, live run dirs for "
        f"{ev['with_resolvable_run_dir']}")
    for m, s in doc["series"].items():
        slope = ("-" if s["slope_per_run"] is None
                 else f"{s['slope_per_run']:+.4g}/run")
        lines.append(f"  {m:34s} n={s['n']:2d} median {s['median']:.6g} "
                     f"range [{s['min']:.6g}, {s['max']:.6g}] "
                     f"slope {slope}")
    return "\n".join(lines)


# -------------------------------------------------------------- self-test
def fixture_dir() -> Path:
    """The committed two-run explain fixture: a base run and a run with
    a planted regression whose diagnosis is known (new HLO digest at
    ``compile:multi_step``, backend_compiles 1 → 9, dispatch_frac
    +11pt)."""
    from hfrep_tpu_torch.obs.report import fixture_dir as _fx
    return _fx() / "explain"


def self_test() -> int:
    """CI gate for the diagnosis loop (``obs explain --self-test``,
    beside the gate self-test): the
    committed planted regression must produce a ranked diagnosis naming
    the planted causes in a sane order, a base-vs-base diff must stay
    silent, and the JSON document must round-trip.  Pure-JSON result on
    stdout; diagnostics on stderr."""
    fx = fixture_dir()
    try:
        base, bad = fx / "base", fx / "regressed"
        # committed fixtures must be whole — strict parse both streams
        for d in (base, bad):
            if not load_events(d, strict=True):
                raise SchemaError(f"{d}: empty fixture stream")
        doc = explain_runs([base], bad)
        if not doc["findings"]:
            raise SchemaError("planted regression produced no findings")
        if not doc["attributed"]:
            raise SchemaError("planted regression not attributed")
        kinds = {f["kind"] for f in doc["findings"]}
        for want in ("program", "compile", "attrib"):
            if want not in kinds:
                raise SchemaError(
                    f"planted {want} cause missing from diagnosis "
                    f"(kinds: {sorted(kinds)})")
        top_f = doc["findings"][0]
        if top_f["kind"] != "program" \
                or "compile:multi_step" not in top_f["summary"]:
            raise SchemaError(
                "top-ranked finding is not the planted program-"
                f"fingerprint delta: {top_f['summary']!r}")
        scores = [f["score"] for f in doc["findings"]]
        if scores != sorted(scores, reverse=True):
            raise SchemaError("findings not ranked by score")
        if "attrib/dispatch_frac" not in json.dumps(doc) and not any(
                "dispatch_frac" in f["summary"] for f in doc["findings"]):
            raise SchemaError("planted dispatch_frac delta not named")
        # no false positives: a run diffed against itself is silent
        clean = explain_runs([base], base)
        if any(f["kind"] in ("program", "compile", "cost", "attrib")
               for f in clean["findings"]):
            raise SchemaError(
                "base-vs-base diagnosis invented attributed causes: "
                f"{[f['summary'] for f in clean['findings']]}")
        # the document round-trips as one JSON object
        round_tripped = json.loads(json.dumps(doc, default=str))
        if round_tripped["findings"][0]["rank"] != 1:
            raise SchemaError("diagnosis JSON lost its ranking")
    except (OSError, json.JSONDecodeError, SchemaError, KeyError,
            ValueError) as e:
        print(f"obs explain self-test FAILED: {e}", file=sys.stderr)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print("obs explain self-test OK", file=sys.stderr)
    print(json.dumps({
        "ok": True,
        "findings": len(doc["findings"]),
        "attributed": doc["attributed"],
        "top": {"kind": top_f["kind"], "summary": top_f["summary"]},
        "kinds": sorted(kinds),
    }))
    return 0
