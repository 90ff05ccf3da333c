"""Declarative SLOs with multi-window burn-rate alerts over the fleet
(``hfrep_tpu/obs/slo.py``).

The regression gate (:mod:`hfrep_tpu_torch.obs.regress`) answers "did this
run get worse than its own history?"; an SLO answers the operator's
question: "is the fleet inside its error budget *right now*?"  This
module evaluates declarative objectives — p95 latency, shed rate,
error rate — over the time-bucketed rollup segments of every replica
under a fleet root, using the standard multi-window burn-rate scheme:

* **burn rate** = observed value / target.  Burn 1.0 consumes exactly
  the budget; burn 14 pages someone.
* **two windows** per objective: a *fast* window (the last few
  buckets — catches an active incident) and a *slow* window (a longer
  trailing range — rejects blips).  An alert **breaches** only when
  BOTH windows burn ≥ 1.0 (the classic Google SRE workbook reduction);
  fast-only burn is a *warning*.

Objectives are declarative JSON (``slo.json`` at the fleet root, or
``--slos FILE``), defaulting to :data:`DEFAULT_SLOS`:

* ``p95``   — nearest-rank p95 of a rollup histogram vs a target value
  (e.g. ``serve/latency_ms`` ≤ 250 ms);
* ``ratio`` — bad-events / (bad + good) vs a target fraction
  (e.g. shed rate ≤ 5%), counted from the bucketed ``event`` names.

Surfaced through ``obs slo`` (human table + ``--json`` doc + ``slo/*``
gauges for the history store) and ``obs gate --slo`` (exit 1 on any
breach, alongside the per-run regression verdict).  Stdlib-only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

from hfrep_tpu_torch.obs import fleet, rollup

#: fast window = last N buckets, slow window = last M buckets (with the
#: default 60 s buckets: 5 min / 30 min — compressed-time fixtures pass
#: their own)
DEFAULT_FAST_BUCKETS = 5
DEFAULT_SLOW_BUCKETS = 30

SLO_FILE = "slo.json"

#: the serving tier's standing objectives (terminal-outcome event names
#: from serve/server.py; the latency histogram from the request path)
DEFAULT_SLOS: List[dict] = [
    {"name": "serve_latency_p95_ms", "kind": "p95",
     "hist": "serve/latency_ms", "target": 250.0},
    {"name": "serve_shed_rate", "kind": "ratio", "target": 0.05,
     "bad": ["serve_shed"],
     "good": ["serve_complete", "serve_degraded"]},
    {"name": "serve_error_rate", "kind": "ratio", "target": 0.01,
     "bad": ["serve_fault"],
     "good": ["serve_complete", "serve_degraded", "serve_shed"]},
]


def load_slos(path: Optional[str] = None,
              root: Optional[str] = None) -> List[dict]:
    """Objectives from ``--slos FILE``, else ``<root>/slo.json``, else
    the defaults.  Each entry needs ``name``/``kind``/``target``;
    malformed entries fail loud (a silently dropped SLO is an outage
    you stopped watching for)."""
    src = None
    if path is not None:
        src = Path(path)
    elif root is not None and (Path(root) / SLO_FILE).exists():
        src = Path(root) / SLO_FILE
    if src is None:
        return [dict(s) for s in DEFAULT_SLOS]
    slos = json.loads(src.read_text())
    if not isinstance(slos, list):
        raise ValueError(f"{src}: SLO file must be a JSON list")
    for s in slos:
        if not isinstance(s, dict):
            raise ValueError(f"{src}: SLO entries must be objects")
        missing = [k for k in ("name", "kind", "target") if k not in s]
        if missing:
            raise ValueError(f"{src}: SLO {s.get('name')!r} missing "
                             f"{missing}")
        if s["kind"] not in ("p95", "ratio"):
            raise ValueError(f"{src}: SLO {s['name']!r}: unknown kind "
                             f"{s['kind']!r}")
        if s["kind"] == "ratio" and "bad" not in s:
            raise ValueError(f"{src}: ratio SLO {s['name']!r} needs "
                             f"'bad' event names")
    return slos


# ---------------------------------------------------------------- windows
def _window(states: Dict[str, dict], n_buckets: int) -> dict:
    """Fleet-wide fold of each replica's last ``n_buckets`` time
    buckets: event counts summed, histograms merged.  Windows align
    per-replica (each replica's own trailing range) — replica clocks
    are process-relative, not wall-synchronized."""
    events: Dict[str, int] = {}
    hists: Dict[str, dict] = {}
    for state in states.values():
        keys = sorted(state.get("buckets") or {}, key=int)
        for key in keys[-int(n_buckets):]:
            b = state["buckets"][key]
            for name, n in b["events"].items():
                events[name] = events.get(name, 0) + n
            for name, h in b["hists"].items():
                rollup.hist_merge(hists.setdefault(name, rollup.new_hist()),
                                  h)
    return {"events": events, "hists": hists}


def _slo_value(slo: dict, window: dict) -> Optional[float]:
    """The objective's observed value over one window; None = no data
    (no data is *not* a breach — an idle fleet burns no budget)."""
    if slo["kind"] == "p95":
        h = window["hists"].get(slo.get("hist"))
        if not h or not h["n"]:
            return None
        return rollup.hist_percentile(h, 95.0)
    bad = sum(window["events"].get(n, 0) for n in slo.get("bad") or [])
    good = sum(window["events"].get(n, 0) for n in slo.get("good") or [])
    denom = bad + good
    if denom <= 0:
        return None
    return bad / denom


def evaluate(states: Dict[str, dict], slos: Optional[List[dict]] = None,
             *, fast_buckets: int = DEFAULT_FAST_BUCKETS,
             slow_buckets: int = DEFAULT_SLOW_BUCKETS) -> dict:
    """Multi-window burn rates for every objective over the fleet."""
    if slos is None:
        slos = [dict(s) for s in DEFAULT_SLOS]
    fast = _window(states, fast_buckets)
    slow = _window(states, slow_buckets)
    rows = []
    breaches = warnings = 0
    worst = 0.0
    for slo in slos:
        target = float(slo["target"])
        vf = _slo_value(slo, fast)
        vs = _slo_value(slo, slow)
        bf = (vf / target) if (vf is not None and target > 0) else None
        bs = (vs / target) if (vs is not None and target > 0) else None
        breach = bool(bf is not None and bs is not None
                      and bf >= 1.0 and bs >= 1.0)
        warn = bool(not breach and bf is not None and bf >= 1.0)
        breaches += breach
        warnings += warn
        for b in (bf, bs):
            if b is not None and b > worst:
                worst = b
        rows.append({
            "name": slo["name"], "kind": slo["kind"], "target": target,
            "fast": {"value": vf, "burn": bf, "buckets": int(fast_buckets)},
            "slow": {"value": vs, "burn": bs, "buckets": int(slow_buckets)},
            "breach": breach, "warning": warn,
            "no_data": vf is None and vs is None,
        })
    return {"v": 1, "slos": rows, "evaluated": len(rows),
            "breaches": breaches, "warnings": warnings,
            "worst_burn": worst, "ok": breaches == 0}


def render(result: dict) -> str:
    """Human table for ``obs slo``."""
    lines = [f"{'slo':<24} {'target':>10} {'fast':>10} {'slow':>10} "
             f"{'burn(f/s)':>12}  status"]

    def _fmt(v):
        return "-" if v is None else f"{v:.4g}"

    for row in result["slos"]:
        status = ("BREACH" if row["breach"]
                  else "warn" if row["warning"]
                  else "no-data" if row["no_data"] else "ok")
        burn = (f"{_fmt(row['fast']['burn'])}/"
                f"{_fmt(row['slow']['burn'])}")
        lines.append(f"{row['name']:<24} {row['target']:>10.4g} "
                     f"{_fmt(row['fast']['value']):>10} "
                     f"{_fmt(row['slow']['value']):>10} "
                     f"{burn:>12}  {status}")
    lines.append(f"=> {result['breaches']} breach(es), "
                 f"{result['warnings']} warning(s), worst burn "
                 f"{result['worst_burn']:.4g} over "
                 f"{result['evaluated']} objective(s)")
    return "\n".join(lines)


def emit_gauges(sink, result: dict) -> None:
    """``slo/*`` gauges into the ambient obs session (history-gated;
    every name has an explicit threshold row — burn-style gauges must
    not fall through to the inverted suffix fallback)."""
    sink.gauge("slo/evaluated").set(result["evaluated"])
    sink.gauge("slo/breaches").set(result["breaches"])
    sink.gauge("slo/warnings").set(result["warnings"])
    sink.gauge("slo/worst_burn").set(result["worst_burn"])


def evaluate_root(root, *, slos_path: Optional[str] = None,
                  fast_buckets: int = DEFAULT_FAST_BUCKETS,
                  slow_buckets: int = DEFAULT_SLOW_BUCKETS,
                  bucket_secs: float = rollup.DEFAULT_BUCKET_SECS,
                  persist: bool = False) -> dict:
    """One-call evaluation for the CLI: discover → ingest → evaluate,
    with the fleet invariant battery attached (an SLO report that hides
    a ledger deficit would be lying by omission)."""
    states = fleet.fleet_states(root, persist=persist,
                                bucket_secs=bucket_secs)
    slos = load_slos(slos_path, root=str(root))
    result = evaluate(states, slos, fast_buckets=fast_buckets,
                      slow_buckets=slow_buckets)
    result["fleet"] = fleet.invariants(states)
    result["root"] = str(root)
    return result


# -------------------------------------------------------------- self-test
def _fixture_root() -> Path:
    return Path(__file__).resolve().parent / "_fixture" / "fleet"


def self_test() -> int:
    """``obs slo --self-test``: evaluate the committed two-replica fleet
    fixture (read-only — the fixture stays pristine) and assert the
    planted defects are caught:

    * replica_b drained with ``terminal < submitted`` → the fleet
      ledger invariant must report the exact deficit;
    * a shed storm in the trailing buckets → the shed-rate SLO must
      breach on both burn windows;
    * the latency and error-rate objectives are healthy → must NOT
      breach (a self-test that only checks firing alarms would pass
      with an evaluator that breaches everything).

    Pure-JSON verdict on stdout, diagnostics on stderr, exit 0/1.
    """
    root = _fixture_root()
    checks: List[dict] = []

    def check(name: str, ok: bool, detail: str) -> None:
        checks.append({"name": name, "ok": bool(ok), "detail": detail})
        print(f"  {'ok' if ok else 'FAIL'}: {name} ({detail})",
              file=sys.stderr)

    print(f"slo self-test over {root}", file=sys.stderr)
    states = fleet.fleet_states(root, persist=False)
    check("fixture_replicas", len(states) == 2,
          f"discovered {sorted(states)}")
    inv = fleet.invariants(states)
    led = inv["ledger"]
    check("ledger_drop_caught",
          led["deficit"] == 2 and not led["ok"]
          and led["bad_replicas"] == ["replica_b"],
          f"submitted={led['submitted']} terminal={led['terminal']} "
          f"deficit={led['deficit']} bad={led['bad_replicas']}")
    check("ledger_sums",
          led["submitted"] == 74 and led["terminal"] == 72,
          f"{led['submitted']}→{led['terminal']}")

    result = evaluate(states, fast_buckets=2, slow_buckets=5)
    by_name = {r["name"]: r for r in result["slos"]}
    shed = by_name.get("serve_shed_rate") or {}
    check("shed_burn_breach",
          bool(shed.get("breach"))
          and (shed.get("fast") or {}).get("burn", 0) >= 1.0
          and (shed.get("slow") or {}).get("burn", 0) >= 1.0,
          f"fast={_j(shed, 'fast')} slow={_j(shed, 'slow')}")
    lat = by_name.get("serve_latency_p95_ms") or {}
    check("latency_healthy",
          not lat.get("breach") and not lat.get("no_data"),
          f"fast={_j(lat, 'fast')}")
    err = by_name.get("serve_error_rate") or {}
    check("error_rate_healthy",
          not err.get("breach") and not err.get("no_data"),
          f"fast={_j(err, 'fast')}")
    check("totals", result["breaches"] == 1 and not result["ok"],
          f"breaches={result['breaches']} worst={result['worst_burn']:.3g}")

    # read-only contract: evaluating a fixture must not dirty it
    dirty = [str(p) for p in root.rglob("rollup")]
    check("fixture_pristine", not dirty, f"rollup dirs: {dirty}")

    ok = all(c["ok"] for c in checks)
    doc = {"v": 1, "ok": ok, "checks": checks,
           "fleet": {"deficit": led["deficit"],
                     "bad_replicas": led["bad_replicas"]},
           "slo": {"breaches": result["breaches"],
                   "worst_burn": result["worst_burn"]}}
    print(json.dumps(doc, indent=2, sort_keys=True))
    print(f"slo self-test: {'OK' if ok else 'FAIL'} "
          f"({sum(c['ok'] for c in checks)}/{len(checks)})",
          file=sys.stderr)
    return 0 if ok else 1


def _j(row: dict, window: str) -> str:
    w = row.get(window) or {}
    v, b = w.get("value"), w.get("burn")
    return (f"{v:.4g}@burn={b:.3g}" if isinstance(v, float)
            and isinstance(b, float) else "no-data")
