"""Fleet watcher: cross-replica invariants over a tree of run dirs
(``hfrep_tpu/obs/fleet.py``).

N serve replicas behind one admission tier, or a market-replay daemon,
are long-lived *fleets*: many run dirs under one
root, each with its own event stream, whose core guarantees only mean
anything summed across replicas while they run.  This module discovers
every run dir under a fleet root (serve replicas, actor pods — whose
members already stream into ``<run>/actors/<name>`` — scenario
daemons), folds each through the durable rollup consumer
(:mod:`hfrep_tpu_torch.obs.rollup`), and continuously evaluates:

* **ledger conservation** — fleet-wide ``terminal == submitted`` over
  every drained replica's authoritative ``serve_drain`` counts: a
  nonzero deficit is a silently dropped request *somewhere* in the
  fleet, the one invariant the whole serving tier is built around;
* **breaker state** — the per-replica circuit-breaker table
  (``serve_breaker_open``/``serve_breaker_close``), so "how many
  replicas are degraded right now" is one number;
* **restart storms** — ``actor_restart`` bursts (≥ *k* restarts inside
  one window) that per-run telemetry shows only as isolated events.

``obs export --fleet ROOT`` serves the whole thing as ONE federated
Prometheus exposition: every replica's rolled-up instruments labeled
``{replica="..."}`` plus the fleet-level ``hfrep_fleet_*`` gauges.
Stdlib-only, like the rest of the obs read path.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from hfrep_tpu_torch.obs import rollup
from hfrep_tpu_torch.obs.report import EVENTS_NAME
from hfrep_tpu_torch.obs.tail import _prom_name

#: ≥ this many restarts inside one storm window = a restart storm
DEFAULT_STORM_RESTARTS = 3
DEFAULT_STORM_WINDOW_S = 60.0


def discover(root) -> List[Path]:
    """Every run dir under ``root``, recursively: any directory holding
    an ``events.jsonl`` (the same shape contract as multi-host proc
    dirs).  Actor member dirs (``<run>/actors/<name>``) qualify on
    their own — their streams are separate by design."""
    root = Path(root)
    if (root / EVENTS_NAME).exists():
        return [root]
    return sorted(p.parent for p in root.rglob(EVENTS_NAME))


def replica_label(root, run_dir) -> str:
    root, run_dir = Path(root), Path(run_dir)
    try:
        rel = run_dir.relative_to(root)
    except ValueError:
        return run_dir.name
    return str(rel) if str(rel) != "." else run_dir.name


def fleet_states(root, *, persist: bool = False,
                 bucket_secs: float = rollup.DEFAULT_BUCKET_SECS,
                 ) -> Dict[str, dict]:
    """label -> rolled-up state for every discovered replica.
    ``persist=True`` advances each replica's durable cursors (the
    continuous-watch mode); ``persist=False`` folds read-only (one-shot
    export, self-tests over committed fixtures)."""
    out: Dict[str, dict] = {}
    for run_dir in discover(root):
        state, _ = rollup.ingest(run_dir, bucket_secs=bucket_secs,
                                 persist=persist)
        out[replica_label(root, run_dir)] = state
    return out


def _storm(times: List[float], restarts: int, window_s: float) -> bool:
    if len(times) < restarts:
        return False
    times = sorted(times)
    return any(times[i + restarts - 1] - times[i] <= window_s
               for i in range(len(times) - restarts + 1))


def invariants(states: Dict[str, dict], *,
               storm_restarts: int = DEFAULT_STORM_RESTARTS,
               storm_window_s: float = DEFAULT_STORM_WINDOW_S) -> dict:
    """The cross-replica invariant battery over rolled-up states."""
    submitted = terminal = 0
    drained, pending, bad_replicas = [], [], []
    breaker_table: Dict[str, dict] = {}
    restarts_total = 0
    storms: List[str] = []
    by_replica: Dict[str, int] = {}
    for label in sorted(states):
        facts = states[label].get("facts") or rollup._new_facts()
        drain = facts.get("serve_drain")
        if drain is not None:
            s, t = rollup._num(drain.get("submitted")), \
                rollup._num(drain.get("terminal"))
            if s is not None and t is not None:
                drained.append(label)
                submitted += int(s)
                terminal += int(t)
                if int(s) != int(t):
                    bad_replicas.append(label)
        elif (facts.get("breaker", {}).get("opens")
              or _has_serve_traffic(states[label])):
            # a serve replica that never drained: ledger still open
            pending.append(label)
        b = facts.get("breaker") or {}
        if b.get("opens") or b.get("closes"):
            breaker_table[label] = {
                "state": b.get("state"), "opens": b.get("opens"),
                "closes": b.get("closes"),
                "last_reason": b.get("last_reason")}
        r = facts.get("restarts") or {}
        n = int(r.get("n") or 0)
        if n:
            restarts_total += n
            by_replica[label] = n
            if _storm(list(r.get("t") or []), storm_restarts,
                      storm_window_s):
                storms.append(label)
    deficit = submitted - terminal
    ledger_ok = deficit == 0 and not bad_replicas
    return {
        "v": 1,
        "replicas": len(states),
        "ledger": {"drained": len(drained), "pending": len(pending),
                   "submitted": submitted, "terminal": terminal,
                   "deficit": deficit, "bad_replicas": bad_replicas,
                   "ok": ledger_ok},
        "breakers": {
            "open": sum(1 for b in breaker_table.values()
                        if b["state"] == "open"),
            "table": breaker_table},
        "restarts": {"total": restarts_total, "storms": storms,
                     "by_replica": by_replica},
        "ok": ledger_ok and not storms,
    }


def _has_serve_traffic(state: dict) -> bool:
    tot = rollup.totals(state)
    if "serve/latency_ms" in tot["hists"]:
        return True
    return any(name.startswith("serve_") for name in tot["events"])


# ------------------------------------------------------------- exposition
def _esc(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(states: Dict[str, dict],
                    inv: Optional[dict] = None) -> str:
    """One federated exposition: every replica's rollup totals labeled
    ``{replica="..."}``, then the fleet-level invariant gauges."""
    if inv is None:
        inv = invariants(states)
    gauges: Dict[str, List] = {}
    counters: Dict[str, List] = {}
    hists: Dict[str, List] = {}
    for label in sorted(states):
        tot = rollup.totals(states[label])
        for k, g in tot["gauges"].items():
            v = rollup._num(g.get("last"))
            if v is not None:
                gauges.setdefault(k, []).append((label, v))
        for k, c in tot["counters"].items():
            v = rollup._num(c.get("last"))
            if v is not None:
                counters.setdefault(k, []).append((label, v))
        for k, h in tot["hists"].items():
            hists.setdefault(k, []).append((label, h))
    lines = []
    for name in sorted(gauges):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        for label, v in gauges[name]:
            lines.append(f'{pname}{{replica="{_esc(label)}"}} {v}')
    for name in sorted(counters):
        pname = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pname} counter")
        for label, v in counters[name]:
            lines.append(f'{pname}{{replica="{_esc(label)}"}} {v}')
    for name in sorted(hists):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for label, h in hists[name]:
            for le, cum in rollup.hist_cumulative(h):
                lines.append(f'{pname}_bucket{{replica="{_esc(label)}",'
                             f'le="{le}"}} {cum}')
            lines.append(f'{pname}_count{{replica="{_esc(label)}"}} '
                         f'{h["n"]}')
            lines.append(f'{pname}_sum{{replica="{_esc(label)}"}} '
                         f'{h["sum"]}')
    fleet_gauges = [
        ("hfrep_fleet_replicas", inv["replicas"]),
        ("hfrep_fleet_submitted", inv["ledger"]["submitted"]),
        ("hfrep_fleet_terminal", inv["ledger"]["terminal"]),
        ("hfrep_fleet_ledger_deficit", inv["ledger"]["deficit"]),
        ("hfrep_fleet_ledger_pending", inv["ledger"]["pending"]),
        ("hfrep_fleet_breakers_open", inv["breakers"]["open"]),
        ("hfrep_fleet_restarts", inv["restarts"]["total"]),
        ("hfrep_fleet_restart_storms", len(inv["restarts"]["storms"])),
    ]
    for pname, v in fleet_gauges:
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {v}")
    return "\n".join(lines) + "\n"


def emit_gauges(sink, inv: dict) -> None:
    """Narrate one watch pass into the ambient obs session (``fleet/*``
    gauges ride the history store through the regression gate — every
    name here has an explicit ``regress.DEFAULT_THRESHOLDS`` row)."""
    sink.gauge("fleet/replicas").set(inv["replicas"])
    sink.gauge("fleet/submitted").set(inv["ledger"]["submitted"])
    sink.gauge("fleet/terminal").set(inv["ledger"]["terminal"])
    sink.gauge("fleet/ledger_deficit").set(inv["ledger"]["deficit"])
    sink.gauge("fleet/breakers_open").set(inv["breakers"]["open"])
    sink.gauge("fleet/restarts").set(inv["restarts"]["total"])
    sink.gauge("fleet/restart_storms").set(len(inv["restarts"]["storms"]))


def watch(root, *, interval: float = 5.0,
          iterations: Optional[int] = None, out: Optional[str] = None,
          bucket_secs: float = rollup.DEFAULT_BUCKET_SECS,
          persist: bool = True, sink=None) -> dict:
    """The continuous mode: ingest → invariants → exposition, forever
    (or ``iterations`` passes).  ``out`` atomically republishes the
    exposition each pass (a node-exporter-style textfile target)."""
    inv: dict = {}
    passes = 0
    while True:
        states = fleet_states(root, persist=persist,
                              bucket_secs=bucket_secs)
        inv = invariants(states)
        if sink is not None:
            emit_gauges(sink, inv)
        text = prometheus_text(states, inv)
        if out is not None:
            rollup._publish_bytes(Path(out), text.encode())
        print(f"fleet {root}: {inv['replicas']} replicas, ledger "
              f"{inv['ledger']['submitted']}→{inv['ledger']['terminal']} "
              f"(deficit {inv['ledger']['deficit']}), "
              f"{inv['breakers']['open']} breaker(s) open, "
              f"{len(inv['restarts']['storms'])} storm(s)",
              file=sys.stderr)
        passes += 1
        if iterations is not None and passes >= iterations:
            return inv
        try:
            time.sleep(max(0.05, float(interval)))
        except KeyboardInterrupt:
            return inv


def export_fleet_main(root, *, out: Optional[str] = None,
                      watch_iterations: Optional[int] = None,
                      interval: float = 5.0,
                      persist: bool = False) -> int:
    """``obs export --fleet ROOT`` entry: one-shot federated exposition
    (or a bounded watch loop with ``--watch N``)."""
    if not discover(root):
        print(f"no {EVENTS_NAME} under {root}", file=sys.stderr)
        return 1
    if watch_iterations is not None:
        watch(root, interval=interval, iterations=watch_iterations,
              out=out, persist=persist)
        return 0
    states = fleet_states(root, persist=persist)
    inv = invariants(states)
    text = prometheus_text(states, inv)
    if out is None:
        sys.stdout.write(text)
    else:
        rollup._publish_bytes(Path(out), text.encode())
    return 0


def fleet_json(root, *, persist: bool = False) -> dict:
    """The invariant battery as one JSON doc (the ``obs slo`` CLI and
    the self-test embed it)."""
    states = fleet_states(root, persist=persist)
    return dict(invariants(states), root=str(root))
