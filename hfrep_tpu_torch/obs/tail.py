"""The live plane: ``obs tail`` (follow a running run dir) + ``obs
export`` (Prometheus-exposition snapshots) (``hfrep_tpu/obs/tail.py``).

The report CLI answers questions *after* a run; ``tail`` answers "is
this run diverging / shedding / breaker-open RIGHT NOW".  It
follows every ``events*.jsonl`` under the given run dir(s) — the
supervisor's stream plus its actors', a server's stream, a trainer's —
torn-tail-tolerantly (only complete lines are consumed; a partial final
line waits for its newline, exactly the property the buffered writer
guarantees) and renders a refreshing one-screen summary: recent
steps/sec from ``block`` spans, the latest ``health/*`` gauges, queue
depth, shed/deadline counts, circuit-breaker state, event totals.

``export`` writes the same aggregate as a Prometheus exposition-format
text snapshot (gauges, counters as ``_total``, histogram p50/p95/max),
name-sanitized under the ``hfrep_`` prefix — the hand-off point for
external scrapers until a real HTTP exporter is worth its dependencies.

Everything here is stdlib-only, like the rest of the obs read path.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

#: recent-window length for the live steps/sec estimate (block spans)
_RECENT_BLOCKS = 8

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


class TailAggregate:
    """Incremental consumer of event records → the live-view state."""

    def __init__(self):
        self.gauges: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.hists: Dict[str, dict] = {}
        self.events: Dict[str, int] = {}
        self.n_records = 0
        self.last_t = 0.0
        self.last_event: Optional[str] = None
        self.breaker: Optional[str] = None
        self.blocks: List[Tuple[float, float]] = []   # (steps, dur)
        self.run_end = False

    def consume(self, rec: dict) -> None:
        self.n_records += 1
        t = rec.get("t")
        if isinstance(t, (int, float)):
            self.last_t = max(self.last_t, float(t))
        rtype = rec.get("type")
        if rtype == "metric":
            name, value = str(rec.get("name")), rec.get("value")
            if rec.get("kind") == "gauge":
                if isinstance(value, (int, float)):
                    self.gauges[name] = float(value)
            elif rec.get("kind") == "counter":
                if isinstance(value, (int, float)):
                    self.counters[name] = float(value)
            elif rec.get("kind") == "histogram":
                # the full log-bucket accumulator (same math as the
                # in-process obs.Histogram), not just count/sum/max —
                # the Prometheus exposition derives real cumulative
                # _bucket{le=...} series from it
                from hfrep_tpu_torch.obs import rollup as _rollup
                h = self.hists.setdefault(name, _rollup.new_hist())
                if isinstance(value, (int, float)):
                    _rollup.hist_observe(h, value)
        elif rtype == "span":
            if rec.get("name") == "block" and rec.get("steps"):
                try:
                    self.blocks.append((float(rec["steps"]),
                                        float(rec["dur"])))
                except (TypeError, ValueError):
                    pass
                self.blocks = self.blocks[-_RECENT_BLOCKS:]
        elif rtype == "event":
            name = str(rec.get("name"))
            self.events[name] = self.events.get(name, 0) + 1
            self.last_event = name
            if name == "serve_breaker_open":
                self.breaker = "open"
            elif name == "serve_breaker_close":
                self.breaker = "closed"
            elif name == "run_end":
                self.run_end = True
                summary = rec.get("summary") or {}
                for k, v in (summary.get("gauges") or {}).items():
                    if isinstance(v, (int, float)):
                        self.gauges.setdefault(str(k), float(v))

    # ------------------------------------------------------------ derived
    def steps_per_sec(self) -> Optional[float]:
        if not self.blocks:
            return None
        steps = sum(s for s, _ in self.blocks)
        secs = sum(d for _, d in self.blocks)
        return steps / secs if secs > 0 else None

    def queue_depth(self) -> Optional[float]:
        for name in ("orchestrate/queue_depth", "serve/queue_depth"):
            if name in self.gauges:
                return self.gauges[name]
        return None


def _fmt(v, digits: int = 2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e9:
        return str(int(v))
    return f"{v:.{digits}f}" if isinstance(v, float) else str(v)


def render_frame(aggs: Dict[str, TailAggregate], width: int = 78) -> str:
    """One screen: per-stream-root sections, health and serving state
    called out, everything else summarized."""
    lines = [f"flight recorder — {time.strftime('%H:%M:%S')}"]
    for label, agg in sorted(aggs.items()):
        status = "ended" if agg.run_end else "live"
        lines.append(f"[{label}]  {status}  t={agg.last_t:.1f}s  "
                     f"{agg.n_records} records")
        sps = agg.steps_per_sec()
        if sps is not None:
            lines.append(f"  steps/sec (recent): {sps:.1f}")
        health = {k: v for k, v in agg.gauges.items()
                  if k.startswith("health/")}
        if health:
            lines.append("  health: " + "  ".join(
                f"{k[len('health/'):]}={_fmt(v, 4)}"
                for k, v in sorted(health.items())))
        depth = agg.queue_depth()
        if depth is not None:
            lines.append(f"  queue depth: {_fmt(depth)}")
        serve_bits = []
        if "serve/shed_rate" in agg.gauges:
            serve_bits.append(f"shed_rate={agg.gauges['serve/shed_rate']}")
        for ev in ("serve_shed", "serve_deadline_miss", "serve_degraded"):
            if agg.events.get(ev):
                serve_bits.append(f"{ev.split('serve_')[-1]}={agg.events[ev]}")
        if agg.breaker is not None:
            serve_bits.append(f"breaker={agg.breaker}")
        if serve_bits:
            lines.append("  serving: " + "  ".join(serve_bits))
        faults = {k: v for k, v in agg.events.items()
                  if k in ("numeric_fault", "fault_injected", "io_retry",
                           "preempt_requested", "actor_restart",
                           "crash_bundle")}
        if faults:
            lines.append("  faults: " + "  ".join(
                f"{k}={v}" for k, v in sorted(faults.items())))
        if agg.last_event:
            lines.append(f"  last event: {agg.last_event}")
    return "\n".join(ln[:width] for ln in lines)


# ------------------------------------------------------------- following
class _StreamFollower:
    """Offset-tracking reader of one JSONL file: consumes only complete
    (newline-terminated) lines, so a writer's torn tail is simply
    re-read on the next poll when the rest of the line lands."""

    def __init__(self, path: Path):
        self.path = path
        self.offset = 0

    def poll(self) -> List[dict]:
        out = []
        try:
            with open(self.path) as fh:
                fh.seek(self.offset)
                chunk = fh.read()
        except OSError:
            return out
        end = chunk.rfind("\n")
        if end < 0:
            return out
        for line in chunk[: end + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                    # mid-file garbage: skip a line
            if isinstance(rec, dict):
                out.append(rec)
        self.offset += end + 1
        return out


def _stream_label(path: Path, roots: List[Path]) -> str:
    # rollup chunks/pins are earlier bytes of their run dir's live
    # stream — fold them under the run's label, not a "rollup" row
    parent = path.parent
    if parent.name == "rollup":
        parent = parent.parent
    for root in roots:
        try:
            rel = parent.relative_to(root)
        except ValueError:
            continue
        return root.name if str(rel) in ("", ".") else str(rel)
    return str(parent)


def _discover(run_dirs: List[Path]) -> List[Path]:
    from hfrep_tpu_torch.obs.report import is_stream_file
    out = []
    for d in run_dirs:
        # real streams only: a crash bundle's events_tail.jsonl is a
        # copy of stream tails and would double-count every record.
        # Rollup chunks/pins are earlier bytes of those same streams
        # (writer rotation / compaction evidence) — follow them too, so
        # a long soak's tail/export doesn't go blind at the first
        # rotation.  Fully-compacted aggregates live in rollup
        # state.json; `export --fleet` is the reader for those.
        streams = sorted(f for f in d.rglob("events*.jsonl")
                         if is_stream_file(f))
        for f in streams:
            if f.name == "events.jsonl":
                from hfrep_tpu_torch.obs import rollup as _rollup
                out.extend(_rollup.pinned_files(f.parent))
                out.extend(_rollup.chunk_files(f.parent))
            out.append(f)
    return out


def tail_main(run_dirs, interval: float = 1.0, once: bool = False,
              max_frames: Optional[int] = None,
              out=None) -> int:
    """Follow the run dirs until interrupted (or ``once``/``max_frames``
    for scripting); returns 0.  ``out`` defaults to stdout."""
    out = out or sys.stdout
    roots = [Path(d) for d in run_dirs]
    followers: Dict[Path, _StreamFollower] = {}
    aggs: Dict[str, TailAggregate] = {}
    frames = 0
    clear = not once and out is sys.stdout and out.isatty()
    while True:
        for path in _discover(roots):
            if path not in followers:
                followers[path] = _StreamFollower(path)
        for path, follower in followers.items():
            label = _stream_label(path, roots)
            agg = aggs.setdefault(label, TailAggregate())
            for rec in follower.poll():
                agg.consume(rec)
        if not aggs:
            aggs["(no streams yet)"] = TailAggregate()
        frame = render_frame(aggs)
        if clear:
            out.write("\x1b[2J\x1b[H")
        out.write(frame + "\n")
        out.flush()
        frames += 1
        if once or (max_frames is not None and frames >= max_frames):
            return 0
        try:
            time.sleep(max(0.05, float(interval)))
        except KeyboardInterrupt:
            return 0


# ------------------------------------------------------------ Prometheus
def _prom_name(name: str) -> str:
    return "hfrep_" + _PROM_BAD.sub("_", str(name))


def prometheus_text(aggs: Dict[str, TailAggregate]) -> str:
    """One exposition-format document over every stream, labeled by
    stream root (``{stream="..."}``)."""
    gauges: Dict[str, List[Tuple[str, float]]] = {}
    counters: Dict[str, List[Tuple[str, float]]] = {}
    hists: Dict[str, List[Tuple[str, dict]]] = {}
    for label, agg in sorted(aggs.items()):
        for k, v in agg.gauges.items():
            gauges.setdefault(k, []).append((label, v))
        for k, v in agg.counters.items():
            counters.setdefault(k, []).append((label, v))
        for k, h in agg.hists.items():
            hists.setdefault(k, []).append((label, h))
    lines = []

    def esc(label: str) -> str:
        return label.replace("\\", "\\\\").replace('"', '\\"')

    for name in sorted(gauges):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        for label, v in gauges[name]:
            lines.append(f'{pname}{{stream="{esc(label)}"}} {v}')
    for name in sorted(counters):
        pname = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pname} counter")
        for label, v in counters[name]:
            lines.append(f'{pname}{{stream="{esc(label)}"}} {v}')
    for name in sorted(hists):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for label, h in hists[name]:
            # proper cumulative buckets from the log-bucket accumulator:
            # le = each bucket's exact upper edge (10**((idx+1)/100)),
            # zero/negative samples folded in from the smallest bucket
            # up, closed by the mandatory le="+Inf" = _count
            from hfrep_tpu_torch.obs import rollup as _rollup
            for le, cum in _rollup.hist_cumulative(h):
                lines.append(f'{pname}_bucket{{stream="{esc(label)}",'
                             f'le="{le}"}} {cum}')
            lines.append(
                f'{pname}_count{{stream="{esc(label)}"}} {h["n"]}')
            lines.append(f'{pname}_sum{{stream="{esc(label)}"}} {h["sum"]}')
            if h["max"] is not None:
                lines.append(
                    f'{pname}_max{{stream="{esc(label)}"}} {h["max"]}')
    return "\n".join(lines) + "\n"


def export_main(run_dirs, out: Optional[str] = None) -> int:
    """Read the run dirs to completion and emit one Prometheus snapshot
    (stdout, or ``out`` via tmp + atomic rename)."""
    roots = [Path(d) for d in run_dirs]
    aggs: Dict[str, TailAggregate] = {}
    for path in _discover(roots):
        agg = aggs.setdefault(_stream_label(path, roots), TailAggregate())
        for rec in _StreamFollower(path).poll():
            agg.consume(rec)
    if not aggs:
        print(f"no events*.jsonl under {', '.join(map(str, run_dirs))}",
              file=sys.stderr)
        return 1
    text = prometheus_text(aggs)
    if out is None:
        sys.stdout.write(text)
        return 0
    dst = Path(out)
    tmp = dst.with_name(dst.name + f".tmp-{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, dst)
    return 0
