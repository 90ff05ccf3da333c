"""Wall-clock ledger: conservation-law time accounting for every drive
(``hfrep_tpu/obs/timeline.py``).

Every millisecond of an instrumented drive's wall time is assigned to
exactly one category of :data:`CATEGORIES`, and

    Σ(category ms) == window wall ms

is the ledger's invariant.  Three moving parts:

* **the accumulator** — a lock-guarded, per-process category ledger fed
  by :func:`timed` / :func:`account` / :func:`note_obs_self`.  Nested
  :func:`timed` frames account EXCLUSIVE (self) time, so nesting can
  never double-count.  Pure host-side arithmetic: no events, no syncs.
* **window flushes** — :func:`flush_window` closes the ledger at a
  boundary the drive already synchronises at (the trainer's block stop,
  the AE engine's chunk boundary), emitting one ``timeline_window``
  event plus cumulative ``timeline/*`` gauges.  The residual ``wall −
  Σ(measured)`` lands in ``unattributed``, never negative (oversums are
  proportionally clamped and flagged).  The boundary's synchronisation
  is MEASURED here (``device_compute``: host time blocked on the card),
  not added.
* **reconstruction** — :func:`build_trace` renders a run dir's event
  stream as a Chrome-trace/perfetto ``trace.json``, and
  :func:`ledger_from_events` re-derives the whole-run ledger from the
  ``timeline_window`` records.  Both read only the records compaction
  keeps verbatim (:func:`hfrep_tpu_torch.obs.rollup.pin_record`), so
  their output is byte-identical on a rotated and compacted run dir and
  on the raw original, and is the JAX module's byte for byte.

Call sites time through :func:`clock` / :func:`stopwatch` / :func:`timed`
so measured wall time stays inside the plane; all three work with
telemetry off (:func:`timed` still measures; it just books nothing).

:class:`BlockTimer` closes the dispatch attribution window
(:mod:`hfrep_tpu_torch.obs.attrib`) at each block and hands its dispatch
seconds to the ledger's ``dispatch`` category.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from hfrep_tpu_torch.core.device import DeviceLike
from hfrep_tpu_torch.obs import get_obs
from hfrep_tpu_torch.obs.report import EVENTS_NAME, SchemaError, load_events
from hfrep_tpu_torch.obs.rollup import pin_record

#: every ledger category, in rendering order.  ``device_compute`` is host
#: time measurably blocked on the device (boundary syncs); ``dispatch``
#: un-blocked launch time (a first call's kernel build included);
#: ``checkpoint`` snapshot/checkpoint persistence, ``host_io`` every
#: other instrumented host I/O, ``queue_wait`` backpressure and
#: empty-queue waits, ``obs_self`` the telemetry layer's own emit cost,
#: and ``unattributed`` the non-negative residual that closes the books.
CATEGORIES = ("device_compute", "dispatch", "host_io", "checkpoint",
              "queue_wait", "obs_self", "unattributed")

#: conservation tolerance: |Σ(cat) − wall| per window, as a fraction of
#: wall (plus an absolute 0.5 ms floor for micro-windows)
CONSERVATION_REL_TOL = 0.01
CONSERVATION_ABS_TOL_MS = 0.5

#: the ``self_test`` gate's ceiling on ``timeline/obs_self_frac``
OBS_SELF_FRAC_MAX = 0.01


def clock() -> float:
    """The sanctioned monotonic wall-clock read (seconds; differences only)."""
    return time.perf_counter()


# ---------------------------------------------------------- accumulator
class _Frame:
    __slots__ = ("child",)

    def __init__(self):
        self.child = 0.0


class _Ledger:
    """Per-process category accumulator.  ``window`` holds seconds since
    the last flush; ``cum``/``cum_wall`` the whole-run totals behind the
    cumulative gauges; the overlap pair accumulates over steady windows
    only.  The lock guards totals (the serve layer's workers); the frame
    stack is thread-local."""

    def __init__(self):
        self.lock = threading.Lock()
        self.window: Dict[str, float] = {}
        self.cum: Dict[str, float] = {}
        self.cum_wall = 0.0
        self.overlap_host = 0.0
        self.sync_wait = 0.0
        self._tls = threading.local()

    def frames(self) -> List[_Frame]:
        st = getattr(self._tls, "frames", None)
        if st is None:
            st = self._tls.frames = []
        return st

    def add(self, category: str, seconds: float) -> None:
        with self.lock:
            self.window[category] = self.window.get(category, 0.0) + seconds

    def take(self) -> Dict[str, float]:
        with self.lock:
            w, self.window = self.window, {}
            return w


_LEDGER = _Ledger()


def reset() -> None:
    """Drop all accumulated state (a fresh ``obs.enable`` arms a fresh run)."""
    global _LEDGER
    _LEDGER = _Ledger()


def account(category: str, seconds: float) -> None:
    """Book ``seconds`` of already-measured wall time to ``category``;
    inside an open :func:`timed` frame the time is moved, not duplicated."""
    if seconds <= 0.0:
        return
    frames = _LEDGER.frames()
    if frames:
        frames[-1].child += seconds
    _LEDGER.add(category, seconds)


def note_sync(seconds: float) -> None:
    """Host time blocked on the device at a boundary the drive already
    pays (a device-to-host copy): the ``device_compute`` category."""
    account("device_compute", seconds)


def note_obs_self(seconds: float) -> None:
    """``Obs._emit``'s self-measurement hook (the ``obs_self`` category)."""
    account("obs_self", seconds)


class stopwatch:
    """``with stopwatch() as sw: ...; sw.s`` — measurement, no booking."""

    s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self._t0
        return False


class timed:
    """``with timed("checkpoint") as tm: ...; tm.s`` — measure AND book the
    block's EXCLUSIVE time to a category (nested frames subtract
    cleanly).  Books nothing when ``category`` is falsy."""

    s = 0.0

    def __init__(self, category: Optional[str], **_attrs):
        self.category = category

    def __enter__(self):
        self._frame = _Frame()
        _LEDGER.frames().append(self._frame)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self.s = dur
        frames = _LEDGER.frames()
        frames.pop()
        if self.category:
            _LEDGER.add(self.category, max(0.0, dur - self._frame.child))
            if frames:
                frames[-1].child += dur
        elif frames:
            frames[-1].child += self._frame.child
        return False


def flush_window(wall_s: float, *, drive: str, steps: Optional[int] = None,
                 warmup: bool = False, dispatch_s: Optional[float] = None,
                 sync_wait_s: Optional[float] = None, **attrs
                 ) -> Optional[dict]:
    """Close the ledger window against a synchronised wall clock.

    ``wall_s`` spans the window; ``dispatch_s`` the attribution window's
    un-blocked dispatch seconds; ``sync_wait_s`` the measured host block
    at the boundary sync (→ ``device_compute``).  Emits ONE
    ``timeline_window`` event — Σ(``cat_ms``) == ``wall_ms`` exactly,
    oversums clamped and flagged — plus the cumulative
    ``timeline/*_frac`` gauges and ``timeline/overlap_frac`` over steady
    windows, ``(wall − sync) / wall``.  With telemetry off the window is
    discarded.  Never raises into a drive."""
    cats = _LEDGER.take()
    obs = get_obs()
    if not obs.enabled or not wall_s > 0:
        return None
    try:
        if dispatch_s:
            cats["dispatch"] = cats.get("dispatch", 0.0) + float(dispatch_s)
        if sync_wait_s:
            cats["device_compute"] = (cats.get("device_compute", 0.0)
                                      + float(sync_wait_s))
        measured = sum(cats.values())
        oversum = measured > wall_s * (1.0 + CONSERVATION_REL_TOL)
        if oversum and measured > 0:
            scale = wall_s / measured
            cats = {k: v * scale for k, v in cats.items()}
            measured = wall_s
        unattributed = max(0.0, wall_s - measured)
        cat_ms = {c: round(cats.get(c, 0.0) * 1e3, 3) for c in CATEGORIES
                  if c != "unattributed"}
        # close the books exactly: unattributed is the rounded residual
        wall_ms = round(wall_s * 1e3, 3)
        cat_ms["unattributed"] = max(
            0.0, round(wall_ms - sum(cat_ms.values()), 3))
        overlap = None
        if sync_wait_s is not None:
            overlap = max(0.0, wall_s - float(sync_wait_s)) / wall_s
        obs.event("timeline_window", drive=drive, wall_ms=wall_ms,
                  cat_ms=cat_ms, steps=steps, warmup=bool(warmup),
                  oversum=bool(oversum),
                  overlap_frac=(None if overlap is None else round(overlap, 6)),
                  **attrs)
        with _LEDGER.lock:
            for c, v in cats.items():
                _LEDGER.cum[c] = _LEDGER.cum.get(c, 0.0) + v
            _LEDGER.cum["unattributed"] = (_LEDGER.cum.get("unattributed", 0.0)
                                           + unattributed)
            _LEDGER.cum_wall += wall_s
            if not warmup and sync_wait_s is not None:
                _LEDGER.overlap_host += max(0.0, wall_s - float(sync_wait_s))
                _LEDGER.sync_wait += float(sync_wait_s)
            cum, cum_wall = dict(_LEDGER.cum), _LEDGER.cum_wall
            o_host, o_sync = _LEDGER.overlap_host, _LEDGER.sync_wait
        for c in CATEGORIES:
            obs.gauge(f"timeline/{c}_frac").set(
                round(cum.get(c, 0.0) / cum_wall, 6), drive=drive)
        obs.gauge("timeline/wall_ms").set(round(cum_wall * 1e3, 3), drive=drive)
        if o_host + o_sync > 0:
            obs.gauge("timeline/overlap_frac").set(
                round(o_host / (o_host + o_sync), 6), drive=drive)
        return {"wall_ms": wall_ms, "cat_ms": cat_ms, "oversum": oversum,
                "overlap_frac": overlap}
    except Exception:       # telemetry must never kill a drive
        return None


# ----------------------------------------------------------- BlockTimer
class BlockTimer:
    """Device-synced step timing and the ledger's block boundary: one
    sample a window, ``(n_steps, seconds, warmup)``, a warmup-aware
    :attr:`steps_per_sec`, and with telemetry on a ``block`` span, the
    ``step_time`` histogram and one :func:`flush_window` a window.

    On a card :meth:`stop` calls ``torch.cuda.synchronize`` first (the
    boundary's price, measured into ``device_compute``), so a window
    holds the device work enqueued in it and not just its launches."""

    def __init__(self, device: DeviceLike = None, drive: str = "gan_block") -> None:
        self.device = torch.device("cuda" if device is None else device)
        self.drive = drive
        self.samples: List[tuple] = []      # (n_steps, secs, warmup)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, warmup: bool = False) -> float:
        """Close one window.  ``warmup=True`` marks a sample that carries
        a first call's build (excluded from :attr:`steps_per_sec` when
        steady samples exist; its ledger window still flushes)."""
        sync_s = None
        if self.device.type == "cuda":
            t_sync = time.perf_counter()
            torch.cuda.synchronize(self.device)
            sync_s = time.perf_counter() - t_sync
        dt = time.perf_counter() - self._t0
        self.samples.append((n_steps, dt, warmup))
        obs = get_obs()
        if obs.enabled:
            obs.record_span("block", dt, steps=int(n_steps), warmup=bool(warmup),
                            synced=sync_s is not None)
            if n_steps > 0:
                obs.histogram("step_time").observe(dt / n_steps, warmup=bool(warmup))
            from hfrep_tpu_torch.obs import attrib
            if warmup or sync_s is None:
                # a first call's build, or a wall with no sync in it: either
                # would lie in the dispatch-vs-compute split, so the
                # attribution window is discarded; the ledger still owes
                # its dispatch seconds to a category
                disp = attrib.window_dispatch_s()
                attrib.reset_window()
                flush_window(dt, drive=self.drive, steps=int(n_steps), warmup=True,
                             dispatch_s=disp, sync_wait_s=sync_s)
            else:
                out = attrib.flush_window(dt, steps=int(n_steps))
                flush_window(dt, drive=self.drive, steps=int(n_steps),
                             dispatch_s=(out or {}).get("dispatch_ms", 0.0) / 1e3,
                             sync_wait_s=sync_s)
        return dt

    @property
    def steps_per_sec(self) -> float:
        """Steady-state rate (warmup samples excluded when possible);
        ``nan`` on zero-duration windows rather than dividing by zero."""
        steady = [(n, t) for n, t, w in self.samples if not w]
        samples = steady or [(n, t) for n, t, _ in self.samples]
        steps = sum(n for n, _ in samples)
        secs = sum(t for _, t in samples)
        return steps / secs if secs > 0.0 else float("nan")

    def reset(self) -> None:
        self.samples.clear()


# ------------------------------------------------------- reconstruction
def _trace_records(run_dir) -> List[dict]:
    return [r for r in load_events(run_dir) if pin_record(r)]


def build_trace(run_dir, records: Optional[List[dict]] = None) -> str:
    """Chrome-trace/perfetto JSON (trace-event format) for one run dir:
    spans become complete ("X") slices ending at their emit time, events
    instants ("i"), ``timeline_window`` records per-category counter
    ("C") tracks, ``memory`` snapshots a high-water counter.  Sorted
    keys and fixed separators, so byte equality is meaningful."""
    if records is None:
        records = _trace_records(run_dir)
    out: List[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": f"hfrep run {Path(run_dir).name}"}},
    ]
    for rec in records:
        t_us = round(float(rec["t"]) * 1e6, 1)
        attrs = {k: v for k, v in rec.items()
                 if k not in ("v", "t", "type", "name", "dur", "depth")
                 and v is not None}
        if rec["type"] == "span":
            dur_us = round(float(rec["dur"]) * 1e6, 1)
            out.append({"ph": "X", "pid": 1,
                        "tid": 1 + int(rec.get("depth") or 0),
                        "name": str(rec["name"]),
                        "ts": round(t_us - dur_us, 1), "dur": dur_us,
                        "args": attrs})
        elif rec["type"] == "event":
            name = str(rec["name"])
            out.append({"ph": "i", "pid": 1, "tid": 0, "name": name,
                        "ts": t_us, "s": "p", "args": attrs})
            if name == "timeline_window" and isinstance(rec.get("cat_ms"), dict):
                wall = rec.get("wall_ms")
                ts0 = (round(t_us - float(wall) * 1e3, 1)
                       if isinstance(wall, (int, float)) else t_us)
                out.append({"ph": "C", "pid": 1, "tid": 0,
                            "name": f"ledger:{rec.get('drive')}",
                            "ts": ts0, "args": {
                                c: rec["cat_ms"].get(c, 0.0)
                                for c in CATEGORIES}})
        elif rec["type"] == "memory":
            out.append({"ph": "C", "pid": 1, "tid": 0, "name": "memory",
                        "ts": t_us,
                        "args": {"high_water": rec.get("high_water")}})
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def _window_ok(w: dict) -> bool:
    wall = float(w.get("wall_ms") or 0.0)
    total = sum(float(w["cat_ms"].get(c, 0.0) or 0.0) for c in CATEGORIES)
    return abs(total - wall) <= max(CONSERVATION_ABS_TOL_MS, wall * CONSERVATION_REL_TOL)


def ledger_from_events(records: List[dict]) -> dict:
    """Fold a run's ``timeline_window`` records into the whole-run
    ledger.  Run time the windows do not cover (instrumentation gaps, a
    torn tail) degrades into ``uncovered_ms`` and a larger effective
    ``unattributed``; per-window conservation is re-checked."""
    windows = [r for r in records
               if r["type"] == "event" and r.get("name") == "timeline_window"
               and isinstance(r.get("cat_ms"), dict)]
    cats = {c: 0.0 for c in CATEGORIES}
    wall_ms = 0.0
    max_residual = 0.0
    oversums = 0
    o_host_ms = 0.0
    o_sync_ms = 0.0
    for w in windows:
        cm = w["cat_ms"]
        ww = float(w.get("wall_ms") or 0.0)
        wall_ms += ww
        total = 0.0
        for c in CATEGORIES:
            v = float(cm.get(c, 0.0) or 0.0)
            cats[c] += v
            total += v
        max_residual = max(max_residual, abs(total - ww))
        if w.get("oversum"):
            oversums += 1
        if not w.get("warmup") and isinstance(w.get("overlap_frac"), (int, float)):
            sync = max(0.0, ww * (1.0 - float(w["overlap_frac"])))
            o_sync_ms += sync
            o_host_ms += ww - sync
    ts = [float(r["t"]) for r in records]
    run_ms = (max(ts) - min(ts)) * 1e3 if ts else 0.0
    uncovered_ms = max(0.0, run_ms - wall_ms)
    denom = wall_ms + uncovered_ms
    fracs = {c: (cats[c] / denom if denom > 0 else 0.0) for c in CATEGORIES}
    fracs["unattributed"] = ((cats["unattributed"] + uncovered_ms) / denom
                             if denom > 0 else 0.0)
    return {
        "windows": len(windows),
        "wall_ms": round(wall_ms, 3),
        "run_span_ms": round(run_ms, 3),
        "uncovered_ms": round(uncovered_ms, 3),
        "categories_ms": {c: round(v, 3) for c, v in cats.items()},
        "fracs": {c: round(v, 6) for c, v in fracs.items()},
        "overlap_frac": (round(o_host_ms / (o_host_ms + o_sync_ms), 6)
                         if (o_host_ms + o_sync_ms) > 0 else None),
        "oversum_windows": oversums,
        "conservation": {
            "max_residual_ms": round(max_residual, 3),
            "ok": all(_window_ok(w) for w in windows),
        },
    }


def render_ledger(doc: dict) -> str:
    lines = [f"timeline ledger — {doc['windows']} window(s), "
             f"{doc['wall_ms']:.1f} ms covered of "
             f"{doc['run_span_ms']:.1f} ms run span "
             f"({doc['uncovered_ms']:.1f} ms uncovered)"]
    for c in CATEGORIES:
        lines.append(f"  {c:16s} {doc['categories_ms'][c]:>12.1f} ms  "
                     f"{doc['fracs'][c] * 100:6.2f}%")
    ov = doc.get("overlap_frac")
    lines.append("  overlap_frac     "
                 + (f"{ov * 100:6.2f}%" if ov is not None else "     -"))
    cons = doc["conservation"]
    lines.append(f"  conservation     max residual {cons['max_residual_ms']}"
                 f" ms — {'OK' if cons['ok'] else 'VIOLATED'}"
                 + (f" ({doc['oversum_windows']} oversum window(s) clamped)"
                    if doc["oversum_windows"] else ""))
    return "\n".join(lines)


# ---------------------------------------------------------------- CLI
def timeline_main(run_dir, out: Optional[str] = None, fmt: str = "human") -> int:
    """Print a run dir's ledger (``fmt`` "human" or "json"), and with
    ``out`` write its perfetto trace; 0 when every window conserves."""
    try:
        records = _trace_records(run_dir)
    except (OSError, SchemaError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if out:
        trace = build_trace(run_dir, records)
        tmp = Path(out).with_name(Path(out).name + ".tmp")
        tmp.write_text(trace)
        tmp.replace(out)
        print(f"wrote {out} ({len(trace)} bytes, {len(records)} records)",
              file=sys.stderr)
    doc = ledger_from_events(records)
    if fmt == "json":
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(render_ledger(doc))
    return 0 if doc["conservation"]["ok"] else 1


# ------------------------------------------------------------ self-test
def fixture_dir() -> Path:
    """The port's copy of the committed timeline fixture, a run dir whose
    ledger was computed by hand (the numbers in :func:`self_test` are
    typed in, not derived)."""
    return Path(__file__).resolve().parent / "_fixture" / "timeline"


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SchemaError(msg)


def self_test() -> int:
    """The accumulator's conservation algebra, the hand-computed fixture
    ledger, the compaction byte-identity discipline, torn-tail
    degradation and the ``obs_self_frac`` < 1% ceiling.  JSON on stdout,
    diagnostics on stderr, 0/1."""
    import shutil
    import tempfile

    from hfrep_tpu_torch.obs import rollup, session
    try:
        # nested timed() books exclusive time; account() inside a frame
        # moves, never duplicates
        reset()
        with timed("host_io"):
            time.sleep(0.002)
            with timed("checkpoint"):
                time.sleep(0.002)
            account("queue_wait", 0.001)
        snap = dict(_LEDGER.window)
        total = sum(snap.values())
        _expect(snap.get("checkpoint", 0.0) > 0 and snap.get("host_io", 0.0) > 0,
                f"nested categories missing: {snap}")
        _expect(snap["queue_wait"] == 0.001, "account() lost seconds")
        outer_wall = snap["host_io"] + snap["checkpoint"] + snap["queue_wait"]
        _expect(total <= outer_wall + 1e-9, f"nesting double-counted: {snap}")
        # oversum clamp: booked 3x the wall → flagged, Σ == wall
        with tempfile.TemporaryDirectory() as td:
            with session(Path(td) / "run", manifest=False):
                account("host_io", 0.3)
                w = flush_window(0.1, drive="selftest", sync_wait_s=0.0)
            _expect(w is not None and w["oversum"], f"oversum not flagged: {w}")
            _expect(abs(sum(w["cat_ms"].values()) - w["wall_ms"]) <= 0.01,
                    f"clamped window does not conserve: {w}")
            live = ledger_from_events(load_events(Path(td) / "run", strict=True))
            _expect(live["windows"] == 1 and live["conservation"]["ok"],
                    f"live round-trip failed: {live}")

        # the committed fixture, against HAND-COMPUTED numbers: three
        # 1000 ms windows (1 warmup + 2 steady) over a 3100 ms run span
        fx = fixture_dir()
        doc = ledger_from_events(load_events(fx, strict=True))
        _expect(doc["windows"] == 3, f"fixture windows {doc['windows']}")
        _expect(doc["wall_ms"] == 3000.0, f"wall {doc['wall_ms']}")
        _expect(doc["run_span_ms"] == 3100.0 and doc["uncovered_ms"] == 100.0,
                f"span {doc['run_span_ms']} uncovered {doc['uncovered_ms']}")
        want = {"device_compute": 1500.0, "dispatch": 1000.0, "checkpoint": 180.0,
                "host_io": 100.0, "queue_wait": 60.0, "obs_self": 17.0,
                "unattributed": 143.0}
        for c, v in want.items():
            _expect(doc["categories_ms"][c] == v, f"{c} {doc['categories_ms']}")
        _expect(doc["conservation"]["ok"] and doc["oversum_windows"] == 0,
                f"fixture conservation: {doc['conservation']}")
        # overlap over the two steady windows: 700 / (700 + 1300)
        _expect(doc["overlap_frac"] == 0.35, f"overlap {doc['overlap_frac']}")
        obs_self_frac = doc["fracs"]["obs_self"]
        _expect(obs_self_frac < OBS_SELF_FRAC_MAX,
                f"obs_self_frac {obs_self_frac} >= {OBS_SELF_FRAC_MAX}")
        _expect(doc["fracs"]["unattributed"] < 0.10,
                f"unattributed_frac {doc['fracs']['unattributed']}")

        # compaction equivalence: rotate and compact a copy of the same
        # basename (the trace embeds the run dir's name), byte-equal trace
        raw = build_trace(fx)
        with tempfile.TemporaryDirectory() as td:
            cp = Path(td) / fx.name
            shutil.copytree(fx, cp)
            rollup.compact(cp, force_rotate=True)
            _expect(build_trace(cp) == raw, "trace bytes differ on the compacted dir")
            # torn tail: a kill mid-write drops the final window; the
            # ledger shrinks its covered set and grows unattributed
            tp = Path(td) / "torn"
            shutil.copytree(fx, tp)
            lines = (tp / EVENTS_NAME).read_text().splitlines(keepends=True)
            (tp / EVENTS_NAME).write_text(
                "".join(lines[:-2]) + lines[-2][: len(lines[-2]) // 2])
            torn_doc = ledger_from_events(load_events(tp))
            _expect(torn_doc["windows"] < doc["windows"], "torn tail did not drop a window")
            _expect(torn_doc["conservation"]["ok"], "torn ledger violates conservation")
            _expect(torn_doc["fracs"]["unattributed"] >= doc["fracs"]["unattributed"],
                    "torn ledger did not degrade toward unattributed")
    except (OSError, json.JSONDecodeError, SchemaError, KeyError) as e:
        print(f"obs timeline self-test FAILED: {e}", file=sys.stderr)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    finally:
        reset()
    print("obs timeline self-test OK", file=sys.stderr)
    print(json.dumps({
        "ok": True,
        "fixture": {"windows": doc["windows"], "wall_ms": doc["wall_ms"],
                    "obs_self_frac": obs_self_frac,
                    "unattributed_frac": doc["fracs"]["unattributed"],
                    "overlap_frac": doc["overlap_frac"]},
        "compaction_byte_identical": True,
        "torn_tail": {"windows": torn_doc["windows"],
                      "unattributed_frac": torn_doc["fracs"]["unattributed"]},
    }))
    return 0
