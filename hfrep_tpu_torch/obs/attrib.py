"""Perf microscope, write side: program fingerprints, dispatch-vs-compute
attribution and profiler-trace digestion (``hfrep_tpu/obs/attrib.py``).

* **program fingerprints** — the port compiles no XLA program: its
  programs are the hand-kernel libraries that
  :mod:`hfrep_tpu_torch.ops._build` builds by source hash into
  ``build/cuda/<name>-<hash>.so``.  At each compile boundary the repo
  owns (``instrument_step``'s first call, each bucket of
  ``serve/aot.py::aot_compile``), :func:`profile_boundary` records one
  ``program_profile`` event and one ``run.json`` ``programs`` entry per
  library the process has loaded (``<boundary>:<library>``) and one for
  the boundary itself.  The events keep the JAX field names, so the JAX
  package's ``explain`` reads them, but here they hold library digests:
  ``hlo_sha256`` is the sha256 of the ``.so`` bytes (of the sorted
  ``{library: digest}`` map for the boundary's own entry), ``hlo_bytes``
  its size, ``memory`` the registers, shared memory and spills ptxas
  reported when the library was built (``-Xptxas -v``), and ``cost`` the
  FLOPs of one launch of the boundary where :mod:`~hfrep_tpu_torch.obs.
  flops` counts them (the flagship's training step), else None.  An
  edited ``.cu`` is then a digest the baseline cohort never loaded;
* **dispatch-vs-compute attribution** — :func:`note_dispatch` /
  :func:`flush_window` split an instrumented drive's wall clock into
  host-dispatch time (an eager PyTorch launch returns before the card
  finishes, as a jitted call returns before XLA does) and the residual
  the host spent blocked on the card, measured only at the syncs the
  drives already make (``BlockTimer.stop``, the AE engine's chunk
  flag): no new sync, nothing with telemetry off.  Surfaced as
  ``attrib/{dispatch_ms,compute_ms,dispatch_frac}`` gauges;
* **trace digestion** — :func:`profile_run` parses the ``torch.profiler``
  Chrome traces a run captured (``trace_capture``, ``train-gan
  --profile-dir``: ``trace-<n>.json``) into per-kernel and per-region
  device-time tables with interval-union busy time.  The device work is
  the events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``;
  a JAX trace's ``XLA Ops`` thread is read too.

Reading (trace digestion) is stdlib-only; capturing touches only the
build registry and never raises into the caller.
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import json
import re
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from hfrep_tpu_torch.obs import get_obs

#: the event-stream name program fingerprints land under (the JAX
#: package's; ``obs/explain.py`` and the manifest ``programs`` section
#: are the readers)
PROGRAM_EVENT = "program_profile"

#: Chrome-trace categories of device work in a ``torch.profiler`` trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: the port's named regions: the hand kernels (``csrc/*``) and cuBLAS
PORT_REGIONS = (("lstm_fwd", ("lstm_fwd",)),
                ("lstm_bwd", ("lstm_bwd",)),
                ("lstm_adj", ("lstm_adj",)),
                ("stack_fwd", ("stack_fwd",)),
                ("stack_bwd", ("stack_bwd",)),
                ("stack_adj", ("stack_adj",)),
                ("stack_gates", ("stack_gates",)),
                ("weight_sum", ("weight_sum", "col_sum")),
                ("gemm/matmul", ("gemm", "Gemm", "GEMM", "matmul", "cutlass", "xmma")),
                ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")))


# ------------------------------------------------------ program fingerprints
def fingerprint_bytes(data: Optional[bytes]) -> Optional[str]:
    """sha256 hex digest of a library's bytes: the identity of "the same
    program"."""
    if not data:
        return None
    return hashlib.sha256(data).hexdigest()


_PTXAS_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                         r"(?:, (\d+) bytes smem)?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_memory(log: str) -> Optional[dict]:
    """The registers, shared memory and spills of a library's ``-Xptxas
    -v`` report: the largest register count and static shared memory of
    any kernel, the spill bytes summed over its kernels, and how many
    kernels it holds.  None for an empty report."""
    regs, smem, functions = [], [], 0
    for m in _PTXAS_USED.finditer(log or ""):
        functions += 1
        regs.append(int(m.group(1)))
        smem.append(int(m.group(2) or 0))
    spill_st = spill_ld = 0
    for m in _PTXAS_SPILL.finditer(log or ""):
        spill_st += int(m.group(1))
        spill_ld += int(m.group(2))
    if not functions:
        return None
    return {"kernels": functions, "registers_max": max(regs), "smem_bytes_max": max(smem),
            "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld}


def library_profile(program: str, path, log: str = "") -> dict:
    """The JSON-safe profile of one kernel library file."""
    data = Path(path).read_bytes()
    return {"name": str(program), "hlo_sha256": fingerprint_bytes(data),
            "hlo_bytes": len(data), "cost": None, "memory": ptxas_memory(log)}


def _record(prof: dict) -> None:
    obs = get_obs()
    payload = dict(prof)
    # the boundary name rides as ``program``: the event's own ``name`` is
    # its type tag
    payload["program"] = payload.pop("name")
    obs.event(PROGRAM_EVENT, **payload)
    from hfrep_tpu_torch.obs import manifest
    manifest.add_program(obs.run_dir, prof)


def profile_boundary(boundary: str, flops: Optional[float] = None) -> Optional[List[dict]]:
    """Fingerprint the kernel libraries this process has loaded at a
    compile boundary: one profile a library (``<boundary>:<library>``)
    and one for the boundary (its digest covers every library's; ``cost``
    carries ``flops``, one launch of the boundary, when given).  No-op
    (None) with telemetry off; never raises into the caller."""
    obs = get_obs()
    if not obs.enabled:
        return None
    try:
        from hfrep_tpu_torch.ops import _build

        libs = []
        for name, path in sorted(_build.loaded_paths().items()):
            libs.append(library_profile(f"{boundary}:{name}", path, _build.build_log(name)))
        digests = {p["name"].rsplit(":", 1)[1]: p["hlo_sha256"] for p in libs}
        top = {"name": str(boundary),
               "hlo_sha256": hashlib.sha256(json.dumps(digests, sort_keys=True)
                                            .encode()).hexdigest(),
               "hlo_bytes": sum(p["hlo_bytes"] for p in libs),
               "cost": {"flops": float(flops)} if flops else None,
               "memory": None}
        for prof in libs + [top]:
            _record(prof)
        return libs + [top]
    except Exception:
        return None


# ------------------------------------------- dispatch-vs-compute windows
class _Window:
    """The open attribution window: host-dispatch seconds accumulated per
    step name since the last boundary flush (guarded for the serve
    layer's threads)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.dispatch_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    def note(self, name: str, dur_s: float) -> None:
        with self.lock:
            self.dispatch_s[name] = self.dispatch_s.get(name, 0.0) + dur_s
            self.calls[name] = self.calls.get(name, 0) + 1

    def take(self) -> Tuple[Dict[str, float], Dict[str, int]]:
        with self.lock:
            d, c = self.dispatch_s, self.calls
            self.dispatch_s, self.calls = {}, {}
            return d, c


_WINDOW = _Window()


def note_dispatch(name: str, dur_s: float) -> None:
    """Record one un-blocked call's host-side duration (callers decide on
    ``obs.enabled`` when they build or start a drive, so the off path
    never reaches here).  Pure accumulation: no event, no sync."""
    _WINDOW.note(name, dur_s)


def reset_window() -> None:
    """Discard the open window (a warmup block's dispatch carries the
    kernels' build and would poison the first steady attribution)."""
    _WINDOW.take()


def window_calls() -> int:
    """How many dispatches the open window holds, without draining it."""
    with _WINDOW.lock:
        return sum(_WINDOW.calls.values())


def window_dispatch_s() -> float:
    """The open window's dispatch seconds, without draining it."""
    with _WINDOW.lock:
        return sum(_WINDOW.dispatch_s.values())


def flush_window(wall_s: float, steps: Optional[int] = None,
                 warmup: bool = False, **attrs) -> Optional[dict]:
    """Close the attribution window at a boundary the drive already syncs
    at: the accumulated dispatch seconds split ``wall_s`` into host
    dispatch and device compute.  Emits ``attrib/{dispatch_ms,compute_ms,
    dispatch_frac}`` gauges (a rising fraction means the host, not the
    card, is the bottleneck).  Warmup windows are discarded.  No-op with
    nothing accumulated or telemetry off."""
    dispatch, calls = _WINDOW.take()
    obs = get_obs()
    n_calls = sum(calls.values())
    if not obs.enabled or warmup or not n_calls or not wall_s > 0:
        return None
    dispatch_s = sum(dispatch.values())
    # clamp: on a synchronous device (the CPU) the dispatch is the compute
    # and rounding can push the sum a hair past the wall
    dispatch_s = min(dispatch_s, wall_s)
    compute_s = wall_s - dispatch_s
    frac = dispatch_s / wall_s
    steps_attr = {} if steps is None else {"steps": int(steps)}
    names = ",".join(sorted(calls))
    out = {"dispatch_ms": dispatch_s * 1e3, "compute_ms": compute_s * 1e3,
           "dispatch_frac": frac, "calls": n_calls, "wall_ms": wall_s * 1e3,
           "step": names}
    obs.gauge("attrib/dispatch_ms").set(
        round(dispatch_s * 1e3, 3), step=names, calls=n_calls, **steps_attr, **attrs)
    obs.gauge("attrib/compute_ms").set(
        round(compute_s * 1e3, 3), step=names, calls=n_calls, **steps_attr, **attrs)
    obs.gauge("attrib/dispatch_frac").set(
        round(frac, 6), step=names, calls=n_calls, **steps_attr, **attrs)
    return out


class dispatch_timer:
    """``with dispatch_timer("ae_chunk"): fn(...)`` — time one un-blocked
    dispatch into the open window (the AE engine's chunk loop; the GAN
    steps go through ``instrument_step``'s wrapper)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        note_dispatch(self.name, time.perf_counter() - self._t0)
        return False


# ------------------------------------------------------- trace digestion
class TraceUnavailable(RuntimeError):
    """A run dir carries no digestible profiler trace (the typed skip
    ``obs profile`` renders as a skip document)."""


def find_trace_files(run_dir) -> List[Path]:
    """Every trace-event JSON under the run dir's capture roots: the
    ``traces`` links in ``run.json`` and ``<run_dir>/traces``; the port's
    ``trace-<n>.json`` and the JAX layout's ``*.trace.json[.gz]``."""
    run_dir = Path(run_dir)
    roots = [run_dir / "traces"]
    try:
        doc = json.loads((run_dir / "run.json").read_text())
        for link in doc.get("traces") or []:
            if isinstance(link, dict) and link.get("path"):
                roots.append(Path(str(link["path"])))
    except (OSError, json.JSONDecodeError):
        pass
    out: List[Path] = []
    seen = set()
    for root in roots:
        for pat in ("**/*.trace.json.gz", "**/*.trace.json", "**/trace-*.json"):
            for p in sorted(glob.glob(str(root / pat), recursive=True)):
                if p not in seen:
                    seen.add(p)
                    out.append(Path(p))
    return out


def load_trace_events(path) -> Tuple[List[Tuple[str, float, float]], List[str]]:
    """The device events of one trace: ``([(name, ts_us, dur_us)], sorted
    thread names)``.  Device work is a complete event of category
    ``kernel``, ``gpu_memcpy`` or ``gpu_memset`` (``torch.profiler``), or
    one on a device process's ``XLA Ops`` thread (a JAX capture)."""
    path = Path(path)
    opener = gzip.open if path.name.endswith(".gz") else open
    with opener(path, "rt") as fh:
        tr = json.load(fh)
    ev = tr.get("traceEvents", []) if isinstance(tr, dict) else []
    pid_name, tid_name = {}, {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_name[e.get("pid")] = (e.get("args") or {}).get("name", "")
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_name[(e.get("pid"), e.get("tid"))] = (e.get("args") or {}).get("name", "")
    dev_pids = {p for p, n in pid_name.items()
                if "TPU" in str(n).upper() or "device" in str(n).lower()}
    op_tids = {pt for pt, n in tid_name.items() if pt[0] in dev_pids and "XLA Ops" in str(n)}
    out = []
    for e in ev:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS or (e.get("pid"), e.get("tid")) in op_tids:
            try:
                out.append((str(e.get("name", "")), float(e["ts"]), float(e.get("dur", 0.0))))
            except (KeyError, TypeError, ValueError):
                continue
    return out, sorted({str(n) for n in tid_name.values()})


def interval_union_s(events) -> float:
    """Union length of the events' ``[ts, ts+dur)`` intervals in seconds:
    device busy time without double-counting overlapping kernels."""
    ivs = sorted((ts, ts + d) for _, ts, d in events if d > 0)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in ivs:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total * 1e-6                                   # us -> s


def op_table(events, top: int = 20) -> List[dict]:
    """Per-kernel time table (summed durations, comparable between
    kernels; the union above is the honest total), largest first."""
    by_op: Dict[str, List[float]] = {}
    for name, _, dur in events:
        by_op.setdefault(name, [0.0, 0])
        by_op[name][0] += dur * 1e-6
        by_op[name][1] += 1
    rows = [{"op": n, "total_s": round(v[0], 9), "n": int(v[1])} for n, v in by_op.items()]
    rows.sort(key=lambda r: -r["total_s"])
    return rows[: max(0, int(top))] if top else rows


def region_table(events, regions=PORT_REGIONS) -> List[dict]:
    """Named-region busy time: the interval union over the events whose
    name carries any of the region's substrings."""
    out = []
    for label, needles in regions:
        matched = [e for e in events if any(n in e[0] for n in needles)]
        if matched:
            out.append({"region": label, "busy_s": round(interval_union_s(matched), 9),
                        "n": len(matched)})
    out.sort(key=lambda r: -r["busy_s"])
    return out


def _wall_s(path) -> Optional[float]:
    """The traced wall: first event start to last event end, any thread."""
    try:
        with (gzip.open if str(path).endswith(".gz") else open)(path, "rt") as fh:
            ev = json.load(fh).get("traceEvents", [])
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in ev if e.get("ph") == "X" and "ts" in e]
    except (OSError, ValueError, TypeError, KeyError, AttributeError):
        return None
    if not spans:
        return None
    return (max(b for _, b in spans) - min(a for a, _ in spans)) * 1e-6


def profile_run(run_dir, top: int = 20) -> dict:
    """Digest every trace a run captured into one per-kernel/per-region
    time document.  Raises :class:`TraceUnavailable` when the run carries
    no digestible trace."""
    run_dir = Path(run_dir)
    files = find_trace_files(run_dir)
    if not files:
        raise TraceUnavailable(
            f"{run_dir}: no trace-event JSON under traces/ or the manifest's trace "
            "links (trace_capture and --profile-dir are opt-in)")
    captures = []
    parsed_any = False
    for f in files:
        try:
            events, threads = load_trace_events(f)
        except (OSError, json.JSONDecodeError, EOFError) as e:
            captures.append({"file": str(f), "error": str(e)})
            continue
        parsed_any = True
        wall = _wall_s(f)
        captures.append({
            "file": str(f),
            "n_events": len(events),
            "busy_s": round(interval_union_s(events), 9),
            "wall_s": None if wall is None else round(wall, 9),
            "ops": op_table(events, top=top),
            "regions": region_table(events),
            "threads": threads,
        })
    if not parsed_any:
        raise TraceUnavailable(
            f"{run_dir}: {len(files)} trace file(s) present but none parsed as "
            "trace-event JSON")
    return {"run_dir": str(run_dir), "n_traces": len(files), "captures": captures}


def render_profile(doc: dict) -> str:
    """Human rendering of :func:`profile_run`'s document."""
    lines = [f"trace profile — {doc['run_dir']} ({doc['n_traces']} capture(s))"]
    for cap in doc["captures"]:
        if "error" in cap:
            lines.append(f"  {cap['file']}: unreadable ({cap['error']})")
            continue
        lines.append(f"  {cap['file']}")
        wall = cap.get("wall_s")
        of = f" of {wall * 1e3:.3f} ms traced" if wall else ""
        lines.append(f"    device busy {cap['busy_s'] * 1e3:.3f} ms{of} "
                     f"(interval union over {cap['n_events']} device events)")
        for r in cap["regions"]:
            lines.append(f"    region {r['region']:16s} {r['busy_s'] * 1e3:10.3f} ms  "
                         f"(n={r['n']})")
        for row in cap["ops"][:10]:
            lines.append(f"    op {row['op'][:48]:48s} {row['total_s'] * 1e3:10.3f} ms  "
                         f"(n={row['n']})")
    return "\n".join(lines)


# ------------------------------------------------------------- CLI entry
def profile_main(run_dir, top: int = 20, fmt: str = "human") -> int:
    """``obs profile RUN_DIR``: exit 0 with a table or JSON document, or a
    typed skip document (still exit 0: an un-profiled run is a fact)."""
    import sys
    try:
        doc = profile_run(run_dir, top=top)
    except TraceUnavailable as e:
        if fmt == "json":
            print(json.dumps({"run_dir": str(run_dir), "skipped": str(e)}))
        else:
            print(f"profile skipped: {e}", file=sys.stderr)
        return 0
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if fmt == "json":
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(render_profile(doc))
    return 0
