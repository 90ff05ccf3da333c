"""Tracing, metrics and the event stream of the port
(``hfrep_tpu/obs/__init__.py``).

One telemetry subsystem behind the trainer, the replication engine, the
resilience layer and the actor fabric:

* **spans** — ``with obs.span("train"): ...``, nested; ``sync_on=`` a
  CUDA tensor synchronises its device before the clock stops, so a span
  holds the device work enqueued in it and not just its launches;
* **metrics** — one registry of counters, gauges and log-bucket
  histograms;
* **the wall-clock ledger** — :mod:`hfrep_tpu_torch.obs.timeline`;
* **device facts and memory snapshots** — :mod:`hfrep_tpu_torch.obs.device`
  (``torch.cuda``);
* **run manifests** — ``run.json`` (:mod:`hfrep_tpu_torch.obs.manifest`).

The stream is the JAX package's schema v1, record for record:
``<run_dir>/events.jsonl``, one JSON object a line,
``{"v": 1, "t": <seconds since run start>, "type": ...}`` with the types
of :data:`EVENT_TYPES`, so the JAX package's readers (``report``,
``timeline``) read a port run dir.

No-op when disabled: the module singleton starts as :data:`NULL` and
every hook costs one attribute check while telemetry is off.  Telemetry
is host-side only; enabling it changes no kernel launch and no result.

Past ``HFREP_OBS_ROTATE_BYTES`` the writer rotates its live stream into
the rollup tier's next chunk (:mod:`hfrep_tpu_torch.obs.rollup`), as the
JAX module does.  An exception escaping :func:`session` lands a crash
bundle (:mod:`hfrep_tpu_torch.obs.crash`), and :func:`instrument_step`
feeds the dispatch attribution window and fingerprints the kernel
libraries at its first call (:mod:`hfrep_tpu_torch.obs.attrib`).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import IO, Dict, List, Optional

SCHEMA_VERSION = 1

#: every ``"type"`` the event stream may carry
EVENT_TYPES = ("span", "metric", "memory", "event")

#: log-bucket resolution of the streaming histogram: buckets per decade
#: (~2.3% relative bucket width)
_HIST_BUCKETS_PER_DECADE = 100


def _json_safe(v):
    """Best-effort conversion so telemetry can never crash a run."""
    if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
        return None          # keep the stream strict JSON (no bare NaN)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:
        import numpy as np
        if isinstance(v, (np.generic, np.ndarray)) and np.ndim(v) == 0:
            return np.asarray(v).item()
    except Exception:
        pass
    if hasattr(v, "dim") and hasattr(v, "item"):       # a 0-d torch tensor
        try:
            if v.dim() == 0:
                return _json_safe(v.item())
        except Exception:
            pass
    return str(v)


def _sync(sync_on) -> bool:
    """Synchronise the CUDA device of every tensor in ``sync_on`` (a
    tensor, or a list/tuple/dict of them); True when one was on a card."""
    stack, devices = [sync_on], set()
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif getattr(getattr(x, "device", None), "type", None) == "cuda":
            devices.add(x.device)
    if not devices:
        return False
    import torch
    for d in devices:
        torch.cuda.synchronize(d)
    return True


# ------------------------------------------------------------- instruments
class Counter:
    """Monotonic count; every ``inc`` also lands in the event stream."""

    def __init__(self, obs: "Obs", name: str):
        self._obs, self.name, self.value = obs, name, 0

    def inc(self, n: int = 1, **attrs) -> None:
        self.value += n
        self._obs._emit({"type": "metric", "kind": "counter",
                         "name": self.name, "value": self.value,
                         "delta": n, **_json_safe(attrs)})


class Gauge:
    """Last-value-wins measurement (memory bytes, steps/sec, queue depth)."""

    def __init__(self, obs: "Obs", name: str):
        self._obs, self.name, self.value = obs, name, None

    def set(self, v, **attrs) -> None:
        self.value = _json_safe(v)
        self._obs._emit({"type": "metric", "kind": "gauge",
                         "name": self.name, "value": self.value,
                         **_json_safe(attrs)})


class Histogram:
    """Bounded log-bucket streaming accumulator: every ``observe`` lands
    in the stream as one metric line, the registry keeps sparse bucket
    counts and exact n/sum/min/max.  Nearest-rank percentiles come back
    as the holding bucket's geometric midpoint, clamped to [min, max]."""

    def __init__(self, obs: "Obs", name: str):
        self._obs, self.name = obs, name
        self.counts: Dict[int, int] = {}    # log-bucket index -> count
        self.n = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._n_zero = 0                    # exactly-0.0 samples
        self._n_neg = 0                     # negative and non-finite samples

    def observe(self, v: float, **attrs) -> None:
        v = float(v)
        self.n += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if v > 0.0 and math.isfinite(v):
            idx = math.floor(math.log10(v) * _HIST_BUCKETS_PER_DECADE)
            self.counts[idx] = self.counts.get(idx, 0) + 1
        elif v == 0.0:
            self._n_zero += 1
        else:
            self._n_neg += 1
        self._obs._emit({"type": "metric", "kind": "histogram",
                         "name": self.name, "value": v,
                         **_json_safe(attrs)})

    def percentile(self, pct: float) -> Optional[float]:
        """Nearest-rank percentile (rank ``ceil(pct/100 · n)``), resolved
        to the holding bucket's representative value."""
        if self.n == 0:
            return None
        rank = max(1, math.ceil(self.n * float(pct) / 100.0))
        acc = self._n_neg
        if rank <= acc:
            return self.min
        acc += self._n_zero
        if rank <= acc:
            return 0.0
        for idx in sorted(self.counts):
            acc += self.counts[idx]
            if rank <= acc:
                lo = 10.0 ** (idx / _HIST_BUCKETS_PER_DECADE)
                hi = 10.0 ** ((idx + 1) / _HIST_BUCKETS_PER_DECADE)
                rep = math.sqrt(lo * hi)
                return min(max(rep, self.min), self.max)
        return self.max


class _NullInstrument:
    """Counter/Gauge/Histogram stand-in when telemetry is off."""

    name, value, samples = "null", 0, ()

    def inc(self, n: int = 1, **attrs) -> None: pass
    def set(self, v, **attrs) -> None: pass
    def observe(self, v: float, **attrs) -> None: pass


_NULL_INSTRUMENT = _NullInstrument()
_NULL_CTX = contextlib.nullcontext()


# ------------------------------------------------- hooks of the analysis tier
def _crash_bundle(obs: "Obs", exc: BaseException) -> None:
    """The flight recorder's black box (``obs.crash.write_crash_bundle``)."""
    from hfrep_tpu_torch.obs import crash
    crash.write_crash_bundle(obs, exc)


def _note_dispatch(name: str, seconds: float) -> None:
    """The dispatch attribution window (``obs.attrib.note_dispatch``)."""
    from hfrep_tpu_torch.obs import attrib
    attrib.note_dispatch(name, seconds)


# --------------------------------------------------------------- the sink
class Obs:
    """An enabled telemetry sink bound to one run directory.

    Constructed via :func:`enable` (which also writes the run manifest);
    all writes go through :meth:`_emit`, which must never raise into the
    training loop.
    """

    enabled = True

    def __init__(self, run_dir, flush_every: int = 32,
                 rotate_bytes: Optional[int] = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.events_path = self.run_dir / "events.jsonl"
        self._rotate_previous_run()
        self._fh: Optional[IO] = open(self.events_path, "a")
        if rotate_bytes is None:
            try:
                rotate_bytes = int(os.environ.get("HFREP_OBS_ROTATE_BYTES") or 0)
            except ValueError:
                rotate_bytes = 0
        self._rotate_bytes = max(0, int(rotate_bytes))
        # fault-injection hook for the append stream (io_fail@obs_append=N):
        # None unless a plan is active, so the per-emit cost stays one `if`;
        # a malformed HFREP_FAULTS spec raises here
        from hfrep_tpu_torch.resilience import io_hook
        self._io_fault = io_hook("obs_append")
        self._flush_every = max(1, flush_every)
        # every _emit times its own body into the ledger's `obs_self`
        # category, so the obs layer's cost is measured by the plane it feeds
        from hfrep_tpu_torch.obs import timeline as _timeline
        self._timeline = _timeline
        self._t0 = time.perf_counter()
        self._stack: List[str] = []          # open span names (nesting)
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._n_events = 0

    # ------------------------------------------------------------- plumbing
    def _rotate_previous_run(self) -> None:
        """A run dir holds ONE run: a previous non-empty stream is rotated
        aside to ``events-<n>.jsonl`` (a restarted actor's stream among
        them); readers of the live run read only ``events.jsonl``."""
        try:
            if not (self.events_path.exists()
                    and self.events_path.stat().st_size > 0):
                return
            n = 1
            while (self.run_dir / f"events-{n}.jsonl").exists():
                n += 1
            self.events_path.rename(self.run_dir / f"events-{n}.jsonl")
        except OSError:
            pass

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def _emit(self, rec: dict) -> None:
        if self._fh is None:
            return
        t_emit = time.perf_counter()
        rec = {"v": SCHEMA_VERSION, "t": round(self.now(), 6), **rec}
        try:
            if self._io_fault is not None:
                self._io_fault()
            self._fh.write(json.dumps(rec, default=str) + "\n")
            self._n_events += 1
            if self._n_events % self._flush_every == 0:
                self._fh.flush()
                if self._rotate_bytes and self._fh.tell() >= self._rotate_bytes:
                    self._rotate_live()
        except (OSError, ValueError):       # telemetry must not kill a run
            pass
        finally:
            self._timeline.note_obs_self(time.perf_counter() - t_emit)

    def _rotate_live(self) -> None:
        """Writer-side rotation: flush and close the live stream, rename it
        to the rollup tier's next chunk (``rollup/chunk-<n>.jsonl``, which
        ``obs compact`` folds into segments and pinned evidence), reopen a
        fresh one.  Only the writer can do this safely: an external rename
        would leave this process appending to the renamed file through its
        held handle.  Best-effort like every telemetry write: the worst
        failure leaves the stream unrotated."""
        fh, self._fh = self._fh, None
        try:
            fh.flush()
            fh.close()
        except OSError:
            pass
        try:
            from hfrep_tpu_torch.obs import rollup as _rollup
            chunk_dir = self.run_dir / _rollup.ROLLUP_DIR
            chunk_dir.mkdir(parents=True, exist_ok=True)
            if self.events_path.exists() and self.events_path.stat().st_size > 0:
                self.events_path.rename(
                    chunk_dir / f"chunk-{_rollup.next_chunk_index(self.run_dir)}.jsonl")
        except OSError:
            pass
        try:
            self._fh = open(self.events_path, "a")
        except OSError:
            self._fh = None

    def flush(self) -> None:
        if self._fh is not None:
            try:
                self._fh.flush()
            except OSError:
                pass

    def close(self) -> None:
        """Idempotent: emits the registry summary once, then closes."""
        if self._fh is None:
            return
        self._emit({"type": "event", "name": "run_end",
                    "summary": self.summary()})
        fh, self._fh = self._fh, None
        try:
            fh.flush()
            fh.close()
        except OSError:
            pass

    # ---------------------------------------------------------------- spans
    @contextlib.contextmanager
    def span(self, name: str, sync_on=None, **attrs):
        """Nested timing block.  ``sync_on`` takes a (list or dict of) CUDA
        tensor(s) whose device is synchronised before the clock stops —
        without it a span times only the launches enqueued in it."""
        parent = self._stack[-1] if self._stack else None
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synced = False
            if sync_on is not None:
                try:
                    synced = _sync(sync_on)
                except Exception:
                    synced = False
            dur = time.perf_counter() - t0
            self._stack.pop()
            self._emit({"type": "span", "name": name, "dur": round(dur, 6),
                        "depth": len(self._stack), "parent": parent,
                        "synced": synced, **_json_safe(attrs)})

    def record_span(self, name: str, dur: float, **attrs) -> None:
        """A span whose duration was measured elsewhere (BlockTimer's
        synchronised windows) — same schema, no re-timing."""
        parent = self._stack[-1] if self._stack else None
        self._emit({"type": "span", "name": name, "dur": round(float(dur), 6),
                    "depth": len(self._stack), "parent": parent,
                    **_json_safe(attrs)})

    # -------------------------------------------------------------- metrics
    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(self, name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(self, name))

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram(self, name))

    def event(self, name: str, **attrs) -> None:
        """Free-form structured event (``train_start``, ``actor_exit``)."""
        self._emit({"type": "event", "name": name, **_json_safe(attrs)})

    def summary(self) -> dict:
        """Registry state as plain data (also the ``run_end`` payload)."""
        hist = {name: {"n": h.n,
                       "p50": _json_safe(h.percentile(50)),
                       "p95": _json_safe(h.percentile(95)),
                       "max": _json_safe(h.max)}
                for name, h in self._histograms.items()}
        return {"counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": hist}

    # ----------------------------------------------------- device telemetry
    def memory_snapshot(self, **attrs) -> None:
        from hfrep_tpu_torch.obs import device
        device.memory_snapshot(self, **attrs)

    # ------------------------------------------------------------- manifest
    def annotate(self, **fields) -> None:
        """Merge fields into this run's ``run.json`` (e.g. the trainer's
        config, known only after :func:`enable` ran)."""
        from hfrep_tpu_torch.obs import manifest
        manifest.annotate(self.run_dir, {k: _json_safe(v)
                                         for k, v in fields.items()})


class _NullObs:
    """The disabled singleton: every hook is one attribute check away
    from free.  ``span`` hands back a shared ``nullcontext``."""

    enabled = False
    run_dir = None

    def span(self, name: str, sync_on=None, **attrs):
        return _NULL_CTX

    def record_span(self, name: str, dur: float, **attrs) -> None: pass
    def event(self, name: str, **attrs) -> None: pass
    def counter(self, name: str): return _NULL_INSTRUMENT
    def gauge(self, name: str): return _NULL_INSTRUMENT
    def histogram(self, name: str): return _NULL_INSTRUMENT
    def memory_snapshot(self, **attrs) -> None: pass
    def annotate(self, **fields) -> None: pass
    def summary(self) -> dict: return {}
    def flush(self) -> None: pass
    def close(self) -> None: pass
    def now(self) -> float: return 0.0


NULL = _NullObs()
_active: Optional[Obs] = None


def get_obs():
    """The active sink, or :data:`NULL` — never None."""
    return _active if _active is not None else NULL


def is_enabled() -> bool:
    return _active is not None


def enable(run_dir, *, manifest: bool = True,
           rotate_bytes: Optional[int] = None, **manifest_extra) -> Obs:
    """Activate telemetry into ``run_dir`` (closing any previous sink)
    and write ``run.json`` at once (git SHA, versions, host, the card)."""
    global _active
    if _active is not None:
        disable()
    # a fresh run arms a fresh wall-clock ledger
    from hfrep_tpu_torch.obs import timeline
    timeline.reset()
    obs = Obs(run_dir, rotate_bytes=rotate_bytes)
    _active = obs
    try:
        if manifest:
            from hfrep_tpu_torch.obs import manifest as mf
            mf.write_manifest(obs.run_dir, extra=manifest_extra or None)
        obs.event("run_start")
    except BaseException:
        # a half-open sink must not stay the active singleton
        disable()
        raise
    return obs


def disable() -> None:
    """Close the active sink and return to the no-op singleton."""
    global _active
    if _active is None:
        return
    _active.close()
    _active = None


@contextlib.contextmanager
def session(run_dir, **manifest_extra):
    """The whole enable/disable lifecycle as one context manager.  A falsy
    ``run_dir`` yields :data:`NULL`; otherwise the run_end summary, flush
    and close are guaranteed even when the body raises."""
    if not run_dir:
        yield NULL
        return
    obs = enable(run_dir, **manifest_extra)
    try:
        yield obs
    except BaseException as e:
        if not (isinstance(e, SystemExit) and e.code in (0, None)):
            _crash_bundle(obs, e)
        raise
    finally:
        disable()
        # stderr: a CLI's stdout stays machine-pure
        print(f"telemetry: {run_dir}", file=sys.stderr)


@contextlib.contextmanager
def session_or_off(run_dir, prog: str, **manifest_extra):
    """:func:`session` that degrades to telemetry-off (a stderr notice and
    :data:`NULL`) instead of raising when the run dir is unusable."""
    with contextlib.ExitStack() as stack:
        try:
            obs = stack.enter_context(session(run_dir, **manifest_extra))
        except OSError as e:
            print(f"{prog}: telemetry disabled (run dir {run_dir}: {e})",
                  file=sys.stderr)
            obs = stack.enter_context(session(None))
        yield obs


@contextlib.contextmanager
def trace_capture(log_dir=None, **attrs):
    """Capture a ``torch.profiler`` trace (CPU and CUDA activity) and link
    it into the run.

    With obs enabled the capture lands under ``<run_dir>/traces`` by
    default as a Chrome trace (``trace-<n>.json``), a ``trace_capture``
    event enters the stream and ``run.json`` gains a ``traces`` entry.
    With obs disabled an explicit ``log_dir`` still captures; no dir at
    all is a no-op.  Yields the capture directory (or None)."""
    obs = get_obs()
    if log_dir is None:
        if not obs.enabled:
            yield None
            return
        log_dir = Path(obs.run_dir) / "traces"
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    n = 1
    while (log_dir / f"trace-{n}.json").exists():
        n += 1
    out = log_dir / f"trace-{n}.json"
    t0 = time.perf_counter()
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield str(log_dir)
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(out))
        finally:
            dur = time.perf_counter() - t0
            if obs.enabled:
                obs.event("trace_capture", path=str(log_dir), n_traces=1,
                          secs=round(dur, 6), **_json_safe(attrs))
                from hfrep_tpu_torch.obs import manifest as mf
                mf.add_trace_link(obs.run_dir, str(log_dir), n_traces=1,
                                  secs=round(dur, 6))


def emit_launch_counts() -> None:
    """The hand kernels' launches of this process (the wrappers' counts and
    the weight sums as their C launcher counts them), as ``launches/<kernel>``
    counters in the process's own stream; nothing without a telemetry dir.
    A process on the card (a pipeline member, a verb run as a subprocess)
    reports its launches this way."""
    obs = get_obs()
    if not obs.enabled:
        return
    from hfrep_tpu_torch.ops import cuda_lstm

    counts = dict(cuda_lstm.launch_counts())
    counts.update({f"weight_sum ({k})": v
                   for k, v in cuda_lstm.weight_sum_launches().items()})
    for kernel, n in sorted(counts.items()):
        if n:
            obs.counter(f"launches/{kernel}").inc(int(n), kernel=kernel)
    obs.flush()


def maybe_enable_from_env() -> Optional[Obs]:
    """Honor ``HFREP_OBS_DIR`` so entry points opt in without a flag."""
    run_dir = os.environ.get("HFREP_OBS_DIR")
    if run_dir and not is_enabled():
        return enable(run_dir)
    return None


def mesh_attrs(mesh) -> Optional[Dict[str, int]]:
    """``Mesh -> {"dp": 2}`` (JSON-safe mesh description), ``None`` for
    no mesh."""
    if mesh is None:
        return None
    return {str(n): int(s) for n, s in mesh.shape.items()}


def instrument_step(fn, name: str, flops: Optional[float] = None, mesh=None, **attrs):
    """Wrap a built step for telemetry, decided at BUILD time: with
    telemetry off this returns ``fn`` unchanged.

    When on: a ``parallel_build`` event (the JAX stream's name); the first call recorded as a
    synchronised ``compile:<name>`` span (it pays the kernels' first
    build and launch), booked as ``dispatch`` in the ledger, after which
    the kernel libraries it loaded are fingerprinted at the
    ``compile:<name>`` boundary (``flops``, one call's FLOPs, as the
    boundary's cost); later calls counted (``dispatch:<name>``, no sync,
    so the trainer's pipelined blocks stay pipelined) with their
    host-side time handed to the dispatch attribution window.  The event
    carries the mesh (``None`` without one) and, on a mesh that spans
    processes, its process group's backend."""
    obs = get_obs()
    if not obs.enabled:
        return fn
    if mesh is not None and mesh.backend is not None:
        attrs = dict(attrs, backend=mesh.backend)
    obs.event("parallel_build", step=name, mesh=mesh_attrs(mesh), **_json_safe(attrs))
    state = {"first": True}

    def wrapped(*args, **kwargs):
        from hfrep_tpu_torch.obs import timeline
        if state["first"]:
            state["first"] = False
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            try:
                _sync(out)
            except Exception:
                pass
            dur = time.perf_counter() - t0
            obs.record_span(f"compile:{name}", dur, synced=True)
            timeline.account("dispatch", dur)
            # fingerprinting is obs-only work: it books as the obs layer's own
            from hfrep_tpu_torch.obs import attrib
            with timeline.timed("obs_self"):
                attrib.profile_boundary(f"compile:{name}", flops=flops)
            return out
        obs.counter(f"dispatch:{name}").inc()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _note_dispatch(name, time.perf_counter() - t0)
        return out

    wrapped.__wrapped__ = fn
    wrapped.__name__ = f"obs_instrumented_{name}"
    return wrapped


def instrument_launch(fn, name: str, tcfg=None, mesh=None, **attrs):
    """The launch-factory form of :func:`instrument_step`: ``tcfg`` (a
    ``TrainConfig``) contributes the batch size to the build event."""
    if tcfg is not None:
        attrs.setdefault("batch", tcfg.batch_size)
    return instrument_step(fn, name, mesh=mesh, **attrs)
