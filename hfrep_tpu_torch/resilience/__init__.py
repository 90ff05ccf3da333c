"""Fault injection and preemption-safe recovery
(``hfrep_tpu/resilience/__init__.py``).

On preemptible fleets a training system is defined by how it survives
SIGTERM, torn writes and flaky storage.  This package gives the port
the JAX package's machinery, host-side only:

* **fault injection** — a deterministic, env-driven plan
  (``HFREP_FAULTS``, :mod:`hfrep_tpu_torch.resilience.faults`) that fires
  SIGTERM/preemption at a chosen chunk/block boundary, fails host-side
  I/O (checkpoint save, obs append, manifest writes) on the Nth call,
  and tears/corrupts checkpoint bytes after a save;
* **graceful drain** — :func:`graceful_drain` installs a SIGTERM handler
  for the duration of a drive; the drives poll :func:`drain_requested`
  at their natural sync points (chunk/block/item boundaries), persist
  state, and raise :class:`Preempted` instead of dying mid-write or
  inside a CUDA call;
* **bounded I/O retry** — :func:`retry_io` wraps host-side writes
  (checkpoints, run manifests) in a small full-jitter exponential
  backoff, surfaced as ``resilience/io_retries`` counters and
  ``io_retry`` events in the obs stream;
* **resume state** — :mod:`hfrep_tpu_torch.resilience.snapshot`
  (the chunked AE drives' :class:`ChunkSnapshot`, the actors'
  :class:`ProgressSnapshot`); **the drive envelope** —
  :mod:`hfrep_tpu_torch.resilience.drive` (exit 75 on a drain, 74 on a
  persistent I/O error).

With no plan installed every hook is one ``None`` check.  On top sit
the chaos search (:mod:`~hfrep_tpu_torch.resilience.chaos`, its oracles
and the registry-derived subjects with their fixture drives) and the
scripted kill→resume ``selftest``, both behind ``python -m
hfrep_tpu_torch.resilience``.
"""

from __future__ import annotations

import contextlib
import os
import random
import signal
import time
from typing import Callable, Optional

from hfrep_tpu_torch.resilience.faults import (  # noqa: F401  (public re-exports)
    Directive,
    FaultPlan,
    FaultSpecError,
)

ENV_FAULTS = "HFREP_FAULTS"
ENV_RETRIES = "HFREP_IO_RETRIES"


class WatchdogTimeout(RuntimeError):
    """A watched drive overran its watchdog budget (see :func:`watchdog`)."""


@contextlib.contextmanager
def watchdog(secs: float, name: str):
    """SIGALRM watchdog around a drive: raise :class:`WatchdogTimeout`
    naming ``name`` if the body runs longer than ``secs``.

    Any wedged drive fails loudly with its own name instead of silently
    eating the caller's whole budget.
    Nests: the previous SIGALRM handler and any pending itimer are
    restored on exit, so an outer watchdog keeps (approximately) its
    remaining budget.  A no-op off the main thread or on platforms
    without SIGALRM — a degraded watchdog must not block the drive.
    """
    import threading

    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def _alarm(signum, frame):
        raise WatchdogTimeout(
            f"{name!r} exceeded its {secs:.0f}s watchdog budget")

    prev_handler = signal.signal(signal.SIGALRM, _alarm)
    prev_delay, _ = signal.setitimer(signal.ITIMER_REAL, secs)
    t0 = time.monotonic()
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev_handler if prev_handler is not None
                      else signal.SIG_DFL)
        if prev_delay:
            # hand the remainder of the outer watchdog's budget back
            remaining = max(prev_delay - (time.monotonic() - t0), 0.001)
            signal.setitimer(signal.ITIMER_REAL, remaining)


class Preempted(RuntimeError):
    """Graceful preemption: a drive stopped at a safe boundary after
    persisting its state.  Callers translate this into a resumable exit
    (the CLIs exit 75 / EX_TEMPFAIL) rather than a crash."""

    def __init__(self, site: str, reason: Optional[str] = None,
                 epoch: Optional[int] = None, snapshot: Optional[str] = None):
        self.site, self.reason, self.epoch, self.snapshot = (
            site, reason, epoch, snapshot)
        msg = f"preempted at {site} boundary"
        if epoch is not None:
            msg += f" (epoch {epoch})"
        if snapshot:
            msg += f"; state persisted at {snapshot}"
        if reason:
            msg += f" [{reason}]"
        super().__init__(msg)


# ------------------------------------------------------------- fault plan
_plan: Optional[FaultPlan] = None
_env_consumed = False


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Activate a fault plan programmatically (tests)."""
    global _plan, _env_consumed
    _plan, _env_consumed = plan, True
    return plan


def clear_plan() -> None:
    global _plan
    _plan = None


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed from ``HFREP_FAULTS`` (read
    once per process — a plan's counters must persist across hooks).

    A spec that does not parse raises :class:`FaultSpecError` — and
    keeps raising on every later call (the env read is only marked
    consumed on success): a malformed plan must fail the drive loudly,
    never silently disable the injection it was asked for.
    """
    global _plan, _env_consumed
    if _plan is None and not _env_consumed:
        spec = os.environ.get(ENV_FAULTS)
        if spec:
            _plan = FaultPlan.parse(spec)      # FaultSpecError propagates
        _env_consumed = True
    return _plan


# ---------------------------------------------------------- graceful drain
class _DrainState:
    requested = False
    reason: Optional[str] = None
    depth = 0
    installed = False
    prev = None


_DRAIN = _DrainState()


def drain_requested() -> bool:
    return _DRAIN.requested


def request_drain(reason: str = "request") -> None:
    """Ask every active drive to stop at its next safe boundary."""
    first = not _DRAIN.requested
    _DRAIN.requested = True
    _DRAIN.reason = reason
    if first:
        try:
            from hfrep_tpu_torch.obs import get_obs
            get_obs().event("preempt_requested", reason=reason)
        except Exception:
            pass


def _sigterm_handler(signum, frame):
    request_drain(f"signal {signum} (SIGTERM)")


@contextlib.contextmanager
def graceful_drain():
    """Install the SIGTERM→drain handler while a training drive runs.

    Re-entrant (the trainers and the chunked engine may nest); the
    outermost exit restores the previous handler and clears the drain
    flag, so a drained-and-resumed process is not instantly preempted
    again.  In a non-main thread ``signal.signal`` is unavailable —
    the drain flag still works via :func:`request_drain` and injected
    ``preempt`` faults, only the OS signal route is off.

    Entry also resolves the ``HFREP_FAULTS`` plan eagerly: every long
    drive (GAN trainer, chunked AE engine, the orchestration supervisor)
    enters through here, so a malformed spec
    raises :class:`FaultSpecError` at the drive entry point — before any
    work is paid for — instead of at whichever hook happens to fire
    first deep inside the loop.
    """
    active_plan()
    outermost = _DRAIN.depth == 0
    _DRAIN.depth += 1
    if outermost:
        try:
            _DRAIN.prev = signal.signal(signal.SIGTERM, _sigterm_handler)
            _DRAIN.installed = True
        except ValueError:              # not the main thread
            _DRAIN.installed = False
    try:
        yield
    finally:
        _DRAIN.depth -= 1
        if outermost:
            if _DRAIN.installed:
                try:
                    signal.signal(signal.SIGTERM,
                                  _DRAIN.prev or signal.SIG_DFL)
                except ValueError:
                    pass
                _DRAIN.installed = False
            _DRAIN.prev = None
            _DRAIN.requested = False
            _DRAIN.reason = None


# ----------------------------------------------------------------- hooks
def tick(site: str) -> None:
    """Cross a boundary ``site`` for fault-injection purposes only — the
    caller handles its own drain (checkpoint first, then raise)."""
    plan = active_plan()
    if plan is not None:
        plan.boundary(site)


def boundary(site: str) -> None:
    """Cross a boundary: fire any injected faults for ``site``, then
    raise :class:`Preempted` if a drain was requested.  For drives whose
    state is already persisted when they cross (the chunked AE engine
    snapshots *before* the boundary call)."""
    tick(site)
    if _DRAIN.requested:
        raise Preempted(site=site, reason=_DRAIN.reason)


def io_point(site: str) -> None:
    """Fault-injection hook just before a host-side I/O operation."""
    plan = active_plan()
    if plan is not None:
        plan.io(site)


def io_hook(site: str) -> Optional[Callable[[], None]]:
    """:func:`io_point` pre-bound for hot paths: ``None`` when no plan is
    active at resolve time, so the caller's per-call cost is one ``if``."""
    plan = active_plan()
    if plan is None:
        return None
    return lambda: plan.io(site)


def post_save(site: str, path) -> None:
    """Fault-injection hook after a successful save of ``path``."""
    plan = active_plan()
    if plan is not None:
        plan.post_save(site, path)


def actor_kill_point(site: str = "actor") -> bool:
    """Fault-injection hook for the orchestration supervisor: True when
    a ``kill@actor=N`` directive fires at this occurrence (one call per
    newly observed queue item) — the supervisor then SIGKILLs the member
    that produced the item.  The effect lives in the caller because only
    the supervisor knows the actor pids."""
    plan = active_plan()
    return plan.actor(site) if plan is not None else False


# ------------------------------------------------------------------ retry
def io_attempts(default: int = 3) -> int:
    try:
        return max(1, int(os.environ.get(ENV_RETRIES, default)))
    except ValueError:
        return default


def backoff_delay(attempt: int, base: float = 0.05, factor: float = 2.0,
                  cap: float = 30.0,
                  rng: Callable[[], float] = random.random) -> float:
    """Full-jitter exponential backoff: uniform in
    ``[0, min(cap, base * factor**attempt)]`` (``attempt`` 0-based).

    The jitter is the point, not a refinement: a preemption or an EIO
    burst hits every pod member at the same moment, and a deterministic
    schedule would march all of them back onto the shared storage (or
    the supervisor's restart path) in lockstep, re-creating the
    contention that failed them.  ``rng`` is injectable so tests can pin
    the bounds exactly (``rng=lambda: 1.0`` = the deterministic ceiling,
    the pre-jitter behavior).
    """
    return min(cap, base * (factor ** attempt)) * rng()


def retry_io(fn: Callable, *, what: str, attempts: Optional[int] = None,
             base_delay: float = 0.05, factor: float = 2.0,
             sleep: Callable[[float], None] = time.sleep,
             rng: Callable[[], float] = random.random):
    """Run ``fn`` with a small bounded retry/backoff on ``OSError``.

    The policy for host-side I/O that must survive flaky storage
    (checkpoint saves, obs manifest writes): ``attempts`` tries total
    (default 3, env override ``HFREP_IO_RETRIES``), full-jitter
    exponential backoff from ``base_delay`` (:func:`backoff_delay` — the
    k-th retry sleeps uniform in ``[0, base_delay * factor**(k-1)]``).
    Each retry lands in the obs stream as an ``io_retry`` event +
    ``resilience/io_retries`` counter; the final failure propagates —
    bounded means bounded.
    """
    attempts = attempts if attempts is not None else io_attempts()
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except OSError as e:
            if attempt == attempts:
                raise
            delay = backoff_delay(attempt - 1, base=base_delay,
                                  factor=factor, rng=rng)
            try:
                from hfrep_tpu_torch.obs import get_obs
                obs = get_obs()
                obs.counter("resilience/io_retries").inc(site=what)
                obs.event("io_retry", site=what, attempt=attempt,
                          error=str(e), backoff_s=round(delay, 4))
            except Exception:
                pass
            sleep(delay)
