"""Admission control + circuit breaking (``hfrep_tpu/serve/admission.py``).

Pure Python and identical to the reference, the breaker's
``serve_breaker_open`` / ``serve_breaker_close`` events included.

A serving layer that melts under load is worse than none — the SRE
failure modes are queueing to death (every request admitted, every
request late), silent drops (a request that never gets an answer), and
retry storms against a struggling backend.  The primitives here encode
the counter-doctrine:

* **typed terminal outcomes** — every admitted request ends in exactly
  one of: a result, an explicit :class:`Overloaded` / :class:`Draining`
  rejection, a :class:`DeadlineExceeded`, or a :class:`WorkerFault`.
  Rejections are *values of the protocol*, not exceptions of the
  implementation: a shed request is the system working as designed.
* **bounded queues** — admission is decided at submit time against a
  fixed queue-depth bound (the micro-batcher enforces it); beyond the
  bound the request is shed immediately with :class:`Overloaded`, never
  parked on an unbounded deque.
* **circuit breaker** — repeated worker faults or a compile storm trip
  the breaker OPEN: the server stops dispatching fresh computation and
  serves degraded answers (last-good cached outputs, flagged stale)
  until a cooldown elapses, then HALF-OPEN lets one probe batch through;
  success closes the breaker, failure re-opens it.  The clock is
  injectable so the state machine is unit-testable without sleeping.

Everything here is host-side, stdlib-only, and thread-safe where it
needs to be (the breaker is shared by worker threads and the submit
path).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ServeError(RuntimeError):
    """Base of every typed terminal rejection the server can hand back.

    ``code`` is the machine-readable outcome class (the counters and the
    chaos selftest key off it); the message is for humans."""

    code = "error"


class Overloaded(ServeError):
    """Load shed at admission: the bounded queue is full.  Explicit by
    design — the client learns *immediately* that it should back off,
    instead of waiting out a deadline in a queue that cannot drain."""

    code = "overloaded"

    def __init__(self, depth: int, bound: int):
        self.depth, self.bound = depth, bound
        super().__init__(f"shed: queue depth {depth} at bound {bound}")


class Draining(ServeError):
    """Admission refused because a graceful drain is in progress: the
    server is flushing in-flight work and will exit 75.  New work must
    go to another replica."""

    code = "draining"

    def __init__(self, reason: Optional[str] = None):
        super().__init__(f"draining{f' ({reason})' if reason else ''}; "
                         "not admitting new requests")


class ServerClosed(ServeError):
    """Submit after shutdown — a caller bug, but still a typed outcome."""

    code = "closed"


class InvalidRequest(ServeError):
    """The request itself is unservable (wrong panel width, rows beyond
    the bucket ladder, unknown kind) — a client error, rejected typed at
    admission before any queueing."""

    code = "invalid"


class DeadlineExceeded(ServeError):
    """The request's deadline expired while it sat in the batcher; it
    was cancelled *before* dispatch (no point computing an answer nobody
    is waiting for) and this is its terminal outcome."""

    code = "deadline"

    def __init__(self, request_id: str, late_ms: float):
        self.request_id, self.late_ms = request_id, late_ms
        super().__init__(f"request {request_id} missed its deadline "
                         f"by {late_ms:.1f}ms (cancelled at the batcher)")


class WorkerFault(ServeError):
    """The batch carrying this request died (worker killed mid-batch, or
    the result publish raised EIO) and the retry budget is spent.  The
    typed alternative to a silent drop."""

    code = "worker_fault"

    def __init__(self, request_id: str, cause: str):
        self.request_id, self.cause = request_id, cause
        super().__init__(f"request {request_id} failed in a worker: {cause}")


# ------------------------------------------------------------------ breaker
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Three-state breaker shared by the submit path and the workers.

    Trips OPEN on either of two signals:

    * ``failure_threshold`` **consecutive** worker faults (a batch that
      died, a result publish that raised) — the backend is sick, and
      dispatching more work to it queues requests to death;
    * a **compile storm**: more than ``compile_storm`` program compiles
      inside ``compile_window_s`` seconds.  An LRU of compiled programs
      thrashing (adversarial shape mix, cache sized wrong) turns every
      request into a multi-second XLA compile; serving stale answers is
      strictly better than compiling in the request path.

    While OPEN, :meth:`allow` is False — the server answers from the
    last-good cache (flagged stale) instead of dispatching.  After
    ``cooldown_s`` the breaker moves to HALF_OPEN and :meth:`allow`
    passes exactly one probe; :meth:`record_success` closes,
    :meth:`record_failure` re-opens (fresh cooldown).

    ``clock`` is injectable (monotonic seconds) so tests can drive the
    cooldown without sleeping.
    """

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 1.0,
                 compile_storm: int = 8, compile_window_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self.compile_storm = max(1, int(compile_storm))
        self.compile_window_s = float(compile_window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_out = False
        self._compiles: list = []       # timestamps inside the storm window
        self.trips = 0
        self.last_trip_reason: Optional[str] = None

    # ------------------------------------------------------------- queries
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May the server dispatch fresh computation right now?  In
        HALF_OPEN, True exactly once (the probe); its outcome decides."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_out:
                self._probe_out = True
                return True
            return False

    # ------------------------------------------------------------- signals
    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state in (HALF_OPEN, OPEN):
                self._state = CLOSED
                self._probe_out = False
                self._emit("serve_breaker_close")

    def record_failure(self, cause: str = "worker_fault") -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                self._trip(f"probe failed ({cause})")
            elif (self._state == CLOSED
                  and self._consecutive_failures >= self.failure_threshold):
                self._trip(f"{self._consecutive_failures} consecutive "
                           f"faults ({cause})")

    def record_compile(self) -> None:
        """One program compile happened; trips on a storm."""
        now = self._clock()
        with self._lock:
            self._compiles.append(now)
            cutoff = now - self.compile_window_s
            self._compiles = [t for t in self._compiles if t >= cutoff]
            if self._state == CLOSED and len(self._compiles) > self.compile_storm:
                self._trip(f"compile storm: {len(self._compiles)} compiles "
                           f"in {self.compile_window_s:.0f}s")

    # ------------------------------------------------------------ plumbing
    def _trip(self, reason: str) -> None:
        # lock held by caller
        self._state = OPEN
        self._opened_at = self._clock()
        self._probe_out = False
        self.trips += 1
        self.last_trip_reason = reason
        self._emit("serve_breaker_open", reason=reason)

    def _maybe_half_open(self) -> None:
        # lock held by caller
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = HALF_OPEN
            self._probe_out = False

    @staticmethod
    def _emit(name: str, **attrs) -> None:
        try:
            from hfrep_tpu_torch.obs import get_obs
            get_obs().event(name, **attrs)
        except Exception:
            pass
