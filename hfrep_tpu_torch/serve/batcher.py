"""Deadline-aware micro-batching with admission control
(``hfrep_tpu/serve/batcher.py``; its fault-injection boundary is the
JAX package's ``batcher`` site, its telemetry events are not ported yet).

The replication programs are batched device computations — serving one
request per dispatch wastes the whole width of the machine, while
waiting forever for a full batch wastes the client's deadline.  The
micro-batcher holds the standard middle: accumulate requests for the
same ``(kind, bucket)`` program until **``max_batch`` requests are
ready or ``batch_window_ms`` has elapsed since the oldest arrival,
whichever comes first**.

Two SRE properties live here because this is the only place they can:

* **admission control** — :meth:`MicroBatcher.submit` is the bounded
  front door: at ``max_queue`` waiting requests the submit is shed
  immediately with a typed :class:`~hfrep_tpu_torch.serve.admission.
  Overloaded` (never parked, never dropped).  ``requeue`` (the worker
  fail-over path) bypasses the bound: an admitted request's retry must
  not be shed by its own failure.
* **deadline cancellation** — every request carries an absolute
  deadline; a request still queued when it expires is completed with
  :class:`~hfrep_tpu_torch.serve.admission.DeadlineExceeded` *at the batcher*
  before any device work is paid for it.  The expiry check runs on every
  wait wake-up AND once more after the batch is formed, so a request
  delayed past its deadline misses loudly instead of riding into a
  dispatch nobody awaits.

The batcher never computes: workers call :meth:`next_batch` and own the
dispatch.  All state lives under one condition variable.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional, Tuple

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.serve.admission import (
    DeadlineExceeded,
    Draining,
    Overloaded,
    ServerClosed,
)


@dataclasses.dataclass
class ServeRequest:
    """One admitted query and its lifecycle state.

    ``bucket`` keys the compiled program the request can join
    (``("replicate", rows_bucket)`` / ``("sample", n_windows)``);
    ``deadline`` is absolute on the server clock.  ``future`` resolves
    to a :class:`~hfrep_tpu_torch.serve.server.ServeResult` or raises one of
    the typed :class:`~hfrep_tpu_torch.serve.admission.ServeError` outcomes —
    exactly once, which is the zero-silent-drop contract the chaos
    selftest asserts.
    """

    id: str
    kind: str                       # "replicate" | "sample"
    payload: object                 # (rows, F) panel | n_windows
    bucket: Tuple
    arrival: float
    deadline: float
    future: Future = dataclasses.field(default_factory=Future)
    retries: int = 0

    def finish(self, value=None, error: Optional[Exception] = None) -> bool:
        """Resolve the request exactly once; False if already terminal.
        Ownership hand-offs (queue → batch → fail-over) are strictly
        serialized, so the done/set pair cannot actually race — the
        InvalidStateError guard makes a future ownership bug surface as
        a counted double-finish instead of an exception inside a worker
        loop that must keep serving."""
        if self.future.done():
            return False
        try:
            if error is not None:
                self.future.set_exception(error)
            else:
                self.future.set_result(value)
        except InvalidStateError:
            return False
        return True


class MicroBatcher:
    """The bounded, deadline-aware accumulation queue.

    ``on_deadline_miss(req, late_ms)`` lets the server keep its outcome
    accounting without the batcher knowing about counters; the batcher
    still completes the future itself (the miss is terminal HERE).
    """

    def __init__(self, max_batch: int, batch_window_ms: float,
                 max_queue: int,
                 on_deadline_miss: Optional[Callable] = None,
                 on_forced_close: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = max(0.0, float(batch_window_ms)) / 1e3
        self.max_queue = max(1, int(max_queue))
        self.on_deadline_miss = on_deadline_miss
        #: called for each request close()/requeue-after-close resolves
        #: with ServerClosed — the server's outcome ledger must count
        #: these too, or a timed-out drain breaks terminal == submitted
        self.on_forced_close = on_forced_close
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: List[ServeRequest] = []
        self._closed = False
        self._draining: Optional[str] = None

    # ------------------------------------------------------------ admission
    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def submit(self, req: ServeRequest) -> None:
        """Admit or shed; raising IS the shed (typed, immediate)."""
        with self._cond:
            if self._closed:
                raise ServerClosed("server is closed")
            if self._draining is not None:
                raise Draining(self._draining)
            if len(self._queue) >= self.max_queue:
                raise Overloaded(depth=len(self._queue), bound=self.max_queue)
            self._queue.append(req)
            self._cond.notify_all()

    def requeue(self, reqs: List[ServeRequest]) -> None:
        """Fail-over re-entry for already-admitted requests (a killed
        worker's batch): front of the queue, bound NOT enforced — the
        alternative is shedding a request the server already accepted
        responsibility for."""
        with self._cond:
            if self._closed:
                for r in reqs:
                    if (r.finish(error=ServerClosed("closed during "
                                                    "fail-over"))
                            and self.on_forced_close is not None):
                        self.on_forced_close(r)
                return
            self._queue[:0] = reqs
            self._cond.notify_all()

    # ------------------------------------------------------------- batching
    def next_batch(self, timeout: Optional[float] = None,
                   ) -> Optional[List[ServeRequest]]:
        """Block until one program's batch is ready (or ``timeout``
        passes with an empty queue → ``None``, the worker's idle tick).

        A batch is all queued requests sharing the OLDEST request's
        ``(kind, bucket)`` key, capped at ``max_batch``; it closes when
        the cap is hit or the oldest member has waited the window out.
        """
        deadline_wait = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                self._expire_locked()
                if self._queue:
                    now = self._clock()
                    head = self._queue[0]
                    group = [r for r in self._queue
                             if (r.kind, r.bucket) == (head.kind, head.bucket)]
                    batch = group[: self.max_batch]
                    window_up = now - head.arrival >= self.batch_window_s
                    if len(batch) >= self.max_batch or window_up:
                        for r in batch:
                            self._queue.remove(r)
                        break
                    wake = head.arrival + self.batch_window_s
                    wake = min(wake, min(r.deadline for r in self._queue))
                    self._cond.wait(max(0.0, min(wake - now, 0.05)))
                    continue
                if self._closed:
                    return None
                if deadline_wait is not None:
                    remaining = deadline_wait - self._clock()
                    if remaining <= 0:
                        return None
                    self._cond.wait(min(remaining, 0.05))
                else:
                    self._cond.wait(0.05)
        # fault-injection boundary: ``stall@batcher`` sleeps here and
        # ``sigterm@batcher``/``preempt@batcher`` land a drain — batch
        # formation is the serving loop's natural boundary site
        resilience.tick("batcher")
        # a member may have expired since the batch closed (or during a
        # stall); it must miss NOW, not ride into the dispatch
        live = [r for r in batch if not self._expired(r)]
        return live if live else []

    def _expired(self, req: ServeRequest) -> bool:
        now = self._clock()
        if now < req.deadline:
            return False
        late_ms = (now - req.deadline) * 1e3
        if (req.finish(error=DeadlineExceeded(req.id, late_ms))
                and self.on_deadline_miss is not None):
            self.on_deadline_miss(req, late_ms)
        return True

    def _expire_locked(self) -> None:
        self._queue = [r for r in self._queue if not self._expired(r)]

    # ------------------------------------------------------------ lifecycle
    def start_drain(self, reason: str) -> None:
        """Stop admitting (submits now get :class:`Draining`); queued
        work keeps flowing to the workers until flushed."""
        with self._cond:
            self._draining = reason
            self._cond.notify_all()

    def wait_empty(self, timeout: float) -> bool:
        """True once the queue is fully flushed (drain step 2)."""
        end = self._clock() + timeout
        with self._cond:
            while self._queue:
                remaining = end - self._clock()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.05))
            return True

    def close(self) -> None:
        """Terminal: wake every waiter; anything still queued is
        completed with :class:`ServerClosed` (typed, never silent)."""
        with self._cond:
            self._closed = True
            leftovers, self._queue = self._queue, []
            self._cond.notify_all()
        for r in leftovers:
            if (r.finish(error=ServerClosed("server closed with request "
                                            "queued"))
                    and self.on_forced_close is not None):
                self.on_forced_close(r)
