"""The replication server (``hfrep_tpu/serve/server.py``) on PyTorch.

``ReplicationServer`` answers two kinds of request:

* ``replicate`` runs a tenant panel through the AE replication head;
* ``sample`` draws windows from a GAN generator — for the MTSS families
  two LSTM layers, each one launch of the hand-written recurrence kernel
  on the card (:mod:`hfrep_tpu_torch.ops.cuda_lstm`).

Requests enter through :meth:`submit`, which returns a ``Future``
resolving to a :class:`ServeResult` or raising one typed
:class:`~hfrep_tpu_torch.serve.admission.ServeError` — exactly one
terminal outcome per submitted request.  The envelope is the reference's:
micro-batching with deadlines and a bounded queue, a circuit breaker
that answers from the last-good cache (flagged ``stale``) while open,
requeue-once of a dead worker's batch, ``warm``, ``drain`` and
``stats``.  Its fault-injection points are the JAX server's:
``kill@serve_worker`` kills the worker holding the Nth dispatched batch,
``io_fail@serve_result`` fails a request's result publication TYPED
(:class:`~hfrep_tpu_torch.serve.admission.WorkerFault`).

Telemetry is the JAX server's: every request carries a trace ID (the
caller's, else its request id) on each event of its lifecycle —
``serve_admit``, ``serve_shed``, ``serve_degraded``, the batch-level
``serve_dispatch`` (its ``traces`` list), ``serve_complete``,
``serve_fault``, the batcher's ``serve_deadline_miss`` — sampled 1 in
``event_log_every`` requests (counters and the outcome ledger stay
exact); the workers book ``queue_wait`` and ``dispatch`` into the
wall-clock ledger (:mod:`~hfrep_tpu_torch.obs.timeline`), and a drain
emits ``serve_drain``.

Each bucket's program is built ahead of traffic by
:func:`~hfrep_tpu_torch.serve.aot.aot_compile`: with ``ServeConfig.via_export``
(the default) a loaded ``torch.export`` program that takes the model's
weights as an operand, else the eager function; ``stats()["cache"]
["modes"]`` counts the resident programs by mode.

Sample noise comes from a ``torch.Generator`` on the model's device,
seeded from ``(cfg.seed, dispatch sequence number)``; its draws differ
from ``jax.random``'s by necessity.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.obs import timeline
from hfrep_tpu_torch.serve import aot
from hfrep_tpu_torch.serve.admission import (
    OPEN,
    CircuitBreaker,
    Draining,
    InvalidRequest,
    Overloaded,
    ServeError,
    ServerClosed,
    WorkerFault,
)
from hfrep_tpu_torch.serve.batcher import MicroBatcher, ServeRequest


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving envelope's knobs."""

    max_batch: int = 8              # requests per dispatched program
    batch_window_ms: float = 5.0    # micro-batch accumulation deadline
    request_timeout_ms: float = 250.0   # default per-request deadline
    max_queue: int = 64             # admission bound (queued requests)
    workers: int = 2                # dispatch threads
    row_buckets: Tuple[int, ...] = aot.DEFAULT_ROW_BUCKETS
    sample_buckets: Tuple[int, ...] = (8, 16, 32, 64)
    cache_capacity: int = 32        # programs held resident; size it >= the
                                    # warmed grid (batch x shape buckets)
    breaker_failures: int = 3       # consecutive faults that trip OPEN
    breaker_cooldown_s: float = 1.0
    compile_storm: int = 16         # program builds per window that trip OPEN
    compile_window_s: float = 10.0
    via_export: bool = True         # each bucket a loaded torch.export program
    #                                 (aot.aot_compile), else the eager one
    seed: int = 0                   # noise stream for `sample` requests
    event_log_every: int = 1        # per-request events sampled 1 in N;
                                    # counters and the outcome ledger stay
                                    # exact, only the event stream thins


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """A successful terminal outcome.  ``stale=True`` marks a degraded
    answer served from the last-good cache while the breaker was open."""

    request_id: str
    kind: str
    value: dict
    latency_ms: float
    stale: bool = False
    batch_size: int = 1


class Outcomes:
    """Thread-safe terminal-outcome ledger; ``submitted == terminal`` is
    the invariant."""

    FIELDS = ("submitted", "admitted", "results", "degraded", "shed",
              "invalid", "drain_rejected", "deadline_missed",
              "worker_faults", "closed_rejected", "requeues",
              "worker_kills")

    #: the terminal buckets (everything except the transition counters
    #: requeues/worker_kills and the non-terminal submitted/admitted)
    TERMINAL_FIELDS = ("results", "degraded", "shed", "invalid",
                       "drain_rejected", "deadline_missed",
                       "worker_faults", "closed_rejected")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    @property
    def terminal(self) -> int:
        with self._lock:
            return sum(getattr(self, f) for f in self.TERMINAL_FIELDS)

    def as_dict(self) -> dict:
        with self._lock:
            d = {f: getattr(self, f) for f in self.FIELDS}
        d["terminal"] = sum(d[f] for f in self.TERMINAL_FIELDS)
        return d


class _WorkerKilled(BaseException):
    """Abrupt worker death.  A BaseException so no except-Exception path
    inside the dispatch can survive it — the shell is the only catcher."""


def sample_generator(device: torch.device, seed: int, seq: int) -> torch.Generator:
    """The noise stream of one sample dispatch: pure in (seed, seq)."""
    state = np.random.SeedSequence([int(seed), int(seq)]).generate_state(1)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


class ReplicationServer:
    """See module docstring.  Construct, :meth:`start`, :meth:`submit`
    futures, :meth:`drain`/:meth:`stop`."""

    def __init__(self, cfg: ServeConfig,
                 ae_model: Optional[aot.AEServeModel] = None,
                 gen_model: Optional[aot.GenServeModel] = None,
                 clock: Callable[[], float] = time.monotonic):
        if ae_model is None and gen_model is None:
            raise ValueError("serve needs at least one model "
                             "(ae_model and/or gen_model)")
        self.cfg = cfg
        self.ae_model = ae_model
        self.gen_model = gen_model
        self._clock = clock
        self.outcomes = Outcomes()
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.breaker_failures,
            cooldown_s=cfg.breaker_cooldown_s,
            compile_storm=cfg.compile_storm,
            compile_window_s=cfg.compile_window_s,
            clock=clock)
        self.cache = aot.ProgramCache(capacity=cfg.cache_capacity,
                                      on_compile=self.breaker.record_compile)
        self.batcher = MicroBatcher(
            max_batch=cfg.max_batch, batch_window_ms=cfg.batch_window_ms,
            max_queue=cfg.max_queue, on_deadline_miss=self._count_miss,
            on_forced_close=lambda req: self.outcomes.inc("closed_rejected"),
            clock=clock)
        self._lock = threading.Lock()
        self._last_good: Dict[str, dict] = {}
        self._latencies: List[float] = []       # bounded reservoir
        self._ids = itertools.count()
        self._dispatch_seq = itertools.count()  # sample-noise stream index
        self._in_flight = 0
        self._idle = threading.Condition(self._lock)
        self._running = False
        self._workers: List[threading.Thread] = []
        self._worker_ids = itertools.count()
        self._batch_buckets = tuple(
            b for b in (1, 2, 4, 8, 16, 32, 64, 128) if b < cfg.max_batch
        ) + (cfg.max_batch,)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicationServer":
        with self._lock:
            if self._running:
                return self
            self._running = True
        for _ in range(max(1, self.cfg.workers)):
            self._spawn_worker()
        return self

    def _spawn_worker(self) -> None:
        idx = next(self._worker_ids)
        t = threading.Thread(target=self._worker_shell, args=(idx,),
                             name=f"serve-worker-{idx}", daemon=True)
        self._workers.append(t)
        t.start()

    def stop(self) -> None:
        with self._lock:
            self._running = False
        self.batcher.close()
        for t in self._workers:
            t.join(timeout=5.0)

    def drain(self, reason: str = "drain", timeout: float = 30.0) -> dict:
        """Stop admitting, flush in-flight work, stop, report."""
        self.batcher.start_drain(reason)
        flushed = self.batcher.wait_empty(timeout)
        end = self._clock() + timeout
        with self._idle:
            while self._in_flight > 0 and self._clock() < end:
                self._idle.wait(0.05)
            flushed = flushed and self._in_flight == 0
        self.stop()
        doc = {"reason": reason, "flushed": bool(flushed),
               **self.outcomes.as_dict()}
        self._emit("serve_drain", reason=reason, flushed=bool(flushed),
                   terminal=doc["terminal"], submitted=doc["submitted"])
        return doc

    # ------------------------------------------------------------ admission
    def submit(self, kind: str, payload,
               timeout_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> Future:
        """Admit one query; ALWAYS returns a future that terminates.
        Typed rejections (shed, draining, closed, invalid) resolve the
        future immediately.  ``trace_id`` is the caller's correlation ID
        (None: the request id); every event of the request carries it."""
        self.outcomes.inc("submitted")
        now = self._clock()
        idnum = next(self._ids)
        rid = f"r{idnum}"
        trace = trace_id or rid
        log = (self.cfg.event_log_every <= 1
               or idnum % self.cfg.event_log_every == 0)
        budget = (self.cfg.request_timeout_ms
                  if timeout_ms is None else float(timeout_ms))
        try:
            bucket = self._bucket(kind, payload)
        except (ValueError, aot.BucketError) as e:
            self.outcomes.inc("invalid")
            if log:
                self._emit("serve_fault", request=rid, trace=trace,
                           cause=f"invalid: {e}")
            return self._rejected(InvalidRequest(str(e)))
        req = ServeRequest(id=rid, kind=kind, payload=payload, bucket=bucket,
                           arrival=now, deadline=now + budget / 1e3,
                           trace_id=trace, log=log)
        if log:
            self._emit("serve_admit", request=rid, kind=kind,
                       bucket=str(bucket), timeout_ms=budget, trace=trace)
        # breaker-open fast path: degraded answer over queueing to death
        if self.breaker.state == OPEN:
            return self._degrade_or_shed(req, "breaker open", log=log)
        try:
            self.batcher.submit(req)
        except Overloaded as e:
            self.outcomes.inc("shed")
            if log:
                self._emit("serve_shed", request=rid, reason="queue_full",
                           depth=e.depth, bound=e.bound, trace=trace)
            req.finish(error=e)
            return req.future
        except Draining as e:
            self.outcomes.inc("drain_rejected")
            if log:
                self._emit("serve_shed", request=rid, reason="draining",
                           trace=trace)
            req.finish(error=e)
            return req.future
        except ServerClosed as e:
            self.outcomes.inc("closed_rejected")
            req.finish(error=e)
            return req.future
        self.outcomes.inc("admitted")
        self._gauge_depth()
        return req.future

    def replicate(self, panel, timeout_ms: Optional[float] = None,
                  trace_id: Optional[str] = None) -> Future:
        return self.submit("replicate", np.asarray(panel, np.float32),
                           timeout_ms=timeout_ms, trace_id=trace_id)

    def sample(self, n_windows: int,
               timeout_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> Future:
        return self.submit("sample", int(n_windows), timeout_ms=timeout_ms,
                           trace_id=trace_id)

    def _bucket(self, kind: str, payload) -> Tuple:
        if kind == "replicate":
            if self.ae_model is None:
                raise ValueError("no AE replication head registered")
            arr = np.asarray(payload)
            if arr.ndim != 2 or arr.shape[1] != self.ae_model.cfg.n_factors:
                raise ValueError(
                    f"replicate wants (rows, {self.ae_model.cfg.n_factors}) "
                    f"panels, got {arr.shape}")
            return ("replicate",
                    aot.bucket_for(arr.shape[0], self.cfg.row_buckets))
        if kind == "sample":
            if self.gen_model is None:
                raise ValueError("no generator registered")
            n = int(payload)
            if n < 1:
                raise ValueError(f"sample wants n_windows >= 1, got {n}")
            return ("sample", aot.bucket_for(n, self.cfg.sample_buckets))
        raise ValueError(f"unknown request kind {kind!r}")

    def _rejected(self, err: ServeError) -> Future:
        f: Future = Future()
        f.set_exception(err)
        return f

    def _degrade_or_shed(self, req: ServeRequest, why: str,
                         log: bool = True) -> Future:
        with self._lock:
            cached = self._last_good.get(req.kind)
        if cached is not None:
            self.outcomes.inc("degraded")
            latency = (self._clock() - req.arrival) * 1e3
            req.finish(value=ServeResult(
                request_id=req.id, kind=req.kind, value=cached,
                latency_ms=latency, stale=True))
            if log:
                self._emit("serve_degraded", request=req.id, reason=why,
                           trace=req.trace_id)
        else:
            self.outcomes.inc("shed")
            if log:
                self._emit("serve_shed", request=req.id, reason=why,
                           trace=req.trace_id)
            req.finish(error=Overloaded(depth=self.batcher.depth,
                                        bound=self.cfg.max_queue))
        return req.future

    # -------------------------------------------------------------- workers
    def _worker_shell(self, idx: int) -> None:
        """Supervision boundary of one worker thread: abrupt death becomes
        fail-over plus a replacement, so a killed worker costs one retry,
        never an answer."""
        try:
            self._worker_loop(idx)
        except _WorkerKilled as e:
            batch = e.args[0] if e.args else []
            self.outcomes.inc("worker_kills")
            self.breaker.record_failure(cause="worker killed")
            self._emit("serve_worker_exit", worker=idx, kind="killed",
                       in_flight=len(batch))
            self._fail_over(batch)
            with self._lock:
                self._in_flight -= len(batch)
                respawn = self._running
                self._idle.notify_all()
            if respawn:
                self._spawn_worker()

    def _worker_loop(self, idx: int) -> None:
        while True:
            with self._lock:
                if not self._running:
                    return
            # measure the batch wait always, book it only when a batch
            # arrived: an idle worker's empty polls are no drive's
            # queue_wait
            with timeline.timed(None) as tm_wait:
                batch = self.batcher.next_batch(timeout=0.05)
            if not batch:
                continue
            timeline.account("queue_wait", tm_wait.s)
            with self._lock:
                self._in_flight += len(batch)
            # a kill must raise here, outside the try/finally below: the
            # shell owns the in_flight decrement on that path
            if self._kill_point():
                raise _WorkerKilled(batch)
            try:
                self._dispatch(batch)
            finally:
                with self._lock:
                    self._in_flight -= len(batch)
                    self._idle.notify_all()
            self._gauge_depth()

    def _kill_point(self) -> bool:
        """Worker-death injection site: True when ``kill@serve_worker=N``
        fires for this dispatched batch."""
        return resilience.actor_kill_point("serve_worker")

    def _fail_over(self, batch: List[ServeRequest]) -> None:
        """A batch whose worker died: retry once, then typed failure."""
        retry, dead = [], []
        for r in batch:
            if r.future.done():
                continue
            (retry if r.retries < 1 else dead).append(r)
        for r in retry:
            r.retries += 1
        if retry:
            self.outcomes.inc("requeues", len(retry))
            self.batcher.requeue(retry)
        for r in dead:
            self.outcomes.inc("worker_faults")
            if r.log:
                self._emit("serve_fault", request=r.id, trace=r.trace_id,
                           cause="worker died twice")
            r.finish(error=WorkerFault(r.id, "worker died twice"))

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, batch: List[ServeRequest]) -> None:
        kind = batch[0].kind
        if not self.breaker.allow():
            for r in batch:
                self._degrade_or_shed(r, "breaker open at dispatch")
            return
        t_disp = self._clock()
        if any(r.log for r in batch):
            # one batch-level hop event: its traces list attributes the
            # batch-wait → dispatch hop to every logged member
            self._emit("serve_dispatch", kind=kind,
                       bucket=str(batch[0].bucket), batch=len(batch),
                       traces=[r.trace_id for r in batch if r.log],
                       max_wait_ms=round(
                           (t_disp - min(r.arrival for r in batch)) * 1e3, 3))
        try:
            with timeline.timed("dispatch"):
                # the run helpers book their device-to-host copies apart,
                # so this frame's exclusive remainder is host dispatch
                if kind == "replicate":
                    values = self._run_replicate(batch)
                else:
                    values = self._run_sample(batch)
        except Exception as e:           # build/execute failure of the batch
            self.breaker.record_failure(cause=type(e).__name__)
            for r in batch:
                self.outcomes.inc("worker_faults")
                if r.log:
                    self._emit("serve_fault", request=r.id, trace=r.trace_id,
                               cause=f"{type(e).__name__}: {e}")
                r.finish(error=WorkerFault(r.id, f"{type(e).__name__}: {e}"))
            return
        # breaker and ledger first, futures last: a client that sees its
        # future done may read the breaker state at once
        ok = True
        now = self._clock()
        settled: List[Tuple[ServeRequest, object, Optional[float]]] = []
        for r, value in zip(batch, values):
            try:
                # the result-publish boundary: ``io_fail@serve_result``
                # raises the injected EIO here — the request then fails
                # TYPED (WorkerFault), never silently
                resilience.io_point("serve_result")
            except OSError as e:
                ok = False
                self.breaker.record_failure(cause="serve_result EIO")
                self.outcomes.inc("worker_faults")
                if r.log:
                    self._emit("serve_fault", request=r.id, trace=r.trace_id,
                               cause=f"result publish: {e}")
                settled.append((r, WorkerFault(r.id, f"result publish: {e}"), None))
                continue
            settled.append((r, value, (now - r.arrival) * 1e3))
        if ok:
            self.breaker.record_success()
            with self._lock:
                self._last_good[kind] = values[-1]
        for r, value, latency in settled:
            if latency is None:
                r.finish(error=value)
                continue
            if r.finish(value=ServeResult(request_id=r.id, kind=kind,
                                          value=value, latency_ms=latency,
                                          batch_size=len(batch))):
                self.outcomes.inc("results")
                self._note_latency(latency)
                if r.log:
                    self._emit("serve_complete", request=r.id,
                               trace=r.trace_id, kind=kind,
                               queue_ms=round((t_disp - r.arrival) * 1e3, 3),
                               exec_ms=round((now - t_disp) * 1e3, 3),
                               latency_ms=round(latency, 3),
                               batch=len(batch))

    def warm(self) -> int:
        """Build the full program grid — every (kind, batch bucket, shape
        bucket) the config admits — ahead of traffic, and report the
        programs resident.  The first sample program builds the CUDA
        kernels, so the workers never race to build them.  Warm builds do
        not count toward the breaker's compile-storm signal."""
        self.cache.warming = True
        try:
            if self.ae_model is not None:
                for rows in self.cfg.row_buckets:
                    for bsz in self._batch_buckets:
                        self._replicate_program(bsz, rows)
            if self.gen_model is not None:
                for bucket in self.cfg.sample_buckets:
                    self._sample_program(bucket)
        finally:
            self.cache.warming = False
        return len(self.cache)

    def _ae_mask(self) -> torch.Tensor:
        model = self.ae_model
        return (model.mask if model.mask is not None
                else aot.full_mask(model.cfg, device=model.device))

    def _replicate_program(self, bsz: int, rows: int):
        model = self.ae_model
        dev, feats = model.device, model.cfg.n_factors
        return self.cache.get_or_compile(
            ("replicate", bsz, rows),
            lambda: aot.aot_compile(
                aot.ae_batch_fn(model), model.params,
                torch.zeros((bsz, rows, feats), dtype=torch.float32, device=dev),
                torch.zeros((bsz,), dtype=torch.int32, device=dev),
                self._ae_mask(), via_export=self.cfg.via_export,
                label=f"serve:replicate:b{bsz}r{rows}")[0])

    def _sample_program(self, bucket: int):
        model = self.gen_model
        w, f = model.cfg.window, model.cfg.features
        return self.cache.get_or_compile(
            ("sample", bucket),
            lambda: aot.aot_compile(
                aot.gen_batch_fn(model), model.params,
                torch.zeros((bucket, w, f), dtype=torch.float32, device=model.device),
                via_export=self.cfg.via_export, label=f"serve:sample:b{bucket}")[0])

    def _run_replicate(self, batch: List[ServeRequest]) -> List[dict]:
        model = self.ae_model
        rows = batch[0].bucket[1]
        bsz = aot.bucket_for(len(batch), self._batch_buckets)
        x, n_rows = aot.pad_panel_batch([r.payload for r in batch], bsz, rows,
                                        model.cfg.n_factors, device=model.device)
        fn = self._replicate_program(bsz, rows)
        recon, err = fn(model.params, x, n_rows, self._ae_mask())
        t_s = timeline.clock()
        recon = recon.float().cpu().numpy()
        err = err.float().cpu().numpy()
        timeline.note_sync(timeline.clock() - t_s)
        return [{"reconstruction": recon[i][: r.payload.shape[0]],
                 "recon_mse": float(err[i]),
                 "weights": model.decoder_host}
                for i, r in enumerate(batch)]

    def _run_sample(self, batch: List[ServeRequest]) -> List[dict]:
        """Each request claims ``payload`` window slots; the batch runs in
        slot-bounded chunks so a wide batch never overflows the largest
        noise bucket."""
        model = self.gen_model
        max_slots = max(self.cfg.sample_buckets)
        w, f = model.cfg.window, model.cfg.features
        chunks: List[List[ServeRequest]] = [[]]
        slots = 0
        for r in batch:
            n = int(r.payload)
            if chunks[-1] and slots + n > max_slots:
                chunks.append([])
                slots = 0
            chunks[-1].append(r)
            slots += n
        out = []
        for chunk in chunks:
            total = sum(int(r.payload) for r in chunk)
            bucket = aot.bucket_for(total, self.cfg.sample_buckets)
            fn = self._sample_program(bucket)
            g = sample_generator(model.device, self.cfg.seed,
                                 next(self._dispatch_seq))
            noise = torch.randn((bucket, w, f), generator=g,
                                device=model.device, dtype=torch.float32)
            out_dev = fn(model.params, noise)
            t_s = timeline.clock()
            windows = out_dev.float().cpu().numpy()
            timeline.note_sync(timeline.clock() - t_s)
            off = 0
            for r in chunk:
                n = int(r.payload)
                out.append({"windows": windows[off: off + n]})
                off += n
        return out

    # ------------------------------------------------------------ telemetry
    def _count_miss(self, req: ServeRequest, late_ms: float) -> None:
        self.outcomes.inc("deadline_missed")

    def _note_latency(self, ms: float) -> None:
        with self._lock:
            if len(self._latencies) < 65536:
                self._latencies.append(ms)
        try:
            from hfrep_tpu_torch.obs import get_obs
            get_obs().histogram("serve/latency_ms").observe(ms)
        except Exception:
            pass

    def _gauge_depth(self) -> None:
        try:
            from hfrep_tpu_torch.obs import get_obs
            obs = get_obs()
            if obs.enabled:
                obs.gauge("serve/queue_depth").set(self.batcher.depth)
        except Exception:
            pass

    @staticmethod
    def _emit(name: str, **attrs) -> None:
        try:
            from hfrep_tpu_torch.obs import get_obs
            get_obs().event(name, **attrs)
        except Exception:
            pass

    def latency_percentiles(self) -> dict:
        from hfrep_tpu_torch.serve.loadgen import percentile
        with self._lock:
            s = sorted(self._latencies)
        if not s:
            return {"n": 0, "p50_ms": None, "p95_ms": None, "max_ms": None}
        return {"n": len(s), "p50_ms": percentile(s, 50),
                "p95_ms": percentile(s, 95), "max_ms": s[-1]}

    def stats(self) -> dict:
        doc = self.outcomes.as_dict()
        doc.update(self.latency_percentiles())
        doc["breaker"] = {"state": self.breaker.state,
                          "trips": self.breaker.trips,
                          "reason": self.breaker.last_trip_reason}
        doc["cache"] = {"programs": len(self.cache),
                        "compiles": self.cache.compiles,
                        "evictions": self.cache.evictions,
                        "modes": self.cache.modes()}
        doc["queue_depth"] = self.batcher.depth
        return doc
