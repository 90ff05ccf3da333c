"""The fabric supervisor: spawn, watch, restart, drain
(``hfrep_tpu/orchestrate/supervisor.py``).

One parent process owns the member pool (the Podracer supervisor role,
arxiv 2104.06272), spawned with ``mp.get_context("spawn")``: a forked
child would inherit the parent's CUDA state, which CUDA does not
support.  Its contract:

* **losing any member costs one member's in-flight work, not the run** —
  a crashed/killed member's claimed items are requeued, then the member
  is restarted with bounded full-jitter exponential backoff
  (:func:`hfrep_tpu_torch.resilience.backoff_delay` — deterministic backoff
  would march every restarted member back onto shared storage in
  lockstep); after ``max_restarts`` total crashes of one member over
  the run the supervisor gives up loudly (:class:`OrchestrationError`)
  — a member that keeps dying is a bug or a poisoned input, not
  preemption noise, and a run's restart budget should not be unbounded.
* **coordinated drain barrier** — SIGTERM to the supervisor (the pod)
  forwards SIGTERM to every live member; each drains at its item
  boundary (producers with their sub-block snapshot already persisted,
  consumers after publishing the current result) and exits 75.  The
  supervisor waits up to ``drain_timeout`` for the barrier; members
  that fail to arrive (e.g. an injected ``stall@drain_barrier``) are
  escalated with SIGKILL — safe, because every member's durable state
  precedes its barrier crossing — and the supervisor raises
  :class:`~hfrep_tpu_torch.resilience.Preempted` for the CLI's exit 75.
  A member that drains on its own (SIGTERM'd individually: its host is
  being preempted) drains the pod the same way.  The JAX supervisor only
  marks such a member drained, and its pod then waits forever for the
  member's stream (ROADMAP queue 3).
* **deterministic fault surface** — ``kill@actor=N`` in ``HFREP_FAULTS``
  makes the supervisor SIGKILL the producer of the Nth queue item it
  observes (:func:`~hfrep_tpu_torch.resilience.actor_kill_point`).

Telemetry (parent-side, one stream): ``actor_start`` / ``actor_exit`` /
``actor_restart`` / ``drain_barrier`` events, the
``orchestrate/queue_depth`` gauge sampled on change, and the
``orchestrate/actor_restarts`` counter.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import random
import signal
import time
from typing import Callable, Dict, List, Optional

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.obs import get_obs
from hfrep_tpu_torch.orchestrate.actors import EXIT_DRAINED, EXIT_GAP, actor_main
from hfrep_tpu_torch.orchestrate import queue as q_mod
from hfrep_tpu_torch.orchestrate.queue import SpoolQueue, _parse_item_name


class OrchestrationError(RuntimeError):
    """The fabric cannot make progress: a member exceeded its restart
    budget, reported an unrecoverable gap, or the run timed out."""


@dataclasses.dataclass
class ActorSpec:
    """One member's identity and spawn payload (payload must pickle —
    the spawn context ships it to a fresh interpreter).  ``env`` entries
    are applied to the child's environment at spawn time (every
    incarnation, restarts included) — how tests aim an ``HFREP_FAULTS``
    plan at ONE member of the pod instead of all of them."""

    name: str
    role: str                    # "generator" | "consumer"
    payload: dict
    max_restarts: int = 3
    env: Optional[dict] = None


class _Member:
    def __init__(self, spec: ActorSpec):
        self.spec = spec
        self.proc: Optional[mp.process.BaseProcess] = None
        self.restarts = 0
        self.done = False
        self.drained = False
        self.restart_at: Optional[float] = None   # pending backoff deadline

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.is_alive()


class Supervisor:
    def __init__(self, specs: List[ActorSpec], queue: SpoolQueue, *,
                 poll: float = 0.05, backoff_base: float = 0.25,
                 backoff_cap: float = 5.0, drain_timeout: float = 30.0,
                 timeout: Optional[float] = 600.0,
                 backoff_rng: Callable[[], float] = random.random):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate actor names: {names}")
        self.specs = list(specs)
        self.queue = queue
        self.poll = float(poll)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.drain_timeout = float(drain_timeout)
        self.timeout = timeout
        self.backoff_rng = backoff_rng
        self._ctx = mp.get_context("spawn")
        self._members: Dict[str, _Member] = {s.name: _Member(s)
                                             for s in self.specs}
        self._seen_items: set = set()
        self._last_depth: Optional[int] = None
        self.total_restarts = 0

    # ------------------------------------------------------------ obs
    def _obs(self):
        return get_obs()

    # ------------------------------------------------------- lifecycle
    def _start(self, m: _Member) -> None:
        m.proc = self._ctx.Process(
            target=actor_main,
            args=(m.spec.name, m.spec.role, m.spec.payload),
            name=m.spec.name)
        # spawn serializes the parent environment at start(): scoping the
        # member's env overrides around it gives per-actor env without a
        # shell layer (the supervisor loop is single-threaded)
        saved = {}
        for k, v in (m.spec.env or {}).items():
            saved[k] = os.environ.get(k)
            os.environ[k] = v
        try:
            m.proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        m.restart_at = None
        self._obs().event("actor_start", actor=m.spec.name,
                          role=m.spec.role, pid=m.proc.pid,
                          restarts=m.restarts)

    def _handle_exit(self, m: _Member, code: int, draining: bool) -> None:
        self._obs().event("actor_exit", actor=m.spec.name, code=code,
                          restarts=m.restarts)
        if code == 0:
            m.done = True
            return
        if code == EXIT_DRAINED:
            # a 75 outside a pod drain is a member SIGTERM'd individually:
            # its state is at a safe boundary, and the pod follows it into
            # the barrier (a stream without its member would never end)
            m.drained = True
            if not draining:
                resilience.request_drain(f"member {m.spec.name} drained")
            return
        if draining:
            # exits during the barrier are escalation fodder, not restart
            # (or abort) material: the drain wants the pod DOWN, and a
            # half-drained stream re-checks completeness on resume anyway
            m.drained = True
            return
        if code == EXIT_GAP:
            raise OrchestrationError(
                f"actor {m.spec.name} found an unrecoverable stream gap "
                "(missing results after eof) — aborting the run")
        # crash (includes SIGKILL: negative exitcode)
        m.restarts += 1
        self.total_restarts += 1
        if m.restarts > m.spec.max_restarts:
            raise OrchestrationError(
                f"actor {m.spec.name} crashed {m.restarts} times "
                f"(last exit {code}); restart budget "
                f"{m.spec.max_restarts} exhausted")
        # a dead consumer's claims would deadlock the drained() check —
        # requeue before the restart can matter
        if m.spec.role == "consumer":
            self.queue.requeue_claims(m.spec.name)
        delay = resilience.backoff_delay(m.restarts - 1,
                                         base=self.backoff_base,
                                         cap=self.backoff_cap,
                                         rng=self.backoff_rng)
        m.restart_at = time.monotonic() + delay
        obs = self._obs()
        obs.counter("orchestrate/actor_restarts").inc(actor=m.spec.name)
        obs.event("actor_restart", actor=m.spec.name, exit_code=code,
                  restarts=m.restarts, backoff_s=round(delay, 4))

    def _poll_members(self, draining: bool = False) -> None:
        # exits first, restarts second: a crash handled this pass never
        # respawns in the same pass, even when the jitter draws ~0
        for m in self._members.values():
            if m.proc is not None and not m.proc.is_alive():
                code = m.proc.exitcode
                m.proc = None
                self._handle_exit(m, code if code is not None else 1,
                                  draining)
        if draining:
            return
        for m in self._members.values():
            if (m.restart_at is not None
                    and time.monotonic() >= m.restart_at):
                self._start(m)

    # -------------------------------------------------- fault injection
    def _observe_items(self) -> None:
        """Tick the ``actor`` fault site once per newly observed queue
        item; a firing ``kill`` directive SIGKILLs the item's producer —
        REAL SIGKILL, mid-stream, with its sub-block snapshot on disk.

        An item is observed in ``ready/`` or, already claimed, in
        ``claimed/`` (the JAX supervisor looks in ``ready/`` only, so an
        idle consumer that claims within a poll hides the item from it
        and a ``kill`` directive may never fire)."""
        claimed = [n.partition(q_mod._CLAIM_SEP)[2] for n in self.queue.claimed_names()]
        for name in self.queue.ready_names() + sorted(claimed):
            if name in self._seen_items:
                continue
            self._seen_items.add(name)
            if not resilience.actor_kill_point("actor"):
                continue
            parsed = _parse_item_name(name)
            if parsed is None:
                continue
            source = parsed[0]
            for m in self._members.values():
                if (m.spec.role == "generator" and m.alive
                        and m.spec.payload.get("source") == source):
                    self._obs().event("actor_kill_injected",
                                      actor=m.spec.name, item=name,
                                      pid=m.proc.pid)
                    m.proc.kill()            # SIGKILL — no cleanup, no mercy
                    break

    def _sample_depth(self) -> None:
        depth = self.queue.depth()
        if depth != self._last_depth:
            self._last_depth = depth
            self._obs().gauge("orchestrate/queue_depth").set(depth)

    # ------------------------------------------------------------ drain
    def _drain_barrier(self) -> None:
        obs = self._obs()
        live = [m for m in self._members.values() if m.alive]
        obs.event("drain_barrier", phase="begin",
                  members=[m.spec.name for m in live])
        t0 = time.monotonic()
        for m in live:
            try:
                os.kill(m.proc.pid, signal.SIGTERM)
            except (OSError, AttributeError):
                pass
        deadline = t0 + self.drain_timeout
        while (time.monotonic() < deadline
               and any(m.alive for m in self._members.values())):
            self._poll_members(draining=True)
            time.sleep(self.poll)
        self._poll_members(draining=True)
        escalated = []
        for m in self._members.values():
            if m.alive:
                # a member that missed the barrier (hung, stalled): its
                # durable state precedes the barrier crossing, so SIGKILL
                # is safe — resume replays at most its in-flight item
                escalated.append(m.spec.name)
                m.proc.kill()
                m.proc.join(timeout=5.0)
                m.proc = None
        obs.event("drain_barrier", phase="end",
                  drained=[m.spec.name for m in self._members.values()
                           if m.drained or m.done],
                  escalated=escalated,
                  secs=round(time.monotonic() - t0, 4))
        raise resilience.Preempted(
            site="drain_barrier",
            reason=(f"pod drain: {len(escalated)} member(s) escalated"
                    if escalated else "pod drain: all members at barrier"),
            snapshot=str(self.queue.dir))

    # -------------------------------------------------------------- run
    def run(self) -> dict:
        """Supervise until every member completes; raises
        :class:`~hfrep_tpu_torch.resilience.Preempted` on a pod drain and
        :class:`OrchestrationError` on unrecoverable failure."""
        t0 = time.monotonic()
        with resilience.graceful_drain():
            for m in self._members.values():
                self._start(m)
            try:
                while True:
                    resilience.tick("supervise")   # sigterm/preempt site
                    if resilience.drain_requested():
                        self._drain_barrier()      # raises Preempted
                    self._poll_members()
                    self._observe_items()
                    self._sample_depth()
                    if all(m.done for m in self._members.values()):
                        break
                    if (self.timeout is not None
                            and time.monotonic() - t0 > self.timeout):
                        states = {
                            n: ("done" if m.done
                                else "live" if m.alive else "dead")
                            for n, m in self._members.items()}
                        raise OrchestrationError(
                            f"fabric did not complete within "
                            f"{self.timeout}s (members: {states})")
                    time.sleep(self.poll)
            finally:
                # never leak children, whatever tore us out of the loop
                for m in self._members.values():
                    if m.alive:
                        m.proc.kill()
                        m.proc.join(timeout=5.0)
        return {"restarts": self.total_restarts,
                "members": len(self._members),
                "secs": round(time.monotonic() - t0, 4)}
