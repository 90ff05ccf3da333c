"""Bounded, crash-safe work queue between generator and consumer actors
(``hfrep_tpu/orchestrate/queue.py``).

The fabric's members are OS processes that may be SIGKILLed at any
instruction, so the queue cannot live in process memory or in a
``multiprocessing.Queue`` (a member killed holding the feeder lock or
mid-pipe-write corrupts it for everyone).  Instead the queue is a spool
directory whose every transition is a single atomic filesystem rename:

* **put** — the item is materialized through the crash-consistent
  checkpoint writer (:func:`hfrep_tpu_torch.utils.checkpoint.write_atomic`:
  payload + checksum'd ``meta.json``, published in one rename into
  ``ready/``).  A kill mid-put leaves a hidden tmp dir, never a torn
  item.  The embedded checksum IS the item digest — every item carries
  ``(source, seq, digest)``.
* **claim** — a consumer renames ``ready/<item>`` to
  ``claimed/<consumer>__<item>``; rename is atomic, so exactly one
  claimant wins a race and the loser just moves to the next item.  The
  claim is digest-verified before use.
* **ack** — the claimed dir is deleted after the consumer has published
  its result (result first, ack second: a kill between the two leaves a
  claimed item whose reprocessing is idempotent).
* **requeue** — the supervisor moves a dead consumer's claimed items
  back to ``ready/`` before restarting it; nothing is lost, nothing is
  processed twice (results are keyed by ``(source, seq)``).

**Backpressure, not buffering**: :meth:`SpoolQueue.put` blocks while
``ready/`` holds ``capacity`` items, so a fast generator pool cannot
balloon host memory/disk ahead of the consumers — the Podracer
decoupling (arxiv 2104.06272) with a bounded channel.  A put blocked
during a pod drain raises :class:`~hfrep_tpu_torch.resilience.Preempted`
instead of deadlocking the barrier (the undelivered item is regenerated
on resume — the producer's snapshot still points at it).

**Exactly-once delivery** is split honestly between the two ends: a
restarted producer re-offers at most the one item it was killed around,
and :meth:`put` detects the duplicate by its ``(source, seq)`` name
(still spooled → skipped); an item that was already consumed and acked
re-enters the spool, but the consumer side skips recomputation because
the result artifact for that ``(source, seq)`` already exists.  Gaps —
an eof count larger than the delivered range — are detected by the
consumers' exit check and the pipeline assembly
(:func:`hfrep_tpu_torch.orchestrate.pipeline.assemble`).

The on-disk format is the JAX package's, name for name and byte for
byte (``payload.npz`` plus the checksummed ``meta.json``), so a JAX
queue and a port queue claim each other's items.

Fault sites: ``io_fail@queue_get`` raises the injected EIO straight out
of :meth:`SpoolQueue.claim` — the consumer crashes and the supervisor's
restart path is exercised.  ``io_fail@queue_put`` lands inside the
atomic item write, which runs under the bounded retry policy like every
other durable write — a single EIO is absorbed as an ``io_retry`` (flaky
shared storage must not kill a producer), so crashing a producer takes a
burst at least ``HFREP_IO_RETRIES`` long (e.g. ``io_fail@queue_put=1x3``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.obs import get_obs, timeline
from hfrep_tpu_torch.utils import checkpoint as ckpt

READY = "ready"
CLAIMED = "claimed"
_CLAIM_SEP = "__"
_EOF_PREFIX = "eof_"


class QueueItem(NamedTuple):
    """A claimed item: identity, payload location and verified metadata."""

    source: str
    seq: int
    path: Path           # the claimed directory holding payload.npz
    meta: dict           # verified meta.json (checksum = the digest)

    def arrays(self) -> Dict[str, np.ndarray]:
        with np.load(self.path / "payload.npz") as z:
            return {k: z[k] for k in z.files}


def item_name(source: str, seq: int) -> str:
    return f"item_{source}_{seq:05d}"


def item_trace_id(stream_seed: int, source: str, seq: int) -> str:
    """The pipeline item's trace/correlation ID — a PURE function of the
    item coordinate, like the item itself: a producer restarted after
    SIGKILL re-emits the same ID for a replayed item, so ``obs report
    --trace`` reconstructs one critical path spanning the restart
    (queue-wait → claim → sweep → publish) instead of two orphan halves.
    Every process's events for the item carry it as the ``trace`` attr.
    """
    return f"t{int(stream_seed)}-{source}-{int(seq):05d}"


def _parse_item_name(name: str):
    """``item_<source>_<seq>`` → (source, seq); None for foreign names."""
    if not name.startswith("item_"):
        return None
    body = name[len("item_"):]
    head, _, tail = body.rpartition("_")
    if not head or not tail.isdigit():
        return None
    return head, int(tail)


def _obs_event(name: str, **attrs) -> None:
    obs = get_obs()
    obs.event(name, **attrs)
    # item-granular durability: a SIGKILLed member loses its write
    # buffer, and the cross-restart trace reconstruction depends on the
    # pre-kill queue hops being ON DISK — queue events are per-item
    # (seconds of work each), so a flush per event is noise
    obs.flush()


class SpoolQueue:
    """One spool directory shared by every member of the fabric."""

    def __init__(self, dirpath, capacity: int = 8, poll: float = 0.02):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.dir = Path(dirpath)
        self.ready = self.dir / READY
        self.claimed = self.dir / CLAIMED
        self.capacity = int(capacity)
        self.poll = float(poll)
        self.ready.mkdir(parents=True, exist_ok=True)
        self.claimed.mkdir(parents=True, exist_ok=True)

    # -------------------------------------------------------------- state
    def ready_names(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.ready)
                          if _parse_item_name(n) is not None)
        except OSError:
            return []

    def depth(self) -> int:
        """Spooled-and-unclaimed items — the backpressure measure and the
        ``orchestrate/queue_depth`` gauge's value."""
        return len(self.ready_names())

    def claimed_names(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.claimed)
                          if _CLAIM_SEP in n)
        except OSError:
            return []

    def spooled(self, source: str, seq: int) -> bool:
        """Is the item currently in flight (ready or claimed)?"""
        name = item_name(source, seq)
        if (self.ready / name).exists():
            return True
        suffix = _CLAIM_SEP + name
        return any(n.endswith(suffix) for n in self.claimed_names())

    # ---------------------------------------------------------------- put
    def put(self, source: str, seq: int, arrays: Dict[str, np.ndarray],
            extra_meta: Optional[dict] = None) -> bool:
        """Spool one item; blocks on backpressure; False = duplicate.

        The duplicate check makes a restarted producer's re-offer of its
        kill-window item a no-op while the original is still in flight.
        A blocked put aborts with :class:`~hfrep_tpu_torch.resilience.
        Preempted` once a drain is requested — the producer's snapshot
        has not advanced past ``seq``, so resume regenerates it.
        """
        name = item_name(source, seq)
        trace = (extra_meta or {}).get("trace")
        if self.spooled(source, seq):
            _obs_event("queue_put", source=source, seq=seq, duplicate=True,
                       trace=trace)
            return False
        with timeline.timed("queue_wait") as tm:
            while self.depth() >= self.capacity:
                if resilience.drain_requested():
                    raise resilience.Preempted(
                        site="queue_put", reason="drain requested while "
                        f"blocked on backpressure (capacity {self.capacity})")
                time.sleep(self.poll)
        waited = tm.s

        def writer(tmp: Path) -> None:
            np.savez(tmp / "payload.npz", **arrays)

        meta = {"source": source, "seq": int(seq)}
        if extra_meta:
            meta.update(extra_meta)
        # the hop is on disk before the item is visible: a producer
        # SIGKILLed as soon as its item shows in ready/ (the supervisor's
        # ``kill@actor``) has already recorded it, so the trace spans the
        # restart.  A put that then fails leaves a hop with no item; the
        # retry or the restarted producer puts it again.
        _obs_event("queue_put", source=source, seq=seq,
                   wait_s=round(waited, 4), depth=self.depth() + 1, trace=trace)
        ckpt.write_atomic(self.ready / name, writer, metadata=meta,
                          io_site="queue_put", fault_site="queue_item")
        return True

    # --------------------------------------------------------------- claim
    def claim(self, consumer: str) -> Optional[QueueItem]:
        """Atomically claim the first ready item, digest-verified.

        Rename decides races: of N consumers trying the same item,
        exactly one rename succeeds, the rest move on.  A claim that
        fails verification (torn/rotted payload) is discarded with a
        ``queue_item_corrupt`` event — the completeness check at exit
        reports the resulting gap rather than training on damaged data.
        """
        if _CLAIM_SEP in consumer:
            raise ValueError(f"consumer name must not contain "
                             f"{_CLAIM_SEP!r}: {consumer!r}")
        resilience.io_point("queue_get")
        for name in self.ready_names():
            dst = self.claimed / f"{consumer}{_CLAIM_SEP}{name}"
            try:
                os.rename(self.ready / name, dst)
            except OSError:
                continue                    # raced: another consumer won
            source, seq = _parse_item_name(name)
            try:
                meta = ckpt.verify(dst)
            except ckpt.CheckpointCorrupt as e:
                _obs_event("queue_item_corrupt", source=source, seq=seq,
                           error=str(e))
                shutil.rmtree(dst, ignore_errors=True)
                continue
            _obs_event("queue_get", source=source, seq=seq,
                       consumer=consumer, depth=self.depth(),
                       trace=(meta or {}).get("trace"))
            return QueueItem(source=source, seq=seq, path=dst,
                             meta=meta or {})
        return None

    def ack(self, item: QueueItem) -> None:
        """Delete a processed claim (call AFTER publishing the result)."""
        shutil.rmtree(item.path, ignore_errors=True)

    def requeue_claims(self, consumer: Optional[str] = None) -> List[str]:
        """Move claimed items back to ``ready/`` — the supervisor's
        recovery step for a crashed consumer (``consumer=<name>``) and
        the pipeline's resume step for an entire killed pod (None =
        every claim is orphaned)."""
        moved = []
        for name in self.claimed_names():
            owner, _, item = name.partition(_CLAIM_SEP)
            if consumer is not None and owner != consumer:
                continue
            dst = self.ready / item
            try:
                if dst.exists():            # duplicate already re-spooled
                    shutil.rmtree(self.claimed / name, ignore_errors=True)
                else:
                    os.rename(self.claimed / name, dst)
                moved.append(item)
            except OSError:
                continue
        if moved:
            _obs_event("queue_requeue", consumer=consumer, items=len(moved))
        return moved

    # ----------------------------------------------------------------- eof
    def put_eof(self, source: str, count: int) -> None:
        """Publish a source's end-of-stream marker (+ item count) — the
        consumers' termination signal and the gap check's ground truth."""
        path = self.dir / f"{_EOF_PREFIX}{source}.json"
        tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
        tmp.write_text(json.dumps({"source": source, "count": int(count)}))
        os.replace(tmp, path)

    def clear_eof(self, source: str) -> None:
        """Retract a source's end-of-stream marker — the resume-time
        repair path replays a block by clearing its eof + snapshot."""
        try:
            os.remove(self.dir / f"{_EOF_PREFIX}{source}.json")
        except OSError:
            pass

    def eof_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if n.startswith(_EOF_PREFIX) and n.endswith(".json"):
                try:
                    doc = json.loads((self.dir / n).read_text())
                    out[str(doc["source"])] = int(doc["count"])
                except (OSError, ValueError, KeyError):
                    continue
        return out

    def drained(self, sources) -> bool:
        """Every source has published eof AND nothing is spooled or
        claimed — the consumers' safe-exit condition (claims held by a
        live sibling block the exit; orphaned claims are requeued by the
        supervisor before this can deadlock)."""
        eofs = self.eof_counts()
        if any(s not in eofs for s in sources):
            return False
        return not self.ready_names() and not self.claimed_names()
