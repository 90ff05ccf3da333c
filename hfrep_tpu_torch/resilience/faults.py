"""Deterministic fault injection: the ``HFREP_FAULTS`` spec
(``hfrep_tpu/resilience/faults.py``, the same grammar, sites and effects).

On preemptible fleets the failure modes that matter — SIGTERM at an
arbitrary point, torn checkpoint writes, flaky host-side storage — are
exactly the ones a normal test run never exercises.  This module makes
them *injectable on purpose*, deterministically, from one env variable,
so kill→resume and corrupt→fallback paths can be driven end to end by
the tests and ``chip_smoke.py``.  A spec means the same thing to both
packages: the same directives fire at the same occurrences.

Spec grammar (semicolon-separated directives)::

    HFREP_FAULTS = directive [';' directive]*
    directive    = kind '@' site '=' N ['x' COUNT]

``N`` is the 1-based occurrence of ``site`` that triggers the fault;
``x COUNT`` fires it on that and the next ``COUNT - 1`` occurrences
(default 1).  Kinds and the sites they apply to:

======== ===================== ==========================================
kind     sites                 effect at the Nth occurrence
======== ===================== ==========================================
sigterm  boundary              a REAL ``os.kill(getpid(), SIGTERM)`` —
         (:data:`BOUNDARY_    caught by the graceful-drain handler.
         SITES`) or io         Also valid at io sites: the signal then
                               lands DURING that host I/O call (e.g.
                               ``sigterm@snapshot_save=1`` = SIGTERM
                               mid-way through the final drain snapshot)
preempt  boundary, io or       set the drain flag directly (no signal)
         actor
stall    boundary              sleep :data:`STALL_SECS` at the boundary —
                               a member that hangs instead of draining
                               (drives the supervisor's drain-barrier
                               timeout/escalation path); at ``batcher``
                               it wedges the serving layer's batch
                               formation, turning queued requests into
                               a deadline storm the batcher must cancel
                               typed (never dispatch-and-forget)
io_fail  io (:data:`IO_SITES`: raise ``OSError(EIO)`` from that I/O call
         ``ckpt_save``,        (at ``serve_result``: the server's
         ``snapshot_save``,    result-publish boundary — the request
         ``result_save``,      must fail TYPED, never silently)
         ``bank_save``,
         ``obs_append``,
         ``manifest``,
         ``queue_put``,
         ``queue_get``,
         ``serve_result``)
torn     post-save             truncate the just-written payload — a
         (:data:`POST_SAVE_    torn write that survived the process
         SITES`: ``ckpt``,
         ``snapshot``,
         ``queue_item``,
         ``result``, ``bank``)
corrupt  post-save             flip bytes mid-payload (bit rot)
kill     actor (:data:`ACTOR_  tell the caller that owns the victim to
         SITES`: ``actor``,    kill it: the orchestration supervisor
         ``serve_worker``)     SIGKILLs the actor behind the Nth
                               observed queue item
                               (:func:`FaultPlan.actor` returns True;
                               only the supervisor knows the pids), the
                               replication server kills the worker
                               thread holding the Nth dispatched batch
                               mid-flight (its requests must still
                               reach typed terminal outcomes)
======== ===================== ==========================================

The full per-group site vocabulary lives in the module-level registries
:data:`BOUNDARY_SITES` / :data:`IO_SITES` / :data:`POST_SAVE_SITES` /
:data:`ACTOR_SITES` — the single source of truth every hook call and
spec literal is checked against.

Examples::

    HFREP_FAULTS='sigterm@chunk=2'            # kill at the 2nd chunk boundary
    HFREP_FAULTS='io_fail@ckpt_save=1x2'      # first two save calls fail
    HFREP_FAULTS='torn@ckpt=3;preempt@block=5'
    HFREP_FAULTS='kill@actor=2'               # SIGKILL the producer of the
                                              # 2nd queue item the supervisor
                                              # observes

Occurrence counters live on the :class:`FaultPlan` instance, keyed by
(hook group, site), so a plan's behavior is a pure function of the spec
and the sequence of hook calls — no randomness, no wall clock.
"""

from __future__ import annotations

import dataclasses
import difflib
import errno
import os
import re
import signal
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

BOUNDARY_KINDS = ("sigterm", "preempt", "stall")
IO_KINDS = ("io_fail",)
POST_SAVE_KINDS = ("torn", "corrupt")
ACTOR_KINDS = ("kill",)
KINDS = BOUNDARY_KINDS + IO_KINDS + POST_SAVE_KINDS + ACTOR_KINDS

#: THE site registry — every site each hook group fires at, one tuple per
#: group, the JAX package's exactly (a spec is valid in both or neither).
#: A site string at an injection/hook call (``resilience.boundary("chunk")``,
#: ``write_atomic(..., io_site="ckpt_save")``) or inside an
#: ``HFREP_FAULTS`` spec must appear here.  A typo'd site would
#: otherwise just never fire — the silently-disarmed-injection failure
#: mode — so :meth:`FaultPlan.parse` rejects unknown sites at runtime.
BOUNDARY_SITES = (
    "chunk",          # chunked AE engine / scenario training chunk boundary
    "block",          # GAN trainer / multi-seed epoch-block boundary
    "window",         # walk-forward scoring-window boundary
    "item",           # actor produce/consume item boundary
    "idle",           # actor idle-poll boundary
    "supervise",      # orchestration supervisor poll loop
    "drain_barrier",  # coordinated pod-drain barrier crossing
    "batcher",        # serving micro-batch formation loop
    "serve_drive",    # serving selftest drive loop
    "gan_block",      # conditional-GAN bank training block
    "bank_block",     # stress-bank block publication boundary
)
IO_SITES = (
    "ckpt_save",      # checkpoint directory writes (utils/checkpoint.py)
    "snapshot_save",  # chunk/sub-block resume snapshots
    "result_save",    # actor result artifact publication
    "bank_save",      # scenario stress-bank block publication
    "obs_append",     # telemetry event-stream appends
    "manifest",       # run.json manifest writes
    "queue_put",      # spool-queue item publication
    "queue_get",      # spool-queue item claim/read
    "serve_result",   # serving result-publish boundary
    "rollup_publish",  # rollup state/seed/pinned atomic publication
)
POST_SAVE_SITES = (
    "ckpt",           # a published checkpoint directory
    "snapshot",       # a published resume snapshot
    "queue_item",     # a published spool-queue item
    "result",         # a published actor result artifact
    "bank",           # a published stress-bank block
)
ACTOR_SITES = (
    "actor",          # orchestration fabric members (supervisor SIGKILLs)
    "serve_worker",   # serving dispatch worker threads
)
#: every site any hook may be called with; boundary kinds (sigterm /
#: preempt / stall) may target io and actor sites too (the signal lands
#: during that I/O call / at that observed item)
KNOWN_SITES = BOUNDARY_SITES + IO_SITES + POST_SAVE_SITES + ACTOR_SITES

#: how long an injected ``stall`` holds its boundary — long enough that
#: any realistic drain-barrier timeout fires first (the stalled member is
#: then escalated/SIGKILLed; it never wakes up to matter), short enough
#: that a misconfigured test cannot hang CI forever.  Read at fire time,
#: so in-process drivers that stall a *thread* they cannot escalate (the
#: serving chaos scenario stalls the batcher to manufacture a deadline
#: storm) shorten it for the scenario's scope and restore it after.
STALL_SECS = 120.0

_DIRECTIVE_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<site>[a-z_]+)=(?P<n>[0-9]+)(?:x(?P<count>[0-9]+))?$")


class FaultSpecError(ValueError):
    """An ``HFREP_FAULTS`` spec that does not parse."""


#: which sites each kind can actually FIRE at — the hook dispatch above,
#: as data.  Boundary kinds fire at boundary, io and actor sites (the
#: signal lands between chunks, mid-I/O, or at an observed item); the
#: other kinds are hook-specific.  :meth:`FaultPlan.parse` rejects a
#: directive outside its kind's reach: such a spec would parse, never
#: fire, and read as "the system survived" — the silently-disarmed
#: injection again, one level up from an unknown site.
def kind_sites(kind: str) -> Tuple[str, ...]:
    if kind in BOUNDARY_KINDS:
        return BOUNDARY_SITES + IO_SITES + ACTOR_SITES
    if kind in IO_KINDS:
        return IO_SITES
    if kind in POST_SAVE_KINDS:
        return POST_SAVE_SITES
    if kind in ACTOR_KINDS:
        return ACTOR_SITES
    return ()


def site_group(site: str) -> str:
    """The occurrence-counter group a directive at ``site`` ticks
    against (boundary kinds at an io site count io occurrences)."""
    if site in BOUNDARY_SITES:
        return "boundary"
    if site in IO_SITES:
        return "io"
    if site in POST_SAVE_SITES:
        return "post_save"
    return "actor"


#: one-line effect summaries, keyed by kind — the ``explain-faults``
#: CLI's rendering vocabulary (the long-form table lives in the module
#: docstring)
KIND_EFFECTS = {
    "sigterm": "REAL os.kill(SIGTERM) -> graceful-drain handler",
    "preempt": "set the drain flag directly (no signal)",
    "stall": f"sleep STALL_SECS ({STALL_SECS:.0f}s) at the site",
    "io_fail": "raise OSError(EIO) from that host I/O call",
    "torn": "truncate the just-published payload to half",
    "corrupt": "XOR-flip bytes mid-payload (bit rot)",
    "kill": "caller SIGKILLs the actor/worker behind the occurrence",
}


@dataclasses.dataclass(frozen=True)
class Directive:
    kind: str
    site: str
    n: int            # 1-based occurrence that triggers
    count: int = 1    # consecutive occurrences that fire

    def hits(self, occurrence: int) -> bool:
        return self.n <= occurrence < self.n + self.count

    def spec(self) -> str:
        """The directive back in ``HFREP_FAULTS`` grammar — the shrink
        loop re-emits reduced plans through this, so a minimal repro is
        always a paste-able spec."""
        return f"{self.kind}@{self.site}={self.n}" + (
            f"x{self.count}" if self.count != 1 else "")


class FaultPlan:
    """A parsed spec plus its per-(hook group, site) occurrence counters."""

    def __init__(self, directives: Iterable[Directive]):
        self.directives: Tuple[Directive, ...] = tuple(directives)
        self._counts: Dict[Tuple[str, str], int] = {}

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        directives = []
        for part in filter(None, (s.strip() for s in spec.split(";"))):
            m = _DIRECTIVE_RE.match(part)
            if m is None:
                raise FaultSpecError(
                    f"bad fault directive {part!r} (want kind@site=N[xCOUNT])")
            kind = m.group("kind")
            if kind not in KINDS:
                raise FaultSpecError(
                    f"unknown fault kind {kind!r} (one of {', '.join(KINDS)})")
            site = m.group("site")
            if site not in KNOWN_SITES:
                # an unknown site would parse fine and then never fire —
                # the silently-disarmed injection the registry exists to
                # prevent; fail the spec as loudly as an unknown kind,
                # and name the registry's nearest candidates (a repro
                # line with one typo should correct itself in one paste)
                near = difflib.get_close_matches(site, KNOWN_SITES, n=3,
                                                 cutoff=0.4)
                hint = (f"did you mean {', '.join(near)}? " if near else "")
                raise FaultSpecError(
                    f"unknown fault site {site!r} — {hint}(registry: "
                    f"{', '.join(KNOWN_SITES)})")
            if site not in kind_sites(kind):
                # parses, but the dispatching hook would never match it:
                # e.g. io_fail@chunk or torn@actor can't fire by
                # construction — reject as loudly as an unknown site
                raise FaultSpecError(
                    f"{part!r}: kind {kind!r} never fires at site "
                    f"{site!r} (valid sites: "
                    f"{', '.join(kind_sites(kind))})")
            n = int(m.group("n"))
            if n < 1:
                raise FaultSpecError(f"{part!r}: N is 1-based, got {n}")
            directives.append(Directive(kind=kind, site=site, n=n,
                                        count=int(m.group("count") or 1)))
        return cls(directives)

    def spec(self) -> str:
        """The plan back in ``HFREP_FAULTS`` grammar (round-trips through
        :meth:`parse`)."""
        return ";".join(d.spec() for d in self.directives)

    def _tick(self, group: str, site: str) -> int:
        key = (group, site)
        self._counts[key] = occ = self._counts.get(key, 0) + 1
        return occ

    def _matching(self, kinds: Tuple[str, ...], site: str, occ: int):
        for d in self.directives:
            if d.site == site and d.kind in kinds and d.hits(occ):
                yield d

    def _fire_signalish(self, d: Directive, site: str, occ: int) -> None:
        """The sigterm/preempt/stall effects, shared by the boundary and
        io hooks (a SIGTERM can land mid-I/O just as well as between
        chunks — the drain-during-final-checkpoint scenario)."""
        if d.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif d.kind == "stall":
            time.sleep(STALL_SECS)
        else:
            from hfrep_tpu_torch import resilience
            resilience.request_drain(f"injected preempt@{site}={occ}")

    # ------------------------------------------------------------- hooks
    def boundary(self, site: str) -> None:
        """Called by the drives at each ``site`` boundary crossing."""
        occ = self._tick("boundary", site)
        for d in self._matching(BOUNDARY_KINDS, site, occ):
            _note(d, occ)
            self._fire_signalish(d, site, occ)

    def io(self, site: str) -> None:
        """Called just before a host-side I/O operation at ``site``.

        ``io_fail`` raises the injected EIO; boundary kinds (``sigterm``
        / ``preempt`` / ``stall``) fire here too — their occurrence is
        counted against the SAME ("io", site) counter, so e.g.
        ``sigterm@snapshot_save=1`` lands during the first snapshot
        write of the process.
        """
        occ = self._tick("io", site)
        for d in self._matching(BOUNDARY_KINDS, site, occ):
            _note(d, occ)
            self._fire_signalish(d, site, occ)
        for d in self._matching(IO_KINDS, site, occ):
            _note(d, occ)
            raise OSError(errno.EIO, f"injected io_fail@{site} (call {occ})")

    def actor(self, site: str = "actor") -> bool:
        """Called by the orchestration supervisor once per newly observed
        queue item; True = a ``kill`` directive fired and the supervisor
        should SIGKILL the actor that produced it (the effect lives in
        the supervisor — only it knows the member pids).  Boundary kinds
        fire here too: ``preempt@actor=N`` requests a pod drain at the
        Nth observed item — a drain deterministically coupled to stream
        progress rather than to supervision-loop timing."""
        occ = self._tick("actor", site)
        for d in self._matching(BOUNDARY_KINDS, site, occ):
            _note(d, occ)
            self._fire_signalish(d, site, occ)
        fired = False
        for d in self._matching(ACTOR_KINDS, site, occ):
            _note(d, occ)
            fired = True
        return fired

    def post_save(self, site: str, path) -> None:
        """Called after a successful save of ``path`` — may damage it."""
        occ = self._tick("post_save", site)
        for d in self._matching(POST_SAVE_KINDS, site, occ):
            _note(d, occ)
            target = _payload_file(Path(path))
            if target is None:
                continue
            if d.kind == "torn":
                tear_file(target)
            else:
                corrupt_file(target)


def _note(d: Directive, occ: int) -> None:
    """Injected faults announce themselves in the telemetry stream (and
    never anywhere that could mask the fault's own effect)."""
    try:
        from hfrep_tpu_torch.obs import get_obs
        get_obs().event("fault_injected", kind=d.kind, site=d.site,
                        occurrence=occ)
    except Exception:
        pass


def _payload_file(path: Path):
    """The file whose bytes a torn/corrupt directive damages: the largest
    non-metadata file under a checkpoint dir (or the path itself)."""
    if path.is_file():
        return path
    best, best_size = None, -1
    try:
        for f in path.rglob("*"):
            if f.is_file() and f.name != "meta.json":
                size = f.stat().st_size
                if size > best_size:
                    best, best_size = f, size
    except OSError:
        return None
    return best


def tear_file(path: Path) -> None:
    """Simulate a torn write: keep only the first half of the file."""
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.truncate(size // 2)


# ----------------------------------------------------------- explanation
def plan_rows(plan: FaultPlan) -> List[dict]:
    """One dict per directive — the machine form behind
    the JAX package's ``explain-faults`` CLI: kind, site, the
    occurrence-counter group the directive ticks against, the 1-based
    trigger occurrence, the consecutive-fire count, and the effect."""
    return [{"kind": d.kind, "site": d.site,
             "counter": f"({site_group(d.site)}, {d.site})",
             "occurrence": d.n, "count": d.count,
             "spec": d.spec(), "effect": KIND_EFFECTS.get(d.kind, "?")}
            for d in plan.directives]


def render_plan(plan: FaultPlan) -> str:
    """The human table for ``explain-faults`` — a shrunk repro spec one
    paste away from readable."""
    rows = plan_rows(plan)
    if not rows:
        return "(empty plan: no directives)"
    headers = ("kind", "site", "counter", "fires at", "count", "effect")
    cells = [(r["kind"], r["site"], r["counter"],
              f"occurrence {r['occurrence']}"
              + (f"..{r['occurrence'] + r['count'] - 1}"
                 if r["count"] > 1 else ""),
              str(r["count"]), r["effect"]) for r in rows]
    widths = [max(len(h), *(len(c[i]) for c in cells))
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(c.ljust(w) for c, w in zip(row, widths))
              for row in cells]
    return "\n".join(lines)


def corrupt_file(path: Path) -> None:
    """Simulate bit rot: XOR a 16-byte run in the middle of the file."""
    size = path.stat().st_size
    if size == 0:
        return
    start = size // 2
    length = min(16, size - start) or size
    with open(path, "r+b") as f:
        f.seek(start)
        chunk = f.read(length)
        f.seek(start)
        f.write(bytes(b ^ 0xFF for b in chunk))
