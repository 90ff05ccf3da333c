"""The drive envelope: ONE fault-tolerant wrapper for every long-running
workload (``hfrep_tpu/resilience/drive.py``).

* :class:`DriveSpec` — the declaration: name, family, boundary sites,
  snapshot kind, watchdog budget, fault-site hints, drain hint;
* :func:`run_drive` — the runtime: ``graceful_drain`` OUTERMOST (the obs
  session opens inside it, so a SIGTERM during the session's first
  stream append drains instead of killing the process raw), the
  per-drive :func:`~hfrep_tpu_torch.resilience.watchdog`,
  ``drive_start``/``drive_exit`` events and the ``drive/secs`` gauge,
  Preempted → exit 75 (EX_TEMPFAIL), a persistent-storage OSError →
  exit 74 (EX_IOERR), at the session boundary too;
* :func:`drive_boundary` — the boundary crossing for new workloads:
  wall-clock ledger window flush, a ``drive_boundary`` event, then the
  resilience boundary (fault injection and drain);
* :data:`DRIVE_REGISTRY` — the port's registered specs, under the JAX
  package's spec names.

Not ported yet (ROADMAP): ``check_registry``, the completeness gate that
ties each spec to a chaos subject (``chaos_subjects``) and a fixture
drive (``drive_fixtures``), which come with the chaos slice with the specs'
``fixture`` bindings.  The crash-forensics bundle
on a drain is the obs-analysis slice's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable, Dict, Optional, Tuple

#: EX_TEMPFAIL — drained at a safe boundary with state persisted;
#: re-running (with resume where the drive supports it) continues.
EXIT_DRAINED = 75

#: EX_IOERR — persistent storage failure: an EIO burst outlasting the
#: bounded retry policy at a write the drive cannot proceed without.
EXIT_IO = 74

#: every drive runs under a watchdog; a spec without its own budget gets
#: this generous ceiling (a wedged boundary fails LOUDLY inside a day,
#: instead of silently eating a fleet slot forever).
DEFAULT_WATCHDOG_SECS = 24 * 3600.0

#: env override for the watchdog budget (seconds; ``0`` disarms — the
#: escape hatch for legitimately unbounded runs).
ENV_WATCHDOG = "HFREP_DRIVE_WATCHDOG"

#: the six production drive families of the JAX registry
FAMILIES = ("trainer", "engine", "walkforward", "orchestrate", "serve",
            "scenario")


@dataclasses.dataclass(frozen=True)
class DriveSpec:
    """One declared long-running workload (the JAX spec's fields but its
    ``fixture``, the chaos fixture binding, which comes with the chaos
    slice)."""

    name: str
    family: str                          # FAMILIES + telemetry/canary
    timeout: float                       # chaos watchdog budget, seconds
    # sites the drive crosses; [0] is the CANONICAL drain boundary —
    # the one a pod-level SIGTERM reaches (tests/test_drive.py's drain
    # leg injects there; for a supervised fabric that is the
    # supervisor's own loop, not a member's item boundary)
    boundary_sites: Tuple[str, ...] = ()
    snapshot: str = "none"               # chunk|checkpoint|progress|blocks|queue|none
    deterministic: bool = True           # artifacts bit-identical on resume
    resumable: bool = True               # a 75 can be continued
    double_buffer: bool = False          # stop flag read one chunk behind
    tier: str = "fast"                   # fast|slow|test (soak membership)
    hint_sites: Tuple[str, ...] = ()     # schedule-generator bias
    watchdog_secs: Optional[float] = None  # production budget (None=default)
    drain_hint: str = ""                 # appended to the exit-75 message
    description: str = ""


DRIVE_REGISTRY: Dict[str, DriveSpec] = {}


def register_drive(spec: DriveSpec) -> DriveSpec:
    if spec.name in DRIVE_REGISTRY:
        raise ValueError(f"drive {spec.name!r} already registered")
    DRIVE_REGISTRY[spec.name] = spec
    return spec


def resolve_watchdog(spec: DriveSpec,
                     override: Optional[float] = None) -> float:
    """The per-drive budget: explicit caller override, else the
    ``HFREP_DRIVE_WATCHDOG`` env knob, else the spec's own budget, else
    :data:`DEFAULT_WATCHDOG_SECS`.  ``0`` disarms (setitimer(0))."""
    if override is not None:
        return float(override)
    env = os.environ.get(ENV_WATCHDOG)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if spec.watchdog_secs is not None:
        return float(spec.watchdog_secs)
    return DEFAULT_WATCHDOG_SECS


def run_drive(spec: DriveSpec, work: Callable[[], Optional[int]], *,
              obs_dir=None, session_meta: Optional[dict] = None,
              drain_hint: Optional[str] = None,
              watchdog_secs: Optional[float] = None,
              watchdog_name: Optional[str] = None,
              on_preempt: Optional[Callable] = None) -> int:
    """Run ``work`` under the full envelope; return the process exit
    code (``work``'s own int return passes through; 0 when it returns
    None).

    ``graceful_drain`` wraps the WHOLE run, the obs session open
    included; the watchdog is armed around ``work``; Preempted →
    ``drain_hint`` on stderr → 75; OSError in the body or at the session
    boundary (the manifest write, the close-path flush) → 74.
    ``on_preempt(exc)`` runs inside the session first — the hook for
    drive-specific drain tails (the actors emit ``actor_drained`` and
    cross the ``drain_barrier`` stall site)."""
    import hfrep_tpu_torch.obs as obs_pkg
    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.obs import get_obs, timeline

    meta = dict(session_meta or {})
    meta.setdefault("command", spec.name)
    budget = resolve_watchdog(spec, watchdog_secs)
    hint = drain_hint if drain_hint is not None else (spec.drain_hint or "")
    wname = watchdog_name or f"drive {spec.name}"
    with resilience.graceful_drain():
        code = 0
        try:
            with obs_pkg.session(obs_dir, **meta):
                obs = get_obs()
                t0 = timeline.clock()
                if obs.enabled:
                    obs.event("drive_start", drive=spec.name, family=spec.family,
                              watchdog_secs=round(budget, 3))
                try:
                    with resilience.watchdog(budget, wname):
                        code = int(work() or 0)
                except resilience.Preempted as e:
                    if on_preempt is not None:
                        on_preempt(e)
                    tail = f"; {hint}" if hint else ""
                    print(f"preempted: {e}{tail}", file=sys.stderr)
                    code = EXIT_DRAINED
                except OSError as e:
                    # an I/O error that outlasted the bounded retry policy
                    # at a REQUIRED write: typed 74, never a traceback
                    print(f"{spec.name}: storage failed persistently: {e}",
                          file=sys.stderr)
                    code = EXIT_IO
                if obs.enabled:
                    obs.event("drive_exit", drive=spec.name, code=code)
                    obs.gauge("drive/secs").set(round(timeline.clock() - t0, 4),
                                                drive=spec.name)
        except OSError as e:
            print(f"{spec.name}: telemetry storage failed persistently "
                  f"at the session boundary: {e}", file=sys.stderr)
            code = EXIT_IO
        return code


# per-drive window start for drive_boundary's ledger flush
_WINDOW_T0: Dict[str, float] = {}


def drive_boundary(spec: DriveSpec, site: str,
                   steps: Optional[int] = None) -> None:
    """The envelope's boundary crossing: flush the wall-clock ledger
    window accumulated since the previous crossing, emit one
    ``drive_boundary`` event, then cross the resilience boundary (fault
    injection fires; a requested drain raises Preempted)."""
    from hfrep_tpu_torch import resilience
    from hfrep_tpu_torch.obs import get_obs, timeline

    now = timeline.clock()
    t0 = _WINDOW_T0.get(spec.name)
    _WINDOW_T0[spec.name] = now
    obs = get_obs()
    if obs.enabled:
        if t0 is not None:
            timeline.flush_window(now - t0, drive=spec.name, steps=steps)
        obs.event("drive_boundary", drive=spec.name, site=site, steps=steps)
        obs.counter("drive/boundaries").inc(drive=spec.name, site=site)
    resilience.boundary(site)


def spec_capabilities(spec: DriveSpec) -> dict:
    """The machine-readable row behind ``resilience drives``."""
    return {
        "name": spec.name, "family": spec.family, "timeout": spec.timeout,
        "boundary_sites": list(spec.boundary_sites),
        "snapshot": spec.snapshot,
        "deterministic": spec.deterministic,
        "resumable": spec.resumable,
        "double_buffer": spec.double_buffer,
        "tier": spec.tier,
        "hint_sites": list(spec.hint_sites),
        "watchdog_secs": (spec.watchdog_secs
                          if spec.watchdog_secs is not None
                          else DEFAULT_WATCHDOG_SECS),
        "description": spec.description,
    }


# ------------------------------------------------------------- registry
# Spec names are the JAX package's: the chaos corpus and the oracle
# harness key on them.

register_drive(DriveSpec(
    name="ae_sweep", family="engine", timeout=75.0, boundary_sites=("chunk",),
    snapshot="chunk", double_buffer=True,
    hint_sites=("chunk", "snapshot_save", "snapshot", "obs_append",
                "result_save", "manifest"),
    drain_hint="re-run the same command to resume from the last chunk",
    description="chunked AE latent sweep (engine _drive_chunks; CLI `sweep`)"))

register_drive(DriveSpec(
    name="gan_ckpt", family="trainer", timeout=120.0, boundary_sites=("block",),
    snapshot="checkpoint",
    hint_sites=("block", "ckpt_save", "ckpt", "obs_append", "manifest",
                "result_save"),
    drain_hint="re-run with --resume to continue",
    description="GAN block loop with periodic checkpoints + torn/corrupt-walk "
                "restore (CLI `train-gan`)"))

register_drive(DriveSpec(
    name="serve_load", family="serve", timeout=90.0,
    boundary_sites=("serve_drive",), snapshot="none", deterministic=False,
    resumable=False,
    hint_sites=("serve_worker", "serve_result", "batcher", "serve_drive",
                "obs_append"),
    description="serving lifecycle shell: admission/shed/drain with the "
                "zero-silent-drop ledger (CLI `serve`)"))

register_drive(DriveSpec(
    name="walkforward", family="walkforward", timeout=120.0,
    boundary_sites=("chunk", "window"), snapshot="progress",
    hint_sites=("chunk", "window", "snapshot_save", "snapshot", "result_save",
                "obs_append"),
    drain_hint="re-run with --resume to continue (published blocks/windows "
               "are kept and verified)",
    description="walk-forward regime sweep: chunk-snapshot training, "
                "window-granular scoring (CLI `scenario`)"))

register_drive(DriveSpec(
    name="scenario_bank", family="scenario", timeout=120.0,
    boundary_sites=("gan_block", "bank_block"), snapshot="blocks",
    hint_sites=("gan_block", "bank_block", "bank_save", "bank", "obs_append",
                "manifest"),
    drain_hint="re-run with --resume to continue (published blocks/windows "
               "are kept and verified)",
    description="conditional-GAN train + deterministic scenario bank "
                "(block-granular resume; CLI `scenario bank`)"))

register_drive(DriveSpec(
    name="pipeline", family="orchestrate", timeout=240.0, tier="slow",
    boundary_sites=("supervise", "item", "idle", "drain_barrier"),
    snapshot="queue",
    hint_sites=("item", "idle", "actor", "queue_put", "queue_get",
                "queue_item", "result", "result_save", "snapshot_save",
                "drain_barrier"),
    drain_hint="re-run with --resume to continue from the drained state",
    description="async actor fabric end to end: supervisor + spawned "
                "members over the spool queue (CLI `pipeline`)"))
