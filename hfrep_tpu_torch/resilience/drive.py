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
  package's spec names, each bound to its chaos fixture
  (:mod:`hfrep_tpu_torch.resilience.drive_fixtures`);
* :func:`check_registry` — the completeness gate behind ``resilience
  drives --check``.

A drain (exit 75) and a persistent storage failure (exit 74) land a
crash bundle first (:func:`hfrep_tpu_torch.obs.crash.bundle_if_enabled`).
The JAX registry's ``ae_mesh`` spec (the multi-dataset fabric through a
1×1 device mesh) waits for the port's parallelism (ROADMAP queue 1 item
9): :func:`check_registry` names it as the one gap.
"""

from __future__ import annotations

import dataclasses
import importlib
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


#: every spec the JAX package registers: the chaos corpus and the oracle
#: harness key on these names, and :func:`check_registry` holds the port's
#: registry to them
JAX_SPECS = ("ae_sweep", "ae_multi", "ae_mesh", "gan_ckpt", "serve_load", "walkforward",
             "scenario_bank", "rollup", "pipeline", "_planted")

#: specs of the JAX registry that wait for a later part of the port
#: (ROADMAP queue 1 item 9: the 1x1 mesh launch)
DEFERRED_SPECS = {"ae_mesh": "waits for the port's parallelism (ROADMAP queue 1 item 9)"}


@dataclasses.dataclass(frozen=True)
class DriveSpec:
    """One declared long-running workload.

    ``fixture`` is a lazy ``"module:function"`` binding to the drive's
    chaos fixture (``run(out, fixture_seed, resume, device) -> dict`` of
    invariant counters): a dotted string, so the registry imports nothing
    heavy until a subject runs."""

    name: str
    family: str                          # FAMILIES + telemetry/canary
    fixture: str                         # "pkg.mod:func" chaos binding
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

    def load_fixture(self) -> Callable:
        mod, _, fn = self.fixture.partition(":")
        return getattr(importlib.import_module(mod), fn)


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
    included; the watchdog is armed around ``work``; Preempted → a crash
    bundle (drain forensics) → ``drain_hint`` on stderr → 75; OSError in
    the body → a bundle → 74, and at the session boundary (the manifest
    write, the close-path flush) → 74.  ``on_preempt(exc)`` runs inside
    the session after the bundle — the hook for drive-specific drain
    tails (the actors emit ``actor_drained`` and cross the
    ``drain_barrier`` stall site)."""
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
                    from hfrep_tpu_torch.obs.crash import bundle_if_enabled
                    bundle_if_enabled(e)
                    if on_preempt is not None:
                        on_preempt(e)
                    tail = f"; {hint}" if hint else ""
                    print(f"preempted: {e}{tail}", file=sys.stderr)
                    code = EXIT_DRAINED
                except OSError as e:
                    # an I/O error that outlasted the bounded retry policy
                    # at a REQUIRED write: typed 74, never a traceback
                    from hfrep_tpu_torch.obs.crash import bundle_if_enabled
                    bundle_if_enabled(e)
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
        "name": spec.name, "family": spec.family,
        "fixture": spec.fixture, "timeout": spec.timeout,
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


def check_registry() -> Tuple[bool, list]:
    """The completeness gate (``resilience drives --check``): every
    spec's fixture resolves, its sites are registered fault sites, the
    six production families are covered, the chaos subjects mirror the
    registry in both directions, and every spec of the JAX registry is
    registered here (:data:`DEFERRED_SPECS` named as gaps, never
    dropped).  Returns ``(ok, problems)``; imports no torch."""
    from hfrep_tpu_torch.resilience import faults
    from hfrep_tpu_torch.resilience.chaos_subjects import SUBJECTS

    problems = []
    known = (set(faults.BOUNDARY_SITES) | set(faults.IO_SITES)
             | set(faults.POST_SAVE_SITES) | set(faults.ACTOR_SITES))
    for name, spec in DRIVE_REGISTRY.items():
        try:
            fn = spec.load_fixture()
            if not callable(fn):
                problems.append(f"{name}: fixture {spec.fixture!r} is not callable")
        except Exception as e:
            problems.append(f"{name}: fixture {spec.fixture!r} does not resolve: "
                            f"{type(e).__name__}: {e}")
        for site in tuple(spec.boundary_sites) + tuple(spec.hint_sites):
            if site not in known:
                problems.append(f"{name}: unknown fault site {site!r}")
        if spec.family not in FAMILIES + ("telemetry", "canary"):
            problems.append(f"{name}: unknown family {spec.family!r}")
    covered = {s.family for s in DRIVE_REGISTRY.values()}
    for fam in FAMILIES:
        if fam not in covered:
            problems.append(f"drive family {fam!r} has no registered spec")
    reg, subj = set(DRIVE_REGISTRY), set(SUBJECTS)
    if reg - subj:
        problems.append(f"specs without chaos subjects: {sorted(reg - subj)}")
    if subj - reg:
        problems.append(f"chaos subjects without specs: {sorted(subj - reg)}")
    for name in JAX_SPECS:
        if name not in DRIVE_REGISTRY:
            why = DEFERRED_SPECS.get(name, "not ported")
            problems.append(f"{name}: spec of the JAX registry not registered ({why})")
    return (not problems), problems


# ------------------------------------------------------------- registry
# Spec names are the JAX package's: the chaos corpus and the oracle
# harness key on them.
_FX = "hfrep_tpu_torch.resilience.drive_fixtures"

register_drive(DriveSpec(
    name="ae_sweep", family="engine", fixture=f"{_FX}:run_ae_sweep",
    timeout=75.0, boundary_sites=("chunk",),
    snapshot="chunk", double_buffer=True,
    hint_sites=("chunk", "snapshot_save", "snapshot", "obs_append",
                "result_save", "manifest"),
    drain_hint="re-run the same command to resume from the last chunk",
    description="chunked AE latent sweep (engine _drive_chunks; CLI `sweep`)"))

register_drive(DriveSpec(
    name="ae_multi", family="engine", fixture=f"{_FX}:run_ae_multi",
    timeout=75.0, boundary_sites=("chunk",), snapshot="chunk", double_buffer=True,
    hint_sites=("chunk", "snapshot_save", "snapshot", "result_save", "obs_append"),
    description="padded multi-dataset AE fabric (ragged rows via the row counts)"))

register_drive(DriveSpec(
    name="gan_ckpt", family="trainer", fixture=f"{_FX}:run_gan_ckpt",
    timeout=120.0, boundary_sites=("block",),
    snapshot="checkpoint",
    hint_sites=("block", "ckpt_save", "ckpt", "obs_append", "manifest",
                "result_save"),
    drain_hint="re-run with --resume to continue",
    description="GAN block loop with periodic checkpoints + torn/corrupt-walk "
                "restore (CLI `train-gan`)"))

register_drive(DriveSpec(
    name="serve_load", family="serve", fixture=f"{_FX}:run_serve_load",
    timeout=90.0,
    boundary_sites=("serve_drive",), snapshot="none", deterministic=False,
    resumable=False,
    hint_sites=("serve_worker", "serve_result", "batcher", "serve_drive",
                "obs_append"),
    description="serving lifecycle shell: admission/shed/drain with the "
                "zero-silent-drop ledger (CLI `serve`)"))

register_drive(DriveSpec(
    name="walkforward", family="walkforward", fixture=f"{_FX}:run_walkforward",
    timeout=120.0,
    boundary_sites=("chunk", "window"), snapshot="progress",
    hint_sites=("chunk", "window", "snapshot_save", "snapshot", "result_save",
                "obs_append"),
    drain_hint="re-run with --resume to continue (published blocks/windows "
               "are kept and verified)",
    description="walk-forward regime sweep: chunk-snapshot training, "
                "window-granular scoring (CLI `scenario`)"))

register_drive(DriveSpec(
    name="scenario_bank", family="scenario", fixture=f"{_FX}:run_scenario_bank",
    timeout=120.0,
    boundary_sites=("gan_block", "bank_block"), snapshot="blocks",
    hint_sites=("gan_block", "bank_block", "bank_save", "bank", "obs_append",
                "manifest"),
    drain_hint="re-run with --resume to continue (published blocks/windows "
               "are kept and verified)",
    description="conditional-GAN train + deterministic scenario bank "
                "(block-granular resume; CLI `scenario bank`)"))

register_drive(DriveSpec(
    name="rollup", family="telemetry", fixture=f"{_FX}:run_rollup",
    timeout=60.0, boundary_sites=("item",), snapshot="progress",
    hint_sites=("item", "rollup_publish", "obs_append"),
    description="fleet telemetry retention loop: append/rotate/compact against "
                "the durable cursor (no torch)"))

register_drive(DriveSpec(
    name="pipeline", family="orchestrate", fixture=f"{_FX}:run_pipeline",
    timeout=240.0, tier="slow",
    boundary_sites=("supervise", "item", "idle", "drain_barrier"),
    snapshot="queue",
    hint_sites=("item", "idle", "actor", "queue_put", "queue_get",
                "queue_item", "result", "result_save", "snapshot_save",
                "drain_barrier"),
    drain_hint="re-run with --resume to continue from the drained state",
    description="async actor fabric end to end: supervisor + spawned "
                "members over the spool queue (CLI `pipeline`)"))

register_drive(DriveSpec(
    name="_planted", family="canary", fixture=f"{_FX}:run_planted",
    timeout=15.0, tier="test", boundary_sites=("item",),
    hint_sites=("item", "result_save"),
    description="the chaos engine's canary: a deliberate swallowed-EIO silent "
                "drop the search must find (never soaked)"))
