"""Chaos subjects: the registry-derived view the fault-schedule search
exercises (``hfrep_tpu/resilience/chaos_subjects.py``).

A subject is one end-to-end drive, wrapped so that a run is a pure
function of ``(fixture_seed, schedule)`` on its device.  The subject
list is derived from :data:`~hfrep_tpu_torch.resilience.drive.
DRIVE_REGISTRY`: every registered spec becomes one :class:`Subject` (its
``fixture`` binding is the run function; ``timeout``, ``tier`` and
``hint_sites`` carry over), so a workload registered with the drive
runtime is born chaos-covered; ``drive.check_registry`` fails if the two
views ever diverge.  The fixture bodies live in
:mod:`hfrep_tpu_torch.resilience.drive_fixtures`.

The chaos engine (:mod:`hfrep_tpu_torch.resilience.chaos`) spawns each
run as a fresh subprocess (``python -m hfrep_tpu_torch.resilience
chaos-subject NAME --out DIR --device DEV``) with the schedule's
``HFREP_FAULTS`` spec in the environment, and judges the wreckage with
the shared oracles (:mod:`hfrep_tpu_torch.resilience.chaos_oracles`).

What :func:`subject_main` enforces (a thin shell over
:func:`~hfrep_tpu_torch.resilience.drive.run_drive`):

* the drive runs under its own watchdog and a real obs session at
  ``<out>/obs`` (stream health and crash-bundle presence are oracle
  surfaces); a drain maps to exit 75 after a crash bundle;
* the stream carries the process's hand-kernel launches as
  ``launches/*`` counters (``obs.emit_launch_counts``), as a pipeline
  member's does;
* final outputs land under ``<out>/artifacts`` through the atomic
  writers, scratch state under ``<out>/scratch``; a completed run
  publishes ``chaos_result.json`` with its invariant counters.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Tuple

from hfrep_tpu_torch.resilience.drive import DRIVE_REGISTRY, DriveSpec

#: an injected ``stall`` holds its site for ``faults.STALL_SECS`` so that a
#: supervisor's escalation wins; a single-process subject has no escalator,
#: so the harness shortens it to a bounded delay the deadlines must absorb
SUBJECT_STALL_SECS = 0.5


@dataclasses.dataclass(frozen=True)
class Subject:
    """One chaos subject: the engine's view of a registered drive."""

    name: str
    run: Callable[[Path, int, bool, str], dict]
    timeout: float                 # in-process watchdog budget, seconds
    deterministic: bool = True     # artifacts bit-identical to the reference
    tier: str = "fast"             # "fast" = soak default; "slow" = opt-in
    hint_sites: Tuple[str, ...] = ()


def _subject_of(spec: DriveSpec) -> Subject:
    def run(out: Path, fixture_seed: int, resume: bool, device: str = "cuda",
            _spec: DriveSpec = spec) -> dict:
        # lazy: the registry lists without importing the training stacks
        return _spec.load_fixture()(out, fixture_seed, resume, device)

    return Subject(name=spec.name, run=run, timeout=spec.timeout,
                   deterministic=spec.deterministic, tier=spec.tier,
                   hint_sites=tuple(spec.hint_sites))


#: derived, never hand-edited: one subject per registered spec, in
#: registration order
SUBJECTS: Dict[str, Subject] = {name: _subject_of(spec) for name, spec in DRIVE_REGISTRY.items()}


def fast_subjects() -> Tuple[str, ...]:
    """The default soak set (registration order, hidden and slow excluded)."""
    return tuple(n for n, s in SUBJECTS.items() if s.tier == "fast" and not n.startswith("_"))


# ------------------------------------------------------------ subprocess
RESULT_NAME = "chaos_result.json"


def _emit_launches() -> None:
    """The process's hand-kernel launches into its stream; nothing when no
    kernel module was imported (a drive that touched no tensor)."""
    if "hfrep_tpu_torch.ops.cuda_lstm" in sys.modules:
        from hfrep_tpu_torch.obs import emit_launch_counts
        emit_launch_counts()


def subject_main(name: str, out_dir: str, fixture_seed: int, resume: bool,
                 device: str = "cuda") -> int:
    """The ``chaos-subject`` subprocess entry: one fixture run on
    ``device`` under the full :func:`~hfrep_tpu_torch.resilience.drive.
    run_drive` envelope (0 complete, 75 drained with state persisted, 74
    persistent storage failure, anything else a bug the oracles flag)."""
    from hfrep_tpu_torch.resilience import faults
    from hfrep_tpu_torch.resilience.drive import run_drive

    spec = DRIVE_REGISTRY.get(name)
    if spec is None:
        print(f"unknown chaos subject {name!r} (registry: {', '.join(sorted(DRIVE_REGISTRY))})",
              file=sys.stderr)
        return 2
    out = Path(out_dir)
    for sub in ("artifacts", "scratch"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    faults.STALL_SECS = SUBJECT_STALL_SECS
    invariants: dict = {}

    def work() -> int:
        try:
            invariants.update(spec.load_fixture()(out, fixture_seed, resume, device) or {})
        finally:
            _emit_launches()
        return 0

    code = run_drive(
        spec, work, obs_dir=out / "obs",
        session_meta={"command": f"chaos:{name}",
                      "chaos": {"subject": name, "fixture_seed": fixture_seed,
                                "resume": resume, "device": device}},
        watchdog_secs=spec.timeout, watchdog_name=f"chaos subject {name}")
    if code:
        return code
    from hfrep_tpu_torch.utils.checkpoint import atomic_text
    atomic_text(out / RESULT_NAME, json.dumps(
        {"v": 1, "subject": name, "fixture_seed": fixture_seed, "resumed": bool(resume),
         "invariants": invariants}, indent=2, sort_keys=True))
    return 0
