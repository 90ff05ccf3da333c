"""Rule registry (``hfrep_tpu/analysis/rules/__init__.py``).  Rule IDs are
stable API and keep the JAX package's: baselines, ``# noqa:`` codes and
CI configuration all key on them, so ``# noqa: HF009`` means the same in
both packages.  The JAX rules with no PyTorch meaning are not carried
(``hfrep_tpu_torch/analysis/README.md``'s rule table says why)."""

from __future__ import annotations

from hfrep_tpu_torch.analysis.rules.base import Rule  # noqa: F401
from hfrep_tpu_torch.analysis.rules.py_mutation import MutationRule
from hfrep_tpu_torch.analysis.rules.shape_contracts import ShapeContractRule
from hfrep_tpu_torch.analysis.rules.hf_gauge_thresholds import GaugeThresholdRule
from hfrep_tpu_torch.analysis.rules.hf_fault_sites import FaultSiteRule
from hfrep_tpu_torch.analysis.rules.hf_atomic_writes import AtomicWriteRule
from hfrep_tpu_torch.analysis.rules.hf_obs_doc import ObsDocRule
from hfrep_tpu_torch.analysis.rules.hf_thread_signal import ThreadSignalRule
from hfrep_tpu_torch.analysis.rules.hf_exit_codes import ExitCodeRule
from hfrep_tpu_torch.analysis.rules.hf_mesh_launch import MeshLaunchRule
from hfrep_tpu_torch.analysis.rules.hf_wallclock import WallClockRule
from hfrep_tpu_torch.analysis.rules.hf_boundary_sync import BoundarySyncRule
from hfrep_tpu_torch.analysis.rules.hf_drive_envelope import DriveEnvelopeRule
from hfrep_tpu_torch.analysis.rules.jpx_base import ProgramRule  # noqa: F401
from hfrep_tpu_torch.analysis.rules.jpx_precision import ProgramPrecisionRule
from hfrep_tpu_torch.analysis.rules.jpx_hostsync import ProgramHostSyncRule
from hfrep_tpu_torch.analysis.rules.jpx_retrace import ProgramRetraceRule

ALL_RULES = (
    MutationRule(),
    ShapeContractRule(),
    # cross-layer rules: whole-project string-protocol invariants, fed by
    # the ProjectModel pre-pass
    GaugeThresholdRule(),
    FaultSiteRule(),
    AtomicWriteRule(),
    ObsDocRule(),
    ThreadSignalRule(),
    ExitCodeRule(),
    # the single-mesh-API discipline: process groups and collectives
    # outside hfrep_tpu_torch/parallel/
    MeshLaunchRule(),
    # the wall-clock ledger's monopoly: raw clock reads outside
    # hfrep_tpu_torch/obs/ measure time the ledger cannot conserve
    WallClockRule(),
    # the async boundary engine's overlap contract: an eager device sync
    # inside a boundary loop re-serializes the drive
    BoundarySyncRule(),
    # the drive runtime's monopoly: hand-rolled survival envelopes outside
    # resilience/drive.py regrow the copy-paste class
    DriveEnvelopeRule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}

#: the program-audit rules: run over TRACED programs by ``python -m
#: hfrep_tpu_torch.analysis audit``, never over source text — deliberately
#: not in ALL_RULES so `check` runs stay trace-free
PROGRAM_RULES = (
    ProgramPrecisionRule(),
    ProgramHostSyncRule(),
    ProgramRetraceRule(),
)

PROGRAM_RULES_BY_ID = {r.id: r for r in PROGRAM_RULES}
