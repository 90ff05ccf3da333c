"""hfrep_tpu_torch.analysis — static lint, shape contracts and
cross-layer invariant checking for the port (``hfrep_tpu/analysis``).

A pure-AST analyzer (no torch import, no CUDA context): mutable
defaults (JAX005) and shape-contract annotations (JAX006), plus a
two-phase whole-project pass (:mod:`hfrep_tpu_torch.analysis.project`)
behind the cross-layer rules for the string-protocol invariants a
per-file linter structurally cannot see: history-store gauge directions
(HF001), fault-site registry round-trips (HF002), atomic-publish
discipline (HF003), the obs schema tables (HF004), signal-handler and
lock discipline (HF006), the drain exit contract (HF007), the one mesh
API (HF008), the wall-clock ledger's monopoly (HF009), eager syncs in
boundary loops (HF010) and the drive envelope (HF011); and the program
audit (:mod:`hfrep_tpu_torch.analysis.programs`), the JPX rules over
the port's traced programs.  Rule ids are the JAX package's.  See
``hfrep_tpu_torch/analysis/README.md`` for the rule catalogue and
``python -m hfrep_tpu_torch.analysis check --help`` for the CLI.

Importing ``hfrep_tpu_torch`` imports torch (its ``__init__`` sets MKL's
mode and a cuBLAS flag); the modules of this package import neither it
nor anything that does at their top level, so their checks run on a bare
CPython; only the audit's tracer imports torch, when it traces.
"""

from __future__ import annotations

from hfrep_tpu_torch.analysis.engine import (  # noqa: F401
    AnalysisError,
    FileContext,
    Finding,
    analyze_paths,
    analyze_source,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from hfrep_tpu_torch.analysis.contracts import (  # noqa: F401
    ContractError,
    contract,
    parse_contract_spec,
    parse_shape_spec,
)
from hfrep_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID  # noqa: F401
