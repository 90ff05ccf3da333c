"""Supervised async actor fabric (``hfrep_tpu/orchestrate/__init__.py``).

The paper's pipeline (GAN synthesis feeding the AE replication sweep)
runs decoupled instead of serialized: a generator pool streams synthetic
panels into a bounded host-side spool queue and AE sweep consumers pull
from it, under a supervisor that restarts any lost member and drains the
whole pod at a coordinated barrier on SIGTERM.  Podracer architectures
(arxiv 2104.06272) supply the supervision pattern; the generator/
consumer split is where the throughput lives (arxiv 2111.04628).

The three layers:

* :mod:`~hfrep_tpu_torch.orchestrate.queue` — :class:`SpoolQueue`, a bounded
  crash-safe file-backed queue: atomic item publication with embedded
  ``(source, seq, digest)``, rename-based claims, requeue of orphans,
  backpressure instead of unbounded buffering;
* :mod:`~hfrep_tpu_torch.orchestrate.actors` — the member processes
  (generator: deterministic per-``(source, seq)`` items + sub-block
  :class:`~hfrep_tpu_torch.resilience.snapshot.ProgressSnapshot`; consumer:
  idempotent per-item AE sweeps published atomically);
* :mod:`~hfrep_tpu_torch.orchestrate.supervisor` — spawn/watch/restart with
  full-jitter bounded backoff, the ``kill@actor`` fault hook (REAL
  SIGKILL of a live member), and the drain barrier with timeout
  escalation;

plus :mod:`~hfrep_tpu_torch.orchestrate.pipeline` (:func:`run_pipeline`), the
end-to-end drive behind ``python -m hfrep_tpu_torch pipeline``.
"""

from __future__ import annotations

from hfrep_tpu_torch.orchestrate.pipeline import (  # noqa: F401  (public API)
    PipelinePlan,
    PipelineStateError,
    SourceSpec,
    assemble,
    run_pipeline,
)
from hfrep_tpu_torch.orchestrate.queue import QueueItem, SpoolQueue  # noqa: F401
from hfrep_tpu_torch.orchestrate.supervisor import (  # noqa: F401
    ActorSpec,
    OrchestrationError,
    Supervisor,
)
