"""hfrep_tpu_torch.serve — the replication server on PyTorch/CUDA.

Counterpart of ``hfrep_tpu.serve``: the same envelope (typed terminal
outcomes, bounded admission, deadline-aware micro-batching, circuit
breaker with last-good answers, requeue-once fail-over, drain) around
PyTorch programs, with the LSTM recurrence of ``sample`` requests on the
hand-written Hopper kernel.
"""

from __future__ import annotations

from hfrep_tpu_torch.serve.admission import (  # noqa: F401  (public re-exports)
    CircuitBreaker,
    DeadlineExceeded,
    Draining,
    InvalidRequest,
    Overloaded,
    ServeError,
    ServerClosed,
    WorkerFault,
)
from hfrep_tpu_torch.serve.aot import (  # noqa: F401
    AEServeModel,
    GenServeModel,
    torch_export_supported,
)
from hfrep_tpu_torch.serve.batcher import MicroBatcher, ServeRequest  # noqa: F401
from hfrep_tpu_torch.serve.server import (  # noqa: F401
    ReplicationServer,
    ServeConfig,
    ServeResult,
)
