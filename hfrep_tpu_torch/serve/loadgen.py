"""Load generation + outcome classification (``hfrep_tpu/serve/loadgen.py``).

Requests are submitted open-loop in waves, every future is awaited to
its terminal outcome, and the report classifies all of them.  Latency
numbers are the server-side per-request latencies of fresh results
(admission → result publish, queue wait included).  The whole offered
load is one ``serve_load`` window of the wall-clock ledger
(:mod:`~hfrep_tpu_torch.obs.timeline`).
"""

from __future__ import annotations

from concurrent.futures import Future, wait
from typing import Callable, List, Optional, Sequence

import numpy as np

from hfrep_tpu_torch.obs import timeline
from hfrep_tpu_torch.serve.admission import (
    DeadlineExceeded,
    Draining,
    InvalidRequest,
    Overloaded,
    ServerClosed,
    WorkerFault,
)

#: exception class → report bucket (anything else lands in ``errors``)
_BUCKETS = ((Overloaded, "shed"), (DeadlineExceeded, "deadline"),
            (Draining, "draining"), (WorkerFault, "worker_faults"),
            (ServerClosed, "closed"), (InvalidRequest, "invalid"))

#: every terminal bucket a future can land in — report["terminal"] sums
#: these, and the zero-silent-drop check is terminal == submitted
TERMINAL_KEYS = ("results", "stale", "shed", "deadline", "draining",
                 "worker_faults", "closed", "invalid", "errors")


def percentile(sorted_vals, pct: int) -> Optional[float]:
    """Nearest-rank percentile (rank ``ceil(pct/100 * n)``)."""
    n = len(sorted_vals)
    if not n:
        return None
    return sorted_vals[max(0, (n * pct + 99) // 100 - 1)]


def make_panels(seed: int, feats: int, rows_choices: Sequence[int],
                variants: int = 8) -> List[np.ndarray]:
    """A deterministic pool of tenant panels with mixed row counts."""
    g = np.random.default_rng(seed)
    out = []
    for i in range(variants):
        rows = int(rows_choices[i % len(rows_choices)])
        z = g.normal(size=(rows, 3))
        out.append((z @ g.normal(size=(3, feats))
                    + 0.05 * g.normal(size=(rows, feats))
                    ).astype(np.float32) * 0.02)
    return out


def classify(futures: List[Future]) -> dict:
    """Every future into exactly one bucket; latencies from fresh
    results.  Futures must all be done (the caller waited)."""
    doc = {k: 0 for k in TERMINAL_KEYS}
    latencies: List[float] = []
    for f in futures:
        err = f.exception()
        if err is None:
            res = f.result()
            if getattr(res, "stale", False):
                doc["stale"] += 1
            else:
                doc["results"] += 1
                latencies.append(float(res.latency_ms))
            continue
        for cls, bucket in _BUCKETS:
            if isinstance(err, cls):
                doc[bucket] += 1
                break
        else:
            doc["errors"] += 1
    doc["latencies_ms"] = latencies
    return doc


def drive_load(server, total: int, panels: Sequence[np.ndarray], *,
               timeout_ms: Optional[float] = None,
               sample_every: int = 0,
               wave: int = 512,
               on_wave: Optional[Callable[[int], None]] = None,
               trace_prefix: Optional[str] = None,
               keep_futures: bool = False) -> dict:
    """Offer ``total`` queries in waves of ``wave`` and account for every
    terminal outcome.

    ``sample_every > 0`` turns every Nth request into a one-window
    ``sample`` query (when the server carries a generator).
    ``on_wave(submitted)`` runs after each wave: the verb's drain poll,
    which may raise to stop the load (the futures already offered are
    still awaited).  ``trace_prefix`` submits request ``j`` with the
    trace ID ``<prefix><j:06d>`` and adds the IDs under ``"trace_ids"``;
    None lets the server mint them.  ``keep_futures`` adds the awaited
    futures, in submission order, under ``"futures"`` so a caller can
    check answers.
    """
    futures: List[Future] = []
    trace_ids: List[str] = []
    t0 = timeline.clock()
    submitted = 0
    try:
        while submitted < total:
            n = min(wave, total - submitted)
            for j in range(submitted, submitted + n):
                tid = None
                if trace_prefix is not None:
                    tid = f"{trace_prefix}{j:06d}"
                    trace_ids.append(tid)
                if (sample_every and server.gen_model is not None
                        and j % sample_every == sample_every - 1):
                    futures.append(server.sample(1, timeout_ms=timeout_ms,
                                                 trace_id=tid))
                else:
                    futures.append(server.replicate(panels[j % len(panels)],
                                                    timeout_ms=timeout_ms,
                                                    trace_id=tid))
            submitted += n
            if on_wave is not None:
                on_wave(submitted)
    finally:
        wait(futures)
        wall = timeline.clock() - t0
    # one ledger window for the whole load: the workers booked queue_wait,
    # dispatch and device_compute into the shared ledger as they served it
    timeline.flush_window(wall, drive="serve_load", steps=submitted)
    doc = classify(futures)
    if trace_prefix is not None:
        doc["trace_ids"] = trace_ids
    lat = sorted(doc.pop("latencies_ms"))
    done = doc["results"] + doc["stale"]
    doc.update({
        "submitted": submitted,
        "wall_s": round(wall, 4),
        "qps": round(done / wall, 2) if wall > 0 else None,
        "p50_ms": percentile(lat, 50),
        "p95_ms": percentile(lat, 95),
        "shed_rate": round((doc["shed"] + doc["draining"]) / submitted, 4)
        if submitted else 0.0,
        "terminal": sum(doc[k] for k in TERMINAL_KEYS),
    })
    if keep_futures:
        doc["futures"] = futures
    return doc
