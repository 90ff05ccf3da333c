"""Load generation + outcome classification (``hfrep_tpu/serve/loadgen.py``).

Requests are submitted open-loop, every future is awaited to its
terminal outcome, and the report classifies all of them.  Latency
numbers are the server-side per-request latencies of fresh results
(admission → result publish, queue wait included).  The JAX version's
wall-clock ledger (``timeline``) is not ported yet.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, wait
from typing import List, Optional, Sequence

import numpy as np

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
               keep_futures: bool = False) -> dict:
    """Offer ``total`` queries and account for every terminal outcome.

    ``sample_every > 0`` turns every Nth request into a one-window
    ``sample`` query (when the server carries a generator).
    ``keep_futures`` adds the awaited futures, in submission order, under
    ``"futures"`` so a caller can check answers.
    """
    futures: List[Future] = []
    t0 = time.perf_counter()
    try:
        for j in range(total):
            if (sample_every and server.gen_model is not None
                    and j % sample_every == sample_every - 1):
                futures.append(server.sample(1, timeout_ms=timeout_ms))
            else:
                futures.append(server.replicate(panels[j % len(panels)],
                                                timeout_ms=timeout_ms))
    finally:
        wait(futures)
        wall = time.perf_counter() - t0
    submitted = len(futures)
    doc = classify(futures)
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
