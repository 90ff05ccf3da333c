"""JPX003 — a host sync inside a loop body
(``hfrep_tpu/analysis/rules/jpx_hostsync.py``).

A sync executed PER ITERATION forces a device→host round trip each
time round: the multi-step block that exists to amortise one dispatch
over many epochs silently degrades back to one sync per epoch, and the
dispatch-vs-compute overlap the perf microscope measures collapses.

The syncs of a traced torch program: ``aten._local_scalar_dense``
(``.item()``, ``bool(t)``, ``float(t)``), a ``_to_copy`` / ``to`` /
``copy_`` that lands a device tensor on the CPU, and the ops whose
output shape depends on the data (``nonzero``, ``masked_select``,
``unique``...), which must read the data back to size their result.

In a traced graph Python loops unroll, so "inside a loop body" means:
its count grows with the loop's length.  The engine traces each loop
boundary twice, the second time one iteration longer
(``steps_per_call`` 2 and 3, the AE chunk at 2 and 3 epochs); a sync
whose count grows is the per-iteration sync JAX flags under
``scan``/``while``; one whose count stays the same is top level — a
one-off host read per program dispatch, the ordinary logging posture —
and allowed, as in JAX.
"""

from __future__ import annotations

from collections import Counter
from typing import List

from hfrep_tpu_torch.analysis.engine import Finding
from hfrep_tpu_torch.analysis.rules.jpx_base import (ProgramContext, ProgramRule,
                                                     call_nodes, device_of, node_val,
                                                     op_name, tensor_args)

#: ops that read a device value back to the host by definition
SCALAR_READS = frozenset({"_local_scalar_dense", "item"})
#: ops whose output shape depends on the data
DATA_SHAPED = frozenset({"nonzero", "nonzero_static", "masked_select", "unique",
                         "_unique", "_unique2", "unique_consecutive", "unique_dim"})
#: copies that may land a tensor on the host
COPIES = frozenset({"_to_copy", "to", "copy_", "_copy_from"})


def sync_kind(node) -> str:
    """The sync a node is ("" when none)."""
    name = op_name(node)
    if name in SCALAR_READS or name in DATA_SHAPED:
        return name
    if name in COPIES:
        ins = [device_of(v) for v in tensor_args(node)]
        out = device_of(node_val(node))
        if out == "cpu" and any(d not in (None, "cpu") for d in ins[:1]):
            return f"{name}->cpu"
    return ""


def sync_census(graph) -> Counter:
    return Counter(k for k in map(sync_kind, call_nodes(graph)) if k)


class ProgramHostSyncRule(ProgramRule):
    id = "JPX003"
    name = "program-host-sync"
    description = ("host sync whose count grows with the loop's length — "
                   "one device→host sync per iteration defeats the "
                   "multi-step dispatch amortization")

    def check_program(self, pctx: ProgramContext) -> List[Finding]:
        if pctx.graph is None or pctx.loop_graph is None:
            return []
        short, long_ = sync_census(pctx.graph), sync_census(pctx.loop_graph)
        return [pctx.finding(
            self.id,
            f"{n - short[name]}× `{name}` per loop iteration ({short[name]}× → "
            f"{n}× with one more) — a host sync per iteration; hoist it out of "
            "the loop or batch it into the stacked per-epoch outputs",
            token=name) for name, n in sorted(long_.items()) if n > short[name]]
