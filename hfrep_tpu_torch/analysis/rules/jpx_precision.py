"""JPX002 — precision-policy conformance of a traced program
(``hfrep_tpu/analysis/rules/jpx_precision.py``).

A boundary registered with ``policy="bf16"`` promises its products run
at the card's bf16 tensor-core rate.  The classic leak: one code path
builds the model WITHOUT threading the compute dtype (a constructor
default, a serving head built from a different factory than training),
and the bf16 configuration silently traces full-f32 products — correct
numerics, a fraction of the tensor-core rate, and nothing crashes so
nobody notices.

The check counts the products whose tensor operands are all float32 —
``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``, ``matmul``, ``linear``
and ``convolution`` nodes — and the hand kernels' nodes
(``hfrep.lstm_fwd`` and the other ``hfrep.*`` calls) whose stream
operands, ``xz`` and ``rec``, are float32: a bf16 program that feeds
the kernel float32 streams is the same leak.  float32 *accumulation* is
deliberate policy here — losses, optimizer updates and reductions lift
to float32 (``core/precision.py``) — but those are adds and mults, not
products; the rare legitimate float32 product under a bf16 policy is
declared per boundary via ``f32_dot_allow``.  Boundaries with
``policy="fp32"`` (the default) are exempt: all-float32 programs are
the contract there.
"""

from __future__ import annotations

from typing import List

from hfrep_tpu_torch.analysis.engine import Finding
from hfrep_tpu_torch.analysis.rules.jpx_base import (ProgramContext, ProgramRule,
                                                     arg_dtypes, call_nodes, is_kernel,
                                                     op_name)

PRODUCT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "matmul", "linear",
                         "convolution", "_convolution", "conv1d", "conv2d"})


def count_f32_products(graph) -> int:
    """float32 products plus kernel nodes fed float32 streams."""
    n = 0
    for node in call_nodes(graph):
        dtypes = arg_dtypes(node)
        if is_kernel(node):
            streams = dtypes[:2]            # (xz, rec): the kernels' leading operands
            if streams and all(d == "float32" for d in streams):
                n += 1
        elif op_name(node) in PRODUCT_OPS:
            if dtypes and all(d == "float32" for d in dtypes):
                n += 1
    return n


class ProgramPrecisionRule(ProgramRule):
    id = "JPX002"
    name = "program-precision"
    description = ("f32 product in the compute path of a bf16-policy "
                   "program — a dtype not threaded through one build "
                   "path runs the products off the bf16 tensor cores")

    def check_program(self, pctx: ProgramContext) -> List[Finding]:
        if pctx.boundary.policy != "bf16" or pctx.graph is None:
            return []
        count = count_f32_products(pctx.graph)
        allow = pctx.boundary.f32_dot_allow
        if count <= allow:
            return []
        return [pctx.finding(
            self.id,
            f"{count} f32 product(s) in a bf16-policy program "
            f"(allowlist {allow}) — a compute dtype was not threaded into "
            "this build path",
            token="f32dot")]
