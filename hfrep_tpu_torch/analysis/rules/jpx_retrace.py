"""JPX004 — retrace hazards visible in an exported program's interface
(``hfrep_tpu/analysis/rules/jpx_retrace.py``).

``torch.export`` specialises every Python value it is handed: a bare
Python scalar reaching the program's signature is baked into the graph
as a ``ConstantArgument``, so the program must be exported again for
every value — the "one program per value for what the author thinks is
one program" hazard the server's compile-storm breaker catches only
after it has cost a storm of builds.  A closure-captured 0-d tensor is
the same hazard in another spelling: the export lifts it into a
constant input, and a config change that SHOULD have been an operand
needs a new program.

Flagged per export boundary:

* inputs that are Python constants (``scalar-in``) — the caller passes a
  raw number where production passes a tensor;
* outputs that are Python constants (``scalar-out``);
* lifted 0-d tensor constants used directly (``captured-const``).

Inner literals are NOT flagged: ``x * 2`` inlines the 2 into one node,
and ``torch.tensor(3.4e38)`` built inside the program reaches the graph
through ``lift_fresh_copy`` — both live inside one program and cannot
split it (JAX's negative fixture).  The rule reads export boundaries
only: an eager fx row is never compiled again, so it has no meaning
there.
"""

from __future__ import annotations

from typing import List

from hfrep_tpu_torch.analysis.engine import Finding
from hfrep_tpu_torch.analysis.rules.jpx_base import (ProgramContext, ProgramRule,
                                                     node_val, op_name)


def _captured_scalar(value) -> bool:
    """A lifted constant that is 0-d and used directly (not copied out by
    ``lift_fresh_copy``, the inner ``torch.tensor(...)`` literal)."""
    shape = getattr(node_val(value), "shape", None)
    if shape is None or tuple(shape) != ():
        return False
    users = list(getattr(value, "users", ()) or ())
    return not users or any(op_name(u) != "lift_fresh_copy" for u in users)


class ProgramRetraceRule(ProgramRule):
    id = "JPX004"
    name = "program-retrace"
    description = ("Python scalar specialised into an exported program's "
                   "interface or a closure-captured 0-d tensor — the "
                   "program must be exported again for every value")

    def check_program(self, pctx: ProgramContext) -> List[Finding]:
        if pctx.boundary.tracer != "export":
            return []
        findings: List[Finding] = []
        n_in = sum(1 for kind, _, _ in pctx.inputs if kind == "constant")
        if n_in:
            findings.append(pctx.finding(
                self.id,
                f"{n_in} Python-scalar input(s) specialised into the program: "
                "every other value needs a new export — pass a tensor",
                token="scalar-in"))
        n_out = sum(1 for kind, _, _ in pctx.outputs if kind == "constant")
        if n_out:
            findings.append(pctx.finding(
                self.id,
                f"{n_out} Python-constant output(s): the program publishes a "
                "value baked in at export time",
                token="scalar-out"))
        n_const = sum(1 for kind, _, value in pctx.inputs
                      if kind == "lifted" and _captured_scalar(value))
        if n_const:
            findings.append(pctx.finding(
                self.id,
                f"{n_const} closure-captured 0-d tensor(s) lifted into the "
                "program as constants — a config value that needs a new "
                "export per change; thread it as an operand",
                token="captured-const"))
        return findings
