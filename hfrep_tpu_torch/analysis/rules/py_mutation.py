"""JAX005 — mutable default arguments (``hfrep_tpu/analysis/rules/py_mutation.py``).

``def f(x, acc=[])``: the default is evaluated once at import, so state
leaks across calls.  Checked on every function.

The JAX rule's other half — in-place mutation of arguments inside
jit/pmap/shard_map-compiled functions, whose compiled program replays
the traced values — keys on jit-compiled functions, and the port has
none: it is not carried.
"""

from __future__ import annotations

import ast
from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule

_MUTABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set)
_MUTABLE_CALLS = {"list", "dict", "set", "bytearray", "defaultdict",
                  "OrderedDict", "Counter", "deque"}


class MutationRule(Rule):
    id = "JAX005"
    name = "arg-mutation"
    description = "mutable default arguments (any function)"

    def check(self, ctx: FileContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_defaults(ctx, node))
        return findings

    def _check_defaults(self, ctx: FileContext, fn) -> List[Finding]:
        findings: List[Finding] = []
        a = fn.args
        for default in [*a.defaults, *[d for d in a.kw_defaults if d]]:
            bad = isinstance(default, _MUTABLE_DISPLAYS)
            if (not bad and isinstance(default, ast.Call)
                    and isinstance(default.func, ast.Name)
                    and default.func.id in _MUTABLE_CALLS):
                bad = True
            if bad:
                findings.append(ctx.finding(
                    self.id, default,
                    f"mutable default argument in `{fn.name}`; default "
                    f"to None and construct inside the body"))
        return findings
