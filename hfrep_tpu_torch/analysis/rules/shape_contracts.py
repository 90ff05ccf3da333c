"""JAX006 — shape contract annotations, checked where shapes are literal
(``hfrep_tpu/analysis/rules/shape_contracts.py``).

Two annotation forms, both sharing the grammar in
:mod:`hfrep_tpu_torch.analysis.contracts` (a spec may lead with ``...``,
the leading dims the port batches where JAX vmaps):

* trailing ``# shape: (B, W, F)`` comments on assignments — when the
  right-hand side is a literal-shape constructor (``torch.zeros((4, 8))``,
  ``torch.full((n, 3), v)``, ``x.reshape(4, -1)``), the annotated rank
  and any literal dims are checked against the constructed shape, and
  repeated symbols must bind consistently (``# shape: (B, B)`` over
  ``zeros((3, 4))`` is an error);
* ``@contract("(T,S),(T,K)->(N,K,S)")`` decorators — the spec must
  parse, must not declare more inputs than the function has positional
  parameters, and a literal-constructor ``return`` is rank-checked
  against the output spec.  (Full value checking happens at call time
  via the runtime decorator; this rule catches the annotations that
  could never fire.)

Failure mode being defended: a wrong shape that broadcasts doesn't
crash — the error surfaces as NaNs or a silently transposed product
three modules away.  Pinning intent in a machine-checked comment keeps
the doc and the code from drifting.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple, Union

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import (
    Rule, direct_nodes, dotted_name, literal_int_tuple, param_names,
)
from hfrep_tpu_torch.analysis.contracts import (
    BATCH, ContractError, parse_contract_spec, parse_shape_spec,
)

#: parens can't nest in the spec grammar, so match one balanced group —
#: trailing prose (even with its own parens) is ignored, not "unparseable"
_SHAPE_COMMENT_RE = re.compile(r"#\s*shape:\s*(?P<spec>\([^()#]*\))")

#: constructors whose literal shape argument we can read off the AST:
#: name -> positional index of the shape tuple
_SHAPE_ARG_POS = {
    "zeros": 0, "ones": 0, "empty": 0, "full": 0,
    "normal": 1, "uniform": 1, "truncated_normal": 1,
    "broadcast_to": 1, "zeros_like": None, "ones_like": None,
}


def _constructed_shape(value: ast.AST) -> Optional[Tuple[object, ...]]:
    """Literal shape of a constructor call, with ints literal, names
    symbolic and unknowns "_"; None when the expression isn't one."""
    if not isinstance(value, ast.Call):
        return None
    fname = dotted_name(value.func)
    if fname is None:
        return None
    tail = fname.split(".")[-1]
    if tail == "reshape":
        args = list(value.args)
        root = fname.split(".")[0]
        if root in ("jnp", "np", "numpy", "jax", "torch"):
            args = args[1:]         # function form: jnp.reshape(x, shape)
        # method form: x.reshape(4, -1) or x.reshape((4, -1))
        if len(args) == 1:
            tup = literal_int_tuple(args[0])
            if tup is not None:
                return tup
        dims: List[object] = []
        for a in args:
            if isinstance(a, ast.Constant) and isinstance(a.value, int):
                dims.append(a.value)
            elif isinstance(a, ast.Name):
                dims.append(a.id)
            else:
                return None
        return tuple(dims) if dims else None
    pos = _SHAPE_ARG_POS.get(tail, "missing")
    if pos == "missing" or pos is None:
        return None
    args = list(value.args)
    shape_node = args[pos] if len(args) > pos else None
    for kw in value.keywords:
        if kw.arg == "shape":
            shape_node = kw.value
    if shape_node is None:
        return None
    return literal_int_tuple(shape_node)


def _unify(spec, shape, env: Dict[str, object]) -> Optional[str]:
    """Check one spec against one AST-derived shape; returns an error
    message or None.  Symbolic AST dims ("n") and "_" match anything but
    symbolic spec letters still have to bind consistently over literal
    ints; a leading ``...`` takes any leading dims."""
    if spec == "*" or shape == "*":
        return None
    dims, rest = spec, shape
    if spec and spec[0] == BATCH:
        dims = spec[1:]
        if len(shape) >= len(dims):
            rest = shape[len(shape) - len(dims):]
    if len(dims) != len(rest):
        return (f"rank mismatch: annotation {_fmt(spec)} vs constructed "
                f"shape {_fmt(shape)}")
    for d_spec, d in zip(dims, rest):
        if d_spec == "_" or d == "_":
            continue
        if isinstance(d_spec, int):
            if isinstance(d, int) and d_spec >= 0 and d >= 0 and d_spec != d:
                return (f"dim mismatch: annotation {_fmt(spec)} vs "
                        f"constructed shape {_fmt(shape)}")
        else:                       # symbolic letter: bind consistently
            if isinstance(d, int) and d >= 0:
                bound = env.setdefault(d_spec, d)
                if bound != d:
                    return (f"symbol {d_spec!r} bound to {bound} and "
                            f"{d} in the same annotation")
    return None


def _fmt(dims) -> str:
    return "(" + ", ".join(str(d) for d in dims) + ")"


class ShapeContractRule(Rule):
    id = "JAX006"
    name = "shape-contract"
    description = ("`# shape: (...)` comments and @contract decorators "
                   "verified against literal constructor shapes")

    def check(self, ctx: FileContext) -> List[Finding]:
        findings: List[Finding] = []
        specs = self._comment_specs(ctx, findings)
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                # the annotation may sit on any physical line of a
                # multi-line assignment (usually the last)
                spec = next(
                    (specs[ln] for ln in range(
                        node.lineno, (node.end_lineno or node.lineno) + 1)
                     if ln in specs), None)
                if spec is None or node.value is None:
                    continue
                shape = _constructed_shape(node.value)
                if shape is None:
                    continue        # annotation is documentation only
                err = _unify(spec, shape, {})
                if err:
                    findings.append(ctx.finding(self.id, node, err))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_contract_decorators(ctx, node))
        return findings

    def _comment_specs(self, ctx: FileContext,
                       findings: List[Finding]) -> Dict[int, tuple]:
        """line -> parsed ``# shape:`` spec; bad specs become findings.
        Only real comment tokens are scanned — a ``# shape: (...)``
        example inside a docstring is prose, not a contract."""
        specs: Dict[int, tuple] = {}
        for lineno, text in ctx.comments.items():
            m = _SHAPE_COMMENT_RE.search(text)
            if not m:
                continue
            marker = ast.Expr(value=ast.Constant(value=None))
            marker.lineno, marker.col_offset = lineno, m.start()
            try:
                specs[lineno] = parse_shape_spec(m.group("spec"))
            except ContractError as e:
                findings.append(ctx.finding(
                    self.id, marker, f"unparseable shape annotation: {e}"))
        return specs

    def _check_contract_decorators(self, ctx: FileContext, fn) -> List[Finding]:
        findings: List[Finding] = []
        for dec in fn.decorator_list:
            if not (isinstance(dec, ast.Call)
                    and dotted_name(dec.func) is not None
                    and dotted_name(dec.func).split(".")[-1] == "contract"):
                continue
            if not (dec.args and isinstance(dec.args[0], ast.Constant)
                    and isinstance(dec.args[0].value, str)):
                continue            # dynamic spec: nothing to check statically
            try:
                ins, outs = parse_contract_spec(dec.args[0].value)
            except ContractError as e:
                findings.append(ctx.finding(
                    self.id, dec, f"unparseable @contract spec: {e}"))
                continue
            n_params = len(param_names(fn))
            if len(ins) > n_params:
                findings.append(ctx.finding(
                    self.id, dec,
                    f"@contract on `{fn.name}` declares {len(ins)} input "
                    f"shapes but the function has only {n_params} "
                    f"parameters"))
            # literal-return rank check against the (single) output spec;
            # only THIS function's returns — a nested helper's literal
            # return answers the helper's contract, not this one
            if len(outs) == 1 and outs[0] != "*":
                out = outs[0]
                batched = bool(out) and out[0] == BATCH
                rank = len(out) - batched
                for node in direct_nodes(fn):
                    if isinstance(node, ast.Return) and node.value is not None:
                        shape = _constructed_shape(node.value)
                        if shape is not None and (len(shape) < rank if batched
                                                  else len(shape) != rank):
                            findings.append(ctx.finding(
                                self.id, node,
                                f"`{fn.name}` returns a rank-{len(shape)} "
                                f"literal but @contract declares output "
                                f"{_fmt(outs[0])}"))
        return findings
