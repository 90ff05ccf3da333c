"""Rule base class + shared AST helpers (dotted names, alias tracking)
(``hfrep_tpu/analysis/rules/base.py``).

Every rule is a stateless object with an ``id`` and a
``check(ctx) -> list[Finding]``; the helpers here answer the questions
the rules keep asking: "what dotted name is this expression?", "what do
`np` / `time` resolve to in this file?", "which nodes belong to this
scope?".  The JAX package's jit helpers have no counterpart: the port
has no jit-compiled functions.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hfrep_tpu_torch.analysis.engine import FileContext, Finding


class Rule:
    id: str = "JAX000"
    name: str = "base"
    description: str = ""

    def check(self, ctx: FileContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


def dotted_name(node: ast.AST) -> Optional[str]:
    """``jax.random.split`` -> "jax.random.split"; None for non-name exprs."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.AST, module: str) -> Set[str]:
    """Dotted prefixes that denote ``module`` in this file: ``import numpy
    as np`` -> {"np"}, ``import numpy`` -> {"numpy"}, ``from jax import
    numpy as jnp`` (module="jax.numpy") -> {"jnp"}."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    names.add(a.asname if a.asname else a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if f"{node.module}.{a.name}" == module:
                    names.add(a.asname or a.name)
    return names


def from_imports(tree: ast.AST, module: str) -> Dict[str, str]:
    """``from <module> import a as b`` -> {"b": "a"}."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def literal_int_tuple(node: ast.AST) -> Optional[Tuple[object, ...]]:
    """Literal ``(4, 8, n)`` -> (4, 8, "n"); names become symbolic strs,
    anything else (calls, subscripts) becomes "_" (unknown).  Returns
    None when the node is not a tuple/list display at all."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    dims: List[object] = []
    for elt in node.elts:
        if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
            dims.append(elt.value)
        elif isinstance(elt, ast.Name):
            dims.append(elt.id)
        elif isinstance(elt, ast.Starred):
            return None             # (*dims, 4): rank unknown
        else:
            dims.append("_")
    return tuple(dims)


def walk_scopes(tree: ast.AST) -> Iterable[ast.AST]:
    """Yield the module and every function/lambda node (each a scope)."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            yield node


def param_names(scope: ast.AST) -> Set[str]:
    """Positional/keyword/vararg names of a function scope, minus
    self/cls."""
    if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return set()
    a = scope.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            names.append(extra.arg)
    return {n for n in names if n not in ("self", "cls")}


def direct_nodes(scope: ast.AST) -> List[ast.AST]:
    """All AST nodes belonging to ``scope`` itself — traversal stops at
    nested function/lambda boundaries (their bodies are their own
    scopes).  The nested def node itself is included (for decorators),
    its body is not."""
    out: List[ast.AST] = []

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            out.append(child)
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                walk(child)

    walk(scope)
    return out
