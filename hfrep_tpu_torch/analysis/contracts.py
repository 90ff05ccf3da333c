"""Shape contracts: ``@contract("(B,W,F)->(B,W,H)")`` + spec parsing
(``hfrep_tpu/analysis/contracts.py``).

One tiny grammar serves three consumers:

* the **runtime decorator** below — checks argument/return ranks and
  literal dims at every call (eager PyTorch has no trace time, so the
  check runs per call; none of the decorated functions runs per
  training step);
* the **static rule** JAX006 (:mod:`hfrep_tpu_torch.analysis.rules.shape_contracts`)
  — verifies ``# shape: (...)`` comments and ``@contract`` specs against
  literal constructor shapes without running anything;
* humans — the spec doubles as the only shape doc that can't go stale.

Grammar::

    spec     := shapes "->" shapes
    shapes   := shape ("," shape)*
    shape    := "(" ["...,"] dim ("," dim)* ")" | "()" | "*"
    dim      := INT | NAME | "_"          # "_" matches anything

``*`` opts a whole position out (any rank).

A leading ``...`` matches zero or more leading dims and binds them once
per call, as ``jax.vmap``'s batch does: the JAX package maps its
per-lane functions over lanes, the port calls them on lane-batched
tensors, so ``(T,S),(...,T,K)->(...,N,K,S)`` takes ``x`` of any batch
shape and requires the output to repeat it.  A spec without ``...``
means exactly what it means in the JAX package.

Symbolic NAMEs bind consistently across one call: ``(T,S),(T,K)->(N,K,S)``
requires both inputs to share T and the output to repeat the K/S bound
from the inputs.  Checks are skipped for arguments without a ``.shape``
(python scalars, configs) so decorated functions stay polymorphic.
Set ``HFREP_CONTRACTS=0`` to disable runtime checking entirely.
"""

from __future__ import annotations

import functools
import os
import re
from typing import Dict, List, Sequence, Tuple, Union

Dim = Union[int, str]          # int literal, symbolic name, "_" wildcard or "..."
ShapeSpec = Tuple[Dim, ...]

#: the leading-dims token: binds a tuple of dims, once per call
BATCH = "..."

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class ContractError(Exception):
    """A shape contract failed to parse or was violated at call time."""


def parse_shape_spec(text: str) -> Union[ShapeSpec, str]:
    """``"(B, T, F)"`` -> ``("B", "T", "F")``; ``"()"`` -> ``()``;
    ``"(..., T, F)"`` -> ``("...", "T", "F")``; ``"*"`` -> ``"*"`` (any
    rank: this position is unchecked)."""
    t = text.strip()
    if t == "*":
        return "*"
    if not (t.startswith("(") and t.endswith(")")):
        raise ContractError(f"shape spec must be parenthesized: {text!r}")
    inner = t[1:-1].strip()
    if not inner:
        return ()
    dims: List[Dim] = []
    for part in inner.split(","):
        part = part.strip()
        if not part:
            continue               # tolerate a trailing comma: "(B,)"
        if re.fullmatch(r"-?\d+", part):
            dims.append(int(part))
        elif _NAME_RE.match(part):
            dims.append(part)
        elif part == BATCH and not dims:
            dims.append(BATCH)
        else:
            raise ContractError(f"bad dim {part!r} in shape spec {text!r}")
    return tuple(dims)


def _split_top_level(text: str) -> List[str]:
    """Split ``"(T,S),(T,K)"`` on commas outside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise ContractError(f"unbalanced parens in {text!r}")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ContractError(f"unbalanced parens in {text!r}")
    if cur:
        parts.append("".join(cur))
    return [p for p in (s.strip() for s in parts) if p]


def parse_contract_spec(spec: str) -> Tuple[List[ShapeSpec], List[ShapeSpec]]:
    """``"(T,S),(T,K)->(N,K,S)"`` -> ([("T","S"),("T","K")], [("N","K","S")])."""
    if "->" not in spec:
        raise ContractError(f"contract spec needs '->': {spec!r}")
    lhs, rhs = spec.split("->", 1)
    ins = [parse_shape_spec(s) for s in _split_top_level(lhs)]
    outs = [parse_shape_spec(s) for s in _split_top_level(rhs)]
    if not outs:
        raise ContractError(f"contract spec has no output shape: {spec!r}")
    return ins, outs


def _concrete_shape(x) -> Union[Tuple[int, ...], None]:
    shape = getattr(x, "shape", None)
    if shape is None:
        return None
    try:
        return tuple(int(d) for d in shape)
    except (TypeError, ValueError):
        return None                # symbolic dims: skip


def check_shape(spec: Union[ShapeSpec, str], shape: Sequence[int],
                env: Dict[str, object], where: str) -> None:
    """Unify one concrete shape against one spec, binding names in ``env``
    (a leading ``...`` binds the tuple of leading dims under ``"..."``)."""
    if spec == "*":
        return
    shape = tuple(shape)
    dims, rest = spec, shape
    if spec and spec[0] == BATCH:
        dims = spec[1:]
        if len(shape) >= len(dims):
            lead, rest = shape[:len(shape) - len(dims)], shape[len(shape) - len(dims):]
            bound = env.setdefault(BATCH, lead)
            if bound != lead:
                raise ContractError(
                    f"{where}: leading dims {BATCH!r} bound to {bound} but got "
                    f"{lead} in shape {shape} (contract {spec})")
    if len(dims) != len(rest):
        raise ContractError(
            f"{where}: rank mismatch — contract {spec} vs shape {shape}")
    for d_spec, d in zip(dims, rest):
        if d_spec == "_":
            continue
        if isinstance(d_spec, int):
            if d_spec >= 0 and d_spec != d:
                raise ContractError(
                    f"{where}: dim mismatch — contract {spec} vs shape {shape}")
        else:
            bound = env.setdefault(d_spec, d)
            if bound != d:
                raise ContractError(
                    f"{where}: symbol {d_spec!r} bound to {bound} but got "
                    f"{d} in shape {shape} (contract {spec})")


def contracts_enabled() -> bool:
    return os.environ.get("HFREP_CONTRACTS", "1") not in ("0", "false", "off")


def contract(spec: str):
    """Decorator enforcing a shape contract on positional array args and
    outputs.  Non-array positions (no ``.shape``) are skipped; specs past
    the last checked position simply don't fire, so keyword-only knobs
    and trailing config args need no spec entries."""
    ins, outs = parse_contract_spec(spec)   # parse eagerly: bad specs fail at import

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not contracts_enabled():
                return fn(*args, **kwargs)
            env: Dict[str, object] = {}
            for i, (s, a) in enumerate(zip(ins, args)):
                shape = _concrete_shape(a)
                if shape is not None:
                    check_shape(s, shape, env,
                                f"{fn.__qualname__} arg[{i}]")
            out = fn(*args, **kwargs)
            out_vals = (tuple(out) if isinstance(out, tuple) and len(outs) > 1
                        else (out,))
            for i, (s, v) in enumerate(zip(outs, out_vals)):
                shape = _concrete_shape(v)
                if shape is not None:
                    check_shape(s, shape, env,
                                f"{fn.__qualname__} out[{i}]")
            return out

        wrapper.__contract__ = spec
        return wrapper

    return deco
