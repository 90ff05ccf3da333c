"""Program-rule base + graph walking helpers
(``hfrep_tpu/analysis/rules/jpx_base.py``).

JPX rules audit *traced programs*, not source text: the audit engine
(``hfrep_tpu_torch/analysis/programs.py``) builds each registered compile
boundary at tiny fixture shapes and traces it to a ``torch.fx.Graph`` —
the serve rows through ``serve/aot.py``'s own ``torch.export`` round trip,
the step, chunk and init rows with ``make_fx`` — then hands the graph to
every ``ProgramRule.check_program``.  The rules themselves import no
torch: they duck-type the graph (``.nodes``, ``.op``, ``.target``,
``.args``, ``.meta["val"]``), so the registry tests, the warm-cache path
and the unit fixtures (which feed synthetic graphs) all run on a bare
CPython — only a cold trace pays the torch import.

A hand kernel shows in a graph as ONE node: the dispatcher op
``hfrep.lstm_fwd`` in an exported program, and in a ``make_fx`` trace
each kernel's plain version recorded as one ``hfrep.<kernel>`` call
(``programs.kernel_calls``) — the card launches a kernel there, not the
plain version's step loop.

Findings anchor at the boundary's registry row in ``programs.py`` (the
one source line a human can edit), with a *label-stable* snippet so the
fingerprint survives registry reshuffles, and ``# noqa: JPXnnn`` on
that row suppresses through the ordinary :class:`FileContext` path.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple

from hfrep_tpu_torch.analysis.engine import Finding
from hfrep_tpu_torch.analysis.rules.base import Rule

#: where every program finding anchors: the registry row in programs.py
PROGRAMS_PATH = "hfrep_tpu_torch/analysis/programs.py"

#: namespace of the hand kernels' nodes (the dispatcher op's library and
#: the make_fx kernel calls' prefix)
KERNEL_NAMESPACE = "hfrep"


class ProgramContext:
    """Everything a JPX rule sees about one traced boundary.

    ``boundary`` is the registry row (``programs.Boundary``); ``graph``
    the ``torch.fx.Graph`` (or None when tracing failed); ``inputs`` one
    ``(kind, name, value)`` per input of the program's signature — kind
    ``"tensor"``, ``"constant"`` (a Python value specialised into the
    program) or ``"lifted"`` (a tensor constant the export lifted into an
    input), ``value`` the example value's metadata; ``outputs`` the same
    for the outputs; ``loop_graph`` the boundary traced again with one
    more loop iteration (``steps_per_call`` or chunk epochs + 1), or None
    where the program has no loop to grow (JPX003); ``line`` the
    registry row's line.
    """

    def __init__(self, boundary, graph=None,
                 inputs: Tuple[Tuple[str, str, Any], ...] = (),
                 outputs: Tuple[Tuple[str, str, Any], ...] = (),
                 loop_graph=None, line: int = 1):
        self.boundary = boundary
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.loop_graph = loop_graph
        self.line = line

    def finding(self, rule: str, message: str, token: str = "") -> Finding:
        label = self.boundary.label
        snippet = f"{label} {token}".strip()
        return Finding(rule=rule, path=PROGRAMS_PATH, line=self.line,
                       col=0, message=f"[{label}] {message}",
                       snippet=snippet)


class ProgramRule(Rule):
    """A rule over traced programs.  ``check`` (the AST hook) is a no-op
    so JPX rules can share registries/CLI plumbing with the text rules;
    the real work happens in ``check_program``."""

    def check(self, ctx) -> List[Finding]:
        return []

    def check_program(self, pctx: ProgramContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


# ------------------------------------------------------------ graph walks
def call_nodes(graph) -> Iterator[Any]:
    """The ``call_function`` nodes of a graph, in program order."""
    for node in getattr(graph, "nodes", ()):
        if getattr(node, "op", None) == "call_function":
            yield node


def op_name(node) -> str:
    """``aten.mm.default`` -> "mm"; ``hfrep.lstm_fwd.default`` -> "lstm_fwd";
    a make_fx kernel call ``hfrep.lstm_bwd`` -> "lstm_bwd"; a Python
    callable -> its ``__name__``."""
    text = str(getattr(node, "target", ""))
    parts = text.split(".")
    if len(parts) >= 3 and parts[0] in ("aten", KERNEL_NAMESPACE, "prims"):
        return parts[1]
    if len(parts) == 2 and parts[0] == KERNEL_NAMESPACE:
        return parts[1]
    return getattr(getattr(node, "target", None), "__name__", parts[-1])


def is_kernel(node) -> bool:
    """A hand kernel's node: the dispatcher op or a kernel call."""
    return str(getattr(node, "target", "")).startswith(KERNEL_NAMESPACE + ".")


def node_val(node) -> Any:
    meta = getattr(node, "meta", None)
    return meta.get("val") if isinstance(meta, dict) else None


def dtype_name(val) -> str:
    """``torch.float32`` -> "float32"; "?" for a value without a dtype."""
    dt = getattr(val, "dtype", None)
    return "?" if dt is None else str(dt).replace("torch.", "")


def tensor_args(node) -> List[Any]:
    """The example values of a node's tensor operands, in argument order
    (nested lists flattened: a kernel call takes tuples of operands)."""
    out: List[Any] = []

    def visit(a):
        if isinstance(a, (list, tuple)):
            for x in a:
                visit(x)
            return
        val = node_val(a)
        if getattr(val, "dtype", None) is not None and hasattr(val, "shape"):
            out.append(val)

    visit(getattr(node, "args", ()))
    return out


def arg_dtypes(node) -> List[str]:
    return [dtype_name(v) for v in tensor_args(node)]


def device_of(val) -> Optional[str]:
    dev = getattr(val, "device", None)
    return None if dev is None else str(getattr(dev, "type", dev))
