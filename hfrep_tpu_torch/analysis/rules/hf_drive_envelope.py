"""HF011 — drive-envelope discipline: the survival envelope lives in
``resilience/drive.py``, nowhere else
(``hfrep_tpu/analysis/rules/hf_drive_envelope.py``).

The drive runtime holds the one fault-tolerant envelope every long-running
workload needs — ``graceful_drain`` outermost, the obs session INSIDE
it, watchdog, Preempted→75 / storage→74 through
``crash.bundle_if_enabled`` — into :func:`hfrep_tpu_torch.resilience.drive.
run_drive`, because the hand-copied version kept regressing
(HF007 was added for mis-exiting copies; chaos corpus entries 003 and
007 each pinned a bug a copy had and the shared envelope cannot).  This
rule keeps the copy-paste class from regrowing:

* **hand-rolled drain exit** — an ``except ...Preempted`` handler that
  terminates with an integer status (``return <int>``,
  ``sys.exit(<int>)``, ``raise SystemExit(<int>)``) outside the
  sanctioned runtime is a re-implementation of ``run_drive``'s exit
  mapping.  Handlers that re-raise, continue a loop, or assert (resume
  drills, the engine's context-enriched re-raise) are not exits and
  stay exempt — those are drain *points*, not envelopes;
* **hand-rolled envelope pairing** — one function that both enters
  ``resilience.graceful_drain()`` and opens ``obs.session(...)`` /
  ``session_or_off(...)`` is rebuilding the envelope's load-bearing
  nesting by hand (and history says it will eventually get the order
  wrong — corpus entry 003 was exactly a ``with session`` line outside
  the drain).  Bare ``graceful_drain`` without a session (library-level
  drain points: the engine's chunk loop, the trainer's block loop, the
  supervisor) is fine and not flagged.

Sanctioned: ``resilience/drive.py`` (the one implementation) and tests
wholesale.  Anything else routes through ``run_drive`` or carries an
explicit ``# noqa: HF011`` with its justification.
"""

from __future__ import annotations

import ast
from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name
from hfrep_tpu_torch.analysis.rules.hf_exit_codes import (
    _catches_preempted,
    _module_int_constants,
    _resolve_int,
)

#: the one file allowed to implement the envelope
_SANCTIONED_SUFFIXES = ("resilience/drive.py",)

#: context managers that ARE the envelope's two layers
_DRAIN_NAMES = ("graceful_drain",)
_SESSION_NAMES = ("session", "session_or_off")


def _own_nodes(fn: ast.AST):
    """Walk a function's own body, not nested function/class defs —
    a helper closure opening a session inside a function that drains
    is a different scope's decision."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _call_short(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return name.split(".")[-1]
    return ""


class DriveEnvelopeRule(Rule):
    id = "HF011"
    name = "drive-envelope-discipline"
    description = ("hand-rolled drive envelopes (Preempted→exit mapping, "
                   "graceful_drain+session pairing) outside "
                   "resilience/drive.py must route through run_drive")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import _is_test_path

        if _is_test_path(ctx.relpath) \
                or ctx.relpath.replace("\\", "/").endswith(
                    _SANCTIONED_SUFFIXES):
            return []
        consts = _module_int_constants(ctx.tree)
        findings: List[Finding] = []

        # A: hand-rolled drain exits (the HF007 shape, relocated)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler) \
                    or not _catches_preempted(node):
                continue
            exit_at = None
            for sub in ast.walk(ast.Module(body=node.body,
                                           type_ignores=[])):
                if isinstance(sub, ast.Return) and sub.value is not None \
                        and _resolve_int(sub.value, consts) is not None:
                    exit_at = exit_at or sub
                elif isinstance(sub, ast.Call):
                    short = _call_short(sub)
                    if short in ("exit", "_exit", "SystemExit") \
                            and sub.args \
                            and _resolve_int(sub.args[0], consts) is not None:
                        exit_at = exit_at or sub
            if exit_at is not None:
                findings.append(ctx.finding(
                    "HF011", exit_at,
                    "hand-rolled drain exit: an except-Preempted handler "
                    "terminating with a status re-implements the drive "
                    "envelope — declare a DriveSpec and route through "
                    "resilience.drive.run_drive"))

        # B: hand-rolled envelope pairing (graceful_drain + obs session
        # in one function — corpus-003's bug class)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            drain_at = None
            session_at = None
            for node in _own_nodes(fn):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        short = _call_short(item.context_expr)
                        if short in _DRAIN_NAMES and drain_at is None:
                            drain_at = node
                        elif short in _SESSION_NAMES and session_at is None:
                            session_at = node
                elif _call_short(node) in _SESSION_NAMES \
                        and session_at is None:
                    session_at = node
            if drain_at is not None and session_at is not None:
                findings.append(ctx.finding(
                    "HF011", session_at,
                    f"function {fn.name!r} pairs graceful_drain with an "
                    "obs session by hand — the envelope's nesting order "
                    "is load-bearing (chaos corpus 003); route through "
                    "resilience.drive.run_drive"))
        return findings
