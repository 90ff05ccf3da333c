"""HF007 — exit-code-contract discipline for drain handlers
(``hfrep_tpu/analysis/rules/hf_exit_codes.py``).

The repo-wide contract (selftest, orchestration actors, the chaos
oracles): a drive that catches :class:`~hfrep_tpu_torch.resilience.Preempted`
and converts it into a process exit must exit **75** (``EX_TEMPFAIL`` —
drained at a safe boundary, resumable) and must route through
:func:`hfrep_tpu_torch.obs.crash.bundle_if_enabled` first, so the flight
recorder's drain forensics land (handled drains bundle in exactly
these handlers).  A new CLI entry that maps Preempted to
``return 1`` — or forgets the bundle — silently breaks both the
supervisor's retry story and ``report --crash``; the chaos
engine's exit-contract oracle catches it dynamically, this rule keeps
new entry points honest statically.

Scope: ``except ...Preempted`` handlers that *terminate with an integer
status* — a ``return <int>``, ``sys.exit(<int>)`` or ``raise
SystemExit(<int>)`` anywhere in the handler body (module-level integer
constants like ``EXIT_DRAINED`` resolve).  Handlers that re-raise,
continue a loop, or assert (tests, resume drills, the engine's
context-enriched re-raise) are not exits and are exempt.  Tests are
exempt wholesale.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name

EXIT_DRAINED = 75


def _module_int_constants(tree: ast.AST) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int) \
                and not isinstance(node.value.value, bool):
            out[node.targets[0].id] = node.value.value
    return out


def _catches_preempted(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return False
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        name = dotted_name(e)
        if name and name.split(".")[-1] == "Preempted":
            return True
    return False


def _resolve_int(node: Optional[ast.AST],
                 consts: Dict[str, int]) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


class ExitCodeRule(Rule):
    id = "HF007"
    name = "preempted-exit-contract"
    description = ("except-Preempted handlers that exit with a status "
                   "must exit 75 and route through crash.bundle_if_enabled")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import _is_test_path

        if _is_test_path(ctx.relpath):
            return []
        consts = _module_int_constants(ctx.tree)
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler) \
                    or not _catches_preempted(node):
                continue
            exits = []          # (ast node, resolved int or None)
            bundled = False
            for sub in ast.walk(ast.Module(body=node.body,
                                           type_ignores=[])):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    val = _resolve_int(sub.value, consts)
                    if val is not None:
                        exits.append((sub, val))
                elif isinstance(sub, ast.Call):
                    fname = dotted_name(sub.func) or ""
                    short = fname.split(".")[-1]
                    if short == "bundle_if_enabled":
                        bundled = True
                    elif short in ("exit", "_exit") and sub.args:
                        val = _resolve_int(sub.args[0], consts)
                        if val is not None:
                            exits.append((sub, val))
                    elif short == "SystemExit" and sub.args:
                        val = _resolve_int(sub.args[0], consts)
                        if val is not None:
                            exits.append((sub, val))
            if not exits:
                continue        # re-raise / loop / assert handler
            for site, val in exits:
                if val != EXIT_DRAINED:
                    findings.append(ctx.finding(
                        "HF007", site,
                        f"Preempted handler exits {val}, not 75 "
                        "(EX_TEMPFAIL): a drained drive must signal "
                        "resumable, or the supervisor's retry story breaks"))
            if all(val == EXIT_DRAINED for _, val in exits) and not bundled:
                findings.append(ctx.finding(
                    "HF007", node,
                    "Preempted handler exits 75 without routing through "
                    "crash.bundle_if_enabled — the drain leaves no "
                    "flight-recorder forensics (report --crash finds "
                    "nothing)"))
        return findings
