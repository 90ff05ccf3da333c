"""HF009 — wall-clock monopoly: raw timestamps bypass the ledger
(``hfrep_tpu/analysis/rules/hf_wallclock.py``).

The wall-clock ledger (:mod:`hfrep_tpu_torch.obs.timeline`) can only uphold
its conservation invariant — every measured millisecond of a drive
assigned to exactly one category — if the code that *measures* wall
time routes through it.  A raw ``time.perf_counter()`` pair in a drive
or tool measures seconds the ledger never sees: the time silently
lands in ``unattributed`` (or worse, gets double-reported through a
side channel the timeline CLI cannot reconcile).

Flagged: call sites of ``time.perf_counter`` and ``time.time`` —
through any import spelling (``import time``, ``import time as t``,
``from time import perf_counter [as pc]``) — anywhere outside
``hfrep_tpu_torch/obs/`` (the ledger's own implementation must read the
clock) and test files.  The fix is almost always mechanical:

* a bare timestamp read → :func:`hfrep_tpu_torch.obs.timeline.clock`
* a measure-and-report pair → ``with timeline.stopwatch() as sw:``
* a measure-and-*account* pair → ``with timeline.timed(category):``

``time.monotonic`` stays legal: the serve/admission layers use it as an
injectable *scheduling* clock (deadlines, batching windows), which is
exactly the use the ledger does not want to own.  Deliberate
exceptions carry ``# noqa: HF009``.
"""

from __future__ import annotations

import ast
from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name, from_imports, \
    import_aliases

_BANNED_ATTRS = ("perf_counter", "time")


def _is_exempt_path(path: str) -> bool:
    p = path.replace("\\", "/")
    return ("hfrep_tpu_torch/obs/" in p or p.startswith("tests/")
            or "/tests/" in p or p.split("/")[-1].startswith("test_"))


class WallClockRule(Rule):
    id = "HF009"
    name = "wall-clock-monopoly"
    description = ("raw time.perf_counter()/time.time() outside "
                   "hfrep_tpu_torch/obs/ — wall time the ledger cannot "
                   "account")

    def check(self, ctx: FileContext) -> List[Finding]:
        if _is_exempt_path(ctx.path):
            return []
        tree = ctx.tree
        time_aliases = import_aliases(tree, "time")
        # from time import perf_counter [as pc] / time [as t]
        direct = {alias: orig for alias, orig in from_imports(tree, "time")
                  .items() if orig in _BANNED_ATTRS}
        if not time_aliases and not direct:
            return []
        banned = {f"{mod}.{attr}" for mod in time_aliases
                  for attr in _BANNED_ATTRS}
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func)
            if fname is None:
                continue
            hit = fname in banned or (fname in direct
                                      and "." not in fname)
            if hit:
                tail = fname.split(".")[-1] if "." in fname \
                    else direct.get(fname, fname)
                findings.append(ctx.finding(
                    "HF009", node,
                    f"raw time.{tail}() outside hfrep_tpu_torch/obs/: wall "
                    "time measured here never reaches the ledger and "
                    "degrades to unattributed — use timeline.clock() "
                    "(bare read), timeline.stopwatch() (measure+report) "
                    "or timeline.timed(category) (measure+account)"))
        return findings
