"""HF010 — eager device syncs inside boundary loops
(``hfrep_tpu/analysis/rules/hf_boundary_sync.py``).

The async boundary engine earns its overlap by keeping the host one step
behind the device: the chunked AE drive syncs a chunk's stop flag
through a one-slot pending future, the GAN block loop commits staged
checkpoint writes after the next dispatch, and the walk-forward eval
loop routes its score fetch through one named, ledgered helper.  An
*eager* sync added inside one of those loops silently re-serializes the
boundary: the host parks on the device every iteration and
``timeline/overlap_frac`` collapses back to the serial wall, with
nothing in review to show for it but an innocent-looking conversion.

A *boundary loop* is recognized by the markers every drive loop in this
codebase already carries: a call to ``resilience.boundary(...)`` /
``resilience.tick(...)`` (the preemption boundary) or
``timeline.flush_window(...)`` (the ledger boundary) anywhere in the
loop body.  Loops without those markers — fingerprint digests, host-side
assembly over numpy — are not drive loops and stay legal.

Flagged inside a boundary loop's body — the torch forms of the JAX
rule's ``jax.device_get`` / ``jax.block_until_ready``:

* any zero-argument ``.item()``, ``.cpu()`` or ``.tolist()`` call (a
  device value pulled to the host eagerly);
* ``torch.cuda.synchronize()`` through any import spelling (``import
  torch``, ``from torch import cuda``, ``from torch.cuda import
  synchronize as sync``);
* ``np.asarray(f(...))`` where the argument is itself a call — fetching
  a computed (possibly device) value, as opposed to viewing an array.

The fix is to route the sync through a named helper defined OUTSIDE the
loop (``_boundary_sync``, ``_synced_scores`` — the sanctioned sync
points, each of which times and ledgers its wait) or to defer it behind
a one-slot pending future like the engine's.  A deliberate in-loop sync
carries ``# noqa: HF010`` with its reason.
"""

from __future__ import annotations

import ast
from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name, from_imports, \
    import_aliases

#: attribute tails that mark a loop as a drive-boundary loop
_BOUNDARY_MARKS = ("boundary", "tick", "flush_window")

#: zero-argument tensor methods that copy a device value to the host
_HOST_PULLS = ("item", "cpu", "tolist")


def _is_exempt_path(path: str) -> bool:
    p = path.replace("\\", "/")
    return ("hfrep_tpu_torch/obs/" in p or p.startswith("tests/")
            or "/tests/" in p or p.split("/")[-1].startswith("test_")
            or p.startswith("tools/") or "/tools/" in p)


def _is_boundary_loop(loop) -> bool:
    for node in ast.walk(loop):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname is not None and "." in fname \
                    and fname.split(".")[-1] in _BOUNDARY_MARKS:
                return True
    return False


def _sync_names(tree: ast.AST) -> set:
    """Every dotted spelling of ``torch.cuda.synchronize`` in this file."""
    names = {f"{mod}.cuda.synchronize" for mod in import_aliases(tree, "torch")}
    names |= {f"{mod}.synchronize" for mod in import_aliases(tree, "torch.cuda")}
    names |= {alias for alias, orig in from_imports(tree, "torch.cuda").items()
              if orig == "synchronize"}
    return names


class BoundarySyncRule(Rule):
    id = "HF010"
    name = "eager-boundary-sync"
    description = ("eager device sync (.item()/.cpu()/.tolist()/"
                   "torch.cuda.synchronize/np.asarray-on-call) inside a "
                   "boundary loop — re-serializes the async engine")

    def check(self, ctx: FileContext) -> List[Finding]:
        if _is_exempt_path(ctx.path):
            return []
        tree = ctx.tree
        syncs = _sync_names(tree)
        np_mods = import_aliases(tree, "numpy")
        np_direct = {alias: orig for alias, orig
                     in from_imports(tree, "numpy").items()
                     if orig == "asarray"}
        np_banned = {f"{mod}.asarray" for mod in np_mods}
        findings: List[Finding] = []
        seen: set = set()
        for loop in ast.walk(tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            if not _is_boundary_loop(loop):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                msg = self._classify(node, syncs, np_banned, np_direct)
                if msg is not None:
                    seen.add(id(node))
                    findings.append(ctx.finding(
                        "HF010", node,
                        f"{msg} inside a boundary loop: the host parks "
                        "on the device every iteration and the async "
                        "engine's overlap collapses — route it through "
                        "a named sync helper defined outside the loop "
                        "(like _boundary_sync / _synced_scores) or "
                        "defer it behind a one-slot pending future"))
        return findings

    @staticmethod
    def _classify(node: ast.Call, syncs, np_banned, np_direct):
        func = node.func
        if (isinstance(func, ast.Attribute) and func.attr in _HOST_PULLS
                and not node.args and not node.keywords):
            return f"eager .{func.attr}() host pull"
        fname = dotted_name(func)
        if fname is None:
            return None
        if fname in syncs:
            return "eager torch.cuda.synchronize()"
        is_asarray = fname in np_banned or (fname in np_direct
                                            and "." not in fname)
        if is_asarray and node.args and isinstance(node.args[0], ast.Call):
            return "np.asarray() over a computed value (device fetch)"
        return None
