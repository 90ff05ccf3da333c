"""HF003 — atomic-publish discipline
(``hfrep_tpu/analysis/rules/hf_atomic_writes.py``).

The durability model is only as strong as its weakest writer: one
``open(path, "w")`` straight into a checkpoint/result/artifact location
and a crash mid-write leaves a torn file that resume paths, manifests
and the committed history store happily read back.  The sanctioned
writers — ``utils.checkpoint.write_atomic`` (directories),
``utils.checkpoint.atomic_text`` (single files),
``obs.manifest._write_with_retry`` (manifests; lenient readers) —
stage into a tmp sibling and publish by rename.

Flagged: ``open(..., "w"/"wb")``, ``Path.write_text``/``write_bytes``,
``np.save``/``np.savez``/``np.savetxt`` whose destination *names an
artifact location* (a path expression mentioning ``results``,
``checkpoint(s)``/``ckpt``, ``snapshot(s)``, ``history``, ``spool``,
``manifest`` or ``artifact(s)``) — outside the sanctioned contexts:

* lexically inside one of the sanctioned writer functions themselves;
* a destination rooted at a ``tmp``/``tmp_dir``/``tmp_path`` name — the
  ``writer(tmp)`` callback convention, where ``write_atomic`` owns the
  publish (this is the pinned false-positive class: staging writes are
  the *mechanism* of atomic publication, not a violation of it).

Append-mode opens are exempt (the event stream and history store are
append-only by design, with torn-tail-tolerant readers).  Tests are
exempt.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name

ARTIFACT_TOKENS = {
    "results", "ckpt", "checkpoint", "checkpoints", "snapshot",
    "snapshots", "history", "spool", "manifest", "artifact", "artifacts",
}

#: destination roots that mark the write as staging inside an atomic
#: publish (the writer-callback convention)
STAGING_ROOTS = {"tmp", "tmp_dir", "tmp_path"}

_NP_WRITERS = {"save", "savez", "savez_compressed", "savetxt"}


def _expr_tokens(node: ast.AST) -> Set[str]:
    """Identifier-ish tokens of a path expression: names, attribute
    parts, and path segments of string literals — lowercased, split on
    separators, so ``os.path.join(ckpt_dir, name)`` yields ``ckpt``."""
    tokens: Set[str] = set()

    def add(text: str) -> None:
        for sep in ("/", "\\", "."):
            text = text.replace(sep, "_")
        for part in text.lower().split("_"):
            if part:
                tokens.add(part)

    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            add(sub.id)
        elif isinstance(sub, ast.Attribute):
            add(sub.attr)
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            add(sub.value)
    return tokens


def _root_name(node: ast.AST) -> Optional[str]:
    """The leftmost name a destination expression hangs off
    (``(tmp / "x").write_text`` -> "tmp"; ``args.out`` -> "args")."""
    while True:
        if isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.BinOp):      # Path / "name"
            node = node.left
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _write_mode(call: ast.Call) -> Optional[str]:
    """The mode literal of an ``open`` call (positional or keyword)."""
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


class AtomicWriteRule(Rule):
    id = "HF003"
    name = "atomic-publish-discipline"
    description = ("direct writes into checkpoint/result/artifact "
                   "locations must go through write_atomic/atomic_text/"
                   "_write_with_retry")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import _is_test_path
        from hfrep_tpu_torch.analysis.rules.base import import_aliases

        project = ctx.project
        if project is None or not project.atomic_writers:
            return []
        if _is_test_path(ctx.relpath):
            return []
        findings: List[Finding] = []
        sanctioned_fns = project.atomic_writers
        # only real numpy writers count as np.save-class writes — a
        # dotted ``ckpt.save(...)`` is the atomic checkpoint writer
        # itself, not a raw array dump (pinned false-positive class)
        self._np_aliases = import_aliases(ctx.tree, "numpy")

        def scan(scope: ast.AST, inside_sanctioned: bool) -> None:
            for node in ast.iter_child_nodes(scope):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan(node, inside_sanctioned
                         or node.name in sanctioned_fns)
                    continue
                if isinstance(node, ast.Call):
                    self._check_call(ctx, node, inside_sanctioned, findings)
                scan(node, inside_sanctioned)

        scan(ctx.tree, False)
        return findings

    def _check_call(self, ctx: FileContext, call: ast.Call,
                    inside_sanctioned: bool,
                    findings: List[Finding]) -> None:
        if inside_sanctioned:
            return
        dest: Optional[ast.AST] = None
        what = None
        fname = dotted_name(call.func)
        if fname and fname.split(".")[0] in ("open",) and call.args:
            mode = _write_mode(call)
            if not mode or not any(c in mode for c in "wx"):
                return
            dest, what = call.args[0], f"open(..., {mode!r})"
        elif isinstance(call.func, ast.Attribute) \
                and call.func.attr in ("write_text", "write_bytes"):
            dest, what = call.func.value, f".{call.func.attr}()"
        elif fname and "." in fname \
                and fname.split(".")[-1] in _NP_WRITERS \
                and fname.rsplit(".", 1)[0] in getattr(self, "_np_aliases", ()) \
                and call.args:
            dest, what = call.args[0], fname.split(".", 1)[-1] + "()"
        if dest is None:
            return
        root = _root_name(dest)
        if root in STAGING_ROOTS:
            return
        tokens = _expr_tokens(dest)
        hit = tokens & ARTIFACT_TOKENS
        if not hit:
            return
        findings.append(ctx.finding(
            "HF003", call,
            f"direct {what} into an artifact location "
            f"({'/'.join(sorted(hit))}): a crash mid-write leaves a torn "
            "file readers trust — publish through write_atomic/"
            "atomic_text/_write_with_retry instead"))
