"""HF006 — signal-handler and lock-discipline safety
(``hfrep_tpu/analysis/rules/hf_thread_signal.py``).

Two host-side concurrency classes the serving/resilience layers live
or die by:

**Signal handlers.**  A handler registered with ``signal.signal`` runs
re-entrantly at an arbitrary bytecode boundary.  The repo's sanctioned
handlers set a flag (``request_drain``) or raise a typed exception (the
selftest watchdog) — both async-signal-safe.  Flagged: *direct* calls
in a registered handler's body to non-reentrant machinery — ``open``,
file ``.write``/``.flush``, ``json.dump``, ``logging``, lock
``.acquire``/``with lock:``, ``time.sleep``, ``subprocess``/
``os.system``.  One level only, by design: transitive analysis would
flag the flag-setters themselves (``request_drain`` emits telemetry —
behind its own try/except, which is the sanctioned pattern).

**Lock discipline.**  A class that writes an attribute under ``with
self._lock:`` in one method has declared that attribute
lock-protected; writing it elsewhere WITHOUT the lock is a data race
that CPython's scheduling hides on laptops and the serve worker pool
hits under load.  Attributes are matched per class; ``__init__`` is
exempt (pre-concurrency construction), and a ``threading.Condition``
constructed over the lock counts as holding it (``with self._idle:``
in the server IS ``with self._lock:``).  Methods whose name ends in
``_locked`` are exempt — the caller-holds-the-lock convention.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule, dotted_name

_UNSAFE_CALL_TAILS = {"open", "acquire", "sleep", "dump", "dumps",
                      "write", "flush", "print", "system", "run",
                      "Popen", "call", "check_call", "check_output"}
_UNSAFE_PREFIXES = ("logging.", "subprocess.", "os.system")

_LOCK_FACTORIES = {"Lock", "RLock"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.x`` (or ``self.x[...]``) -> "x"."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class ThreadSignalRule(Rule):
    id = "HF006"
    name = "signal-thread-safety"
    description = ("non-reentrant work in registered signal handlers; "
                   "lock-protected attributes written without the lock")

    def check(self, ctx: FileContext) -> List[Finding]:
        findings: List[Finding] = []
        self._check_signal_handlers(ctx, findings)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                self._check_lock_discipline(ctx, node, findings)
        return findings

    # ------------------------------------------------------ signal safety
    def _check_signal_handlers(self, ctx: FileContext,
                               findings: List[Finding]) -> None:
        handlers: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                fname = dotted_name(node.func)
                if fname and fname.split(".")[-1] == "signal" \
                        and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Name):
                    # signal.signal(SIG, handler) — only restore-shaped
                    # second args (names) register local handlers
                    handlers.add(node.args[1].id)
        if not handlers:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in handlers:
                self._scan_handler_body(ctx, node, findings)

    def _scan_handler_body(self, ctx: FileContext, fn: ast.AST,
                           findings: List[Finding]) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted_name(node.func) or ""
            tail = fname.split(".")[-1]
            if fname.startswith(_UNSAFE_PREFIXES) \
                    or tail in _UNSAFE_CALL_TAILS:
                findings.append(ctx.finding(
                    "HF006", node,
                    f"{fname or tail}() inside the registered signal "
                    f"handler {getattr(fn, 'name', '?')!r}: signal "
                    "handlers run re-entrantly at arbitrary bytecode "
                    "boundaries — set a flag or raise; do the work at a "
                    "safe boundary"))

    # ----------------------------------------------------- lock discipline
    def _check_lock_discipline(self, ctx: FileContext, cls: ast.ClassDef,
                               findings: List[Finding]) -> None:
        locks: Set[str] = set()
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        init = next((m for m in methods if m.name == "__init__"), None)
        if init is None:
            return
        # pass 1a: lock attrs (self.X = threading.Lock()/RLock()/Condition())
        cond_wraps: Dict[str, Optional[str]] = {}
        for node in ast.walk(init):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            attr = _self_attr(node.targets[0])
            if attr is None or not isinstance(node.value, ast.Call):
                continue
            factory = dotted_name(node.value.func) or ""
            tail = factory.split(".")[-1]
            if tail in _LOCK_FACTORIES:
                locks.add(attr)
            elif tail == "Condition":
                inner = (_self_attr(node.value.args[0])
                         if node.value.args else None)
                cond_wraps[attr] = inner     # None = its own internal lock
        for attr, inner in cond_wraps.items():
            if inner is None or inner in locks:
                locks.add(attr)              # holding the cond = the lock
        if not locks:
            return

        # one pass per method: record every self-attr write and every
        # intra-class ``self._helper()`` call with its under-lock flag
        writes: Dict[str, List] = {}        # method -> [(attr, node, under)]
        calls: Dict[str, List] = {}         # method -> [(callee, under)]

        def scan_method(fn: ast.AST) -> None:
            def walk(node: ast.AST, under: bool) -> None:
                if isinstance(node, ast.With):
                    held = under or any(
                        _self_attr(item.context_expr) in locks
                        for item in node.items)
                    for child in node.body:
                        walk(child, held)
                    return
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        attr = _self_attr(t)
                        if attr is not None and attr not in locks:
                            writes[fn.name].append((attr, node, under))
                if isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee is not None:
                        calls[fn.name].append((callee, under))
                for child in ast.iter_child_nodes(node):
                    if not isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.Lambda)):
                        walk(child, under)

            writes[fn.name], calls[fn.name] = [], []
            walk(fn, False)

        for m in methods:
            if m.name != "__init__":
                scan_method(m)

        # caller-holds-the-lock helpers: a PRIVATE method every
        # intra-class call site of which is lock-held runs under the
        # lock by contract (CircuitBreaker._trip's "# lock held by
        # caller" pattern — the pinned false-positive class); iterate to
        # a fixpoint so locked helpers calling locked helpers resolve
        locked_ctx: Set[str] = {m.name for m in methods
                                if m.name.endswith("_locked")}
        method_names = {m.name for m in methods}
        changed = True
        while changed:
            changed = False
            for name in method_names:
                if name in locked_ctx or not name.startswith("_") \
                        or name == "__init__":
                    continue
                sites = [(caller, under)
                         for caller, cs in calls.items()
                         for callee, under in cs if callee == name]
                if sites and all(under or caller in locked_ctx
                                 for caller, under in sites):
                    locked_ctx.add(name)
                    changed = True

        protected: Set[str] = set()
        unprotected: Dict[str, List] = {}
        for name, ws in writes.items():
            in_locked_helper = name in locked_ctx
            for attr, node, under in ws:
                if under or in_locked_helper:
                    protected.add(attr)
                else:
                    unprotected.setdefault(attr, []).append(node)
        for attr in sorted(protected & set(unprotected)):
            for node in unprotected[attr]:
                findings.append(ctx.finding(
                    "HF006", node,
                    f"self.{attr} is written under `with self.<lock>:` "
                    f"elsewhere in {cls.name} but written here without "
                    "it — a data race the GIL hides until the worker "
                    "pool is actually loaded"))
