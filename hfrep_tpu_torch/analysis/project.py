"""The whole-project model behind the cross-layer rules
(``hfrep_tpu/analysis/project.py``).

A per-file rule sees one file; the failure classes the cross-layer rules
exist for are *cross-file string protocols* — a gauge emitted in one
module whose fold direction is decided by a table in ``obs/regress.py``;
a fault site injected in ``orchestrate/queue.py`` that must round-trip
against the registry in ``resilience/faults.py``.

This module is phase one of the two-phase analyzer: it extracts, by AST
(never by importing the live modules — a ``check`` run imports no
``torch`` and creates no CUDA context), the port's registries those
protocols are defined in, plus a per-file summary of what each analyzed
file *contributes* (instruments/events emitted, fault sites referenced).
Phase two hands the assembled :class:`ProjectModel` to every rule via
``FileContext.project``.

It also reads the schema tables of the port's own ``obs/README.md``
(HF004): the events and namespaced instruments the port emits.  The JAX
package's model also reads a table of jax APIs absent on its pinned
runtime (HF005), which has no PyTorch meaning.  Extraction is pinned
against the live modules by ``tests/test_torch_analysis_project.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from hfrep_tpu_torch.analysis.engine import REPO_ROOT

# --------------------------------------------------------------------------
# Registry source locations (repo-relative).  The extractors below read
# these files directly, so a ``--changed``-scoped run still sees the full
# registries even when none of them is in the analyzed file set.
FAULTS_PATH = "hfrep_tpu_torch/resilience/faults.py"
REGRESS_PATH = "hfrep_tpu_torch/obs/regress.py"
HISTORY_PATH = "hfrep_tpu_torch/obs/history.py"
CHECKPOINT_PATH = "hfrep_tpu_torch/utils/checkpoint.py"
MANIFEST_PATH = "hfrep_tpu_torch/obs/manifest.py"
OBS_README_PATH = "hfrep_tpu_torch/obs/README.md"

#: the sanctioned crash-consistent writer entry points (HF003).  Each is
#: ``(repo-relative defining file, function name)``; extraction verifies
#: the function still exists there, so a rename breaks the analyzer
#: loudly instead of silently blessing nothing.
ATOMIC_WRITER_DEFS = (
    (CHECKPOINT_PATH, "write_atomic"),
    (CHECKPOINT_PATH, "atomic_text"),
    (CHECKPOINT_PATH, "_atomic_publish"),
    (MANIFEST_PATH, "_write_with_retry"),
)

#: the emission surface the obs/README.md schema documents: every
#: non-test .py file under these roots (a directory, a file, or a glob)
#: can emit documented rows, so the HF004 doc-side (stale-row) check runs
#: only when the analyzed file set covers ALL of them — a single-file or
#: package-scoped run cannot judge "nothing emits this row" (it would
#: flag every row stale).
DOC_SYNC_ROOTS = ("hfrep_tpu_torch", "tools/torch_*.py")


def doc_surface_files(root: Optional[Path] = None) -> Set[str]:
    """Repo-relative posix paths of every file the HF004 doc-side check
    needs in scope (the full emission surface under
    :data:`DOC_SYNC_ROOTS`)."""
    root = Path(root) if root is not None else REPO_ROOT
    out: Set[str] = set()
    for entry in DOC_SYNC_ROOTS:
        p = root / entry
        if "*" in entry:
            out.update(f.relative_to(root).as_posix() for f in root.glob(entry))
        elif p.is_dir():
            out.update(f.relative_to(root).as_posix()
                       for f in p.rglob("*.py"))
        elif p.exists():
            out.add(entry)
    return out


#: hook-callable name -> the fault-site group its literal site argument
#: must belong to (HF002).  ``write_atomic`` sites arrive as keywords.
FAULT_HOOKS = {
    "tick": "boundary",
    "boundary": "boundary",
    "io_point": "io",
    "io_hook": "io",
    "post_save": "post_save",
    "actor_kill_point": "actor",
}
FAULT_KEYWORDS = {"io_site": "io", "fault_site": "post_save"}


# ------------------------------------------------------------ doc schema
@dataclasses.dataclass(frozen=True)
class DocRow:
    """One schema-table row of ``obs/README.md``: a name the docs claim
    the code emits."""

    name: str           # as written, e.g. "timeline/<category>_frac"
    line: int           # 1-based line in the README

    @property
    def patterns(self) -> Tuple[str, ...]:
        return expand_doc_name(self.name)


def expand_doc_name(name: str) -> Tuple[str, ...]:
    """A documented name -> regex pattern(s).

    ``{a,b,c}`` brace sets expand to alternatives; single-token holes —
    ``{H}``, ``<key>``, ``<n>`` — become wildcards.  Plain names yield
    one exact-match pattern.
    """
    variants = [""]
    i = 0
    while i < len(name):
        c = name[i]
        # an unbalanced brace/angle is prose, not a hole — fall through
        # to the literal branch rather than raising (one stray `x < y`
        # in README backticks must not kill the whole analyzer run)
        j = name.find("}", i) if c == "{" else \
            name.find(">", i) if c == "<" else -1
        if c == "{" and j != -1:
            body = name[i + 1:j]
            if "," in body:
                opts = [re.escape(o) for o in body.split(",")]
                variants = [v + f"(?:{'|'.join(opts)})" for v in variants]
            else:
                variants = [v + r"[^\s]+" for v in variants]
            i = j + 1
        elif c == "<" and j != -1:
            variants = [v + r"[^\s]+" for v in variants]
            i = j + 1
        else:
            variants = [v + re.escape(c) for v in variants]
            i += 1
    return tuple(v + "$" for v in variants)


@dataclasses.dataclass
class DocSchema:
    """What ``obs/README.md`` documents: the structured table rows (names
    the docs *claim* are emitted — checked both directions) and every
    backticked token anywhere (the weaker "documented somewhere" set)."""

    rows: List[DocRow] = dataclasses.field(default_factory=list)
    mentioned: Set[str] = dataclasses.field(default_factory=set)

    def documents(self, emitted_name: str) -> bool:
        """Is ``emitted_name`` covered — an exact backtick mention or a
        structured-row pattern match?"""
        if emitted_name in self.mentioned:
            return True
        for row in self.rows:
            for pat in row.patterns:
                if re.match(pat, emitted_name):
                    return True
        for token in self.mentioned:
            if ("{" in token or "<" in token) and any(
                    re.match(p, emitted_name)
                    for p in expand_doc_name(token)):
                return True
        return False


_BACKTICK_RE = re.compile(r"`([^`\n]+)`")
_ROW_RE = re.compile(r"^\|\s*`([^`|]+)`")


def parse_obs_readme(text: str) -> DocSchema:
    """Extract the schema vocabulary from ``obs/README.md``.

    Structured rows: inside a markdown table whose header's first column
    is one of the schema-table headers (``event name``, ``instrument``,
    ``counter``, ``name``, ``metric``), each data row's first backticked
    cell is a documented emission.  Cells carrying multiple backticked
    names (``serve/p50_ms`, `serve/p95_ms``) contribute each.
    """
    schema = DocSchema()
    in_schema_table = False
    for lineno, line in enumerate(text.splitlines(), start=1):
        stripped = line.strip()
        for token in _BACKTICK_RE.findall(line):
            schema.mentioned.add(token.strip())
        if stripped.startswith("|"):
            cells = [c.strip() for c in stripped.strip("|").split("|")]
            first = cells[0] if cells else ""
            if set(first) <= {"-", " ", ":"} and first:
                continue                     # the |---|---| separator row
            header = first.lower().strip("*")
            if header in ("event name", "instrument", "counter", "name",
                          "metric"):
                in_schema_table = True
                continue
            if in_schema_table and _ROW_RE.match(stripped):
                for name in _BACKTICK_RE.findall(first):
                    schema.rows.append(DocRow(name=name.strip(),
                                              line=lineno))
        else:
            in_schema_table = False
    return schema


# ------------------------------------------------------- per-file summary
@dataclasses.dataclass
class Emission:
    """One instrument/event emission site observed in a file."""

    kind: str                      # "gauge" | "counter" | "histogram" | "event"
    line: int
    names: Tuple[str, ...] = ()    # statically resolved full names
    prefix: Optional[str] = None   # static prefix when dynamic (f"bench/{x}")

    def to_dict(self) -> dict:
        return {"kind": self.kind, "line": self.line,
                "names": list(self.names), "prefix": self.prefix}

    @classmethod
    def from_dict(cls, d: dict) -> "Emission":
        return cls(kind=d["kind"], line=d["line"],
                   names=tuple(d.get("names") or ()),
                   prefix=d.get("prefix"))


@dataclasses.dataclass
class FileSummary:
    """Everything the project model needs from one analyzed file —
    cacheable as JSON keyed by the file's content hash."""

    emissions: List[Emission] = dataclasses.field(default_factory=list)
    #: fault-site strings referenced at hook calls: (group, site, line)
    fault_sites_used: List[Tuple[str, str, int]] = \
        dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {"emissions": [e.to_dict() for e in self.emissions],
                "fault_sites_used": [list(t) for t in self.fault_sites_used]}

    @classmethod
    def from_dict(cls, d: dict) -> "FileSummary":
        return cls(emissions=[Emission.from_dict(e)
                              for e in d.get("emissions") or []],
                   fault_sites_used=[tuple(t) for t in
                                     d.get("fault_sites_used") or []])


# ------------------------------------------------- static string resolution
def loop_constant_bindings(scope: ast.AST) -> Dict[str, Set[str]]:
    """Names bound by ``for`` loops over literal collections in ``scope``
    -> the set of string constants they range over.

    Handles the repo's dominant emission idiom::

        for name, value in (("qps", qps), ("p95_ms", p95)):
            obs.gauge(f"bench/serve_{name}").set(value)

    — ``name`` resolves to {"qps", "p95_ms"}.  Both plain targets over
    tuples of constants and tuple-targets over tuples of tuples (the
    constant positions) are resolved; anything else is absent from the
    map (= unresolvable).
    """
    from hfrep_tpu_torch.analysis.rules.base import direct_nodes

    out: Dict[str, Set[str]] = {}
    for node in direct_nodes(scope):
        if not isinstance(node, ast.For):
            continue
        if not isinstance(node.iter, (ast.Tuple, ast.List)):
            continue
        elts = node.iter.elts
        if isinstance(node.target, ast.Name):
            vals = {e.value for e in elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)}
            if vals and len(vals) == len(elts):
                out[node.target.id] = vals
        elif isinstance(node.target, ast.Tuple) and all(
                isinstance(t, ast.Name) for t in node.target.elts):
            width = len(node.target.elts)
            rows = [e for e in elts
                    if isinstance(e, (ast.Tuple, ast.List))
                    and len(e.elts) == width]
            if len(rows) != len(elts):
                continue
            for pos, tgt in enumerate(node.target.elts):
                vals = {r.elts[pos].value for r in rows
                        if isinstance(r.elts[pos], ast.Constant)
                        and isinstance(r.elts[pos].value, str)}
                if len(vals) == len(rows):
                    out[tgt.id] = vals
    return out


def resolve_names(expr: ast.AST,
                  bindings: Dict[str, Set[str]]) -> Tuple[Tuple[str, ...],
                                                          Optional[str]]:
    """Statically resolve a string-valued expression.

    Returns ``(names, prefix)``: the full set of values when resolvable
    (constants, loop-bound names, f-strings whose every hole is
    loop-bound), else ``((), static_prefix_or_None)`` — the leading
    constant text of an f-string, for prefix-scoped checks.
    """
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return (expr.value,), None
    if isinstance(expr, ast.Name):
        vals = bindings.get(expr.id)
        return (tuple(sorted(vals)), None) if vals else ((), None)
    if isinstance(expr, ast.JoinedStr):
        parts: List[Set[str]] = []
        resolvable = True
        for piece in expr.values:
            if isinstance(piece, ast.Constant):
                parts.append({str(piece.value)})
            elif isinstance(piece, ast.FormattedValue):
                hole = piece.value
                if isinstance(hole, ast.Name) and hole.id in bindings:
                    parts.append(bindings[hole.id])
                else:
                    resolvable = False
                    break
            else:
                resolvable = False
                break
        if resolvable:
            names = [""]
            for opts in parts:
                names = [n + o for n in names for o in sorted(opts)]
            return tuple(names), None
        first = expr.values[0] if expr.values else None
        prefix = (str(first.value)
                  if isinstance(first, ast.Constant) else None)
        return (), prefix
    return (), None


# ----------------------------------------------------- emission collection
def _wrapper_names(tree: ast.AST) -> Set[str]:
    """Local event-forwarding wrappers: any function whose first
    non-self parameter is forwarded as the literal first argument of an
    ``.event(...)`` call in its body (the repo's ``_emit`` / ``_event`` /
    ``_obs_event`` pattern)."""
    wrappers: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = [a.arg for a in node.args.args if a.arg not in ("self", "cls")]
        if not params:
            continue
        first = params[0]
        for call in ast.walk(node):
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "event"
                    and call.args
                    and isinstance(call.args[0], ast.Name)
                    and call.args[0].id == first):
                wrappers.add(node.name)
                break
    return wrappers


_INSTRUMENT_ATTRS = ("gauge", "counter", "histogram")


def classify_emission_call(node: ast.Call,
                           wrappers: Set[str]) -> Optional[str]:
    """``.gauge(...)``/``.counter(...)``/``.histogram(...)`` ->
    instrument kind; ``.event(...)`` or a call to a local event wrapper
    -> ``"event"``; anything else -> None."""
    if not isinstance(node, ast.Call) or not node.args:
        return None
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr in _INSTRUMENT_ATTRS:
            return func.attr
        if func.attr == "event" or func.attr in wrappers:
            return "event"
    elif isinstance(func, ast.Name) and func.id in wrappers:
        return "event"
    return None


def collect_emissions(tree: ast.AST) -> List[Emission]:
    """Every instrument/event emission in a file, with static name
    resolution (one level of local-wrapper indirection for events).
    Each scope resolves against its OWN loop bindings — a loop variable
    in one function must not leak into another."""
    from hfrep_tpu_torch.analysis.rules.base import direct_nodes, walk_scopes

    wrappers = _wrapper_names(tree)
    out: List[Emission] = []
    for scope in walk_scopes(tree):
        bindings = loop_constant_bindings(scope)
        for node in direct_nodes(scope):
            kind = classify_emission_call(node, wrappers) \
                if isinstance(node, ast.Call) else None
            if kind is None:
                continue
            names, prefix = resolve_names(node.args[0], bindings)
            out.append(Emission(kind=kind, line=node.lineno,
                                names=names, prefix=prefix))
    return out


def collect_fault_sites(tree: ast.AST) -> List[Tuple[str, str, int]]:
    """Literal site strings at fault-hook calls: (group, site, line).

    Covers the module-level hooks (``resilience.boundary("chunk")``,
    bare ``boundary(...)`` via from-import), the plan methods of the
    same names, and the ``io_site=`` / ``fault_site=`` keywords of
    ``write_atomic``-shaped writers.  ``self._tick(...)`` internal
    bookkeeping is excluded (its first argument is a hook *group*, not
    a site).
    """
    out: List[Tuple[str, str, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        fname = None
        if isinstance(func, ast.Attribute):
            if func.attr.startswith("_"):
                continue                      # self._tick etc.
            fname = func.attr
        elif isinstance(func, ast.Name):
            fname = func.id
        if fname in FAULT_HOOKS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((FAULT_HOOKS[fname], arg.value, node.lineno))
        for kw in node.keywords:
            if kw.arg in FAULT_KEYWORDS and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                out.append((FAULT_KEYWORDS[kw.arg], kw.value.value,
                            node.lineno))
    # parameter DEFAULTS named io_site=/fault_site= count as usage too:
    # ``write_atomic(path, writer)`` reaches "ckpt_save"/"ckpt" through
    # its signature, not through any call-site literal
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = node.args
        pairs = list(zip(a.args[len(a.args) - len(a.defaults):], a.defaults))
        pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if arg.arg in FAULT_KEYWORDS and isinstance(default, ast.Constant) \
                    and isinstance(default.value, str):
                out.append((FAULT_KEYWORDS[arg.arg], default.value,
                            arg.lineno))
    return out


def summarize_file(tree: ast.AST) -> FileSummary:
    """The whole per-file contribution the project model aggregates."""
    return FileSummary(emissions=collect_emissions(tree),
                       fault_sites_used=collect_fault_sites(tree))


# -------------------------------------------------------- registry readers
def _parse_repo_file(root: Path, relpath: str) -> Optional[ast.AST]:
    p = root / relpath
    if not p.exists():
        return None
    try:
        return ast.parse(p.read_text(encoding="utf-8"), filename=str(p))
    except SyntaxError:
        return None


def extract_string_tuple(tree: ast.AST, varname: str) -> Tuple[
        Dict[str, int], int]:
    """Module-level ``NAME = ("a", "b", ...)`` -> ``({value:
    element_lineno}, assign_lineno)`` — per-ELEMENT lines, so a finding
    about one entry of a multi-line registry tuple points at that
    entry's row, not the assignment header; ``({}, 0)`` when absent."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == varname \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            vals = {e.value: e.lineno for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
            return vals, node.lineno
    return {}, 0


def extract_dict_str_keys(tree: ast.AST, varname: str) -> Tuple[
        Dict[str, int], int]:
    """Module-level ``NAME: ... = {"k": ..., ...}`` -> ({key: key_line},
    assign_line)."""
    body = tree.body if isinstance(tree, ast.Module) else []
    for node in body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if not (isinstance(target, ast.Name) and target.id == varname):
            continue
        value = node.value
        if isinstance(value, ast.Dict):
            keys = {k.value: k.lineno for k in value.keys
                    if isinstance(k, ast.Constant) and isinstance(k.value, str)}
            return keys, node.lineno
    return {}, 0


@dataclasses.dataclass
class ProjectModel:
    """Phase-one output: every cross-file registry plus the per-file
    contributions, handed to the rules via ``FileContext.project``."""

    #: fault-site registry: group -> {site: registry_line} (HF002)
    fault_sites: Dict[str, Dict[str, int]] = \
        dataclasses.field(default_factory=dict)
    #: fault kinds: kind -> group (HF002 spec checking)
    fault_kinds: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: regress.DEFAULT_THRESHOLDS keys -> line (HF001)
    thresholds: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: history.GAUGE_PREFIXES (HF001 scope)
    gauge_prefixes: Tuple[str, ...] = ()
    #: obs/README.md schema (HF004)
    doc: DocSchema = dataclasses.field(default_factory=DocSchema)
    #: sanctioned atomic-writer function names (HF003)
    atomic_writers: Set[str] = dataclasses.field(default_factory=set)
    #: per-file summaries, keyed by repo-relative posix path
    files: Dict[str, FileSummary] = dataclasses.field(default_factory=dict)
    #: HF004 doc-side gating: None = decide by comparing ``files``
    #: against :func:`doc_surface_files` on disk; tests inject True/False
    doc_surface_complete: Optional[bool] = None

    def covers_doc_surface(self) -> bool:
        if self.doc_surface_complete is not None:
            return self.doc_surface_complete
        return doc_surface_files() <= set(self.files)

    # ------------------------------------------------------------ assembly
    @classmethod
    def from_file_summaries(cls, summaries: Dict[str, FileSummary],
                            root: Optional[Path] = None) -> "ProjectModel":
        """Build the model: registries read from their canonical files
        under ``root`` (default: the repo root), per-file contributions
        from ``summaries``."""
        root = Path(root) if root is not None else REPO_ROOT
        model = cls(files=dict(summaries))
        parsed: Dict[str, Optional[ast.AST]] = {}

        def parse_once(relpath: str) -> Optional[ast.AST]:
            if relpath not in parsed:
                parsed[relpath] = _parse_repo_file(root, relpath)
            return parsed[relpath]

        faults = parse_once(FAULTS_PATH)
        if faults is not None:
            for group, var in (("boundary", "BOUNDARY_SITES"),
                               ("io", "IO_SITES"),
                               ("post_save", "POST_SAVE_SITES"),
                               ("actor", "ACTOR_SITES")):
                sites, _ = extract_string_tuple(faults, var)
                model.fault_sites[group] = sites
            for group, var in (("boundary", "BOUNDARY_KINDS"),
                               ("io", "IO_KINDS"),
                               ("post_save", "POST_SAVE_KINDS"),
                               ("actor", "ACTOR_KINDS")):
                vals, _ = extract_string_tuple(faults, var)
                for v in vals:
                    model.fault_kinds[v] = group

        regress = parse_once(REGRESS_PATH)
        if regress is not None:
            keys, _ = extract_dict_str_keys(regress, "DEFAULT_THRESHOLDS")
            model.thresholds = keys

        history = parse_once(HISTORY_PATH)
        if history is not None:
            vals, _ = extract_string_tuple(history, "GAUGE_PREFIXES")
            model.gauge_prefixes = tuple(vals)

        readme = root / OBS_README_PATH
        if readme.exists():
            model.doc = parse_obs_readme(readme.read_text(encoding="utf-8"))

        for relpath, name in ATOMIC_WRITER_DEFS:
            tree = parse_once(relpath)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name == name:
                    model.atomic_writers.add(name)
                    break
        return model

    # ------------------------------------------------------- aggregations
    def emitted_names(self, kinds: Sequence[str] = ("gauge", "counter",
                                                    "histogram", "event"),
                      exclude_tests: bool = True) -> Set[str]:
        """Every statically resolved emitted name across the project."""
        out: Set[str] = set()
        for path, s in self.files.items():
            if exclude_tests and _is_test_path(path):
                continue
            for e in s.emissions:
                if e.kind in kinds:
                    out.update(e.names)
        return out

    def emitted_prefixes(self, kinds: Sequence[str] = ("gauge", "counter",
                                                       "histogram", "event"),
                         exclude_tests: bool = True) -> Set[str]:
        """Static prefixes of dynamic (unresolvable) emission sites."""
        out: Set[str] = set()
        for path, s in self.files.items():
            if exclude_tests and _is_test_path(path):
                continue
            for e in s.emissions:
                if e.kind in kinds and not e.names and e.prefix:
                    out.add(e.prefix)
        return out

    def digest(self) -> str:
        """Stable hash over everything a cached PER-FILE verdict depends
        on besides the file itself: the registries and the doc schema.
        Any registry edit invalidates every cached finding — correctness
        over cleverness.  Cross-file emission aggregates are deliberately
        NOT part of it: only the (never cached) project-level pass reads
        them."""
        payload = {
            "fault_sites": {g: sorted(d) for g, d in
                            sorted(self.fault_sites.items())},
            "fault_kinds": dict(sorted(self.fault_kinds.items())),
            "thresholds": sorted(self.thresholds),
            "gauge_prefixes": list(self.gauge_prefixes),
            "doc_rows": sorted((r.name for r in self.doc.rows)),
            "doc_mentioned": sorted(self.doc.mentioned),
            "atomic_writers": sorted(self.atomic_writers),
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()


def _is_test_path(relpath: str) -> bool:
    return relpath.startswith("tests/") or "/tests/" in relpath
