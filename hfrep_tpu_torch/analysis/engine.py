"""Rule engine: file contexts, findings, ``# noqa`` suppression, baselines
(``hfrep_tpu/analysis/engine.py``).

The engine is deliberately flake8-shaped — parse once per file, hand the
tree to every rule, post-filter by per-line suppressions — because that
shape is what lets a rule be a ~50-line visitor instead of a framework.
Three extensions matter here:

* a **project pre-pass** (:func:`analyze_paths`): every file is
  summarized once (instruments/events emitted, fault sites referenced —
  :mod:`hfrep_tpu_torch.analysis.project`), the summaries plus the
  extracted registries (fault sites, ``DEFAULT_THRESHOLDS``,
  ``GAUGE_PREFIXES``, the atomic-writer entry points) are assembled
  into a :class:`~hfrep_tpu_torch.analysis.project.ProjectModel`, and
  every rule runs with it in context — so a gauge emitted in a tool
  checks against the table in ``obs/regress.py``.  Rules may
  additionally implement ``check_project(model)`` for findings that
  belong to no single analyzed file (a dead registry entry);
* a **fingerprint cache** (:data:`DEFAULT_CACHE`): per-file summaries
  and findings keyed by (file sha, analyzer self-hash, project digest),
  so the repo-wide two-phase run costs parse+rules only for files that
  changed — the whole-tree gate stays inside the tier-1 budget as the
  codebase grows.  Any registry edit changes the project digest and
  invalidates every cached verdict: correctness over cleverness;
* a **baseline file** keyed by content fingerprints (rule + path +
  normalized source line, with multiplicity) so pre-existing violations
  can be burned down incrementally without blocking CI on day one —
  line numbers are deliberately *not* part of the fingerprint, so
  unrelated edits above a baselined site don't resurrect it.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import re
import tokenize
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: Repo root, the parent of ``hfrep_tpu_torch/``; fingerprint paths are
#: made relative to it so baselines are CWD-independent.
REPO_ROOT = Path(__file__).resolve().parents[2]

#: default per-file fingerprint cache (gitignored; safe to delete any
#: time); its own name, beside the JAX package's analyzer's at the root
DEFAULT_CACHE = REPO_ROOT / ".analysis-cache-torch.json"
CACHE_VERSION = 1

_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>[A-Z]+[0-9]+(?:\s*,\s*[A-Z]+[0-9]+)*))?",
    re.IGNORECASE,
)


class AnalysisError(Exception):
    """Unrecoverable analyzer failure (bad baseline file, unknown rule id)."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation at one source location."""

    rule: str            # "JAX005", "HF001" … (or "JAX000" for parse errors)
    path: str            # posix path, relative to the repo root when under it
    line: int            # 1-based
    col: int             # 0-based
    message: str
    snippet: str = ""    # stripped source line, used in the fingerprint

    @property
    def fingerprint(self) -> str:
        """Stable identity for baseline matching: where-independent of
        line numbers, so edits elsewhere in the file don't churn it."""
        return f"{self.rule}::{self.path}::{self.snippet}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"


def _normalize_path(path) -> str:
    p = Path(path).resolve()
    try:
        return p.relative_to(REPO_ROOT).as_posix()
    except ValueError:
        return p.as_posix()


class FileContext:
    """Everything a rule needs about one file: source, AST, suppressions,
    plus the project model assembled by the pre-pass."""

    def __init__(self, path, source: str,
                 relpath: Optional[str] = None,
                 project=None, tree: Optional[ast.AST] = None):
        self.path = str(path)
        self.relpath = relpath if relpath is not None else _normalize_path(path)
        self.source = source
        self.lines = source.splitlines()
        # ``tree`` lets the two-phase runner hand over its phase-1 parse
        # instead of paying ast.parse twice per file
        self.tree = tree if tree is not None \
            else ast.parse(source, filename=self.path)
        #: the assembled ProjectModel on whole-project runs; None on
        #: single-snippet runs, where the cross-layer rules no-op unless
        #: handed a model explicitly (the unit-test path)
        self.project = project
        #: line -> comment text (tokenizer-accurate, so ``# noqa`` or
        #: ``# shape:`` *inside a docstring* never counts)
        self.comments: Dict[int, str] = self._scan_comments()
        self._noqa: Dict[int, Optional[Set[str]]] = self._scan_noqa()

    def _scan_comments(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(self.source).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            pass                    # partial map is fine; ast.parse gates worse
        return out

    def _scan_noqa(self) -> Dict[int, Optional[Set[str]]]:
        """line -> None (bare ``# noqa``: suppress all) or a code set."""
        out: Dict[int, Optional[Set[str]]] = {}
        for i, text in self.comments.items():
            m = _NOQA_RE.search(text)
            if not m:
                continue
            codes = m.group("codes")
            out[i] = ({c.strip().upper() for c in codes.split(",")}
                      if codes else None)
        return out

    def suppressed(self, finding: Finding) -> bool:
        codes = self._noqa.get(finding.line, False)
        if codes is False:
            return False
        return codes is None or finding.rule in codes

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(rule=rule, path=self.relpath, line=line, col=col,
                       message=message, snippet=snippet)


# --------------------------------------------------------------- running
def _iter_py_files(paths: Sequence) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
        elif p.exists():
            # an explicitly named non-.py file would be silently skipped —
            # "clean" on an unanalyzed target is worse than an error
            raise AnalysisError(f"not a Python file: {p}")
        else:
            raise AnalysisError(f"no such path: {p}")
    # de-dup while keeping order
    seen, out = set(), []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def _syntax_finding(e: SyntaxError, relpath: str) -> Finding:
    return Finding(rule="JAX000", path=relpath, line=e.lineno or 1,
                   col=(e.offset or 1) - 1,
                   message=f"syntax error: {e.msg}",
                   snippet=(e.text or "").strip())


def _run_rules(ctx: "FileContext", rules: Sequence) -> List[Finding]:
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    findings = [f for f in findings if not ctx.suppressed(f)]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Sequence] = None,
                   relpath: Optional[str] = None,
                   project=None) -> List[Finding]:
    """Run ``rules`` (default: all) over one source blob.  Returns findings
    already filtered by ``# noqa`` suppressions.  A syntax error yields a
    single JAX000 finding rather than raising, so one broken file can't
    take down a whole-tree run.  ``project`` injects a
    :class:`~hfrep_tpu_torch.analysis.project.ProjectModel` for the
    cross-layer rules (they no-op without one)."""
    from hfrep_tpu_torch.analysis.rules import ALL_RULES

    rules = list(rules) if rules is not None else list(ALL_RULES)
    try:
        ctx = FileContext(path, source, relpath=relpath, project=project)
    except SyntaxError as e:
        rel = relpath if relpath is not None else _normalize_path(path)
        return [_syntax_finding(e, rel)]
    return _run_rules(ctx, rules)


# ---------------------------------------------------------------- caching
def _self_hash() -> str:
    """Hash of the analyzer's own source: any rule/engine/project edit
    must invalidate every cached verdict, without anyone remembering to
    bump a version constant."""
    h = hashlib.sha256()
    pkg = Path(__file__).resolve().parent
    for f in sorted(pkg.rglob("*.py")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def torch_version() -> str:
    """The installed torch version WITHOUT importing torch (the analysis
    package stays torch-import-free; warm cache paths must not pay the
    import).  The program audit's cache is keyed on it: every traced
    graph is a fact about a specific torch, and an upgrade must
    cold-start it rather than replay the old runtime's answers."""
    try:
        from importlib.metadata import version
        return version("torch")
    except Exception:
        return "unknown"


def load_cache(path) -> dict:
    try:
        data = json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError, ValueError):
        return {}
    if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
        return {}
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return {}
    # a malformed per-file entry (hand-edited, foreign writer) is a
    # cache MISS, never a crash — degrade-to-cold is the contract
    return {rel: e for rel, e in entries.items() if isinstance(e, dict)}


def save_cache(path, entries: dict) -> None:
    """Best-effort: an unwritable cache degrades to a cold run, never an
    error.  Published by rename so a killed run cannot leave a torn
    cache (a corrupt cache also just degrades to cold — belt and
    braces, not load-bearing)."""
    import os
    p = Path(path)
    tmp = p.parent / f".{p.name}.tmp-{os.getpid()}"
    try:
        tmp.write_text(
            json.dumps({"version": CACHE_VERSION, "entries": entries}),
            encoding="utf-8")
        os.replace(tmp, p)
    except OSError:
        tmp.unlink(missing_ok=True)


def analyze_paths(paths: Sequence, rules: Optional[Sequence] = None,
                  cache_path=None, use_cache: bool = True,
                  restrict_to: Optional[Set[str]] = None) -> List[Finding]:
    """Two-phase whole-project run.

    Phase 1 summarizes every file (emissions, fault-site references —
    from the cache when the file is unchanged) and assembles the
    :class:`~hfrep_tpu_torch.analysis.project.ProjectModel`
    (registries are read from their canonical files, so a scoped run
    still sees them).  Phase 2 runs the per-file rules with the model in
    context, then each rule's ``check_project`` hook once.

    ``restrict_to``: repo-relative posix paths — when given, per-file
    findings are reported only for those files (the ``--changed`` mode);
    phase 1 still covers the full path set so cross-layer facts stay
    whole-project.  Project-level findings are always reported: they are
    global invariants, not properties of any one changed file.
    """
    from hfrep_tpu_torch.analysis.project import (FileSummary, ProjectModel,
                                                  summarize_file)
    from hfrep_tpu_torch.analysis.rules import ALL_RULES

    rules = list(rules) if rules is not None else list(ALL_RULES)
    cache_file = Path(cache_path) if cache_path else DEFAULT_CACHE
    cache = load_cache(cache_file) if use_cache else {}
    self_hash = _self_hash()

    findings: List[Finding] = []
    sources: Dict[str, str] = {}          # relpath -> source text
    shas: Dict[str, str] = {}
    trees: Dict[str, ast.AST] = {}
    summaries: Dict[str, FileSummary] = {}

    # ------------------------------------------------------------ phase 1
    for f in _iter_py_files(paths):
        try:
            text = f.read_text(encoding="utf-8")
        except OSError as e:
            raise AnalysisError(f"cannot read {f}: {e}")
        rel = _normalize_path(f)
        sources[rel] = text
        shas[rel] = hashlib.sha256(text.encode()).hexdigest()
        entry = cache.get(rel)
        if (entry and entry.get("sha") == shas[rel]
                and entry.get("self") == self_hash
                and not entry.get("syntax_error")
                and isinstance(entry.get("summary"), dict)):
            try:
                summaries[rel] = FileSummary.from_dict(entry["summary"])
                continue
            except (KeyError, TypeError, AttributeError):
                cache.pop(rel, None)      # malformed inner shape: a MISS
        try:
            tree = ast.parse(text, filename=str(f))
        except SyntaxError as e:
            if restrict_to is None or rel in restrict_to:
                # same reporting scope as phase 2: a --changed run must
                # not fail on an unchanged file's (pre-existing) error
                findings.append(_syntax_finding(e, rel))
            summaries[rel] = FileSummary()
            cache[rel] = {"sha": shas[rel], "self": self_hash,
                          "summary": summaries[rel].to_dict(),
                          "syntax_error": True}
            continue
        trees[rel] = tree
        summaries[rel] = summarize_file(tree)
        cache[rel] = {"sha": shas[rel], "self": self_hash,
                      "summary": summaries[rel].to_dict()}

    model = ProjectModel.from_file_summaries(summaries)
    rule_ids = ",".join(r.id for r in rules)
    digest = hashlib.sha256(
        f"{self_hash}:{rule_ids}:{model.digest()}".encode()).hexdigest()

    # ------------------------------------------------------------ phase 2
    for rel, text in sources.items():
        if restrict_to is not None and rel not in restrict_to:
            continue
        entry = cache.get(rel, {})
        if entry.get("syntax_error"):
            continue                      # the JAX000 finding is emitted above
        if entry.get("digest") == digest and isinstance(
                entry.get("findings"), list):
            try:
                cached = [Finding(**fd) for fd in entry["findings"]]
            except TypeError:             # malformed inner shape: a MISS
                pass
            else:
                findings.extend(cached)
                continue
        try:
            ctx = FileContext(REPO_ROOT / rel, text, relpath=rel,
                              project=model, tree=trees.get(rel))
        except SyntaxError as e:          # unreachable after phase 1, belt
            findings.append(_syntax_finding(e, rel))
            continue
        file_findings = _run_rules(ctx, rules)
        findings.extend(file_findings)
        entry = cache.setdefault(rel, {"sha": shas[rel], "self": self_hash,
                                       "summary": summaries[rel].to_dict()})
        entry["digest"] = digest
        entry["findings"] = [dataclasses.asdict(f) for f in file_findings]

    # ------------------------------------------------- project-level pass
    for rule in rules:
        check_project = getattr(rule, "check_project", None)
        if check_project is None:
            continue
        for finding in check_project(model):
            # project findings carry no per-file noqa scope; they are
            # suppressed only by fixing the registry/doc they point at
            findings.append(finding)

    if use_cache:
        # keep entries for files OUTSIDE this run's scope (a scoped
        # `check hfrep_tpu_torch/serve` must not wipe the repo-wide warm
        # cache); prune only entries whose file is gone from disk, so
        # the cache cannot grow without bound
        save_cache(cache_file, {
            rel: e for rel, e in cache.items()
            if rel in sources or (REPO_ROOT / rel).exists()})
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -------------------------------------------------------------- baseline
def load_baseline(path) -> Counter:
    """Baseline file -> fingerprint multiset.  Format::

        {"version": 1,
         "entries": [{"fingerprint": "...", "justification": "..."}, ...]}

    Each entry absorbs exactly one matching finding; if the code grows a
    second identical violation on the same path it is *not* silently
    covered.
    """
    p = Path(path)
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except OSError as e:
        raise AnalysisError(f"cannot read baseline {p}: {e}")
    except json.JSONDecodeError as e:
        raise AnalysisError(f"baseline {p} is not valid JSON: {e}")
    if not isinstance(data, dict) or "entries" not in data:
        raise AnalysisError(f"baseline {p}: expected {{'entries': [...]}}")
    fps = Counter()
    for entry in data["entries"]:
        if not isinstance(entry, dict) or "fingerprint" not in entry:
            raise AnalysisError(f"baseline {p}: malformed entry {entry!r}")
        fps[entry["fingerprint"]] += 1
    return fps


def apply_baseline(findings: Iterable[Finding],
                   baseline: Counter) -> Tuple[List[Finding], List[Finding], Counter]:
    """Split findings into (new, baselined); also return the unconsumed
    baseline entries (stale — the violation was fixed or moved)."""
    remaining = Counter(baseline)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in findings:
        if remaining[f.fingerprint] > 0:
            remaining[f.fingerprint] -= 1
            matched.append(f)
        else:
            new.append(f)
    stale = Counter({fp: n for fp, n in remaining.items() if n > 0})
    return new, matched, stale


def write_baseline(findings: Iterable[Finding], path,
                   justifications: Optional[Dict[str, str]] = None) -> int:
    """Serialize findings as a baseline.  ``justifications`` maps
    fingerprints to one-line reasons; unknown fingerprints get a TODO so
    review pressure is visible in the diff."""
    justifications = justifications or {}
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        entries.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "line": f.line,          # informational only; not matched on
            "justification": justifications.get(
                f.fingerprint, "TODO: justify or fix"),
        })
    payload = {"version": 1, "entries": entries}
    Path(path).write_text(json.dumps(payload, indent=2) + "\n",
                          encoding="utf-8")
    return len(entries)
