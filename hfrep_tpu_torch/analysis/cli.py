"""CLI: ``python -m hfrep_tpu_torch.analysis check hfrep_tpu_torch tools/torch_*.py
tests/test_torch_*.py`` (``hfrep_tpu/analysis/cli.py``).

Exit codes: 0 — clean (every finding fixed, suppressed, or baselined);
1 — non-baselined findings; 2 — usage or analyzer error.  ``--format
json`` emits a machine-readable report for CI annotation; ``--format
sarif`` emits SARIF 2.1.0 for code-scanning UIs; ``--changed`` scopes
the *reported* files to the git working-set diff (the project pre-pass
still covers every path given, so cross-layer facts stay whole-project);
``--write-baseline`` snapshots the current findings so existing debt can
be burned down incrementally without blocking the gate.  The JAX
package's ``audit`` subcommand (its traced-program rules) has no
counterpart yet (``ROADMAP.md``, queue 1 item 10b).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import List, Optional, Set

from hfrep_tpu_torch.analysis.engine import (
    AnalysisError, Finding, REPO_ROOT, analyze_paths, apply_baseline,
    load_baseline, write_baseline,
)
from hfrep_tpu_torch.analysis.rules import ALL_RULES

#: the port's checked-in debt ledger, used when ``--baseline`` is absent
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m hfrep_tpu_torch.analysis",
        description="static lint & shape-contract checker for the port")
    sub = p.add_subparsers(dest="command", required=True)

    check = sub.add_parser("check", help="analyze files/directories")
    check.add_argument("paths", nargs="+", help=".py files or directories")
    check.add_argument("--format", choices=("human", "json", "sarif"),
                       default="human")
    check.add_argument("--baseline", default=None,
                       help=f"baseline file (default: {DEFAULT_BASELINE})")
    check.add_argument("--write-baseline", action="store_true",
                       help="snapshot current findings into the baseline "
                            "file and exit 0")
    check.add_argument("--changed", action="store_true",
                       help="report findings only for files changed vs git "
                            "HEAD (+ untracked); the project pre-pass still "
                            "covers every path given, and project-level "
                            "findings always report")
    check.add_argument("--no-cache", action="store_true",
                       help="ignore and don't write the per-file "
                            "fingerprint cache")
    check.add_argument("--cache", default=None,
                       help="fingerprint cache file (default: "
                            "<repo>/.analysis-cache-torch.json)")

    sub.add_parser("rules", help="list rule ids and descriptions")
    return p


def _report_human(new: List[Finding], baselined: List[Finding],
                  stale: Counter, out) -> None:
    for f in new:
        print(f.render(), file=out)
    counts = Counter(f.rule for f in new)
    if new:
        per_rule = ", ".join(f"{r}×{n}" for r, n in sorted(counts.items()))
        print(f"\n{len(new)} finding(s) [{per_rule}]"
              f" ({len(baselined)} baselined)", file=out)
    else:
        print(f"clean: 0 findings ({len(baselined)} baselined)", file=out)
    if stale:
        print(f"note: {sum(stale.values())} stale baseline entr"
              f"{'y' if sum(stale.values()) == 1 else 'ies'} (fixed or "
              f"moved — prune with --write-baseline):", file=out)
        for fp in sorted(stale):
            print(f"  {fp}", file=out)


def changed_files() -> Set[str]:
    """Repo-relative posix paths of .py files changed vs HEAD (staged,
    unstaged and untracked) — the ``--changed`` scope.  Raises
    :class:`AnalysisError` outside a git checkout of this repo (a tree
    unpacked from ``git archive`` has no ``.git``, and git run there
    could answer for an enclosing repository): an empty scope would read
    as "clean", which is worse than an error."""
    if not (REPO_ROOT / ".git").exists():
        raise AnalysisError(
            f"--changed needs a git checkout: {REPO_ROOT} has no .git")
    out: Set[str] = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(cmd, cwd=REPO_ROOT, capture_output=True,
                                  text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise AnalysisError(f"--changed needs git: {e}")
        if proc.returncode != 0:
            raise AnalysisError(
                f"--changed: {' '.join(cmd)} failed: {proc.stderr.strip()}")
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip().endswith(".py"))
    return out


def _report_sarif(new: List[Finding], baselined: List[Finding],
                  stale: Counter, out) -> None:
    """SARIF 2.1.0 — one run, one result per non-baselined finding, so
    code-scanning UIs (and ``sarif``-aware CI annotators) ingest the
    gate without a custom adapter."""
    rules = {}
    for r in ALL_RULES:
        rules[r.id] = {
            "id": r.id,
            "name": r.name,
            "shortDescription": {"text": r.description or r.name},
        }
    results = []
    for f in new:
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "partialFingerprints": {"hfrepFingerprint/v1": f.fingerprint},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path,
                                         "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": f.col + 1,
                               "snippet": {"text": f.snippet}},
                },
            }],
        })
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "hfrep-analysis",
                # no informationUri: SARIF 2.1.0 wants an absolute URI and
                # the docs live in-repo (hfrep_tpu_torch/analysis/README.md)
                "rules": sorted(rules.values(), key=lambda r: r["id"]),
            }},
            "originalUriBaseIds": {
                "SRCROOT": {"uri": REPO_ROOT.as_uri() + "/"}},
            "results": results,
            "properties": {"baselined": len(baselined),
                           "staleBaseline": sorted(stale.elements())},
        }],
    }
    json.dump(doc, out, indent=2)
    out.write("\n")


def _report_json(new: List[Finding], baselined: List[Finding],
                 stale: Counter, out) -> None:
    payload = {
        "version": 1,
        "findings": [f.to_dict() for f in new],
        "counts": dict(Counter(f.rule for f in new)),
        "baselined": len(baselined),
        "stale_baseline": sorted(stale.elements()),
    }
    json.dump(payload, out, indent=2)
    out.write("\n")


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.command == "rules":
        for r in ALL_RULES:
            print(f"{r.id}  {r.name:22s} {r.description}")
        return 0

    try:
        if args.changed and args.write_baseline:
            raise AnalysisError(
                "--write-baseline needs the full finding set; drop --changed")
        restrict = changed_files() if args.changed else None
        findings = analyze_paths(
            args.paths, cache_path=args.cache, use_cache=not args.no_cache,
            restrict_to=restrict)

        baseline_path = Path(args.baseline) if args.baseline else DEFAULT_BASELINE
        if args.write_baseline:
            # carry forward justifications for entries that still match
            old = {}
            if baseline_path.exists():
                try:
                    data = json.loads(
                        baseline_path.read_text(encoding="utf-8"))
                except (OSError, json.JSONDecodeError) as e:
                    raise AnalysisError(
                        f"cannot re-read baseline {baseline_path}: {e}")
                for e in data.get("entries", []):
                    if isinstance(e, dict) and "fingerprint" in e:
                        old.setdefault(e["fingerprint"], e.get("justification"))
            n = write_baseline(findings, baseline_path,
                               justifications={k: v for k, v in old.items()
                                               if v})
            print(f"wrote {n} baseline entr{'y' if n == 1 else 'ies'} to "
                  f"{baseline_path}")
            return 0

        baseline = (load_baseline(baseline_path) if baseline_path.exists()
                    else Counter())
        new, matched, stale = apply_baseline(findings, baseline)
        if args.changed:
            # a diff-scoped run never saw the unchanged files' findings,
            # so their baseline entries are not stale, just unchecked
            stale = Counter()
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    report = {"json": _report_json, "sarif": _report_sarif,
              "human": _report_human}[args.format]
    report(new, matched, stale, sys.stdout)
    return 1 if new else 0


if __name__ == "__main__":          # pragma: no cover
    sys.exit(main())
