"""CLI: ``python -m hfrep_tpu_torch.analysis check hfrep_tpu_torch tools/torch_*.py
tests/test_torch_*.py`` (``hfrep_tpu/analysis/cli.py``).

Exit codes: 0 — clean (every finding fixed, suppressed, or baselined);
1 — non-baselined findings; 2 — usage or analyzer error.  ``--format
json`` emits a machine-readable report for CI annotation; ``--format
sarif`` emits SARIF 2.1.0 for code-scanning UIs; ``--changed`` scopes
the *reported* files to the git working-set diff (the project pre-pass
still covers every path given, so cross-layer facts stay whole-project);
``--write-baseline`` snapshots the current findings so existing debt can
be burned down incrementally without blocking the gate.  ``audit``
traces every registered compile boundary and runs the JPX rules over the
graphs (:mod:`hfrep_tpu_torch.analysis.programs`); ``--device cuda``
builds the serve rows' exported programs on the card.
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
from hfrep_tpu_torch.analysis.rules import (ALL_RULES, PROGRAM_RULES,
                                            PROGRAM_RULES_BY_ID)

#: the port's checked-in debt ledger, used when ``--baseline`` is absent
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
#: the program audit's ledger — separate file so `check` runs never see
#: JPX fingerprints as stale (and vice versa)
DEFAULT_AUDIT_BASELINE = Path(__file__).resolve().parent / "audit_baseline.json"
#: committed 0-findings SARIF snapshot `audit --diff` (and obs explain's
#: regressed-boundary pointer) compare against
DEFAULT_AUDIT_SNAPSHOT = Path(__file__).resolve().parent / "audit_snapshot.sarif"


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

    audit = sub.add_parser(
        "audit",
        help="trace + audit every registered compile boundary (JPX rules)")
    audit.add_argument("--format", choices=("human", "json", "sarif"),
                       default="human")
    audit.add_argument("--select", default=None,
                       help="comma-separated JPX rule ids (default: all)")
    audit.add_argument("--baseline", default=None,
                       help=f"baseline file (default: {DEFAULT_AUDIT_BASELINE})")
    audit.add_argument("--no-baseline", action="store_true")
    audit.add_argument("--write-baseline", action="store_true",
                       help="snapshot current audit findings and exit 0")
    audit.add_argument("--changed", action="store_true",
                       help="audit only boundaries whose defining modules "
                            "changed vs git HEAD (+ untracked)")
    audit.add_argument("--no-cache", action="store_true",
                       help="ignore and don't write the per-boundary cache")
    audit.add_argument("--cache", default=None,
                       help="audit cache file (default: "
                            "<repo>/.analysis-programs-cache-torch.json)")
    audit.add_argument("--diff", default=None, metavar="BASE_SARIF",
                       help="also render findings added/removed vs a "
                            "committed SARIF snapshot")
    audit.add_argument("--list", action="store_true",
                       help="list registered boundaries without tracing")
    audit.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                       help="where the serve rows build their exported "
                            "programs (the fx rows trace on the CPU)")

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
                  stale: Counter, out, rule_set=None,
                  result_props: Optional[dict] = None,
                  with_root: bool = True, run_props: Optional[dict] = None) -> None:
    """SARIF 2.1.0 — one run, one result per non-baselined finding, so
    code-scanning UIs (and ``sarif``-aware CI annotators) ingest the
    gate without a custom adapter.  ``rule_set`` defaults to the AST
    rules; the audit passes the JPX rules plus ``result_props`` (a
    fingerprint → properties map carrying the ``boundary`` join key
    ``obs explain`` reads), ``with_root=False`` — its document names no
    checkout (``SRCROOT`` is left to the reader), so the committed
    snapshot is the same from every checkout — and ``run_props``, the
    boundaries traced and skipped, into the run's properties."""
    rules = {}
    for r in (ALL_RULES if rule_set is None else rule_set):
        rules[r.id] = {
            "id": r.id,
            "name": r.name,
            "shortDescription": {"text": r.description or r.name},
        }
    result_props = result_props or {}
    results = []
    for f in new:
        result = {
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
        }
        if f.fingerprint in result_props:
            result["properties"] = result_props[f.fingerprint]
        results.append(result)
    run = {
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
                       "staleBaseline": sorted(stale.elements()), **(run_props or {})},
    }
    if not with_root:
        del run["originalUriBaseIds"]
    doc = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [run],
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


def _select_program_rules(spec: Optional[str]):
    if spec is None:
        return list(PROGRAM_RULES)
    rules = []
    for rid in (s.strip().upper() for s in spec.split(",") if s.strip()):
        if rid not in PROGRAM_RULES_BY_ID:
            raise AnalysisError(
                f"unknown program rule id {rid!r}; known: "
                f"{', '.join(sorted(PROGRAM_RULES_BY_ID))}")
        rules.append(PROGRAM_RULES_BY_ID[rid])
    return rules


def _load_sarif_fingerprints(path) -> Counter:
    """Fingerprint multiset of a SARIF snapshot (the ``--diff`` base)."""
    p = Path(path)
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError) as e:
        raise AnalysisError(f"cannot read SARIF snapshot {p}: {e}")
    fps: Counter = Counter()
    for run in data.get("runs", []) if isinstance(data, dict) else []:
        for res in run.get("results", []):
            fp = (res.get("partialFingerprints") or {}).get(
                "hfrepFingerprint/v1")
            if fp:
                fps[fp] += 1
    return fps


def _main_audit(args) -> int:
    from hfrep_tpu_torch.analysis import programs

    if args.list:
        for b in programs.PROGRAM_BOUNDARIES:
            print(f"{b.label:32s} {b.kind:10s} tracer={b.tracer:6s} "
                  f"device={programs.boundary_device(b, args.device):4s} "
                  f"policy={b.policy:5s} site={b.site}")
        return 0

    try:
        rules = _select_program_rules(args.select)
        if args.select and args.write_baseline:
            raise AnalysisError(
                "--write-baseline requires a full-rule audit; drop --select")
        if args.changed and args.write_baseline:
            raise AnalysisError(
                "--write-baseline needs the full finding set; drop --changed")
        restrict = changed_files() if args.changed else None
        res = programs.audit_boundaries(
            rules=rules, cache_path=args.cache, use_cache=not args.no_cache,
            restrict_to=restrict, device=args.device)

        baseline_path = (Path(args.baseline) if args.baseline
                         else DEFAULT_AUDIT_BASELINE)
        if args.write_baseline:
            n = write_baseline(res.findings, baseline_path)
            print(f"wrote {n} audit baseline entr{'y' if n == 1 else 'ies'} "
                  f"to {baseline_path}")
            return 0

        baseline = Counter()
        if not args.no_baseline and baseline_path.exists():
            baseline = load_baseline(baseline_path)
            if args.select:
                selected = {r.id for r in rules}
                baseline = Counter({
                    fp: n for fp, n in baseline.items()
                    if fp.split("::", 1)[0] in selected})
        new, matched, stale = apply_baseline(res.findings, baseline)
        if args.changed:
            stale = Counter()

        diff = None
        if args.diff:
            base_fps = _load_sarif_fingerprints(args.diff)
            cur = Counter(f.fingerprint for f in new)
            diff = {"added": sorted((cur - base_fps).elements()),
                    "removed": sorted((base_fps - cur).elements())}
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    out = sys.stdout
    if args.format == "json":
        payload = {
            "version": 1,
            "findings": [f.to_dict() for f in new],
            "counts": dict(Counter(f.rule for f in new)),
            "baselined": len(matched),
            "stale_baseline": sorted(stale.elements()),
            "traced": len(res.traced),
            "boundaries": res.traced,
            "devices": res.devices,
            "skipped": res.skipped,
        }
        if diff is not None:
            payload["diff"] = diff
        json.dump(payload, out, indent=2)
        out.write("\n")
    elif args.format == "sarif":
        props = {fp: {"boundary": b}
                 for fp, b in res.boundary_of.items()}
        _report_sarif(new, matched, stale, out, rule_set=rules,
                      result_props=props, with_root=False,
                      run_props={"traced": res.traced, "skipped": res.skipped,
                                 "devices": res.devices})
    else:
        _report_human(new, matched, stale, out)
        print(f"audited {len(res.traced)} boundar"
              f"{'y' if len(res.traced) == 1 else 'ies'}"
              f" ({len(res.skipped)} skipped)", file=out)
        for label, why in sorted(res.skipped.items()):
            print(f"  skip {label}: {why}", file=out)
        if diff is not None:
            for fp in diff["added"]:
                print(f"  diff +{fp}", file=out)
            for fp in diff["removed"]:
                print(f"  diff -{fp}", file=out)
            if not diff["added"] and not diff["removed"]:
                print("  diff: no change vs snapshot", file=out)
    return 1 if new else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.command == "rules":
        for r in (*ALL_RULES, *PROGRAM_RULES):
            print(f"{r.id}  {r.name:22s} {r.description}")
        return 0

    if args.command == "audit":
        return _main_audit(args)

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
