"""HF002 — fault-site consistency
(``hfrep_tpu/analysis/rules/hf_fault_sites.py``).

The fault-injection protocol is a cross-process string registry: a
drive crosses ``resilience.boundary("chunk")``, a writer passes
``write_atomic(..., io_site="queue_put")``, a selftest arms
``HFREP_FAULTS='sigterm@chunk=2'`` — and the only thing connecting them
is that the strings agree with :mod:`hfrep_tpu_torch.resilience.faults`.  A
typo'd site used to parse fine and then simply never fire: the
silently-disarmed injection, the worst possible failure mode for the
machinery whose whole job is proving the failure paths work.

Three checks, orphans flagged in both directions:

* a literal site at a hook call must be registered for that hook's
  group (``boundary("chunk")`` → ``BOUNDARY_SITES``,
  ``io_site=`` → ``IO_SITES``, ``fault_site=`` → ``POST_SAVE_SITES``);
* an ``HFREP_FAULTS`` spec literal (any string constant whose every
  ``;``-separated part matches the ``kind@site=N[xCOUNT]`` grammar)
  must name a known kind AND a site registered for a group that kind
  can fire at (boundary kinds may target boundary/io/actor sites —
  the signal can land mid-I/O);
* a registry entry no non-test hook call references is dead and flagged
  at its registry line (the project-level direction).

Tests are exempt from the spec check: intentionally-malformed specs
(``what@chunk=1``) are how ``FaultSpecError`` behavior is pinned.
"""

from __future__ import annotations

import ast
import re
from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule

_SPEC_PART = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<site>[a-z_]+)=[0-9]+(?:x[0-9]+)?$")

#: which site groups each *kind group* may target (mirrors the runtime
#: semantics: boundary kinds also fire at io and actor hooks)
KIND_GROUP_TARGETS = {
    "boundary": ("boundary", "io", "actor"),
    "io": ("io",),
    "post_save": ("post_save",),
    "actor": ("actor",),
}


def spec_parts(value: str):
    """``"sigterm@chunk=2;torn@ckpt=1"`` -> the matched directive parts;
    [] when the string is not entirely spec-shaped (so ordinary prose
    containing an ``@`` never matches)."""
    parts = [p.strip() for p in value.split(";") if p.strip()]
    matches = [_SPEC_PART.match(p) for p in parts]
    return matches if parts and all(matches) else []


class FaultSiteRule(Rule):
    id = "HF002"
    name = "fault-site-consistency"
    description = ("fault-injection sites at hooks and in HFREP_FAULTS "
                   "specs must round-trip against the faults.py registry")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import (_is_test_path,
                                                collect_fault_sites)

        project = ctx.project
        if project is None or not project.fault_sites:
            return []
        if _is_test_path(ctx.relpath):
            return []
        findings: List[Finding] = []

        def finding(line: int, message: str) -> Finding:
            return Finding(
                rule=self.id, path=ctx.relpath, line=line, col=0,
                message=message,
                snippet=(ctx.lines[line - 1].strip()
                         if 0 < line <= len(ctx.lines) else ""))

        summary = project.files.get(ctx.relpath)
        used = (summary.fault_sites_used if summary is not None
                else collect_fault_sites(ctx.tree))
        for group, site, line in used:
            registry = project.fault_sites.get(group, {})
            if site not in registry:
                findings.append(finding(
                    line,
                    f"fault site {site!r} is not in the faults.py "
                    f"{group.upper()}_SITES registry — an HFREP_FAULTS "
                    "directive targeting it would silently never fire"))

        # spec literals (skip faults.py itself: its docstring grammar
        # examples are prose, and whole-string matching already filters
        # everything but genuine spec constants)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            for m in spec_parts(node.value):
                kind, site = m.group("kind"), m.group("site")
                kind_group = project.fault_kinds.get(kind)
                if kind_group is None:
                    findings.append(finding(
                        node.lineno,
                        f"HFREP_FAULTS spec kind {kind!r} is not a "
                        "registered fault kind"))
                    continue
                targets = KIND_GROUP_TARGETS.get(kind_group, ())
                if not any(site in project.fault_sites.get(g, {})
                           for g in targets):
                    findings.append(finding(
                        node.lineno,
                        f"HFREP_FAULTS spec site {site!r} is not "
                        f"registered for any group {kind!r} can fire at "
                        f"({'/'.join(targets)}) — the directive would "
                        "silently never fire"))
        return findings

    def check_project(self, project) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import FAULTS_PATH, _is_test_path

        if FAULTS_PATH not in project.files:
            # a scoped run (single file, one package) cannot see the
            # registry's whole usage surface — "orphaned" would mean
            # "outside this run's horizon", not "dead"
            return []
        used = set()
        for path, s in project.files.items():
            if _is_test_path(path):
                continue
            for group, site, _line in s.fault_sites_used:
                used.add((group, site))
        findings: List[Finding] = []
        for group, registry in sorted(project.fault_sites.items()):
            for site, line in sorted(registry.items()):
                if (group, site) not in used:
                    findings.append(Finding(
                        rule=self.id, path=FAULTS_PATH, line=line, col=0,
                        message=(
                            f"registry site {site!r} ({group}) is "
                            "referenced by no hook call in the project — "
                            "dead registry entry (or the hook lost its "
                            "literal site)"),
                        snippet=f"{group.upper()}_SITES: {site}"))
        return findings
