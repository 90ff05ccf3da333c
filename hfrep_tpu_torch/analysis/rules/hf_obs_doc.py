"""HF004 — obs schema / README sync, both directions
(``hfrep_tpu/analysis/rules/hf_obs_doc.py``).

``hfrep_tpu_torch/obs/README.md``'s schema tables are the contract
every downstream consumer (the report parser, the history store,
dashboards, humans reading a verdict) programs against.  An event
emitted but undocumented is invisible protocol; a documented row whose
emission was renamed away is a schema lie that survives until someone
greps.

Code side (per file, tests exempt): every *statically named* event
emission (direct ``.event("name", ...)`` or through a local forwarding
wrapper — the repo's ``_emit``/``_event``/``_obs_event`` pattern) and
every namespaced instrument (a name containing ``/``) must be
documented — an exact backtick mention or a wildcard schema row
(``bench/serve_qps_c{1k,10k,100k}``, ``train/<key>``).

Doc side (project-level): every structured schema-table row must match
an emission somewhere — an exact resolved name, or (for wildcard rows)
a dynamic emission site whose static prefix is compatible.  Un-prefixed
instruments (``steps_per_sec``) and dynamic emissions with no prefix
are out of scope: the rule enforces the namespaced vocabulary, not
every local counter.
"""

from __future__ import annotations

import re
from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule


def _wildcard_compatible(row_name: str, prefixes) -> bool:
    """Does a dynamic emission prefix plausibly produce this documented
    (wildcard) row?  Compatibility = the row's static head and some
    emitted prefix extend each other."""
    head = re.split(r"[{<]", row_name, maxsplit=1)[0]
    return any(head.startswith(p) or p.startswith(head)
               for p in prefixes if p)


class ObsDocRule(Rule):
    id = "HF004"
    name = "obs-schema-doc-sync"
    description = ("emitted events/namespaced instruments and the "
                   "obs/README.md schema tables must agree, both "
                   "directions")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import (_is_test_path,
                                                collect_emissions)

        project = ctx.project
        if project is None or (not project.doc.rows
                               and not project.doc.mentioned):
            return []
        if _is_test_path(ctx.relpath):
            return []
        summary = project.files.get(ctx.relpath)
        emissions = (summary.emissions if summary is not None
                     else collect_emissions(ctx.tree))
        findings: List[Finding] = []
        for e in emissions:
            for name in e.names:
                if e.kind != "event" and "/" not in name:
                    continue              # un-namespaced local instrument
                if project.doc.documents(name):
                    continue
                findings.append(Finding(
                    rule=self.id, path=ctx.relpath, line=e.line, col=0,
                    message=(
                        f"{e.kind} {name!r} is not documented in the "
                        "obs/README.md schema tables — undocumented "
                        "protocol every stream consumer has to reverse-"
                        "engineer"),
                    snippet=(ctx.lines[e.line - 1].strip()
                             if 0 < e.line <= len(ctx.lines) else "")))
        return findings

    def check_project(self, project) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import OBS_README_PATH

        if not project.covers_doc_surface():
            # a scoped run cannot judge "nothing emits this row": the
            # emission could live in any file outside the run's horizon
            return []
        emitted = project.emitted_names()
        prefixes = project.emitted_prefixes()
        findings: List[Finding] = []
        for row in project.doc.rows:
            patterns = row.patterns
            if any(re.match(p, name) for p in patterns for name in emitted):
                continue
            if ("{" in row.name or "<" in row.name) \
                    and _wildcard_compatible(row.name, prefixes):
                continue
            findings.append(Finding(
                rule=self.id, path=OBS_README_PATH, line=row.line, col=0,
                message=(
                    f"documented schema row {row.name!r} matches no "
                    "emission in the project — stale docs (renamed or "
                    "removed emission)"),
                snippet=f"| `{row.name}` |"))
        return findings
