"""HF001 — gauge-direction completeness
(``hfrep_tpu/analysis/rules/hf_gauge_thresholds.py``).

The historical bug, twice: ``serve/shed_rate`` and
``scenario/pad_waste_frac`` would each have gated AND cross-host
pod-folded INVERTED — a rising shed rate reading as an improvement —
because the regression engine's fallback rule guesses direction from a
name-suffix heuristic, and both names defeat it.  Both were caught by a
reviewer hand-adding explicit ``regress.DEFAULT_THRESHOLDS`` entries.
This rule kills the class by construction: every *statically named*
gauge or counter emission under one of ``history.GAUGE_PREFIXES`` (the
vocabulary that rides into the committed history store) must have an
explicit ``DEFAULT_THRESHOLDS`` row — the port's own tables in
``hfrep_tpu_torch/obs/``.

Resolution: string constants, loop-bound names and f-strings whose
every hole is loop-bound over literal collections all resolve (the
repo's dominant ``for name, value in ((...), ...)`` emission idiom).
Dynamic open vocabularies — ``f"bench/bf16_probe_h{h}_..."`` — are NOT
flagged: their per-cell series are open-ended by design, the README
documents them as wildcard rows, and demanding a table entry per cell
would be noise (the pinned false-positive class).

Tests are exempt: fixture emissions do not reach the history store.
"""

from __future__ import annotations

from typing import List

from hfrep_tpu_torch.analysis.engine import FileContext, Finding
from hfrep_tpu_torch.analysis.rules.base import Rule


class GaugeThresholdRule(Rule):
    id = "HF001"
    name = "gauge-direction-completeness"
    description = ("history-store gauges/counters (history.GAUGE_PREFIXES) "
                   "must have explicit regress.DEFAULT_THRESHOLDS entries")

    def check(self, ctx: FileContext) -> List[Finding]:
        from hfrep_tpu_torch.analysis.project import (_is_test_path,
                                                collect_emissions)

        project = ctx.project
        if project is None or not project.gauge_prefixes:
            return []
        if _is_test_path(ctx.relpath):
            return []
        summary = project.files.get(ctx.relpath)
        emissions = (summary.emissions if summary is not None
                     else collect_emissions(ctx.tree))
        findings: List[Finding] = []
        for e in emissions:
            if e.kind not in ("gauge", "counter"):
                continue
            for name in e.names:
                if not name.startswith(tuple(project.gauge_prefixes)):
                    continue
                if name in project.thresholds:
                    continue
                findings.append(Finding(
                    rule=self.id, path=ctx.relpath, line=e.line, col=0,
                    message=(
                        f"{e.kind} {name!r} has no explicit "
                        "regress.DEFAULT_THRESHOLDS entry: it would gate "
                        "and cross-host fold by the name-suffix heuristic "
                        "— the class that inverted serve/shed_rate and "
                        "scenario/pad_waste_frac"),
                    snippet=(ctx.lines[e.line - 1].strip()
                             if 0 < e.line <= len(ctx.lines) else ""),
                ))
        return findings
