"""Regression engine: robust rolling baselines over the run history
(``hfrep_tpu/obs/regress.py``).

Given one run (a history record, ingested or not) and the history index
(:mod:`hfrep_tpu_torch.obs.history`), decide per metric whether the run
regressed against the rolling baseline of *comparable* runs — same
``(family, shape, mesh, host, backend)`` key — and produce a machine- and
human-readable verdict: Podracer-style continuous throughput/MFU
accounting (arXiv:2104.06272) needs something that remembers, not just
reports.  The rules and the verdict document are the JAX module's, rule
for rule, so both packages give one verdict on one history.

Baseline math — median/MAD, not mean/stddev: bench series carry
occasional far outliers (a compile-heavy warmstart, a noisy-neighbor
session) that would poison a mean baseline and inflate a stddev gate
into uselessness.  The baseline is the **median** of the last
``window`` comparable samples; the allowed deviation is

    max(rel_tol * |median|,  mad_mult * 1.4826 * MAD,  abs_tol)

— the relative-tolerance floor keeps a zero-MAD series (N identical
CPU-fixture numbers) from flagging measurement jitter, the scaled MAD
term (1.4826 ≈ consistency with σ under normality) adapts to genuinely
noisy series, and ``abs_tol`` covers integer metrics like compile
counts where ±1 is noise at any scale.

Small-N behavior: fewer than ``min_runs`` comparable samples yields an
``insufficient-history`` check that PASSES — a gate must not brick the
first CI run on a new host/mesh; it starts enforcing once the series
exists.  A run that measured *nothing at all* (every check ``missing``:
empty event stream, writer killed before the first flush) fails as
``no-data`` — a green gate with zero evidence would be the silently
disarmed sentinel.  Direction matters: steps/sec and MFU regress
*down*, step times, memory and compile counts regress *up*;
improvements never fail.

Stdlib-only, like the rest of the obs read path.
"""

from __future__ import annotations

import json
from statistics import median
from typing import Dict, List, Optional

from hfrep_tpu_torch.obs.history import _num

#: metric -> gate config.  ``direction``: "up" = higher is better.
#: ``rel_tol`` is the relative floor on the allowed deviation, ``abs_tol``
#: an absolute floor (integer-ish metrics), ``mad_mult`` scales the
#: robust spread term.  Every threshold is overridable per metric via
#: the CLI / function arguments; unlisted metrics (e.g. ``bench/...``
#: gauges) gate with :data:`DEFAULT_RULE` and direction "up".
DEFAULT_THRESHOLDS: Dict[str, dict] = {
    "steps_per_sec":           {"direction": "up",   "rel_tol": 0.05,
                                "mad_mult": 5.0},
    "step_time_p50_s":         {"direction": "down", "rel_tol": 0.08,
                                "mad_mult": 5.0},
    "step_time_p95_s":         {"direction": "down", "rel_tol": 0.15,
                                "mad_mult": 5.0},
    "mfu":                     {"direction": "up",   "rel_tol": 0.05,
                                "mad_mult": 5.0},
    "memory_high_water_bytes": {"direction": "down", "rel_tol": 0.10,
                                "mad_mult": 5.0},
    "backend_compiles":        {"direction": "down", "rel_tol": 0.0,
                                "abs_tol": 2.0, "mad_mult": 5.0},
    "compile_secs":            {"direction": "down", "rel_tol": 0.50,
                                "mad_mult": 5.0},
    # bench_extra.py's lower-is-better emissions (epoch time, divergence
    # from the reference distribution) — without these the fallback rule
    # would invert their gates
    "bench/ae_epoch_time_ms":  {"direction": "down", "rel_tol": 0.10,
                                "mad_mult": 5.0},
    "bench/js_div_regenerated": {"direction": "down", "rel_tol": 0.25,
                                 "mad_mult": 5.0},
    # bench.py's headline gauges (HF001: every statically-named
    # bench/serve/scenario gauge carries an explicit entry — the suffix
    # heuristic guessed these right, but "right by heuristic" is exactly
    # the class that folded serve/shed_rate and scenario/pad_waste_frac
    # inverted; rates regress down = direction "up")
    "bench/headline_steps_per_sec":     {"direction": "up", "rel_tol": 0.05,
                                         "mad_mult": 5.0},
    "bench/headline_f32_steps_per_sec": {"direction": "up", "rel_tol": 0.05,
                                         "mad_mult": 5.0},
    "bench/prod_168x36_steps_per_sec":  {"direction": "up", "rel_tol": 0.05,
                                         "mad_mult": 5.0},
    "bench/dp_shard_map_steps_per_sec": {"direction": "up", "rel_tol": 0.08,
                                         "mad_mult": 5.0},
    "bench/sp_prod_steps_per_sec":      {"direction": "up", "rel_tol": 0.08,
                                         "mad_mult": 5.0},
    "bench/bf16_headline_speedup":      {"direction": "up", "rel_tol": 0.05,
                                         "mad_mult": 5.0},
    # structural marker: 1.0 while the dp/sp probes launch
    # through the unified partition-rule mesh path — identical run to
    # run, so the absolute floor flags a run that REPORTS a lower
    # value.  (A rollback that stops emitting the gauge reads as
    # not-measured and passes — missing metrics are never failures by
    # design; the committed series diff is the absence tripwire.)
    "bench/mesh_unified":               {"direction": "up", "rel_tol": 0.0,
                                         "abs_tol": 0.5, "mad_mult": 0.0},
    # tools/bench_ae.py (chunked early-exit + multi-dataset fabric)
    "bench/ae_chunk_speedup":   {"direction": "up",   "rel_tol": 0.15,
                                 "mad_mult": 5.0},
    "bench/ae_full_scan_s":     {"direction": "down", "rel_tol": 0.15,
                                 "mad_mult": 5.0},
    "bench/ae_chunked_exit_s":  {"direction": "down", "rel_tol": 0.15,
                                 "mad_mult": 5.0},
    "bench/ae_epochs_per_sec":  {"direction": "up",   "rel_tol": 0.10,
                                 "mad_mult": 5.0},
    "bench/ae_multi_batched_s": {"direction": "down", "rel_tol": 0.15,
                                 "mad_mult": 5.0},
    "bench/ae_multi_serial_s":  {"direction": "down", "rel_tol": 0.15,
                                 "mad_mult": 5.0},
    "bench/ae_multi_speedup":   {"direction": "up",   "rel_tol": 0.15,
                                 "mad_mult": 5.0},
    # tools/bench_async.py (actor-fabric overlap probe)
    "bench/async_overlap_speedup": {"direction": "up",   "rel_tol": 0.15,
                                    "mad_mult": 5.0},
    "bench/async_sequential_s":    {"direction": "down", "rel_tol": 0.15,
                                    "mad_mult": 5.0},
    "bench/async_overlapped_s":    {"direction": "down", "rel_tol": 0.15,
                                    "mad_mult": 5.0},
    # tools/bench_overlap.py (async boundary engine): the
    # steady-window overlap fraction at the two instrumented drive
    # boundaries (chunked-AE chunk stops, GAN block stops), re-emitted
    # under bench/ so the probe's own series gates by name.  Fractions
    # in [0,1] near saturation — a relative tolerance is ~nothing, so
    # the gate is the same abs-0.10 floor the timeline/* gauges use.
    "bench/overlap_gan_block":     {"direction": "up", "rel_tol": 0.0,
                                    "abs_tol": 0.10, "mad_mult": 5.0},
    "bench/overlap_ae_chunk":      {"direction": "up", "rel_tol": 0.0,
                                    "abs_tol": 0.10, "mad_mult": 5.0},
    # serving-layer gauges (tools/bench_serve.py).  These rules
    # also decide the cross-host gauge FOLD direction in
    # history.fold_gauges (min where higher-better / max for costs), so
    # the serve/* vocabulary must be explicit here: ``serve/shed_rate``
    # in particular would hit the ``_rate`` = higher-is-better suffix
    # heuristic and gate (and fold) inverted.  shed_rate/queue_depth use
    # absolute floors — both sit near 0 on a healthy run, where a
    # relative tolerance of ~nothing would flag scheduler jitter.
    "serve/qps":               {"direction": "up",   "rel_tol": 0.10,
                                "mad_mult": 5.0},
    "serve/p50_ms":            {"direction": "down", "rel_tol": 0.15,
                                "mad_mult": 5.0},
    "serve/p95_ms":            {"direction": "down", "rel_tol": 0.25,
                                "mad_mult": 5.0},
    "serve/shed_rate":         {"direction": "down", "rel_tol": 0.0,
                                "abs_tol": 0.05, "mad_mult": 5.0},
    "serve/queue_depth":       {"direction": "down", "rel_tol": 0.0,
                                "abs_tol": 4.0, "mad_mult": 5.0},
    # serve/compiles is a counter (it never rides into the history store,
    # which indexes gauges only) but it still cross-host FOLDS through
    # fold_gauges' direction lookup if a future summary carries it, and
    # HF001 requires the explicit row: compile counts are costs, ±2 noise
    "serve/compiles":          {"direction": "down", "rel_tol": 0.0,
                                "abs_tol": 2.0, "mad_mult": 5.0},
    # scenario-factory gauges (tools/bench_scenario.py).  Every
    # entry is explicit — the ``shed_rate`` lesson: ``pad_waste_frac``
    # has no cost suffix and would gate (and cross-host fold) INVERTED
    # under the higher-is-better fallback.  ``lanes`` is structural (the
    # fused program's window×latent grid): identical run to run at a
    # fixed key, so a 0.5 absolute floor flags any silent shrink while
    # config changes re-key the series anyway.  ``pad_waste_frac`` sits
    # near 0 on a healthy schedule — absolute floor, not relative.
    "scenario/windows_per_sec": {"direction": "up",   "rel_tol": 0.10,
                                 "mad_mult": 5.0},
    "scenario/lanes":           {"direction": "up",   "rel_tol": 0.0,
                                 "abs_tol": 0.5, "mad_mult": 0.0},
    "scenario/pad_waste_frac":  {"direction": "down", "rel_tol": 0.0,
                                 "abs_tol": 0.05, "mad_mult": 5.0},
    "scenario/bank_windows_per_sec": {"direction": "up", "rel_tol": 0.15,
                                      "mad_mult": 5.0},
    # flight-recorder health gauges (obs/health.py).
    # Diagnostics, not perf: directions matter mainly for the cross-host
    # FOLD (a pod reports its WORST member's health), so norms are
    # "down" (a growing grad/update norm is instability) with generous
    # relative floors — the NaN tripwire, not the gate, is the alarm —
    # and the nonfinite counts use absolute floors (any value > 0 has
    # already fired a ``numeric_fault`` event; gating re-litigates it).
    "health/g_grad_norm":   {"direction": "down", "rel_tol": 1.0,
                             "mad_mult": 5.0},
    "health/d_grad_norm":   {"direction": "down", "rel_tol": 1.0,
                             "mad_mult": 5.0},
    "health/update_norm":   {"direction": "down", "rel_tol": 1.0,
                             "mad_mult": 5.0},
    "health/param_norm":    {"direction": "down", "rel_tol": 1.0,
                             "mad_mult": 5.0},
    "health/nonfinite":     {"direction": "down", "rel_tol": 0.0,
                             "abs_tol": 0.5, "mad_mult": 0.0},
    "health/ae_grad_norm":  {"direction": "down", "rel_tol": 1.0,
                             "mad_mult": 5.0},
    "health/ae_param_norm": {"direction": "down", "rel_tol": 1.0,
                             "mad_mult": 5.0},
    "health/ae_nonfinite":  {"direction": "down", "rel_tol": 0.0,
                             "abs_tol": 0.5, "mad_mult": 0.0},
    # perf-microscope attribution gauges (the JAX package's
    # obs/attrib.py).  ``dispatch_frac`` is the one that MUST be explicit:
    # "_frac" carries no cost suffix, so the higher-is-better fallback
    # would gate (and cross-host fold) it INVERTED — yet a RISING
    # dispatch fraction means the host, not the chip, is becoming the
    # bottleneck: lower is better.  It sits near 1.0 on a synchronous
    # CPU backend and near 0 on a pipelined device drive, so the floor is
    # absolute (a relative tolerance of ~nothing at either extreme
    # would flag scheduler jitter).  The ms splits are costs with
    # generous relative floors — they are attribution evidence for
    # ``obs explain``, not primary gates; steps_per_sec stays the alarm.
    "attrib/dispatch_ms":   {"direction": "down", "rel_tol": 0.25,
                             "mad_mult": 5.0},
    "attrib/compute_ms":    {"direction": "down", "rel_tol": 0.25,
                             "mad_mult": 5.0},
    "attrib/dispatch_frac": {"direction": "down", "rel_tol": 0.0,
                             "abs_tol": 0.10, "mad_mult": 5.0},
    # chaos-search gauges (the JAX package's resilience/chaos.py).
    # ``violations`` is the one that MUST be explicit: it has no cost
    # suffix, so the higher-is-better fallback would gate (and
    # cross-host fold) a rising violation count as an improvement —
    # the shed_rate class, on the one gauge whose whole job is to be
    # zero.  ``schedules``/``subjects`` are coverage floors (a soak
    # that silently drove fewer schedules is the disarmed-gate failure
    # mode, absolute floors — counts are exact at a fixed seed);
    # ``run_secs`` is a cost with a generous relative floor (spawned
    # subprocess wall clocks are host-load noisy).
    "chaos/schedules":      {"direction": "up",   "rel_tol": 0.0,
                             "abs_tol": 0.5, "mad_mult": 0.0},
    "chaos/subjects":       {"direction": "up",   "rel_tol": 0.0,
                             "abs_tol": 0.5, "mad_mult": 0.0},
    "chaos/violations":     {"direction": "down", "rel_tol": 0.0,
                             "abs_tol": 0.5, "mad_mult": 0.0},
    "chaos/run_secs":       {"direction": "down", "rel_tol": 0.50,
                             "mad_mult": 5.0},
    # fleet-watcher gauges (obs/fleet.py).  The
    # invariant trio — ``ledger_deficit``/``breakers_open``/
    # ``restart_storms`` — exists to be ZERO, the shed_rate class with
    # exact floors (any nonzero value is already an incident; gating
    # re-litigates it).  ``submitted``/``terminal`` are raw ledger
    # sides: "down" would read MORE traffic as a regression and "up"
    # would read a quieter soak as one, so both get wide relative
    # floors and exist mainly so the cross-host fold direction is
    # explicit.  ``replicas`` is a structural coverage floor (a fleet
    # that silently lost a replica dir is the disarmed-gate failure
    # mode); ``restarts`` tolerates supervision churn but flags storms
    # via its dedicated zero-floor gauge.
    "fleet/replicas":        {"direction": "up",   "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    "fleet/submitted":       {"direction": "up",   "rel_tol": 0.50,
                              "mad_mult": 5.0},
    "fleet/terminal":        {"direction": "up",   "rel_tol": 0.50,
                              "mad_mult": 5.0},
    "fleet/ledger_deficit":  {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    "fleet/breakers_open":   {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    "fleet/restarts":        {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 2.0, "mad_mult": 5.0},
    "fleet/restart_storms":  {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    # SLO burn-rate gauges (obs/slo.py).
    # ``worst_burn`` is the one that MUST be explicit: "_burn" carries
    # no cost suffix, so the higher-is-better fallback would gate a
    # rising burn rate — budget consumed FASTER — as an improvement,
    # exactly the inverted-shed_rate failure mode the satellite calls
    # out.  Burn sits anywhere in [0, 1) on a healthy fleet, so the
    # floor is absolute slack below the 1.0 alert line, not relative.
    # ``breaches``/``warnings`` exist to be zero (exact floors);
    # ``evaluated`` is a coverage floor (a run that silently evaluated
    # fewer objectives must not pass as "no breaches").
    "slo/evaluated":         {"direction": "up",   "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    "slo/breaches":          {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    "slo/warnings":          {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 0.5, "mad_mult": 0.0},
    "slo/worst_burn":        {"direction": "down", "rel_tol": 0.0,
                              "abs_tol": 0.25, "mad_mult": 5.0},
    # wall-clock ledger gauges (obs/timeline.py).
    # Every ``timeline/*`` row is explicit — "_frac" carries no cost
    # suffix, so EVERY fraction here would hit the higher-is-better
    # fallback inverted (the shed_rate class, again).  The two gated
    # hygiene fractions use absolute floors near zero: a healthy drive
    # keeps ``obs_self_frac`` under 1% (the <0.01 acceptance gate — the
    # observer must not become the observed) and ``unattributed_frac``
    # small, where any relative tolerance is ~nothing and would flag
    # scheduler jitter.  ``device_compute_frac`` is the one
    # higher-is-better fraction (more of the wall on the chip);
    # dispatch/host_io/checkpoint/queue_wait are overheads.
    # ``overlap_frac`` is ROADMAP item 2(a)'s before-measurement:
    # higher = more host work hidden behind device execution.
    # ``wall_ms`` is a cost with a wide floor (whole-drive wall clocks
    # are host-load noisy; steps_per_sec stays the primary alarm).
    "timeline/device_compute_frac": {"direction": "up",   "rel_tol": 0.0,
                                     "abs_tol": 0.10, "mad_mult": 5.0},
    "timeline/dispatch_frac":       {"direction": "down", "rel_tol": 0.0,
                                     "abs_tol": 0.10, "mad_mult": 5.0},
    "timeline/host_io_frac":        {"direction": "down", "rel_tol": 0.0,
                                     "abs_tol": 0.05, "mad_mult": 5.0},
    "timeline/checkpoint_frac":     {"direction": "down", "rel_tol": 0.0,
                                     "abs_tol": 0.05, "mad_mult": 5.0},
    "timeline/queue_wait_frac":     {"direction": "down", "rel_tol": 0.0,
                                     "abs_tol": 0.05, "mad_mult": 5.0},
    "timeline/obs_self_frac":       {"direction": "down", "rel_tol": 0.0,
                                     "abs_tol": 0.01, "mad_mult": 0.0},
    "timeline/unattributed_frac":   {"direction": "down", "rel_tol": 0.0,
                                     "abs_tol": 0.10, "mad_mult": 5.0},
    "timeline/overlap_frac":        {"direction": "up",   "rel_tol": 0.0,
                                     "abs_tol": 0.10, "mad_mult": 5.0},
    "timeline/wall_ms":             {"direction": "down", "rel_tol": 0.50,
                                     "mad_mult": 5.0},
    # Drive runtime gauges (resilience/drive.py).
    # ``drive/secs`` is the envelope's whole-drive wall clock — a cost
    # with the same wide floor as ``timeline/wall_ms`` (host-load noisy;
    # the per-phase alarms stay primary).  ``drive/boundaries`` is a
    # counter (never indexed by the history store) but it still needs
    # the explicit HF001 row for the fold direction: MORE boundary
    # crossings per drive means finer drain granularity — a run that
    # silently crosses fewer safe points is the regression.
    "drive/secs":                   {"direction": "down", "rel_tol": 0.50,
                                     "mad_mult": 5.0},
    "drive/boundaries":             {"direction": "up",   "rel_tol": 0.0,
                                     "abs_tol": 0.5, "mad_mult": 5.0},
}

#: fallback rule for metrics without an entry above (bench gauges are
#: throughput-like by convention: higher is better).  The suffix check
#: in :func:`_rule_for` flips direction for names that are self-evidently
#: costs — a future ``bench/foo_time_ms`` gauge must not gate inverted
#: just because nobody added a table entry.
DEFAULT_RULE = {"direction": "up", "rel_tol": 0.05, "mad_mult": 5.0}

#: name suffixes that mark a metric as a cost (lower is better) when it
#: has no explicit table entry.  Checked only after the rate suffixes —
#: ``*_per_sec`` stays higher-is-better even though it ends in ``_sec``.
_RATE_SUFFIXES = ("_per_sec", "_per_s", "/sec", "_rate", "_mfu")
_COST_SUFFIXES = ("_ms", "_secs", "_sec", "_s", "_time", "_bytes", "_div",
                  "_loss", "_count", "_compiles")

#: MAD -> σ consistency constant under normality
MAD_TO_SIGMA = 1.4826

DEFAULT_WINDOW = 8
DEFAULT_MIN_RUNS = 3


def mad(values: List[float], center: Optional[float] = None) -> float:
    """Median absolute deviation around ``center`` (default: the median)."""
    c = median(values) if center is None else center
    return median([abs(v - c) for v in values])


def trend_slope(values: List[float]) -> Optional[float]:
    """Ordinary-least-squares slope of ``values`` against run index —
    units per run; ``None`` below 3 samples (two points always fit a
    line, proving nothing about a *trend*)."""
    n = len(values)
    if n < 3:
        return None
    x_bar = (n - 1) / 2.0
    y_bar = sum(values) / n
    den = sum((i - x_bar) ** 2 for i in range(n))
    return sum((i - x_bar) * (y - y_bar)
               for i, y in enumerate(values)) / den


def comparable_series(records: List[dict], key: dict,
                      metric: str) -> List[float]:
    """The metric's samples from records sharing the comparability key,
    oldest-first (history is append-only, so file order IS time order)."""
    out = []
    for rec in records:
        if rec.get("key") != key:
            continue
        v = _num((rec.get("metrics") or {}).get(metric))
        if v is not None:
            out.append(float(v))
    return out


def _rule_for(metric: str, thresholds: Optional[dict]) -> dict:
    if metric in DEFAULT_THRESHOLDS:
        base = dict(DEFAULT_THRESHOLDS[metric])
    else:
        base = dict(DEFAULT_RULE)
        low = metric.lower()
        if (not low.endswith(_RATE_SUFFIXES)
                and low.endswith(_COST_SUFFIXES)):
            base["direction"] = "down"
    if thresholds and metric in thresholds:
        override = thresholds[metric]
        if isinstance(override, dict):
            base.update(override)
        else:
            # bare number = EXACT relative tolerance: an explicit
            # per-metric tolerance replaces the adaptive MAD term rather
            # than being maxed against it (otherwise a tight override
            # could never tighten a noisy series' gate)
            base["rel_tol"] = float(override)
            base["mad_mult"] = 0.0
            base["abs_tol"] = 0.0
    return base


def check_metric(metric: str, observed, series: List[float], *,
                 thresholds: Optional[dict] = None,
                 min_runs: int = DEFAULT_MIN_RUNS,
                 window: int = DEFAULT_WINDOW) -> dict:
    """One metric's gate decision against its comparable series.

    Returns ``{metric, status, baseline, observed, threshold, n, mad}``
    with ``status`` in ``ok`` / ``regression`` / ``insufficient-history``
    / ``missing`` (the run did not measure the metric — never a failure:
    a CPU fixture has no device memory stats).
    """
    rule = _rule_for(metric, thresholds)
    tail = series[-max(1, int(window)):]
    # the enforcement floor can never exceed the window: --window 2
    # --min-runs 3 would otherwise park every check in
    # insufficient-history forever — a green gate that never gates
    need = max(1, min(int(min_runs), max(1, int(window))))
    value = _num(observed)     # ingest's filter: bool/NaN/inf are absent
    if value is None:
        return {"metric": metric, "status": "missing", "baseline": None,
                "observed": None, "threshold": None, "n": len(tail),
                "mad": None}
    if len(tail) < need:
        return {"metric": metric, "status": "insufficient-history",
                "baseline": median(tail) if tail else None,
                "observed": float(value), "threshold": None,
                "n": len(tail), "mad": mad(tail) if tail else None}
    base = median(tail)
    spread = mad(tail, base)
    allowed = max(float(rule.get("rel_tol", 0.0)) * abs(base),
                  float(rule.get("mad_mult", 0.0)) * MAD_TO_SIGMA * spread,
                  float(rule.get("abs_tol", 0.0)))
    delta = (base - float(value) if rule["direction"] == "up"
             else float(value) - base)          # positive = got worse
    status = "regression" if delta > allowed else "ok"
    check = {"metric": metric, "status": status,
             "baseline": round(base, 9), "observed": float(value),
             "threshold": round(allowed, 9), "delta": round(delta, 9),
             "direction": rule["direction"], "n": len(tail),
             "mad": round(spread, 9)}

    # Trend-slope drift tracking: a sequence of sub-threshold moves —
    # each inside the level gate, all in the worsening direction — is
    # exactly the slow-drift pattern the level baseline structurally
    # misses (the rolling median follows the drift down).  Fit a slope
    # over the window *plus this run*; when the cumulative drift it
    # projects across that span exceeds the level gate's rel/abs floors,
    # flag ``drift: true``.  The MAD term is deliberately NOT part of
    # the drift floor: a trending series inflates its own MAD, so the
    # adaptive term that protects the level gate from noise would blind
    # the trend check to exactly the pattern it exists to catch.
    # Warn-only: a slope is an extrapolation, not an observation, so it
    # colors the verdict without failing the gate.
    trend = tail + [float(value)]
    slope = trend_slope(trend)
    if slope is not None and base:
        slope_frac = slope / abs(base)
        worsening = slope < 0 if rule["direction"] == "up" else slope > 0
        projected = abs(slope) * (len(trend) - 1)
        drift_floor = max(float(rule.get("rel_tol", 0.0)) * abs(base),
                          float(rule.get("abs_tol", 0.0)))
        check["slope"] = round(slope, 9)
        check["slope_frac"] = round(slope_frac, 9)
        check["drift"] = bool(status == "ok" and worsening
                              and drift_floor > 0
                              and projected > drift_floor)
    return check


def check_run(record: dict, records: List[dict], *,
              thresholds: Optional[dict] = None,
              min_runs: int = DEFAULT_MIN_RUNS,
              window: int = DEFAULT_WINDOW,
              metrics: Optional[List[str]] = None) -> dict:
    """Gate one run record against the history: the full verdict.

    ``records`` may or may not already contain this run — a sample with
    the same (run_id, created_unix) is excluded from its own baseline,
    so gate-after-ingest and gate-before-ingest agree.
    """
    key = record.get("key") or {}
    prior = [r for r in records
             if not (r.get("run_id") == record.get("run_id")
                     and r.get("created_unix") == record.get("created_unix"))]
    names = metrics if metrics is not None else list(
        (record.get("metrics") or {}).keys())
    checks = [
        check_metric(m, (record.get("metrics") or {}).get(m),
                     comparable_series(prior, key, m),
                     thresholds=thresholds, min_runs=min_runs, window=window)
        for m in names]
    regressions = [c for c in checks if c["status"] == "regression"]
    # a run that measured NOTHING (every check "missing" — empty event
    # stream, OOM-killed before the first flush, broken emission) must
    # not gate green: exit-0-with-zero-evidence is the silently-disarmed
    # sentinel this module exists to close.  Individual missing metrics
    # stay non-failing; it is the total absence that fails.
    no_data = not any(c["status"] != "missing" for c in checks)
    return {
        "v": 2,
        "run_id": record.get("run_id"),
        "git_sha": record.get("git_sha"),
        "key": key,
        "ok": not regressions and not no_data,
        "no_data": no_data,
        "n_comparable": len([r for r in prior if r.get("key") == key]),
        "regressions": [c["metric"] for c in regressions],
        # sustained sub-threshold drift (warn-only; never flips ``ok``)
        "drifts": [c["metric"] for c in checks if c.get("drift")],
        "checks": checks,
    }


# ------------------------------------------------------------- rendering
_STATUS_GLYPH = {"ok": "ok  ", "regression": "FAIL", "missing": "--  ",
                 "insufficient-history": "n={n} "}


def render_verdict(verdict: dict) -> str:
    """Human verdict: one line per metric, worst news first."""
    word = ("NO-DATA" if verdict.get("no_data")
            else "PASS" if verdict["ok"] else "REGRESSION")
    drifts = verdict.get("drifts") or []
    head = word + (
        f"  run {verdict['run_id']}  (key: "
        f"family={verdict['key'].get('family')}, "
        f"shape={verdict['key'].get('shape')}, "
        f"host={verdict['key'].get('host')}, "
        f"backend={verdict['key'].get('backend')}, "
        f"mesh={verdict['key'].get('mesh')}; "
        f"{verdict['n_comparable']} comparable runs)")
    if drifts:
        head += (f"\nDRIFT WARNING: sustained sub-threshold trend on "
                 f"{', '.join(drifts)} (slope below; level gate not tripped)")
    order = {"regression": 0, "ok": 1, "insufficient-history": 2,
             "missing": 3}
    lines = [head]
    for c in sorted(verdict["checks"],
                    key=lambda c: (order[c["status"]],
                                   not c.get("drift"))):
        glyph = _STATUS_GLYPH[c["status"]].format(n=c["n"])
        if c["status"] == "missing":
            lines.append(f"  {glyph} {c['metric']:26s} (not measured)")
            continue
        base = "-" if c["baseline"] is None else f"{c['baseline']:.6g}"
        thr = "-" if c["threshold"] is None else f"{c['threshold']:.3g}"
        line = (f"  {glyph} {c['metric']:26s} observed {c['observed']:.6g}"
                f"  baseline {base} (n={c['n']})  allowed ±{thr}")
        if c.get("slope_frac") is not None:
            line += f"  slope {c['slope_frac'] * 100:+.2f}%/run"
            if c.get("drift"):
                line += "  DRIFT"
        lines.append(line)
    return "\n".join(lines)


def verdict_json(verdict: dict) -> str:
    return json.dumps(verdict, indent=2, default=str)
