"""Chaos search: property-based fault-schedule fuzzing with shrinking
(``hfrep_tpu/resilience/chaos.py``).

The fault lattice (``HFREP_FAULTS`` kinds × sites × occurrences) is
explored the FoundationDB/Jepsen way:

* **generate** — seeded random schedules over the machine-readable fault
  alphabet (the ``BOUNDARY_SITES``/``IO_SITES``/``POST_SAVE_SITES``/
  ``ACTOR_SITES`` registries of :mod:`hfrep_tpu_torch.resilience.faults`,
  the JAX package's), composing 1–4 directives a schedule across kinds,
  occurrences and legs (the initial run or the first resume: "the fault
  lands during recovery");
* **drive** — each schedule through a registered subject
  (:mod:`hfrep_tpu_torch.resilience.chaos_subjects`) as a chain of
  spawned subprocesses on the driver's device: the faulted attempt, then
  resume attempts until completion, all under watchdogs;
* **check** — the shared oracle battery
  (:mod:`hfrep_tpu_torch.resilience.chaos_oracles`): exit-code contract,
  resume bit-identity against an undisturbed reference, atomic
  artifacts, ledger conservation, obs-stream health;
* **shrink** — a failing schedule is minimised (drop directives, then
  lower counts and occurrences, re-running at each step) to a minimal
  ``HFREP_FAULTS`` spec and a one-line repro;
* **persist** — minimal schedules land as ready-to-commit corpus entries
  under ``<out>/found/``; the committed corpus
  (``hfrep_tpu_torch/resilience/_chaos_corpus/``, a copy of the JAX
  package's) replays with ``--replay-corpus``.  An entry whose subject
  the port does not register (``ae_mesh``, ROADMAP queue 1 item 9) is
  reported as skipped, never silently dropped.

The schedule sequence is a pure function of ``--seed`` (the generator is
the JAX package's draw for draw); the time budget only bounds how much of
it runs, never below ``--min-schedules``.  Telemetry: one
``chaos_schedule`` event a driven schedule, a ``chaos_violation`` event a
finding, and ``chaos/*`` gauges.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from hfrep_tpu_torch.obs import timeline
from hfrep_tpu_torch.resilience import faults
from hfrep_tpu_torch.resilience.chaos_oracles import (
    Attempt,
    Violation,
    check_run,
    digest_map,
)
from hfrep_tpu_torch.resilience.chaos_subjects import (
    RESULT_NAME,
    SUBJECTS,
    Subject,
    fast_subjects,
)
from hfrep_tpu_torch.resilience.faults import Directive, FaultPlan, kind_sites

#: committed regression corpus — minimal schedules that once violated an
#: invariant, fixed since, replayed forever by the CI gate
CORPUS_DIR = Path(__file__).resolve().parent / "_chaos_corpus"

#: subprocess attempts per schedule: the faulted run plus at most this
#: many resume legs; a drive still exiting 75 on a CLEAN leg is a wedge
#: (the exit-contract oracle flags it), not grounds for more retries
MAX_ATTEMPTS = 5

#: parent-side backstop over the subject's own in-process watchdog
SPAWN_GRACE_SECS = 45.0


class ChaosError(RuntimeError):
    """Engine misuse / unusable configuration (not a found violation)."""


# ------------------------------------------------------------- schedules
@dataclasses.dataclass(frozen=True)
class Schedule:
    """One generated fault composition: a spec armed on the initial
    attempt and (optionally) one armed on the first resume leg — the
    encoding of "the fault lands during recovery"."""

    subject: str
    fixture_seed: int
    spec: str
    resume_spec: str = ""

    def encode(self) -> str:
        parts = [self.subject, str(self.fixture_seed), self.spec]
        if self.resume_spec:
            parts.append(self.resume_spec)
        return "|".join(parts)

    @classmethod
    def decode(cls, text: str) -> "Schedule":
        parts = text.split("|")
        if len(parts) not in (3, 4) or not parts[0]:
            raise ChaosError(
                f"bad schedule {text!r} "
                "(want subject|fixture_seed|spec[|resume_spec])")
        try:
            seed = int(parts[1])
        except ValueError:
            raise ChaosError(f"bad fixture seed in schedule {text!r}")
        # parse both legs eagerly so a typo'd corpus entry / --replay
        # argument fails loudly with the registry's suggestions
        FaultPlan.parse(parts[2])
        if len(parts) == 4:
            FaultPlan.parse(parts[3])
        return cls(subject=parts[0], fixture_seed=seed, spec=parts[2],
                   resume_spec=parts[3] if len(parts) == 4 else "")

    def directives(self) -> List[Tuple[int, Directive]]:
        """(leg, directive) pairs; leg 0 = initial attempt, 1 = first
        resume."""
        out: List[Tuple[int, Directive]] = []
        for leg, spec in ((0, self.spec), (1, self.resume_spec)):
            if spec:
                out += [(leg, d) for d in FaultPlan.parse(spec).directives]
        return out

    @classmethod
    def from_directives(cls, subject: str, fixture_seed: int,
                        pairs: Sequence[Tuple[int, Directive]]) -> "Schedule":
        spec = ";".join(d.spec() for leg, d in pairs if leg == 0)
        resume = ";".join(d.spec() for leg, d in pairs if leg == 1)
        return cls(subject=subject, fixture_seed=fixture_seed, spec=spec,
                   resume_spec=resume)

    def n_faults(self) -> int:
        return len(self.directives())


_KIND_WEIGHTS = {
    "sigterm": 3, "preempt": 3, "io_fail": 3, "torn": 2, "corrupt": 2,
    "stall": 1, "kill": 2,
}


def _draw_directive(rng: random.Random, subject: Subject) -> Directive:
    kinds = list(faults.KINDS)
    kind = rng.choices(kinds, weights=[_KIND_WEIGHTS[k] for k in kinds])[0]
    legal = kind_sites(kind)
    hinted = [s for s in subject.hint_sites if s in legal]
    # bias toward sites the subject actually crosses, but keep the whole
    # registry in scope — a fresh fault site gets explored with no code
    # change here
    if hinted and rng.random() < 0.75:
        site = rng.choice(hinted)
    else:
        site = rng.choice(list(legal))
    n = rng.choices((1, 2, 3), weights=(5, 3, 1))[0]
    if kind == "io_fail":
        # a single EIO is absorbed by the bounded retry policy (by
        # design); bursts that outlast HFREP_IO_RETRIES are the
        # interesting class, so weight counts upward
        count = rng.choices((1, 2, 3, 4), weights=(2, 2, 3, 2))[0]
    else:
        count = rng.choices((1, 2), weights=(8, 2))[0]
    return Directive(kind=kind, site=site, n=n, count=count)


def generate_schedule(rng: random.Random, subject: Subject,
                      fixture_seeds: int = 1) -> Schedule:
    """One seeded random schedule for ``subject``: 1–4 distinct
    directives spread over the initial leg and (sometimes) the first
    resume leg.  Pure function of the rng state — the soak's schedule
    sequence is reproducible from its seed."""
    n_faults = rng.choices((1, 2, 3, 4), weights=(35, 30, 20, 15))[0]
    pairs: List[Tuple[int, Directive]] = []
    seen = set()
    for _ in range(n_faults * 4):
        if len(pairs) >= n_faults:
            break
        d = _draw_directive(rng, subject)
        leg = 1 if rng.random() < 0.2 else 0
        key = (leg, d.kind, d.site)
        if key in seen:
            continue
        seen.add(key)
        pairs.append((leg, d))
    if pairs and all(leg == 1 for leg, _ in pairs):
        # a schedule whose every fault waits for the resume leg never
        # fires at all (nothing preempts the first attempt) — ground
        # one directive on the initial leg so the draw is never wasted
        pairs[0] = (0, pairs[0][1])
    pairs.sort(key=lambda p: (p[0], p[1].kind, p[1].site, p[1].n))
    seed = rng.randrange(fixture_seeds) if fixture_seeds > 1 else 0
    return Schedule.from_directives(subject.name, seed, pairs)


# ---------------------------------------------------------------- driver
@dataclasses.dataclass
class Report:
    """One driven schedule's verdict."""

    schedule: Schedule
    attempts: List[Attempt]
    violations: List[Violation]
    secs: float

    @property
    def ok(self) -> bool:
        return not self.violations


class Driver:
    """Runs schedules through spawned subject subprocesses and the
    oracle battery, caching one undisturbed reference per
    ``(subject, fixture_seed)``."""

    def __init__(self, workdir, env: Optional[dict] = None, device: str = "cuda"):
        self.workdir = Path(workdir)
        self.device = str(device)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._refs: Dict[Tuple[str, int], Dict[str, str]] = {}
        self._runs = 0
        self._run_secs = 0.0
        base = dict(os.environ if env is None else env)
        # the soak's children must see OUR plan (or none), never the
        # ambient shell's; telemetry/history env likewise must not leak
        # a CI soak's fixture runs into a committed store
        for k in ("HFREP_FAULTS", "HFREP_OBS_DIR", "HFREP_HISTORY",
                  "HFREP_HEALTH"):
            base.pop(k, None)
        self._env = base

    # ------------------------------------------------------------ spawn
    def _spawn(self, subject: Subject, fixture_seed: int, out: Path,
               spec: str, resume: bool) -> Attempt:
        env = dict(self._env)
        if spec:
            env["HFREP_FAULTS"] = spec
        cmd = [sys.executable, "-m", "hfrep_tpu_torch.resilience",
               "chaos-subject", subject.name, "--out", str(out),
               "--fixture-seed", str(fixture_seed), "--device", self.device]
        if resume:
            cmd.append("--resume")
        t0 = timeline.clock()
        try:
            proc = subprocess.run(
                cmd, env=env, capture_output=True, text=True,
                timeout=subject.timeout + SPAWN_GRACE_SECS)
            code: Optional[int] = proc.returncode
            stderr = proc.stderr
        except subprocess.TimeoutExpired as e:
            code = None
            stderr = (e.stderr or b"").decode(errors="replace") \
                if isinstance(e.stderr, bytes) else (e.stderr or "")
        secs = timeline.clock() - t0
        self._runs += 1
        self._run_secs += secs
        return Attempt(spec=spec, exit_code=code, secs=secs,
                       stderr_tail=stderr[-4000:])

    def _drive(self, sched: Schedule, out: Path) -> List[Attempt]:
        subject = self._subject(sched)
        attempts = [self._spawn(subject, sched.fixture_seed, out,
                                sched.spec, resume=False)]
        while attempts[-1].exit_code == 75 and len(attempts) < MAX_ATTEMPTS:
            spec = sched.resume_spec if len(attempts) == 1 else ""
            attempts.append(self._spawn(subject, sched.fixture_seed, out,
                                        spec, resume=True))
        return attempts

    def _subject(self, sched: Schedule) -> Subject:
        subject = SUBJECTS.get(sched.subject)
        if subject is None:
            raise ChaosError(
                f"unknown chaos subject {sched.subject!r} "
                f"(registry: {', '.join(sorted(SUBJECTS))})")
        return subject

    # -------------------------------------------------------- reference
    def reference(self, subject_name: str, fixture_seed: int) -> Dict[str, str]:
        """The undisturbed run's artifact digests (cached).  A reference
        that itself breaks the contract is a finding about the CLEAN
        drive — surfaced loudly, not compared against."""
        key = (subject_name, fixture_seed)
        if key in self._refs:
            return self._refs[key]
        subject = SUBJECTS[subject_name]
        out = self.workdir / f"ref_{subject_name}_{fixture_seed}"
        attempt = self._spawn(subject, fixture_seed, out, spec="",
                              resume=False)
        violations = check_run(
            deterministic=subject.deterministic,
            attempts=[attempt], out_dir=out, ref_digests=None,
            result_doc=_read_result(out))
        if violations:
            raise ChaosError(
                f"reference (fault-free) run of {subject_name}/"
                f"{fixture_seed} violates the contract on its own: "
                + "; ".join(v.render() for v in violations))
        self._refs[key] = digest_map(out / "artifacts")
        return self._refs[key]

    # ------------------------------------------------------------- runs
    def run_schedule(self, sched: Schedule, tag: str = "run") -> Report:
        subject = self._subject(sched)
        ref = self.reference(sched.subject, sched.fixture_seed) \
            if subject.deterministic else None
        # pid-prefixed: a second soak into the same --out must not
        # inherit a previous invocation's fingerprint-matched scratch
        # (a walk-forward rerun would silently SKIP the work the
        # schedule meant to fault; reference dirs may be reused — their
        # fingerprint-gated reuse is bit-identical by construction)
        out = self.workdir / f"r{os.getpid():x}_{tag}_{self._runs:04d}"
        t0 = timeline.clock()
        attempts = self._drive(sched, out)
        violations = check_run(
            deterministic=subject.deterministic,
            attempts=attempts, out_dir=out, ref_digests=ref,
            result_doc=_read_result(out))
        return Report(schedule=sched, attempts=attempts,
                      violations=violations,
                      secs=timeline.clock() - t0)

    @property
    def stats(self) -> dict:
        return {"runs": self._runs,
                "run_secs_mean": round(self._run_secs / self._runs, 3)
                if self._runs else 0.0}


def _read_result(out: Path) -> Optional[dict]:
    try:
        return json.loads((out / RESULT_NAME).read_text())
    except (OSError, json.JSONDecodeError):
        return None


# -------------------------------------------------------------- shrinking
def shrink(driver: Driver, report: Report,
           max_runs: int = 32) -> Tuple[Schedule, int]:
    """Minimize a failing schedule: drop directives, then lower counts,
    then occurrences — re-running the full drive+oracle protocol at
    each step and keeping a reduction only while the SAME oracle still
    fires (determinism makes each re-run a faithful replay, so greedy
    delta-debugging is sound).  Returns (minimal schedule, runs spent).
    """
    target = report.violations[0].oracle
    runs = 0

    def still_fails(s: Schedule) -> bool:
        nonlocal runs
        runs += 1
        r = driver.run_schedule(s, tag="shrink")
        return any(v.oracle == target for v in r.violations)

    cur = report.schedule
    # pass 1: drop whole directives to a local fixpoint
    changed = True
    while changed and runs < max_runs:
        changed = False
        pairs = cur.directives()
        if len(pairs) <= 1:
            break
        for i in range(len(pairs)):
            cand = Schedule.from_directives(
                cur.subject, cur.fixture_seed,
                pairs[:i] + pairs[i + 1:])
            if runs >= max_runs:
                break
            if still_fails(cand):
                cur = cand
                changed = True
                break
    # pass 2: lower occurrence counts, then trigger occurrences, to 1
    for field, floor in (("count", 1), ("n", 1)):
        pairs = cur.directives()
        for i, (leg, d) in enumerate(pairs):
            if getattr(d, field) <= floor or runs >= max_runs:
                continue
            cand_pairs = list(pairs)
            cand_pairs[i] = (leg, dataclasses.replace(d, **{field: floor}))
            cand = Schedule.from_directives(cur.subject, cur.fixture_seed,
                                            cand_pairs)
            if still_fails(cand):
                cur = cand
                pairs = cur.directives()
    return cur, runs


def repro_line(sched: Schedule) -> str:
    return ("python -m hfrep_tpu_torch.resilience chaos --replay "
            f"'{sched.encode()}'")


# ---------------------------------------------------------------- corpus
def corpus_entries(corpus_dir=None) -> List[dict]:
    """The committed regression corpus, schema-checked: every entry
    carries the discovering seed, the (shrunk) schedule, its subject
    and the invariant it violated when found."""
    root = Path(corpus_dir) if corpus_dir is not None else CORPUS_DIR
    entries = []
    for f in sorted(root.glob("*.json")):
        try:
            doc = json.loads(f.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise ChaosError(f"unreadable corpus entry {f.name}: {e}")
        for field in ("schedule", "invariant", "found_by_seed"):
            if field not in doc:
                raise ChaosError(f"corpus entry {f.name} lacks {field!r}")
        doc["_file"] = f.name
        doc["_schedule"] = Schedule.decode(doc["schedule"])
        entries.append(doc)
    return entries


def corpus_entry_doc(sched: Schedule, invariant: str, seed: int,
                     detail: str) -> dict:
    return {"v": 1, "schedule": sched.encode(), "subject": sched.subject,
            "fixture_seed": sched.fixture_seed, "spec": sched.spec,
            "resume_spec": sched.resume_spec, "invariant": invariant,
            "found_by_seed": seed, "detail": detail,
            "repro": repro_line(sched)}


# ------------------------------------------------------------------ soak
def run_soak(*, seed: int, budget_secs: float, min_schedules: int,
             subjects: Sequence[str], fixture_seeds: int, workdir,
             replay_corpus: bool, shrink_findings: bool = True,
             max_schedules: int = 500, device: str = "cuda") -> dict:
    """The budgeted search + (optionally) the corpus replay, sharing one
    reference cache.  Returns the machine summary the CLI prints; the
    ``ok`` field decides the gate."""
    from hfrep_tpu_torch.obs import get_obs

    t_start = time.monotonic()
    obs = get_obs()
    driver = Driver(workdir, device=device)
    subjects = list(subjects)
    for name in subjects:
        if name not in SUBJECTS:
            raise ChaosError(
                f"unknown subject {name!r} "
                f"(registry: {', '.join(sorted(SUBJECTS))})")
    doc: dict = {"seed": seed, "subjects": subjects, "device": str(device)}
    findings: List[dict] = []

    # --- corpus replay first: a regression on a pinned schedule should
    # fail the gate before any budget is spent searching
    replayed = 0
    skipped: List[dict] = []
    if replay_corpus:
        for entry in corpus_entries():
            sched = entry["_schedule"]
            if sched.subject not in SUBJECTS:
                # a subject the port does not register yet: named, not
                # dropped (drive.DEFERRED_SPECS)
                skipped.append({"corpus": entry["_file"], "subject": sched.subject})
                continue
            report = driver.run_schedule(sched, tag="corpus")
            replayed += 1
            if not report.ok:
                findings.append({
                    "schedule": sched.encode(),
                    "invariant": report.violations[0].oracle,
                    "detail": report.violations[0].render(),
                    "shrunk": True, "corpus": entry["_file"],
                    "repro": repro_line(sched)})
                obs.event("chaos_violation", subject=sched.subject,
                          schedule=sched.encode(),
                          invariant=report.violations[0].oracle,
                          corpus=entry["_file"])
    doc["corpus_replayed"] = replayed
    doc["corpus_skipped"] = skipped

    # --- the seeded soak: deterministic schedule sequence; the budget
    # bounds wall time but never the coverage floor
    rng = random.Random(seed)
    driven: List[Report] = []
    seen = set()
    i = 0
    while i < max_schedules:
        elapsed = time.monotonic() - t_start
        if i >= min_schedules and elapsed >= budget_secs:
            break
        subject = SUBJECTS[subjects[i % len(subjects)]]
        sched = generate_schedule(rng, subject, fixture_seeds)
        for _ in range(20):
            if sched.encode() not in seen:
                break
            sched = generate_schedule(rng, subject, fixture_seeds)
        seen.add(sched.encode())
        report = driver.run_schedule(sched)
        driven.append(report)
        obs.event("chaos_schedule", subject=sched.subject,
                  schedule=sched.encode(),
                  attempts=len(report.attempts),
                  exits=[a.exit_code for a in report.attempts],
                  verdict="ok" if report.ok else
                  report.violations[0].oracle)
        if not report.ok:
            entry = {"schedule": sched.encode(),
                     "invariant": report.violations[0].oracle,
                     "detail": report.violations[0].render(),
                     "shrunk": False, "repro": repro_line(sched)}
            if shrink_findings:
                minimal, shrink_runs = shrink(driver, report)
                entry.update({
                    "schedule": minimal.encode(), "shrunk": True,
                    "shrink_runs": shrink_runs,
                    "minimal_spec": minimal.spec,
                    "minimal_resume_spec": minimal.resume_spec,
                    "repro": repro_line(minimal)})
                sched = minimal
            obs.event("chaos_violation", subject=sched.subject,
                      schedule=sched.encode(),
                      invariant=entry["invariant"],
                      shrunk=entry["shrunk"])
            findings.append(entry)
            _write_finding(driver.workdir, seed, entry, sched)
        i += 1

    doc.update({
        "schedules": len(driven),
        "distinct_subjects": len({r.schedule.subject for r in driven}),
        "preempted_runs": sum(
            1 for r in driven for a in r.attempts if a.exit_code == 75),
        "violations": len(findings),
        "findings": findings,
        "secs": round(time.monotonic() - t_start, 2),
        **driver.stats,
        "ok": not findings,
    })
    obs.gauge("chaos/schedules").set(len(driven))
    obs.gauge("chaos/subjects").set(doc["distinct_subjects"])
    obs.gauge("chaos/violations").set(len(findings))
    obs.gauge("chaos/run_secs").set(doc["run_secs_mean"])
    return doc


def _write_finding(workdir: Path, seed: int, entry: dict,
                   sched: Schedule) -> None:
    """Found minimal schedules land under ``<workdir>/found/`` as
    ready-to-commit corpus entries (the soak reports them; committing
    the fix + the pin is the human's move)."""
    from hfrep_tpu_torch.utils.checkpoint import atomic_text

    found = workdir / "found"
    found.mkdir(parents=True, exist_ok=True)
    doc = corpus_entry_doc(sched, entry["invariant"], seed,
                           entry["detail"])
    atomic_text(found / f"{sched.subject}_{len(list(found.glob('*.json'))):03d}.json",
                json.dumps(doc, indent=2, sort_keys=True))


# -------------------------------------------------------------------- CLI
def add_chaos_args(ap) -> None:
    ap.add_argument("--seed", type=int, default=0,
                    help="soak seed: the schedule sequence is a pure "
                         "function of it")
    ap.add_argument("--budget-secs", type=float, default=120.0,
                    help="stop starting new schedules once elapsed "
                         "(never below --min-schedules)")
    ap.add_argument("--min-schedules", type=int, default=0,
                    help="coverage floor driven regardless of budget — "
                         "the CI gate's deterministic minimum")
    ap.add_argument("--subjects", default=None,
                    help="comma-separated subject names (default: the "
                         "fast tier: %s)" % ",".join(fast_subjects()))
    ap.add_argument("--fixture-seeds", type=int, default=1,
                    help="fixture seeds to draw from (more = more "
                         "reference runs, more data diversity)")
    ap.add_argument("--replay-corpus", action="store_true",
                    help="replay the committed regression corpus first")
    ap.add_argument("--replay", default=None, metavar="SCHEDULE",
                    help="drive ONE encoded schedule "
                         "(subject|seed|spec[|resume_spec]) and report")
    ap.add_argument("--no-shrink", action="store_true",
                    help="report findings unshrunk (faster triage)")
    ap.add_argument("--out", default=None,
                    help="work directory (default: a temp dir)")
    ap.add_argument("--device", default="cuda",
                    help="where every subject leg runs (default: the card)")


def run_chaos(args) -> int:
    """``python -m hfrep_tpu_torch.resilience chaos`` — exit 0 = no invariant
    violated, 1 = findings (repro lines on stderr), 2 = engine misuse."""
    import contextlib

    import hfrep_tpu_torch.obs as obs_pkg

    subjects = (args.subjects.split(",") if args.subjects
                else list(fast_subjects()))
    with contextlib.ExitStack() as stack:
        if args.out:
            workdir = Path(args.out)
        else:
            workdir = Path(stack.enter_context(
                tempfile.TemporaryDirectory(prefix="hfrep_chaos_")))
        stack.enter_context(obs_pkg.session_or_off(
            os.environ.get("HFREP_OBS_DIR"), "chaos"))
        try:
            if args.replay:
                sched = Schedule.decode(args.replay)
                driver = Driver(workdir, device=args.device)
                report = driver.run_schedule(sched, tag="replay")
                doc = {
                    "schedule": sched.encode(),
                    "attempts": [[a.spec, a.exit_code, round(a.secs, 2)]
                                 for a in report.attempts],
                    "violations": [v.render() for v in report.violations],
                    "findings": [
                        {"detail": v.render(), "repro": repro_line(sched)}
                        for v in report.violations],
                    "ok": report.ok,
                }
            else:
                doc = run_soak(
                    seed=args.seed, budget_secs=args.budget_secs,
                    min_schedules=args.min_schedules, subjects=subjects,
                    fixture_seeds=max(1, args.fixture_seeds),
                    workdir=workdir, replay_corpus=args.replay_corpus,
                    shrink_findings=not args.no_shrink, device=args.device)
        except ChaosError as e:
            print(f"chaos: {e}", file=sys.stderr)
            return 2
        print(json.dumps(doc, sort_keys=True))
        if not doc["ok"]:
            for f in doc.get("findings", []):
                print(f"chaos VIOLATION: {f.get('detail')}\n"
                      f"  repro: {f.get('repro')}", file=sys.stderr)
            if args.out is None:
                print("(re-run with --out DIR to keep the evidence and "
                      "the ready-to-commit corpus entries)",
                      file=sys.stderr)
            return 1
    return 0
