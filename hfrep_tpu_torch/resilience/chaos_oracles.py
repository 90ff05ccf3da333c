"""Chaos oracles: the invariants every fault schedule is judged by
(``hfrep_tpu/resilience/chaos_oracles.py``).

The chaos engine's value is entirely here — random fault schedules are
cheap, *knowing a run went wrong* is the hard part.  Each oracle is a
pure function of on-disk evidence (the subject's ``<out>`` directory,
the recorded subprocess attempts, the reference digests) returning
violations; the set is shared by every subject, so a new subject buys
the whole invariant battery for free:

``exit_contract``
    every attempt exits 0 (complete) or 75 (drained, resumable) — never
    a watchdog kill (wedge), never another code, never a Python
    traceback on an ostensibly clean exit; and a CLEAN attempt (no
    faults armed) must complete — a drive that keeps exiting 75 with no
    fault plan has wedged its own drain flag.
``resume_bit_identical``
    for deterministic subjects, the final ``artifacts/`` digest map of
    the faulted-then-resumed run equals the undisturbed reference's —
    the bit-identity contract, under *composed* faults.
``artifact_atomicity``
    every ``meta.json``-carrying directory under ``artifacts/``
    checksum-verifies (a crash may cost progress, never a half-published
    artifact).  Skipped when the schedule itself rots final artifacts
    (``torn``/``corrupt`` at ``result``/``bank``): post-publication bit
    rot is the *restore* path's problem, not the writer's.
``zero_silent_drop``
    declared invariant counters conserve: ``terminal == submitted``
    (serving ledger), ``items == expected_items`` (pipeline).
``obs_stream``
    the run's telemetry streams parse (torn final line tolerated —
    that's the documented crash shape); and any drained (exit-75)
    attempt left a crash-forensics bundle (the flight-recorder contract
    behind ``report --crash``).

Violations carry the oracle name + a one-line detail; the shrinker
minimizes against the *same* oracle so a multi-fault schedule cannot
drift onto a different bug while shrinking.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: exit codes the contract always allows (sysexits: 0 OK, 75
#: EX_TEMPFAIL/drained).  74 (EX_IOERR, typed persistent-storage
#: failure) is additionally allowed ONLY on attempts whose own armed
#: spec contains ``io_fail`` — the injected burst earned that exit; a
#: clean run has no business dying of I/O
EXIT_OK, EXIT_DRAINED, EXIT_IO = 0, 75, 74
ALLOWED_EXITS = (EXIT_OK, EXIT_DRAINED)

#: post-save sites whose damage lands on FINAL artifacts — rot there is
#: injected after a successful atomic publish, so the digest/atomicity
#: oracles cannot blame the writer and stand down for those schedules
FINAL_ARTIFACT_SITES = ("result", "bank")


@dataclasses.dataclass(frozen=True)
class Violation:
    oracle: str
    detail: str

    def render(self) -> str:
        return f"{self.oracle}: {self.detail}"


@dataclasses.dataclass(frozen=True)
class Attempt:
    """One subject subprocess run as the driver observed it."""

    spec: str              # HFREP_FAULTS armed for this attempt ("" = clean)
    exit_code: Optional[int]   # None = watchdog killed it (wedge)
    secs: float
    stderr_tail: str = ""


# ------------------------------------------------------------- evidence
def digest_map(artifacts_dir) -> Dict[str, str]:
    """sha256 per payload file under ``artifacts/`` (sorted relative
    posix paths, ``meta.json`` excluded — its checksum is the atomicity
    oracle's business, and its key order is not part of the contract)."""
    root = Path(artifacts_dir)
    out: Dict[str, str] = {}
    if not root.exists():
        return out
    for f in sorted(root.rglob("*")):
        if f.is_file() and f.name != "meta.json":
            out[f.relative_to(root).as_posix()] = hashlib.sha256(
                f.read_bytes()).hexdigest()
    return out


def fired_faults(obs_dir) -> List[Tuple[str, str]]:
    """``(kind, site)`` of every injected fault that ACTUALLY fired,
    from the ``fault_injected`` events the plan announces itself with —
    a directive whose occurrence was never reached must not stand any
    oracle down (the schedule says what was *armed*; the stream says
    what *happened*).  Unparseable lines are skipped here — stream
    health has its own oracle."""
    from hfrep_tpu_torch.obs.report import is_stream_file

    out: List[Tuple[str, str]] = []
    root = Path(obs_dir)
    for stream in sorted(root.rglob("events*.jsonl")):
        if not is_stream_file(stream):
            continue
        for line in stream.read_text(errors="replace").splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("type") == "event" \
                    and rec.get("name") == "fault_injected":
                out.append((rec.get("kind", ""), rec.get("site", "")))
    return out


def _rots_final_artifacts(fired: Sequence[Tuple[str, str]]) -> bool:
    return any(kind in ("torn", "corrupt")
               and site in FINAL_ARTIFACT_SITES for kind, site in fired)


# -------------------------------------------------------------- oracles
def check_exit_contract(attempts: Sequence[Attempt]) -> List[Violation]:
    out: List[Violation] = []
    for i, a in enumerate(attempts):
        what = f"attempt {i} ({a.spec or 'clean'})"
        allowed = ALLOWED_EXITS + ((EXIT_IO,) if "io_fail@" in a.spec
                                   else ())
        if a.exit_code is None:
            out.append(Violation(
                "exit_contract",
                f"{what} wedged: watchdog killed it after {a.secs:.0f}s"))
        elif a.exit_code not in allowed:
            tail = a.stderr_tail.strip().splitlines()
            hint = f" [{tail[-1]}]" if tail else ""
            out.append(Violation(
                "exit_contract",
                f"{what} exited {a.exit_code}, want one of "
                f"{sorted(allowed)}{hint}"))
        elif "Traceback (most recent call last)" in a.stderr_tail:
            out.append(Violation(
                "exit_contract",
                f"{what} exited {a.exit_code} but printed a traceback — "
                "an error escaped the typed paths"))
    if attempts and attempts[-1].exit_code == EXIT_DRAINED \
            and not attempts[-1].spec:
        out.append(Violation(
            "exit_contract",
            "clean (fault-free) resume still exited 75: the drain flag "
            "or persisted state wedged the drive"))
    return out


def check_resume_bit_identical(ref_digests: Dict[str, str],
                               got_digests: Dict[str, str]) -> List[Violation]:
    if ref_digests == got_digests:
        return []
    missing = sorted(set(ref_digests) - set(got_digests))
    extra = sorted(set(got_digests) - set(ref_digests))
    changed = sorted(k for k in set(ref_digests) & set(got_digests)
                     if ref_digests[k] != got_digests[k])
    parts = []
    if missing:
        parts.append(f"missing {missing[:3]}")
    if extra:
        parts.append(f"unexpected {extra[:3]}")
    if changed:
        parts.append(f"differing {changed[:3]}")
    return [Violation("resume_bit_identical",
                      "artifacts differ from the undisturbed reference: "
                      + "; ".join(parts))]


def check_artifact_atomicity(artifacts_dir) -> List[Violation]:
    from hfrep_tpu_torch.utils import checkpoint as ckpt

    out: List[Violation] = []
    root = Path(artifacts_dir)
    if not root.exists():
        return out
    for meta in sorted(root.rglob(ckpt.META_NAME)):
        try:
            ckpt.verify(meta.parent)
        except ckpt.CheckpointCorrupt as e:
            out.append(Violation(
                "artifact_atomicity",
                f"{meta.parent.name}: published artifact fails its own "
                f"checksum ({e})"))
    return out


def check_zero_silent_drop(result_doc: Optional[dict]) -> List[Violation]:
    if not result_doc:
        return []
    inv = result_doc.get("invariants") or {}
    out: List[Violation] = []
    if "submitted" in inv and "terminal" in inv \
            and inv["terminal"] != inv["submitted"]:
        out.append(Violation(
            "zero_silent_drop",
            f"ledger leaked: terminal {inv['terminal']} != submitted "
            f"{inv['submitted']}"))
    if "items" in inv and "expected_items" in inv \
            and inv["items"] != inv["expected_items"]:
        out.append(Violation(
            "zero_silent_drop",
            f"items leaked: {inv['items']} != expected "
            f"{inv['expected_items']}"))
    return out


def check_obs_stream(obs_dir, any_drained: bool) -> List[Violation]:
    from hfrep_tpu_torch.obs.report import is_stream_file

    out: List[Violation] = []
    root = Path(obs_dir)
    streams = [f for f in sorted(root.rglob("events*.jsonl"))
               if is_stream_file(f)]
    if not streams:
        out.append(Violation("obs_stream",
                             f"no telemetry stream under {root.name}/"))
        return out
    for stream in streams:
        lines = stream.read_text(errors="replace").splitlines()
        # every line but a possibly-torn LAST one must parse — a torn
        # tail is the documented crash shape, torn middles are not
        for i, line in enumerate(lines[:-1] if lines else []):
            if not line.strip():
                continue
            try:
                json.loads(line)
            except json.JSONDecodeError:
                out.append(Violation(
                    "obs_stream",
                    f"{stream.name}:{i + 1} is unparseable mid-stream"))
                break
    if any_drained:
        bundles = [d for d in root.rglob("crash_*")
                   if (d / "crash.json").exists()]
        if not bundles:
            out.append(Violation(
                "obs_stream",
                "a drained (exit 75) attempt left no crash-forensics "
                "bundle"))
    return out


# ------------------------------------------------------------- assembly
def check_run(*, deterministic: bool, attempts: Sequence[Attempt],
              out_dir, ref_digests: Optional[Dict[str, str]],
              result_doc: Optional[dict]) -> List[Violation]:
    """The full battery over one driven schedule.  Artifact-level
    oracles only run when the final attempt completed (exit 0): an
    honest wedge/exit violation already explains a missing artifact."""
    out = Path(out_dir)
    violations = check_exit_contract(attempts)
    completed = bool(attempts) and attempts[-1].exit_code == 0
    if completed:
        if result_doc is None:
            violations.append(Violation(
                "exit_contract",
                "exit 0 without publishing chaos_result.json"))
        violations += check_zero_silent_drop(result_doc)
        if not _rots_final_artifacts(fired_faults(out / "obs")):
            violations += check_artifact_atomicity(out / "artifacts")
            if deterministic and ref_digests is not None:
                violations += check_resume_bit_identical(
                    ref_digests, digest_map(out / "artifacts"))
    any_drained = any(a.exit_code == EXIT_DRAINED for a in attempts)
    violations += check_obs_stream(out / "obs", any_drained)
    return violations
