"""The port's chaos layer (``hfrep_tpu_torch/resilience/{drive_fixtures,
chaos_subjects,chaos_oracles,chaos,__main__}.py`` and ``drive.
check_registry``) against the JAX package's, on the CPU.

* Seeded schedule generation equals JAX's for the same seed and subject,
  draw for draw; the schedule codec round-trips as JAX's does.
* The oracles' verdicts on the same artifacts, attempts and streams equal
  JAX's.
* The seeded search finds the ``_planted`` canary and shrinks it to JAX's
  minimal spec (both packages' searches run, as subprocess chains).
* The corpus is the JAX package's, entry for entry, every subject
  registered; its ``_planted``, ``rollup`` and ``ae_mesh`` entries replay
  clean through spawned subjects, none skipped.
* ``drives --check`` passes with every spec of the JAX registry
  registered (``ae_mesh`` included) and no gap; ``explain-faults``
  prints JAX's table.

Every comparison is exact.
"""

from __future__ import annotations

import json
import random
import shutil
from pathlib import Path

import pytest

from hfrep_tpu.resilience import __main__ as jcli
from hfrep_tpu.resilience import chaos as jchaos
from hfrep_tpu.resilience import chaos_oracles as joracles
from hfrep_tpu.resilience import chaos_subjects as jsubjects
from hfrep_tpu_torch.resilience import __main__ as cli
from hfrep_tpu_torch.resilience import chaos, chaos_oracles, chaos_subjects, drive
from hfrep_tpu_torch.utils import checkpoint as ckpt

# ------------------------------------------------------------ generation
@pytest.mark.parametrize("name", list(chaos_subjects.SUBJECTS))
def test_schedule_generation_equals_jax_s(name):
    assert chaos_subjects.SUBJECTS[name].hint_sites == jsubjects.SUBJECTS[name].hint_sites
    for seed, fixture_seeds in ((0, 1), (11, 2), (123, 3)):
        mine, theirs = random.Random(seed), random.Random(seed)
        a = [chaos.generate_schedule(mine, chaos_subjects.SUBJECTS[name], fixture_seeds)
             for _ in range(25)]
        b = [jchaos.generate_schedule(theirs, jsubjects.SUBJECTS[name], fixture_seeds)
             for _ in range(25)]
        assert [s.encode() for s in a] == [s.encode() for s in b]


def test_schedule_codec_and_subject_tiers_are_jax_s():
    for enc in ("ae_sweep|0|sigterm@chunk=2", "gan_ckpt|3|corrupt@ckpt=1x4;preempt@block=2",
                "ae_multi|1|preempt@chunk=1|io_fail@snapshot_save=1x4"):
        s = chaos.Schedule.decode(enc)
        assert s.encode() == enc == jchaos.Schedule.decode(enc).encode()
        assert [(leg, d.spec()) for leg, d in s.directives()] == \
            [(leg, d.spec()) for leg, d in jchaos.Schedule.decode(enc).directives()]
    for bad in ("nope", "s|x|sigterm@chunk=1", "s|1", "s|1|zap@chunk=1"):
        with pytest.raises(Exception):
            chaos.Schedule.decode(bad)
    assert chaos_subjects.fast_subjects() == jsubjects.fast_subjects()
    assert chaos.repro_line(chaos.Schedule.decode("a|0|sigterm@chunk=1")).startswith(
        "python -m hfrep_tpu_torch.resilience chaos --replay ")


# --------------------------------------------------------------- oracles
def _out_dir(root: Path, *, result=None, fired=(), torn_middle=False, bundle=False,
             rot=False) -> Path:
    out = root
    (out / "obs").mkdir(parents=True)
    lines = [json.dumps({"v": 1, "t": 0.1, "type": "event", "name": "run_start"})]
    lines += [json.dumps({"v": 1, "t": 0.2, "type": "event", "name": "fault_injected",
                          "kind": k, "site": s}) for k, s in fired]
    if torn_middle:
        lines.insert(1, '{"v": 1, "t": 0.15, "ty')
    lines.append('{"v": 1, "t": 9')                # a torn tail is the crash shape
    (out / "obs" / "events.jsonl").write_text("\n".join(lines))
    ckpt.write_atomic(out / "artifacts" / "sweep",
                      lambda tmp: (tmp / "data.npz").write_bytes(b"payload") and None,
                      io_site="result_save", fault_site="result")
    if rot:
        (out / "artifacts" / "sweep" / "data.npz").write_bytes(b"rotted!")
    if bundle:
        (out / "obs" / "crash_x").mkdir()
        (out / "obs" / "crash_x" / "crash.json").write_text("{}")
    if result is not None:
        (out / "chaos_result.json").write_text(json.dumps(result))
    return out


ORACLE_CASES = {
    "clean": dict(kw={"result": {"invariants": {"items": 2, "expected_items": 2}}},
                  attempts=[("", 0, "")], ref=True),
    "resumed": dict(kw={"result": {"invariants": {}}, "bundle": True},
                    attempts=[("sigterm@chunk=1", 75, ""), ("", 0, "")], ref=True),
    "drain_without_bundle": dict(kw={"result": {"invariants": {}}},
                                 attempts=[("preempt@chunk=1", 75, ""), ("", 0, "")], ref=True),
    "digest_drift": dict(kw={"result": {"invariants": {}}}, attempts=[("", 0, "")],
                         ref="other"),
    "silent_drop": dict(kw={"result": {"invariants": {"submitted": 40, "terminal": 39}}},
                        attempts=[("kill@serve_worker=1", 0, "")], ref=True),
    "no_result": dict(kw={}, attempts=[("", 0, "")], ref=True),
    "torn_middle": dict(kw={"result": {"invariants": {}}, "torn_middle": True},
                        attempts=[("", 0, "")], ref=True),
    "rotted_by_the_schedule": dict(
        kw={"result": {"invariants": {}}, "rot": True, "fired": [("corrupt", "result")]},
        attempts=[("corrupt@result=1", 0, "")], ref=True),
    "rotted_unarmed": dict(kw={"result": {"invariants": {}}, "rot": True},
                           attempts=[("", 0, "")], ref=True),
    "wedged_and_bad_exits": dict(kw={}, attempts=[("stall@chunk=1", None, ""),
                                                  ("io_fail@manifest=1x6", 74, ""),
                                                  ("sigterm@chunk=1", 74, ""),
                                                  ("", 1, "Traceback (most recent call last)"),
                                                  ("", 75, "")], ref=True),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_verdicts_equal_jax_s(tmp_path, case):
    c = ORACLE_CASES[case]
    out = _out_dir(tmp_path / "out", **c["kw"])
    good = chaos_oracles.digest_map(out / "artifacts")
    assert good == joracles.digest_map(out / "artifacts")
    ref = good if c["ref"] is True else {"sweep/data.npz": "0" * 64}
    result = chaos._read_result(out)
    verdicts = []
    for mod in (chaos_oracles, joracles):
        attempts = [mod.Attempt(spec, code, 1.0, tail) for spec, code, tail in c["attempts"]]
        verdicts.append([v.render() for v in mod.check_run(
            deterministic=True, attempts=attempts, out_dir=out, ref_digests=ref,
            result_doc=result)])
    assert verdicts[0] == verdicts[1]
    assert bool(verdicts[0]) == (case not in ("clean", "resumed", "rotted_by_the_schedule"))
    assert chaos_oracles.fired_faults(out / "obs") == joracles.fired_faults(out / "obs")


# ---------------------------------------------------------- the canary
#: the minimal spec the JAX package's search pins for its canary
#: (tests/test_chaos.py::TestPlantedViolation)
JAX_PLANTED_MINIMAL = "_planted|0|io_fail@result_save=1"


def test_search_finds_and_shrinks_the_planted_bug_as_jax_does(tmp_path):
    doc = chaos.run_soak(seed=2, budget_secs=0.0, min_schedules=1, subjects=["_planted"],
                         fixture_seeds=1, workdir=tmp_path / "soak", replay_corpus=False,
                         device="cpu")
    assert not doc["ok"] and doc["violations"] == 1 and doc["schedules"] == 1
    (a,) = doc["findings"]
    first = jchaos.generate_schedule(random.Random(2), jsubjects.SUBJECTS["_planted"], 1)
    assert a["shrunk"] and a["schedule"] == JAX_PLANTED_MINIMAL != first.encode()
    assert a["invariant"] == "resume_bit_identical"
    assert a["repro"] == chaos.repro_line(chaos.Schedule.decode(a["schedule"]))
    (found,) = (tmp_path / "soak" / "found").glob("*.json")
    entry = json.loads(found.read_text())
    assert entry["schedule"] == a["schedule"] and entry["found_by_seed"] == 2


class _Oracle:
    """A driver stand-in: a schedule fails while it holds the culprit
    directive (on any leg), as the canary does."""

    def __init__(self, mod, violation, culprit):
        self.mod, self.violation, self.culprit, self.runs = mod, violation, culprit, []

    def run_schedule(self, sched, tag="run"):
        self.runs.append(sched.encode())
        bad = any(d.kind == self.culprit[0] and d.site == self.culprit[1]
                  for _, d in sched.directives())
        violations = [self.violation("resume_bit_identical", "x")] if bad else []
        return self.mod.Report(schedule=sched, attempts=[], violations=violations, secs=0.0)


@pytest.mark.parametrize("seed", range(6))
def test_shrinker_reduces_as_jax_s_does(seed):
    """The two shrinkers walk the same reductions to the same minimum."""
    rng = random.Random(seed)
    sched = None
    while sched is None or sched.n_faults() < 2:
        sched = chaos.generate_schedule(rng, chaos_subjects.SUBJECTS["gan_ckpt"], 2)
    leg, d = sched.directives()[-1]
    out = []
    for mod, oracles in ((chaos, chaos_oracles), (jchaos, joracles)):
        driver = _Oracle(mod, oracles.Violation, (d.kind, d.site))
        report = driver.run_schedule(mod.Schedule.decode(sched.encode()))
        minimal, runs = mod.shrink(driver, report)
        out.append((minimal.encode(), runs, driver.runs))
    assert out[0] == out[1]
    assert chaos.Schedule.decode(out[0][0]).n_faults() == 1


# --------------------------------------------------------------- corpus
def test_corpus_is_jax_s_entry_for_entry():
    mine = sorted(p.name for p in chaos.CORPUS_DIR.glob("*.json"))
    theirs = sorted(p.name for p in jchaos.CORPUS_DIR.glob("*.json"))
    assert mine == theirs and len(mine) == 9
    for name in mine:
        assert (chaos.CORPUS_DIR / name).read_bytes() == (jchaos.CORPUS_DIR / name).read_bytes()
    entries = chaos.corpus_entries()
    missing = {e["_file"] for e in entries if e["_schedule"].subject not in
               chaos_subjects.SUBJECTS}
    assert missing == set()
    assert (chaos.CORPUS_DIR / "README.md").exists()


def test_cheap_corpus_entries_replay_clean(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name in ("003_sigterm_before_drive.json",
                 "008_rollup_sigterm_midsoak_resume_publish_eio.json",
                 "006_ae_mesh_pjit_dispatch_coverage.json"):
        shutil.copy(chaos.CORPUS_DIR / name, corpus / name)
    monkeypatch.setattr(chaos, "CORPUS_DIR", corpus)
    doc = chaos.run_soak(seed=0, budget_secs=0.0, min_schedules=0, subjects=["rollup"],
                         fixture_seeds=1, workdir=tmp_path / "soak", replay_corpus=True,
                         device="cpu")
    assert doc["ok"], doc["findings"]
    assert doc["corpus_replayed"] == 3
    assert doc["corpus_skipped"] == []
    assert doc["preempted_runs"] == 0 and doc["schedules"] == 0


# ------------------------------------------------------------------ CLIs
def test_drives_check_names_only_the_ae_mesh_gap(capsys):
    ok, problems = drive.check_registry()
    assert ok and problems == [] and drive.DEFERRED_SPECS == {}
    assert cli.main(["drives", "--check", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["problems"] == problems
    assert {r["name"] for r in doc["drives"]} == set(drive.DRIVE_REGISTRY) == \
        set(drive.JAX_SPECS)
    assert tuple(drive.DRIVE_REGISTRY) == drive.JAX_SPECS
    assert all(r["fixture"].startswith("hfrep_tpu_torch.resilience.drive_fixtures:")
               for r in doc["drives"])
    assert cli.main(["drives"]) == 0


@pytest.mark.parametrize("spec", ["sigterm@chunk=2;io_fail@ckpt_save=1x3",
                                  "preempt@chunk=1;io_fail@snapshot_save=1x4",
                                  "corrupt@ckpt=1x4;preempt@block=2;stall@batcher=3",
                                  "kill@actor=1;torn@result=2", "sigterm@chnk=2"])
@pytest.mark.parametrize("fmt", ["human", "json"])
def test_explain_faults_prints_jax_s_table(spec, fmt, capsys):
    mine = cli.main(["explain-faults", spec, "--format", fmt])
    out_mine = capsys.readouterr()
    theirs = jcli.main(["explain-faults", spec, "--format", fmt])
    out_theirs = capsys.readouterr()
    assert mine == theirs and out_mine.out == out_theirs.out
    assert out_mine.err == out_theirs.err
