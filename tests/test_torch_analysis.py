"""The port's analyzer (``hfrep_tpu_torch/analysis``) against the JAX
package's (``hfrep_tpu/analysis``).

- Every fixture snippet of the JAX package's own tests for the carried
  rules (``tests/test_analysis.py``: ``TestMutation``,
  ``TestShapeContracts``, ``TestGaugeThresholds``, ``TestFaultSites``,
  ``TestAtomicPublish``, ``TestObsDocSync``, ``TestSignalThreadSafety``,
  ``TestExitCodeContract``, ``TestMeshLaunchDiscipline``,
  ``TestWallClockMonopoly``, ``TestBoundarySync``,
  ``TestDriveEnvelopeDiscipline``), read from that file, goes through
  both ``analyze_source``s with the same synthetic project model; paths
  map ``hfrep_tpu/`` to ``hfrep_tpu_torch/``, and the two must give
  equal ``(rule, line, col)`` lists.  Two carried rules are narrower by
  design: JAX005 keeps its mutable-defaults half (the argument-mutation
  half keys on jit-compiled functions, which the port has none of), and
  HF010 flags the torch forms of an eager sync in place of
  ``jax.device_get`` / ``jax.block_until_ready``, and HF008 the torch
  forms of a launch (a process group or collective) in place of
  ``shard_map`` / ``pmap``, so their fixtures reach the port with each
  jax form rewritten to its torch form at the same line and column.
  HF004's project-level (stale-row) fixtures go through both rules'
  ``check_project`` alike.
- The HF010 and HF008 torch forms are the port's own positive fixtures.
- The engine: ``# noqa``, baseline fingerprints, cold run = warm run,
  the JSON and SARIF shape against the JAX package's on one fixture
  tree, and the CLI's exit codes.
"""

from __future__ import annotations

import ast
import json
import re
import textwrap
from pathlib import Path

import pytest

from hfrep_tpu.analysis import analyze_source as jax_analyze_source
from hfrep_tpu.analysis.cli import main as jax_cli_main
from hfrep_tpu.analysis.project import DocRow as JaxDocRow
from hfrep_tpu.analysis.project import DocSchema as JaxDocSchema
from hfrep_tpu.analysis.project import Emission as JaxEmission
from hfrep_tpu.analysis.project import FileSummary as JaxFileSummary
from hfrep_tpu.analysis.project import ProjectModel as JaxProjectModel
from hfrep_tpu.analysis.rules import RULES_BY_ID as JAX_RULES
from hfrep_tpu_torch.analysis import (analyze_paths, analyze_source, apply_baseline,
                                      load_baseline, write_baseline)
from hfrep_tpu_torch.analysis import cli
from hfrep_tpu_torch.analysis.engine import load_cache
from hfrep_tpu_torch.analysis.project import (FAULTS_PATH, DocRow, DocSchema, Emission,
                                              FileSummary, ProjectModel)
from hfrep_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID
from hfrep_tpu_torch.analysis.rules.hf_fault_sites import FaultSiteRule

ROOT = Path(__file__).resolve().parents[1]
CARRIED = ("JAX005", "JAX006", "HF001", "HF002", "HF003", "HF004", "HF006", "HF007",
           "HF008", "HF009", "HF010", "HF011")
CARRIED_JPX = ("JPX002", "JPX003", "JPX004")
FIXTURE_CLASSES = ("TestMutation", "TestShapeContracts", "TestGaugeThresholds",
                   "TestFaultSites", "TestAtomicPublish", "TestObsDocSync",
                   "TestSignalThreadSafety", "TestExitCodeContract", "TestMeshLaunchDiscipline",
                   "TestWallClockMonopoly", "TestBoundarySync", "TestDriveEnvelopeDiscipline")
#: JAX fixtures with no port counterpart, and why
NOT_CARRIED = {
    "TestMeshLaunchDiscipline.test_negative_parallel_package_sanctioned.1":
        "the path is the JAX package's version gate, utils/jax_compat.py, which the "
        "port has no counterpart of",
}

#: the JAX tests' synthetic project model (``tests/test_analysis.py::hf_model``)
MODEL = dict(
    gauge_prefixes=("bench/", "serve/", "scenario/"),
    thresholds={"serve/qps": 1, "bench/known_rate": 2},
    fault_sites={"boundary": {"chunk": 10}, "io": {"ckpt_save": 20},
                 "post_save": {"ckpt": 30}, "actor": {"actor": 40}},
    fault_kinds={"sigterm": "boundary", "preempt": "boundary", "io_fail": "io",
                 "torn": "post_save", "kill": "actor"},
    atomic_writers={"write_atomic", "atomic_text", "_write_with_retry"},
)
#: ... and its doc schema (``hf_model``'s ``doc``), per package
DOC = dict(rows=[("serve_drain", 5)], mentioned={"serve_drain", "serve/qps", "bench/known_rate"})


def _model(jax: bool, doc=DOC, **over) -> object:
    """The JAX tests' model in either package, ``doc`` as ``(rows as
    (name, line), mentioned)``."""
    model_cls, schema, row = ((JaxProjectModel, JaxDocSchema, JaxDocRow) if jax
                              else (ProjectModel, DocSchema, DocRow))
    return model_cls(**dict(MODEL, doc=schema(rows=[row(*r) for r in doc["rows"]],
                                              mentioned=set(doc["mentioned"])), **over))


def _doc_override(fn: ast.FunctionDef, call: ast.Call):
    """A fixture's ``doc=`` override — a local ``DocSchema(rows=[...],
    mentioned={...})`` — as :data:`DOC`'s shape, or None."""
    name = next((k.value.id for k in call.keywords if k.arg == "doc"
                 and isinstance(k.value, ast.Name)), None)
    if name is None:
        return None
    schema = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and any(isinstance(t, ast.Name) and t.id == name for t in n.targets))
    kw = {k.arg: ast.literal_eval(k.value) for k in schema.keywords}
    return dict(rows=kw.get("rows", []), mentioned=kw.get("mentioned", set()))


def _jax_fixtures() -> list:
    """Every ``run(src, rule=...)`` / ``run_hf(src, rule, relpath=...)`` call
    of the fixture classes: ``(id, rule, through run_hf, relpath or None,
    source, doc override or None)``, a source held in a local variable
    resolved in its test."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    out = []
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in FIXTURE_CLASSES):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            local = {t.id: n.value.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                     for t in n.targets if isinstance(t, ast.Name)
                     and isinstance(n.value, ast.Constant)}
            calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                     and isinstance(c.func, ast.Name) and c.func.id in ("run", "run_hf")]
            for i, call in enumerate(sorted(calls, key=lambda c: (c.lineno, c.col_offset))):
                kw = {k.arg: k.value.value for k in call.keywords
                      if isinstance(k.value, ast.Constant)}
                src = call.args[0]
                src = src.value if isinstance(src, ast.Constant) else local[src.id]
                rule = kw["rule"] if call.func.id == "run" else call.args[1].value
                relpath = kw.get("relpath") if call.func.id == "run_hf" else None
                hf = call.func.id == "run_hf"
                fid = f"{cls.name}.{fn.name}.{i}"
                if fid not in NOT_CARRIED:
                    out.append((fid, rule, hf, relpath, src, _doc_override(fn, call)))
    return out


FIXTURES = _jax_fixtures()

#: the torch form of each jax form of an eager sync, at the same column
TORCH_FORMS = ((r"^(\s*)import jax$", r"\1import torch"),
               (r"^(\s*)from jax import device_get as dg$", r"\1import torch"),
               (r"jax\.device_get\((\w+)\)", r"\1.cpu()"),
               (r"\bdg\((\w+\(\w+\))\)", r"\1.cpu()"),
               (r"jax\.block_until_ready\(\w+\)", "torch.cuda.synchronize()"))

#: the torch form of each jax form of a launch, at the same column: the
#: constructor imported bare, the module imported under a name, the
#: dotted call
LAUNCH_FORMS = (
    (r"^(\s*)from jax\.experimental\.shard_map import shard_map$",
     r"\1from torch.distributed import all_reduce as shard_map"),
    (r"^(\s*)from jax\.experimental import shard_map$",
     r"\1from torch import distributed as shard_map"),
    (r"\bshard_map\.shard_map\(", "shard_map.all_reduce("),
    (r"^(\s*)import jax\.experimental\.shard_map as sm$", r"\1import torch.distributed as sm"),
    (r"\bsm\.shard_map\(", "sm.all_gather("),
    (r"^(\s*)from hfrep_tpu\.parallel import _compat$",
     r"\1from torch import distributed as _compat"),
    (r"\b_compat\.shard_map\(", "_compat.broadcast("),
    (r"^(\s*)from hfrep_tpu\.utils\.jax_compat import shard_map as sm$",
     r"\1from torch.distributed import send as sm"),
    (r"^(\s*)from hfrep_tpu\.utils\.jax_compat import shard_map$",
     r"\1from torch.distributed import all_reduce as shard_map"),
    (r"^(\s*)from hfrep_tpu\.utils\.jax_compat import HAS_SHARD_MAP$",
     r"\1from torch.distributed import is_available as HAS_SHARD_MAP"),
    (r'"jax\.shard_map"', '"torch.distributed.all_reduce"'),
    (r"^(\s*)import jax$", r"\1import torch"),
    (r"\bjax\.pmap\(", "torch.distributed.barrier("),
)


def _port_source(rule: str, src: str) -> str:
    forms = {"HF010": TORCH_FORMS, "HF008": LAUNCH_FORMS}.get(rule)
    if forms is None:
        return src
    for pat, rep in forms:
        src = re.sub(pat, rep, src, flags=re.M)
    assert "jax" not in src.replace("hfrep_tpu", ""), src
    return src


def _findings(analyze, rules, rule, hf, relpath, src, model):
    kw = dict(path=relpath or "snippet.py", relpath=relpath or "snippet.py",
              project=model) if hf else dict(path="snippet.py")
    return analyze(textwrap.dedent(src), rules=[rules[rule]], **kw)


def test_the_fixtures_cover_every_carried_rule():
    assert len(FIXTURES) >= 80
    assert {r for _, r, *_ in FIXTURES} == set(CARRIED)
    assert tuple(r.id for r in ALL_RULES) == CARRIED


@pytest.mark.parametrize("fid,rule,hf,relpath,src,doc", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_jax_s_fixture_gives_the_same_findings_in_the_port(fid, rule, hf, relpath, src, doc):
    doc = doc or DOC
    want = _findings(jax_analyze_source, JAX_RULES, rule, hf, relpath, src,
                     _model(True, doc))
    port_rel = relpath.replace("hfrep_tpu/", "hfrep_tpu_torch/", 1) if relpath else None
    got = _findings(analyze_source, RULES_BY_ID, rule, hf, port_rel, _port_source(rule, src),
                    _model(False, doc))
    if rule == "JAX005":
        # the port's JAX005 is the mutable-defaults half alone
        want = [f for f in want if "mutable default" in f.message]
    assert [(f.rule, f.line, f.col) for f in got] == [(f.rule, f.line, f.col) for f in want]
    assert all(f.path == (port_rel or "snippet.py") for f in got)


def test_the_cross_layer_rules_need_a_project():
    src = 'obs.gauge("serve/shed_rate").set(1.0)\n'
    for rid in ("HF001", "HF002", "HF003"):
        assert analyze_source(src, rules=[RULES_BY_ID[rid]]) == \
            jax_analyze_source(src, rules=[JAX_RULES[rid]]) == []


@pytest.mark.parametrize("registry,used,want", [
    ({"boundary": {"chunk": 7, "dead_site": 9}}, True, [("HF002", 9)]),
    ({"boundary": {"dead_site": 9}}, False, []),
])
def test_dead_registry_sites_as_jax_s(registry, used, want):
    """``TestFaultSites.test_project_orphan_*``: a dead registry entry is
    flagged at its line, and only when the registry is in the run."""
    out = []
    for model_cls, rule, faults in ((JaxProjectModel, JAX_RULES["HF002"],
                                     "hfrep_tpu/resilience/faults.py"),
                                    (ProjectModel, FaultSiteRule(), FAULTS_PATH)):
        model = model_cls(**dict(MODEL, fault_sites=registry))
        model.files = {"x.py": FileSummary(fault_sites_used=[("boundary", "chunk", 3)])}
        if used:
            model.files[faults] = FileSummary()
        fs = rule.check_project(model)
        assert all(f.path == faults for f in fs)
        out.append([(f.rule, f.line) for f in fs])
    assert out[0] == out[1] == want


# ------------------------------------------------ HF010's torch forms
def _hf010(src, relpath="hfrep_tpu_torch/replication/custom.py"):
    return [(f.line, f.message.split(" inside")[0]) for f in analyze_source(
        textwrap.dedent(src), path=relpath, relpath=relpath, rules=[RULES_BY_ID["HF010"]],
        project=ProjectModel(**MODEL))]


@pytest.mark.parametrize("imports,call", [
    ("import torch", "torch.cuda.synchronize()"),
    ("import torch as t", "t.cuda.synchronize()"),
    ("from torch import cuda", "cuda.synchronize()"),
    ("import torch.cuda as tc", "tc.synchronize()"),
    ("from torch.cuda import synchronize as sync", "sync()"),
])
def test_hf010_flags_torch_cuda_synchronize_in_every_spelling(imports, call):
    src = f"""
        {imports}
        from hfrep_tpu_torch import resilience
        def drive(fn, state, n):
            for i in range(n):
                state = fn(state)
                {call}
                resilience.boundary("chunk")
            return state
        """
    assert _hf010(src) == [(7, "eager torch.cuda.synchronize()")]


def test_hf010_flags_zero_argument_host_pulls():
    src = """
        from hfrep_tpu_torch.obs import timeline
        def drive(fn, state, n):
            while n > 0:
                state, loss, flag = fn(state)
                a = loss.item()
                b = flag.cpu()
                c = loss.tolist()
                timeline.flush_window(0.1, drive="x", steps=1)
                n -= 1
            return state
        """
    assert _hf010(src) == [(6, "eager .item() host pull"), (7, "eager .cpu() host pull"),
                           (8, "eager .tolist() host pull")]


def test_hf010_leaves_legal_forms_alone():
    src = """
        import torch
        from hfrep_tpu_torch import resilience
        def _boundary_sync(flag):
            torch.cuda.synchronize()
            return bool(flag.cpu())
        def drive(fn, state, n, dev):
            for i in range(n):
                state, flag = fn(state)
                stopped = _boundary_sync(flag)
                moved = state.to(dev)
                kept = state.cpu(memory_format=torch.preserve_format)
                resilience.boundary("chunk")
            return state
        def digest(arrays):
            return [a.cpu().tolist() for a in arrays]
        def in_loop_on_purpose(fn, state, n):
            for i in range(n):
                state = fn(state)
                torch.cuda.synchronize()  # noqa: HF010 - the one timed read
                resilience.tick("block")
        """
    assert _hf010(src) == []
    assert _hf010(src.replace("  # noqa: HF010 - the one timed read", ""),
                  relpath="hfrep_tpu_torch/obs/custom.py") == []



# ------------------------------------------------ HF008's torch forms
def _hf008(src, relpath="hfrep_tpu_torch/serve/custom.py"):
    return analyze_source(textwrap.dedent(src), path=relpath, relpath=relpath,
                          rules=[RULES_BY_ID["HF008"]])


@pytest.mark.parametrize("imports,call", [
    ("import torch", "torch.distributed.init_process_group('gloo')"),
    ("import torch.distributed as dist", "dist.all_reduce(t)"),
    ("from torch import distributed", "distributed.new_group([0, 1])"),
    ("from torch import distributed as d", "d.all_gather([t, t], t)"),
    ("from torch.distributed import broadcast as bc", "bc(t, 0)"),
    ("from torch.distributed import send", "send(t, 1)"),
    ("import torch.distributed", "torch.distributed.recv(t, 0)"),
    ("import torch.distributed as dist", "dist.barrier()"),
])
def test_hf008_flags_a_group_or_collective_in_every_spelling(imports, call):
    src = f"{imports}\ndef f(t):\n    return {call}\n"
    assert [(f.rule, f.line, f.col) for f in _hf008(src)] == [("HF008", 3, 11)]
    assert "outside hfrep_tpu_torch/parallel/" in _hf008(src)[0].message


def test_hf008_leaves_the_mesh_api_probes_and_tests_alone():
    src = """
        import torch.distributed as dist
        def f(t):
            if dist.is_available() and dist.is_initialized():
                return dist.get_world_size()
            return dist.all_reduce(t)
        """
    assert [f.line for f in _hf008(src)] == [6]
    assert _hf008(src, "hfrep_tpu_torch/parallel/rules.py") == []
    assert _hf008(src, "tests/test_torch_custom.py") == []
    assert _hf008(src.replace("dist.all_reduce(t)", "dist.all_reduce(t)  # noqa: HF008")) == []


# ------------------------------------------------ HF004's project side
@pytest.mark.parametrize("rows,emitted,complete,want", [
    ([("serve_drain", 5), ("renamed_away", 9)], [("event", ("serve_drain",), None)], True,
     [("HF004", 9)]),
    ([("renamed_away", 9)], [], False, []),
    ([("bench/serve_qps_c{1k,10k,100k}", 3)], [("gauge", (), "bench/serve_")], True, []),
], ids=["stale_row", "scoped_run_judges_nothing", "wildcard_row_meets_a_prefix"])
def test_doc_side_as_jax_s(rows, emitted, complete, want):
    """``TestObsDocSync.test_project_*``: a documented row nothing emits is
    flagged at its line, only when the run covers the whole emission
    surface, and a wildcard row is met by a dynamic emission's prefix."""
    out = []
    for jax, rule, emission, summary, readme in (
            (True, JAX_RULES["HF004"], JaxEmission, JaxFileSummary, "hfrep_tpu/obs/README.md"),
            (False, RULES_BY_ID["HF004"], Emission, FileSummary,
             "hfrep_tpu_torch/obs/README.md")):
        model = _model(jax, dict(rows=rows, mentioned={r for r, _ in rows}),
                       doc_surface_complete=complete)
        model.files = {"s.py": summary(emissions=[emission(kind=k, line=1, names=n, prefix=p)
                                                  for k, n, p in emitted])}
        fs = rule.check_project(model)
        assert all(f.path == readme for f in fs)
        out.append([(f.rule, f.line) for f in fs])
    assert out[0] == out[1] == want


def test_a_scoped_run_does_not_cover_the_doc_surface():
    model = _model(False, dict(rows=[("renamed_away", 9)], mentioned=set()))
    model.files = {"only_one.py": FileSummary()}
    assert not model.covers_doc_surface()
    assert RULES_BY_ID["HF004"].check_project(model) == []

# --------------------------------------------------------------- engine
BAD = """
def f(x, acc=[]):
    return x
def g(x, cfg={}):
    return x
"""


def _codes(src, **kw):
    return [(f.rule, f.line) for f in analyze_source(textwrap.dedent(src), path="m.py", **kw)]


def test_noqa_is_tokenizer_true_and_scoped_to_its_codes():
    assert _codes(BAD) == [("JAX005", 2), ("JAX005", 4)]
    assert _codes(BAD.replace("acc=[]):", "acc=[]):  # noqa")) == [("JAX005", 4)]
    assert _codes(BAD.replace("acc=[]):", "acc=[]):  # noqa: HF009")) == \
        [("JAX005", 2), ("JAX005", 4)]
    assert _codes(BAD.replace("acc=[]):", "acc=[]):  # noqa: HF009, jax005")) == [("JAX005", 4)]
    # a "# noqa" inside a string is not a comment
    assert _codes(BAD.replace("acc=[]):", "acc=['# noqa']):")) == \
        [("JAX005", 2), ("JAX005", 4)]
    assert _codes("def broken(:\n") == [("JAX000", 1)]


def test_baseline_fingerprints(tmp_path):
    findings = analyze_source(BAD, path="m.py", relpath="m.py")
    bl = tmp_path / "bl.json"
    assert write_baseline(findings[:1], bl, justifications={
        findings[0].fingerprint: "kept on purpose"}) == 1
    doc = json.loads(bl.read_text())
    assert doc["entries"][0]["justification"] == "kept on purpose"
    new, matched, stale = apply_baseline(findings, load_baseline(bl))
    assert [f.line for f in new] == [4] and len(matched) == 1 and not stale
    # a line move keeps the match; a second identical site is not covered
    moved = analyze_source("\n\n" + BAD, path="m.py", relpath="m.py")
    new, matched, _ = apply_baseline(moved, load_baseline(bl))
    assert len(matched) == 1 and moved[0].line != findings[0].line
    doubled = findings[:1] * 2
    new, matched, _ = apply_baseline(doubled, load_baseline(bl))
    assert len(new) == 1 and len(matched) == 1
    _, _, stale = apply_baseline([], load_baseline(bl))
    assert sum(stale.values()) == 1


def test_cold_run_equals_warm_run_and_scoped_runs_keep_the_cache(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    (one / "a.py").write_text(BAD)
    (two / "b.py").write_text("import time\ndef f():\n    return time.time()\n")
    cache = tmp_path / "cache.json"
    cold = analyze_paths([one, two], cache_path=cache)
    assert len(load_cache(cache)) == 2
    warm = analyze_paths([one, two], cache_path=cache)
    assert warm == cold and [f.rule for f in cold] == ["JAX005", "JAX005", "HF009"]
    assert analyze_paths([one, two], use_cache=False) == cold
    analyze_paths([one], cache_path=cache)
    assert len(load_cache(cache)) == 2
    (two / "b.py").unlink()
    analyze_paths([one], cache_path=cache)
    assert len(load_cache(cache)) == 1


@pytest.fixture
def tree(tmp_path):
    """One fixture tree whose findings read the same in both packages."""
    d = tmp_path / "tree"
    d.mkdir()
    (d / "mod.py").write_text(textwrap.dedent("""
        import json
        def f(x, acc=[]):
            return x
        x = zeros((4, 8, 3))  # shape: (B, T)
        def main(rows):
            with open("results/bench.json", "w") as fh:
                json.dump(rows, fh)
        """))
    (d / "ok.py").write_text("y = 1\n")
    return d


def _both(capsys, tree, fmt):
    """Both CLIs over the fixture tree (the port's baseline is empty; the
    JAX package's is not read)."""
    out = []
    for main, extra in ((cli.main, []), (jax_cli_main, ["--no-baseline"])):
        rc = main(["check", str(tree), "--format", fmt, "--no-cache", *extra])
        out.append((rc, capsys.readouterr().out))
    return out


def test_json_report_is_jax_s(tree, capsys):
    (rc, port), (jrc, jax) = _both(capsys, tree, "json")
    assert rc == jrc == 1
    assert json.loads(port) == json.loads(jax)
    assert json.loads(port)["counts"] == {"JAX005": 1, "JAX006": 1, "HF003": 1}


def test_sarif_report_is_jax_s(tree, capsys):
    (rc, port), (jrc, jax) = _both(capsys, tree, "sarif")
    assert rc == jrc == 1
    port, jax = json.loads(port), json.loads(jax)
    pr, jr = port["runs"][0], jax["runs"][0]
    assert port.keys() == jax.keys() and pr.keys() == jr.keys()
    assert port["version"] == "2.1.0" and pr["results"] == jr["results"]
    assert pr["properties"] == jr["properties"]
    assert pr["originalUriBaseIds"] == jr["originalUriBaseIds"]
    p_rules = {r["id"]: r for r in pr["tool"]["driver"]["rules"]}
    j_rules = {r["id"]: r for r in jr["tool"]["driver"]["rules"]}
    assert sorted(p_rules) == sorted(CARRIED)
    assert all(p_rules[k]["name"] == j_rules[k]["name"] for k in CARRIED)


def test_exit_codes_and_the_baseline_flow(tree, tmp_path, capsys):
    bl = tmp_path / "bl.json"
    base = ["check", str(tree), "--no-cache", "--baseline", str(bl)]
    assert cli.main(base) == 1
    assert cli.main(base + ["--write-baseline"]) == 0
    assert cli.main(base) == 0
    assert "clean: 0 findings (3 baselined)" in capsys.readouterr().out
    assert cli.main(["check", str(tree / "ok.py"), "--no-cache"]) == 0
    assert cli.main(base + ["--changed", "--write-baseline"]) == 2
    notes = tmp_path / "notes.md"
    notes.write_text("# not python\n")
    assert cli.main(["check", str(notes), "--no-cache"]) == 2
    bl.write_text("{not json")
    assert cli.main(base) == 2


def test_changed_without_a_git_checkout_is_an_error(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "REPO_ROOT", tmp_path)
    assert cli.main(["check", str(tree), "--no-cache", "--changed"]) == 2
    assert "needs a git checkout" in capsys.readouterr().err


def test_rules_lists_the_carried_ids(capsys):
    assert cli.main(["rules"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == list(CARRIED + CARRIED_JPX)
