"""The port's program audit (``hfrep_tpu_torch/analysis/programs.py``)
against the JAX package's (``hfrep_tpu/analysis/programs.py``).

- **Registry parity**: every JAX boundary label has a port row of the
  same label; every runtime-site token greps verbatim in the port's
  source; every audited site is covered by a row, every row points at a
  live audited site, and every discovered boundary-creation call is
  accounted for; labels are unique and anchored.
- **Rule parity on programs**: for each carried JPX rule the same small
  functions go through ``jax.make_jaxpr`` with JAX's rule and through
  ``make_fx`` / ``torch.export`` (the serve path's ``aot_compile``) with
  the port's, and the (rule id, count) pairs are equal.
- **Serve programs**: ``serve:replicate@bf16`` traced by both packages
  gives the same product census by dtype; ``serve:sample``'s exported
  graph holds the hand kernel's ``hfrep.lstm_fwd`` nodes on the CPU.
- **Machinery**: the registry audits clean, the committed baseline and
  snapshot are clean, ``# noqa`` on a registry row, the SARIF ``--diff``
  round trip, cold = warm, a failing factory's skip note, the seeded
  defects, and ``obs explain``'s note against the JAX package's.
- **Synthetic graphs**: a positive and a negative duck-typed graph per
  JPX rule.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from hfrep_tpu.analysis import programs as jax_programs
from hfrep_tpu.analysis.rules import PROGRAM_RULES_BY_ID as JAX_PROGRAM_RULES
from hfrep_tpu_torch.analysis import cli, programs
from hfrep_tpu_torch.analysis.rules import PROGRAM_RULES, PROGRAM_RULES_BY_ID
from hfrep_tpu_torch.analysis.rules.jpx_base import (ProgramContext, arg_dtypes, call_nodes,
                                                     op_name)
from hfrep_tpu_torch.analysis.rules.jpx_precision import PRODUCT_OPS

ROOT = Path(__file__).resolve().parents[1]
CARRIED_JPX = ("JPX002", "JPX003", "JPX004")


# --------------------------------------------------- registry parity
def test_every_jax_boundary_label_has_a_port_row():
    assert [b.label for b in programs.PROGRAM_BOUNDARIES] == \
        [b.label for b in jax_programs.PROGRAM_BOUNDARIES]
    for b in programs.PROGRAM_BOUNDARIES:
        jb = jax_programs.BOUNDARIES_BY_LABEL[b.label]
        assert (b.kind, b.site, b.policy, b.f32_dot_allow) == \
            (jb.kind, jb.site, jb.policy, jb.f32_dot_allow)
        assert b.factory is not None and b.tracer == ("export" if b.kind == "serve" else "fx")


def test_every_jax_runtime_site_is_carried_or_says_why():
    for site in jax_programs.RUNTIME_SITES:
        assert site in programs.RUNTIME_SITES or site in programs.SITES_WITHOUT_COUNTERPART
    for site, why in programs.SITES_WITHOUT_COUNTERPART.items():
        assert site in jax_programs.RUNTIME_SITES and why


def test_runtime_site_tokens_exist_verbatim_in_live_source():
    for site, row in programs.RUNTIME_SITES.items():
        src = (ROOT / row["file"]).read_text(encoding="utf-8")
        assert row["token"] in src, (site, row)


def test_every_audited_site_is_covered_by_a_boundary():
    covered = {b.site for b in programs.PROGRAM_BOUNDARIES}
    for site, row in programs.RUNTIME_SITES.items():
        assert (site in covered) if row["audited"] else row.get("why"), site


def test_every_boundary_points_at_a_live_audited_site():
    for b in programs.PROGRAM_BOUNDARIES:
        assert programs.RUNTIME_SITES[b.site]["audited"], b.label
        for rel in b.modules:
            assert (ROOT / rel).exists(), (b.label, rel)


def test_discovered_boundary_calls_are_all_accounted_for():
    site_files = {row["file"] for row in programs.RUNTIME_SITES.values()}
    triples = programs.discover_label_calls()
    assert {rel for rel, _, _ in triples} >= {"hfrep_tpu_torch/train/trainer.py",
                                              "hfrep_tpu_torch/serve/server.py"}
    for rel, callee, prefix in triples:
        assert rel in site_files, (rel, callee, prefix)


def test_registry_labels_unique_and_anchored():
    assert len(programs.BOUNDARIES_BY_LABEL) == len(programs.PROGRAM_BOUNDARIES) == 16
    lines = programs.registry_lines()
    assert set(lines) == set(programs.BOUNDARIES_BY_LABEL)
    src = Path(programs.__file__).read_text().splitlines()
    assert all(f'label="{label}"' in src[n - 1] for label, n in lines.items())


def test_the_audit_modules_import_torch_only_to_trace():
    """The registry, the rules and the CLI import no torch at module level:
    a factory or the tracer does, when a boundary is traced cold."""
    pkg = ROOT / "hfrep_tpu_torch" / "analysis"
    for f in [pkg / "programs.py", pkg / "cli.py", *sorted((pkg / "rules").glob("jpx_*.py"))]:
        for node in ast.parse(f.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n == "torch" or n.startswith("torch.") for n in names), f


# ------------------------------------------------- rule parity on programs
def _jax_findings(rule: str, fn, args, policy="fp32"):
    b = jax_programs.Boundary(label="test:parity", kind="test", modules=(),
                              site="trainer_multi_step", factory=lambda: (fn, args),
                              policy=policy)
    pctx = jax_programs.trace_boundary(b)
    return JAX_PROGRAM_RULES[rule].check_program(pctx)


def _port_findings(rule: str, factory, kind: str, tracer="fx", policy="fp32"):
    b = programs.Boundary(label="test:parity", kind=kind, modules=(),
                          site="trainer_multi_step", factory=factory, policy=policy,
                          tracer=tracer)
    return PROGRAM_RULES_BY_ID[rule].check_program(programs.trace_boundary(b))


def _pairs(findings):
    """(rule id, the count the message leads with) per finding."""
    out = []
    for f in findings:
        m = re.search(r"(\d+)[×x ]", f.message.split("] ", 1)[1])
        out.append((f.rule, int(m.group(1)) if m else 1))
    return out


def _jnp_pair(leak: bool):
    import jax.numpy as jnp

    def f(a, b, c, d):
        return jnp.dot(a, b).astype(jnp.float32) + jnp.dot(c, d).astype(jnp.float32)
    bf, f32 = jnp.bfloat16, jnp.float32
    dt = f32 if leak else bf
    return f, (jnp.ones((4, 3), bf), jnp.ones((3, 4), bf), jnp.ones((4, 3), dt),
               jnp.ones((3, 4), dt))


def _torch_pair(leak: bool):
    def factory(loops):
        def f(a, b, c, d):
            return torch.mm(a, b).float() + torch.mm(c, d).float()
        dt = torch.float32 if leak else torch.bfloat16
        bf = torch.bfloat16
        return f, (torch.ones((4, 3), dtype=bf), torch.ones((3, 4), dtype=bf),
                   torch.ones((4, 3), dtype=dt), torch.ones((3, 4), dtype=dt))
    return factory


@pytest.mark.parametrize("leak", [True, False], ids=["one_f32_product", "all_bf16"])
def test_jpx002_parity(leak):
    want = _pairs(_jax_findings("JPX002", *_jnp_pair(leak), policy="bf16"))
    got = _pairs(_port_findings("JPX002", _torch_pair(leak), "ae_init", policy="bf16"))
    assert got == want == ([("JPX002", 1)] if leak else [])


def _jax_sync(in_loop: bool):
    import jax

    def f(x):
        def body(i, x):
            if in_loop:
                jax.debug.callback(lambda v: None, x)
            return x + 1
        if not in_loop:
            jax.debug.callback(lambda v: None, x)
        return jax.lax.fori_loop(0, 3, body, x)
    return f, (jax.numpy.ones(3),)


def _torch_sync(in_loop: bool):
    def factory(loops):
        def f(x):
            if not in_loop:
                x.sum().item()
            for _ in range(loops):
                if in_loop:
                    x.sum().item()
                x = x + 1
            return x
        return f, (torch.ones(3),)
    return factory


@pytest.mark.parametrize("in_loop", [True, False], ids=["sync_in_loop", "sync_at_top"])
def test_jpx003_parity(in_loop):
    want = _pairs(_jax_findings("JPX003", *_jax_sync(in_loop)))
    got = _pairs(_port_findings("JPX003", _torch_sync(in_loop), "gan_multi"))
    assert got == want == ([("JPX003", 1)] if in_loop else [])


def _torch_export_factory(scalar: bool):
    from hfrep_tpu_torch.serve import aot

    def factory(device="cpu"):
        x = torch.ones(3, device=device)
        fn = (lambda x, s: x * s) if scalar else (lambda x: x * 2)
        args = (x, 3.0) if scalar else (x,)
        program, mode = aot.aot_compile(fn, *args)
        return programs.ServeBuild(program, mode, None, args)
    return factory


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar_operand", "inner_literal"])
def test_jpx004_parity(scalar):
    import jax.numpy as jnp
    fn, args = ((lambda x, s: x * s), (jnp.ones(3), 3.0)) if scalar else \
        ((lambda x: x * 2), (jnp.ones(3),))
    want = _pairs(_jax_findings("JPX004", fn, args))
    got = _pairs(_port_findings("JPX004", _torch_export_factory(scalar), "serve",
                                tracer="export"))
    assert got == want == ([("JPX004", 1)] if scalar else [])


# ---------------------------------------------------------- serve programs
def test_bf16_replicate_head_has_jax_s_product_census():
    from hfrep_tpu.analysis.rules.jpx_base import eqn_in_avals, iter_eqns

    jctx = jax_programs.trace_boundary(jax_programs.BOUNDARIES_BY_LABEL["serve:replicate@bf16"])
    want = Counter(str(eqn_in_avals(e)[0].dtype) for e, _ in iter_eqns(jctx.jaxpr)
                   if e.primitive.name == "dot_general")
    pctx = programs.trace_boundary(programs.BOUNDARIES_BY_LABEL["serve:replicate@bf16"])
    got = Counter(arg_dtypes(n)[0] for n in call_nodes(pctx.graph) if op_name(n) in PRODUCT_OPS)
    assert got == want == Counter({"bfloat16": 2})
    assert PROGRAM_RULES_BY_ID["JPX002"].check_program(pctx) == []


def test_serve_sample_ships_the_lstm_kernel_op():
    """The generator's two LSTM layers are two ``hfrep.lstm_fwd`` nodes of
    the loaded program, run on the CPU through the op's CPU kernel, and
    the program answers as the eager one does."""
    built = programs.build_serve_sample("cpu")
    assert built.mode == "export"
    kernels = [n for n in call_nodes(built.program.exported.graph) if op_name(n) == "lstm_fwd"]
    assert len(kernels) == 2
    assert all(str(n.target) == "hfrep.lstm_fwd.default" for n in kernels)
    from hfrep_tpu_torch.serve import aot
    noise = torch.randn(built.args[1].shape, generator=torch.Generator().manual_seed(3))
    eager = aot.Program(aot.gen_batch_fn(built.model), "compiled")
    assert torch.equal(built.program(built.model.params, noise),
                       eager(built.model.params, noise))


def test_fx_rows_record_each_kernel_as_one_call():
    b = programs.BOUNDARIES_BY_LABEL["compile:multi_step@mtss_bf16"]
    graph = programs.fx_graph(*b.factory(2))
    kernels = Counter(op_name(n) for n in call_nodes(graph)
                      if str(n.target).startswith("hfrep."))
    assert set(kernels) >= {"lstm_fwd", "lstm_bwd", "lstm_stack_fwd", "lstm_stack_bwd",
                            "lstm_stack_adj"}
    # the streams the kernels take in a bf16 program are bf16
    assert all(arg_dtypes(n)[:2] == ["bfloat16", "bfloat16"] for n in call_nodes(graph)
               if str(n.target).startswith("hfrep."))
    # and the plain versions are back in place after the trace
    from hfrep_tpu_torch.ops import cuda_lstm
    assert cuda_lstm.lstm_seq_plain.__module__ == "hfrep_tpu_torch.ops.cuda_lstm"


# --------------------------------------------------------------- machinery
def test_the_registry_audits_clean_on_the_cpu(capsys):
    assert cli.main(["audit", "--no-cache", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"] == [] and doc["skipped"] == {} and doc["baselined"] == 0
    assert doc["traced"] == 16 and set(doc["devices"].values()) == {"cpu"}


def test_committed_snapshot_and_baseline_are_clean():
    assert json.loads(cli.DEFAULT_AUDIT_BASELINE.read_text())["entries"] == []
    snap = json.loads(cli.DEFAULT_AUDIT_SNAPSHOT.read_text())
    run = snap["runs"][0]
    assert run["results"] == [] and "originalUriBaseIds" not in run
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == list(CARRIED_JPX)


def _boundary(**over):
    base = dict(label="test:boundary", kind="test", modules=(), site="trainer_multi_step")
    base.update(over)
    return programs.Boundary(**base)


def test_registry_noqa_suppresses_at_the_anchored_row(tmp_path, monkeypatch):
    fake = tmp_path / "hfrep_tpu_torch" / "analysis" / "programs.py"
    fake.parent.mkdir(parents=True)
    fake.write_text("registry = [\n    'row-one',\n    'row-two',  # noqa: JPX004\n]\n")
    monkeypatch.setattr(programs, "REPO_ROOT", tmp_path)
    b = _boundary()
    suppressed = ProgramContext(b, line=3).finding("JPX004", "scalar", token="scalar-in")
    other_rule = ProgramContext(b, line=3).finding("JPX002", "f32", token="f32dot")
    clean_row = ProgramContext(b, line=2).finding("JPX004", "scalar", token="scalar-in")
    kept = programs._apply_registry_noqa([suppressed, other_rule, clean_row])
    assert suppressed not in kept and other_rule in kept and clean_row in kept


def test_audit_sarif_carries_boundary_properties_and_diff_roundtrip(tmp_path, capsys,
                                                                   monkeypatch):
    b = programs.BOUNDARIES_BY_LABEL["serve:replicate@bf16"]
    f = ProgramContext(b, line=7).finding("JPX002", "leak", token="f32dot")
    res = programs.AuditResult(findings=[f], traced=[b.label], skipped={})
    props = {fp: {"boundary": lbl} for fp, lbl in res.boundary_of.items()}
    buf = io.StringIO()
    cli._report_sarif([f], [], Counter(), buf, rule_set=PROGRAM_RULES,
                      result_props=props, with_root=False)
    doc = json.loads(buf.getvalue())
    result = doc["runs"][0]["results"][0]
    assert result["properties"]["boundary"] == "serve:replicate"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "hfrep_tpu_torch/analysis/programs.py"
    assert loc["region"]["startLine"] == 7
    snap = tmp_path / "snap.sarif"
    snap.write_text(buf.getvalue())
    assert cli._load_sarif_fingerprints(snap) == Counter({f.fingerprint: 1})
    # the verb's --diff against that snapshot (over one cheap row): the
    # finding there is gone now
    monkeypatch.setattr(programs, "PROGRAM_BOUNDARIES",
                        (programs.BOUNDARIES_BY_LABEL["ae_chunk:init"],))
    assert cli.main(["audit", "--no-cache", "--diff", str(snap)]) == 0
    out = capsys.readouterr().out
    assert f"diff -{f.fingerprint}" in out and "audited 1 boundary" in out


def test_audit_changed_without_a_git_checkout_is_an_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "REPO_ROOT", tmp_path)
    assert cli.main(["audit", "--no-cache", "--changed"]) == 2
    assert "needs a git checkout" in capsys.readouterr().err


def test_graceful_skip_on_factory_failure():
    def boom(*_):
        raise RuntimeError("build exploded")

    res = programs.audit_boundaries(boundaries=[_boundary(label="test:doomed", factory=boom)],
                                    use_cache=False)
    assert res.findings == [] and res.traced == []
    assert "RuntimeError" in res.skipped["test:doomed"]
    none = _boundary(label="test:nofactory", notes="not traceable here")
    assert programs.audit_boundaries(boundaries=[none], use_cache=False).skipped == \
        {"test:nofactory": "not traceable here"}


def test_an_eager_fallback_is_a_skip_note_not_a_pass():
    def compiled(device="cpu"):
        return programs.ServeBuild(None, "compiled", None, ())

    res = programs.audit_boundaries(
        boundaries=[_boundary(label="test:eager", tracer="export", factory=compiled)],
        use_cache=False)
    assert "mode 'compiled'" in res.skipped["test:eager"]


def test_audit_cache_cold_vs_warm_identity(tmp_path, monkeypatch):
    subset = [programs.BOUNDARIES_BY_LABEL["ae_chunk:init"]]
    cache = tmp_path / "audit-cache.json"
    cold = programs.audit_boundaries(boundaries=subset, cache_path=cache)
    assert cache.exists() and cold.traced == ["ae_chunk:init"]

    def no_trace(*a, **k):
        raise AssertionError("a warm audit replays the cache")

    monkeypatch.setattr(programs, "trace_boundary", no_trace)
    warm = programs.audit_boundaries(boundaries=subset, cache_path=cache)
    assert ([dataclasses.asdict(f) for f in warm.findings]
            == [dataclasses.asdict(f) for f in cold.findings])
    assert warm.traced == cold.traced and warm.skipped == cold.skipped
    # another torch must trace again: the poisoned tracer's error lands in
    # the skip note
    monkeypatch.setattr(programs, "torch_version", lambda: "999.0.0")
    stale = programs.audit_boundaries(boundaries=subset, cache_path=cache)
    assert "AssertionError" in stale.skipped.get("ae_chunk:init", "")


def test_each_seeded_defect_gives_exactly_its_finding():
    for b, rule in programs.SEEDED_DEFECTS:
        res = programs.audit_boundaries(boundaries=[b], use_cache=False)
        assert res.skipped == {} and [f.rule for f in res.findings] == [rule], b.label
        assert re.search(r"\] 1 ", res.findings[0].message)


def test_obs_explain_notes_equal_jax_s(tmp_path):
    from hfrep_tpu.obs.explain import annotate_static_audit as jax_annotate
    from hfrep_tpu_torch.obs.explain import annotate_static_audit

    snap = tmp_path / "audit.sarif"
    snap.write_text(json.dumps({"runs": [{"results": [
        {"ruleId": "JPX003", "properties": {"boundary": "compile:multi_step"}},
        {"ruleId": "JPX002", "properties": {"boundary": "serve:replicate"}},
    ]}]}))
    doc = {"findings": [
        {"kind": "program", "detail": {"program": "compile:multi_step"}},
        {"kind": "program", "detail": {"program": "serve:replicate:b32"}},
        {"kind": "metric", "detail": {"program": "compile:multi_step"}},
    ], "notes": []}
    got = annotate_static_audit(json.loads(json.dumps(doc)), snapshot_path=snap)["notes"]
    want = jax_annotate(json.loads(json.dumps(doc)), snapshot_path=snap)["notes"]
    assert len(got) == 2 and "JPX003" in got[0] and "JPX002" in got[1]
    assert got == [n.replace("python -m hfrep_tpu.analysis",
                             "python -m hfrep_tpu_torch.analysis") for n in want]
    # a clean (or missing) snapshot annotates nothing, the committed one included
    assert annotate_static_audit({"findings": doc["findings"], "notes": []},
                                 snapshot_path=tmp_path / "missing.sarif")["notes"] == []
    assert annotate_static_audit({"findings": doc["findings"], "notes": []})["notes"] == []


# ------------------------------------------------------- synthetic graphs
class _Val:
    def __init__(self, shape=(4, 4), dtype="torch.float32", device="cpu"):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device


class _Node:
    def __init__(self, target, args=(), val=None, op="call_function", users=()):
        self.target, self.args, self.op = target, tuple(args), op
        self.meta = {"val": val}
        self.users = dict.fromkeys(users)


class _Graph:
    def __init__(self, nodes):
        self.nodes = list(nodes)


def _ph(dtype="torch.float32", shape=(4, 4), device="cpu"):
    return _Node("x", op="placeholder", val=_Val(shape, dtype, device))


def _mm(dtype):
    return _Node("aten.mm.default", (_ph(dtype), _ph(dtype)), _Val())


def test_jpx002_synthetic():
    rule = PROGRAM_RULES_BY_ID["JPX002"]
    leaky = _Graph([_mm("torch.float32"), _mm("torch.float32"), _mm("torch.bfloat16")])
    found = rule.check_program(ProgramContext(_boundary(policy="bf16"), graph=leaky))
    assert [f.rule for f in found] == ["JPX002"] and "2 f32" in found[0].message
    assert rule.check_program(ProgramContext(_boundary(), graph=leaky)) == []
    assert rule.check_program(ProgramContext(_boundary(policy="bf16", f32_dot_allow=2),
                                             graph=leaky)) == []
    kernel = _Node("hfrep.lstm_fwd.default", (_ph("torch.float32"), _ph("torch.float32")))
    found = rule.check_program(ProgramContext(_boundary(policy="bf16"), graph=_Graph([kernel])))
    assert [f.rule for f in found] == ["JPX002"]
    bf16_kernel = _Node("hfrep.lstm_fwd.default",
                        (_ph("torch.bfloat16"), _ph("torch.bfloat16"), _ph("torch.float32")))
    assert rule.check_program(ProgramContext(_boundary(policy="bf16"),
                                             graph=_Graph([bf16_kernel]))) == []


def _item():
    return _Node("aten._local_scalar_dense.default", (_ph(),), 1.0)


def test_jpx003_synthetic():
    rule = PROGRAM_RULES_BY_ID["JPX003"]
    to_host = _Node("aten._to_copy.default", (_ph(device="cuda"),), _Val(device="cpu"))
    grows = ProgramContext(_boundary(), graph=_Graph([_item(), to_host]),
                           loop_graph=_Graph([_item(), _item(), to_host, to_host]))
    found = rule.check_program(grows)
    assert [(f.rule, f.snippet) for f in found] == [
        ("JPX003", "test:boundary _local_scalar_dense"), ("JPX003", "test:boundary _to_copy->cpu")]
    flat = ProgramContext(_boundary(), graph=_Graph([_item()]), loop_graph=_Graph([_item()]))
    assert rule.check_program(flat) == []
    # a copy that stays on the host is no sync; no loop graph, no verdict
    host_copy = _Node("aten._to_copy.default", (_ph(),), _Val())
    assert rule.check_program(ProgramContext(_boundary(), graph=_Graph([]),
                                             loop_graph=_Graph([host_copy]))) == []
    assert rule.check_program(ProgramContext(_boundary(), graph=_Graph([_item()]))) == []


def test_jpx004_synthetic():
    rule = PROGRAM_RULES_BY_ID["JPX004"]
    export = _boundary(tracer="export")
    scalar_in = ProgramContext(export, inputs=(("constant", "s", 3.0),))
    assert [f.snippet for f in rule.check_program(scalar_in)] == ["test:boundary scalar-in"]
    scalar_out = ProgramContext(export, outputs=(("constant", "o", 1),))
    assert [f.snippet for f in rule.check_program(scalar_out)] == ["test:boundary scalar-out"]
    captured = _Node("c", op="placeholder", val=_Val(()), users=[_Node("aten.mul.Tensor")])
    assert [f.snippet for f in rule.check_program(
        ProgramContext(export, inputs=(("lifted", "c", captured),)))] == \
        ["test:boundary captured-const"]
    literal = _Node("c", op="placeholder", val=_Val(()),
                    users=[_Node("aten.lift_fresh_copy.default")])
    clean = ProgramContext(export, inputs=(("lifted", "c", literal), ("tensor", "x", _ph())))
    assert rule.check_program(clean) == []
    # fx rows are eager programs, never compiled again
    assert rule.check_program(ProgramContext(_boundary(), inputs=(("constant", "s", 3.0),))) == []


def test_every_program_rule_has_fixture_coverage():
    assert tuple(r.id for r in PROGRAM_RULES) == CARRIED_JPX
    src = Path(__file__).read_text(encoding="utf-8")
    for rid in CARRIED_JPX:
        assert f'"{rid}"' in src and f"test_{rid.lower()}_parity" in src
    tree = ast.parse(src)
    assert {n.name for n in tree.body if isinstance(n, ast.FunctionDef)} >= {
        f"test_{r.lower()}_synthetic" for r in CARRIED_JPX}
