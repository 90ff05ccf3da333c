"""The port's project model (``hfrep_tpu_torch/analysis/project.py``)
pinned against the port's LIVE modules.

The cross-layer rules are only as good as the registries the AST
extractors pull out of the port's ``resilience/faults.py``,
``obs/regress.py``, ``obs/history.py``, ``utils/checkpoint.py`` and
``obs/manifest.py``.  These tests compare every extraction against the
imported module's values, so a registry refactor breaks the analyzer
here instead of silently emptying a rule (``tests/test_analysis_project.py``
does the same for the JAX package).
"""

from __future__ import annotations

import ast

import pytest

from hfrep_tpu_torch.analysis.engine import REPO_ROOT
from hfrep_tpu_torch.analysis.project import (ATOMIC_WRITER_DEFS, FAULTS_PATH, ProjectModel,
                                              collect_fault_sites, loop_constant_bindings,
                                              resolve_names, summarize_file)


def _model():
    return ProjectModel.from_file_summaries({})


@pytest.mark.parametrize("group,var", [("boundary", "BOUNDARY_SITES"), ("io", "IO_SITES"),
                                       ("post_save", "POST_SAVE_SITES"),
                                       ("actor", "ACTOR_SITES")])
def test_fault_sites_match_the_live_module(group, var):
    from hfrep_tpu_torch.resilience import faults

    sites = _model().fault_sites[group]
    assert set(sites) == set(getattr(faults, var))
    assert all(line > 0 for line in sites.values())
    if len(sites) > 1:          # each entry's own row of the registry tuple
        assert len(set(sites.values())) > 1


def test_fault_kinds_match_the_live_module():
    from hfrep_tpu_torch.resilience import faults

    kinds = _model().fault_kinds
    assert set(kinds) == set(faults.KINDS)
    for group, var in (("boundary", "BOUNDARY_KINDS"), ("io", "IO_KINDS"),
                       ("post_save", "POST_SAVE_KINDS"), ("actor", "ACTOR_KINDS")):
        assert {k for k, g in kinds.items() if g == group} == set(getattr(faults, var))


def test_thresholds_and_prefixes_match_the_live_modules():
    from hfrep_tpu_torch.obs import history, regress

    model = _model()
    assert set(model.thresholds) == set(regress.DEFAULT_THRESHOLDS)
    # the two historical inversions stay explicit
    assert {"serve/shed_rate", "scenario/pad_waste_frac"} <= set(model.thresholds)
    assert model.gauge_prefixes == history.GAUGE_PREFIXES


def test_atomic_writers_exist_where_declared():
    assert {name for _, name in ATOMIC_WRITER_DEFS} == _model().atomic_writers
    for relpath, name in ATOMIC_WRITER_DEFS:
        assert relpath.startswith("hfrep_tpu_torch/")
        tree = ast.parse((REPO_ROOT / relpath).read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == name
                   for n in ast.walk(tree)), (relpath, name)


def test_the_emitters_resolve_on_the_port_s_modules():
    server = summarize_file(ast.parse((REPO_ROOT / "hfrep_tpu_torch/serve/server.py")
                                      .read_text()))
    events = {n for e in server.emissions if e.kind == "event" for n in e.names}
    assert {"serve_drain", "serve_shed"} <= events
    cli = summarize_file(ast.parse((REPO_ROOT / "hfrep_tpu_torch/experiments/cli.py")
                                   .read_text()))
    gauges = {n for e in cli.emissions if e.kind == "gauge" for n in e.names}
    assert {"serve/p50_ms", "serve/shed_rate"} <= gauges


def test_loop_bindings_and_site_defaults():
    tree = ast.parse("def f(obs, a, b):\n"
                     "    for name, value in (('qps', a), ('p95_ms', b)):\n"
                     "        obs.gauge(f'serve/{name}').set(value)\n"
                     "def write_atomic(path, writer, *, io_site='ckpt_save',\n"
                     "                 fault_site='ckpt'):\n"
                     "    pass\n")
    fn = tree.body[0]
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "gauge")
    names, prefix = resolve_names(call.args[0], loop_constant_bindings(fn))
    assert set(names) == {"serve/qps", "serve/p95_ms"} and prefix is None
    sites = {(g, s) for g, s, _ in collect_fault_sites(tree)}
    assert {("io", "ckpt_save"), ("post_save", "ckpt")} <= sites


def test_the_digest_follows_the_registries():
    a = ProjectModel(thresholds={"serve/qps": 1})
    assert a.digest() == ProjectModel(thresholds={"serve/qps": 1}).digest()
    assert a.digest() != ProjectModel(thresholds={"serve/qps": 1, "serve/p50_ms": 2}).digest()


@pytest.fixture(scope="module")
def port_model():
    files = sorted((REPO_ROOT / "hfrep_tpu_torch").rglob("*.py")) + sorted(
        (REPO_ROOT / "tools").glob("torch_*.py"))
    return ProjectModel.from_file_summaries(
        {f.relative_to(REPO_ROOT).as_posix(): summarize_file(ast.parse(f.read_text()))
         for f in files})


def test_the_whole_port_s_registries_round_trip(port_model):
    assert FAULTS_PATH in port_model.files
    used = set()
    for path, s in port_model.files.items():
        for group, site, line in s.fault_sites_used:
            assert site in port_model.fault_sites[group], (path, line, site)
            used.add((group, site))
        for e in s.emissions:
            if e.kind in ("gauge", "counter"):
                for n in e.names:
                    if n.startswith(port_model.gauge_prefixes):
                        assert n in port_model.thresholds, (path, e.line, n)
    for group, registry in port_model.fault_sites.items():
        for site in registry:
            assert (group, site) in used, (group, site)


def test_the_port_s_obs_readme_is_read_and_the_gate_covers_its_surface(port_model):
    """HF004's schema: the port's own ``obs/README.md`` tables, every row
    met by an emission of the port, every namespaced emission documented,
    and the gate's paths are the whole emission surface (so its doc side
    runs)."""
    from hfrep_tpu_torch.analysis.project import OBS_README_PATH, doc_surface_files
    from hfrep_tpu_torch.analysis.rules.hf_obs_doc import ObsDocRule

    assert OBS_README_PATH == "hfrep_tpu_torch/obs/README.md"
    rows = port_model.doc.rows
    assert len(rows) >= 80 and all(r.line > 0 for r in rows)
    assert doc_surface_files() <= set(port_model.files)
    assert port_model.covers_doc_surface()
    assert ObsDocRule().check_project(port_model) == []
    emitted = port_model.emitted_names(kinds=("event",))
    assert len(emitted) >= 40 and all(port_model.doc.documents(n) for n in emitted)
    # no row of the JAX package's schema that the port does not emit
    assert "program_profile" not in {r.name for r in rows}
