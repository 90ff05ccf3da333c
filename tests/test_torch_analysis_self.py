"""The port's static-analysis gate: ``python -m hfrep_tpu_torch.analysis
check hfrep_tpu_torch tools/torch_*.py tests/test_torch_*.py`` holds the
port at zero findings with an empty baseline, within its budget, and the
analysis package itself imports no ``jax``, ``hfrep_tpu`` or ``torch``.

Deliberate exceptions carry a line-level ``# noqa: <id>`` with a reason;
the baseline stays empty (``hfrep_tpu_torch/analysis/README.md``).
"""

from __future__ import annotations

import ast
import glob
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "hfrep_tpu_torch" / "analysis"
GATE_BUDGET_S = 60.0


def gate_targets() -> list:
    """The gate's paths, the shell's globs expanded."""
    return (["hfrep_tpu_torch"] + sorted(glob.glob("tools/torch_*.py", root_dir=ROOT))
            + sorted(glob.glob("tests/test_torch_*.py", root_dir=ROOT)))


def test_the_port_is_clean_under_its_gate_cold_and_in_budget(tmp_path):
    cmd = [sys.executable, "-m", "hfrep_tpu_torch.analysis", "check", *gate_targets(),
           "--format", "json"]
    t0 = time.monotonic()
    cold = subprocess.run(cmd + ["--no-cache"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    cold_s = time.monotonic() - t0
    assert cold.returncode == 0, cold.stdout + cold.stderr
    doc = json.loads(cold.stdout)
    assert doc["findings"] == [] and doc["baselined"] == 0 and doc["stale_baseline"] == []
    assert cold_s < GATE_BUDGET_S, f"the cold gate took {cold_s:.1f} s"
    # a warm run through a cache gives the same verdict
    cache = ["--cache", str(tmp_path / "cache.json")]
    for _ in range(2):
        warm = subprocess.run(cmd + cache, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        assert warm.returncode == 0 and json.loads(warm.stdout) == doc


def test_the_baseline_is_empty():
    assert json.loads((PKG / "baseline.json").read_text()) == {"version": 1, "entries": []}


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_no_module_of_the_package_imports_jax_the_jax_package_or_torch():
    """No module imports jax or the JAX package anywhere, and none imports
    torch, numpy or the port's other modules at its top level.  The one
    place that does, inside its functions, is the program audit's tracer
    (``programs.py``): its factories build the port's programs to trace
    them, importing torch only when a boundary is traced cold."""
    for f in sorted(PKG.rglob("*.py")):
        tree = ast.parse(f.read_text())
        for name in _imports(tree):
            assert name.split(".")[0] not in ("jax", "jaxlib", "hfrep_tpu"), (f, name)
        scopes = [ast.Module(body=[n for n in tree.body if not isinstance(
            n, (ast.FunctionDef, ast.ClassDef))], type_ignores=[])]
        if f.name != "programs.py":
            scopes = [tree]
        for name in (n for scope in scopes for n in _imports(scope)):
            top = name.split(".")[0]
            assert top not in ("torch", "numpy"), (f, name)
            if top == "hfrep_tpu_torch":
                assert name.startswith("hfrep_tpu_torch.analysis"), (f, name)


def test_a_check_run_loads_no_jax_hfrep_tpu_or_torch_module():
    """The package's modules, loaded under a bare ``hfrep_tpu_torch`` (its
    ``__init__``, which imports torch, not run), analyze the port and
    leave no jax, hfrep_tpu or torch module in ``sys.modules``."""
    probe = (
        "import sys, types\n"
        f"pkg = types.ModuleType('hfrep_tpu_torch'); pkg.__path__ = [{str(PKG.parent)!r}]\n"
        "sys.modules['hfrep_tpu_torch'] = pkg\n"
        "from hfrep_tpu_torch.analysis import analyze_paths, contract\n"
        "from hfrep_tpu_torch.analysis.cli import main\n"
        f"assert analyze_paths([{str(PKG.parent)!r}], use_cache=False) == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'hfrep_tpu', 'torch'))\n"
        "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
