"""The port's perf microscope, write side (``hfrep_tpu_torch/obs/attrib.py``)
against the JAX package's ``hfrep_tpu/obs/attrib.py``, on the CPU.

* ``interval_union_s``, ``op_table`` and ``region_table`` on the same
  event tuples equal JAX's (JAX's regions passed to both); the port's
  regions name the hand kernels.
* ``load_trace_events`` reads a JAX capture as JAX does, and a
  ``torch.profiler`` Chrome trace by its ``kernel`` / ``gpu_memcpy`` /
  ``gpu_memset`` events; ``profile_run`` digests it with busy time no
  more than the traced wall; the CLI's JSON is one document.
* ``flush_window``'s gauges on the same note sequence equal JAX's
  (exactly: the same float arithmetic), its warmup and clamp paths too.
* ``profile_boundary`` fingerprints the loaded kernel libraries (a
  stand-in library file here: there is no nvcc on the CPU) into events
  and ``run.json`` ``programs`` entries that JAX's ``explain`` reads; the
  ptxas report parses; ``ops/_build.py`` counts its ``nvcc`` runs as
  ``backend_compiles`` (a stand-in compiler).
* Training and the chunked AE drive with obs on equal obs off, bit for
  bit, and the AE drive emits the attribution gauges.

Tolerances: none but ``pytest.approx``'s default on derived milliseconds;
every comparison with JAX is exact.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hfrep_tpu.obs as jobs
import hfrep_tpu_torch.obs as obs_pkg
from hfrep_tpu.obs import attrib as jattrib
from hfrep_tpu.obs import explain as jexplain
from hfrep_tpu_torch.config import AEConfig, ExperimentConfig, ModelConfig, TrainConfig
from hfrep_tpu_torch.obs import attrib, report, timeline
from hfrep_tpu_torch.ops import _build
from hfrep_tpu_torch.replication.engine import sweep_autoencoders_chunked
from hfrep_tpu_torch.train.trainer import GanTrainer
from hfrep_tpu_torch.utils.fixture_data import scaled_panel

EVENTS = [("while", 0.0, 100.0), ("fusion.1", 10.0, 40.0), ("custom-call.lstm", 60.0, 30.0),
          ("dot.3", 150.0, 50.0), ("lstm_fwd_kernel<float>", 210.0, 12.5),
          ("stack_bwd_cluster_kernel", 220.0, 30.0), ("weight_sum_kernel", 260.0, 8.0),
          ("sm90_xmma_gemm_f32", 270.0, 4.0), ("Memcpy HtoD", 300.0, 1.0)]
PTXAS = """ptxas info    : Compiling entry function '_Z15lstm_fwd_kernel' for 'sm_90a'
ptxas info    : Function properties for _Z15lstm_fwd_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 4096 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for _Z10col_sum
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 380 bytes cmem[0]
"""


@pytest.fixture(autouse=True)
def _pristine():
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    attrib.reset_window()
    jattrib.reset_window()
    timeline.reset()
    torch.set_num_threads(1)
    yield
    for pkg in (obs_pkg, jobs):
        pkg.disable()
    attrib.reset_window()
    jattrib.reset_window()


def _records(run) -> list:
    return report.load_events(run)


def _gauges(run) -> list:
    return [{k: v for k, v in r.items() if k != "t"} for r in _records(run)
            if r["type"] == "metric" and r["name"].startswith("attrib/")]


# ------------------------------------------------------- trace digestion
def test_tables_equal_jax_s_on_the_same_events():
    assert attrib.interval_union_s(EVENTS) == jattrib.interval_union_s(EVENTS)
    assert attrib.interval_union_s(EVENTS[:4]) == pytest.approx(150e-6)
    for top in (0, 3, 20):
        assert attrib.op_table(EVENTS, top=top) == jattrib.op_table(EVENTS, top=top)
    jax_regions = jattrib.region_table.__defaults__[0]
    assert attrib.region_table(EVENTS, jax_regions) == jattrib.region_table(EVENTS)


def test_port_regions_name_the_hand_kernels():
    regions = {r["region"]: r for r in attrib.region_table(EVENTS)}
    assert regions["lstm_fwd"]["busy_s"] == pytest.approx(12.5e-6)
    assert regions["stack_bwd"]["n"] == 1 and regions["weight_sum"]["n"] == 1
    assert regions["gemm/matmul"]["busy_s"] == pytest.approx(4e-6)
    assert regions["memcpy/memset"]["n"] == 1
    assert "fusion" not in regions and "while" not in regions


def _write_jax_trace(path: Path):
    events = [{"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "TPU:0"}},
              {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
               "args": {"name": "XLA Ops"}}]
    events += [{"ph": "X", "pid": 1, "tid": 2, "name": n, "ts": ts, "dur": d}
               for n, ts, d in EVENTS[:4]]
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def _write_torch_trace(path: Path):
    """A ``torch.profiler`` Chrome trace: host ops on the CPU thread, the
    device's work as ``kernel`` / ``gpu_memcpy`` events on a stream."""
    events = [{"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
               "args": {"name": "stream 7 "}},
              {"ph": "X", "cat": "cpu_op", "pid": 99, "tid": 99, "name": "aten::mm",
               "ts": 0.0, "dur": 500.0},
              {"ph": "X", "cat": "cuda_runtime", "pid": 99, "tid": 99,
               "name": "cudaLaunchKernel", "ts": 5.0, "dur": 3.0},
              {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "lstm_fwd_kernel<float>",
               "ts": 20.0, "dur": 30.0},
              {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "stack_adj_cluster_kernel",
               "ts": 40.0, "dur": 30.0},
              {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "Memcpy DtoH",
               "ts": 100.0, "dur": 2.0},
              {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7, "name": "Memset",
               "ts": 110.0, "dur": 1.0},
              {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "weight_sum_kernel",
               "ts": 120.0, "dur": 0.0}]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))


def test_jax_capture_reads_as_jax_reads_it(tmp_path):
    path = tmp_path / "traces" / "plugins" / "profile" / "s1" / "host.trace.json.gz"
    _write_jax_trace(path)
    assert attrib.load_trace_events(path) == jattrib.load_trace_events(path)
    assert attrib.find_trace_files(tmp_path) == jattrib.find_trace_files(tmp_path)


def test_profile_run_digests_a_torch_profiler_trace(tmp_path):
    run = tmp_path / "run"
    _write_torch_trace(run / "traces" / "trace-1.json")
    doc = attrib.profile_run(run)
    (cap,) = doc["captures"]
    assert cap["n_events"] == 5                   # host ops and launches are not device work
    assert cap["busy_s"] == pytest.approx((50.0 + 2.0 + 1.0) * 1e-6)
    assert cap["busy_s"] <= cap["wall_s"] == pytest.approx(500e-6)
    regions = {r["region"]: r for r in cap["regions"]}
    assert set(regions) == {"lstm_fwd", "stack_adj", "weight_sum", "memcpy/memset"}
    assert regions["lstm_fwd"]["busy_s"] == pytest.approx(30e-6)
    assert "stream 7 " in cap["threads"]
    text = attrib.render_profile(doc)
    assert "region lstm_fwd" in text and "of 0.500 ms traced" in text


def test_profile_run_follows_the_manifest_trace_link(tmp_path):
    """``train-gan --profile-dir`` captures outside the run dir and links it."""
    run, prof = tmp_path / "run", tmp_path / "prof"
    with obs_pkg.session(run):
        with obs_pkg.trace_capture(prof):
            torch.ones(4).sum()
    assert attrib.find_trace_files(run) == [prof / "trace-1.json"]
    doc = attrib.profile_run(run)
    assert doc["captures"][0]["n_events"] == 0    # a CPU capture has no device work


def test_profile_skips_and_json_purity(tmp_path, capsys):
    run = tmp_path / "run"
    run.mkdir()
    with pytest.raises(attrib.TraceUnavailable):
        attrib.profile_run(run)
    assert attrib.profile_main(run, fmt="json") == 0
    assert "skipped" in json.loads(capsys.readouterr().out)
    bad = tmp_path / "garbage" / "traces" / "x.trace.json.gz"
    bad.parent.mkdir(parents=True)
    bad.write_bytes(b"not gzip")
    with pytest.raises(attrib.TraceUnavailable):
        attrib.profile_run(tmp_path / "garbage")
    _write_torch_trace(run / "traces" / "trace-1.json")
    assert attrib.profile_main(run, fmt="json") == 0
    assert json.loads(capsys.readouterr().out)["captures"][0]["n_events"] == 5


# ------------------------------------------------- dispatch/compute window
NOTES = [("multi_step", 0.2), ("multi_step", 0.1), ("ae_chunk", 0.0125)]


@pytest.mark.parametrize("wall,steps,attrs", [(1.0, 100, {}), (0.25, None, {"epoch": 4}),
                                              (0.3, 3, {"drive": "x"})])
def test_flush_window_gauges_equal_jax_s(tmp_path, wall, steps, attrs):
    outs = []
    for pkg, mod, run in ((obs_pkg, attrib, tmp_path / "mine"),
                          (jobs, jattrib, tmp_path / "theirs")):
        with pkg.session(run):
            for name, s in NOTES:
                mod.note_dispatch(name, s)
            assert mod.window_calls() == 3
            outs.append(mod.flush_window(wall, steps=steps, **attrs))
    assert outs[0] == outs[1]
    assert _gauges(tmp_path / "mine") == _gauges(tmp_path / "theirs")
    assert len(_gauges(tmp_path / "mine")) == 3


def test_flush_window_discards_warmup_clamps_and_drains_when_off(tmp_path):
    with obs_pkg.session(tmp_path / "run"):
        attrib.note_dispatch("w", 5.0)
        assert attrib.flush_window(1.0, warmup=True) is None
        assert attrib.flush_window(1.0) is None
        attrib.note_dispatch("s", 1.02)
        out = attrib.flush_window(1.0)
    assert out["dispatch_frac"] == pytest.approx(1.0) and out["compute_ms"] == pytest.approx(0.0)
    attrib.note_dispatch("orphan", 0.5)
    assert attrib.flush_window(1.0) is None
    assert attrib._WINDOW.take() == ({}, {})


def test_dispatch_timer_feeds_the_window():
    with attrib.dispatch_timer("ae_chunk"):
        pass
    assert attrib.window_calls() == 1 and attrib.window_dispatch_s() >= 0.0


# ------------------------------------------------------ program fingerprints
def test_ptxas_report_parses():
    mem = attrib.ptxas_memory(PTXAS)
    assert mem == {"kernels": 2, "registers_max": 128, "smem_bytes_max": 4096,
                   "spill_store_bytes": 4, "spill_load_bytes": 12}
    assert attrib.ptxas_memory("") is None


def _fake_libs(monkeypatch, tmp_path, payloads: dict):
    paths = {}
    for name, data in payloads.items():
        p = tmp_path / "libs" / f"{name}-0.so"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        paths[name] = str(p)
    monkeypatch.setattr(_build, "loaded_paths", lambda: dict(paths))
    monkeypatch.setattr(_build, "build_log", lambda name: PTXAS)


def test_profile_boundary_records_every_library(tmp_path, monkeypatch):
    _fake_libs(monkeypatch, tmp_path, {"lstm_fwd": b"\x7fELF fwd", "lstm_stack_bwd": b"bwd"})
    assert attrib.profile_boundary("compile:multi_step") is None      # telemetry off
    run = tmp_path / "run"
    with obs_pkg.session(run):
        profs = attrib.profile_boundary("compile:multi_step", flops=1.5e9)
        attrib.profile_boundary("compile:multi_step", flops=1.5e9)    # same digests: dedup
    names = [p["name"] for p in profs]
    assert names == ["compile:multi_step:lstm_fwd", "compile:multi_step:lstm_stack_bwd",
                     "compile:multi_step"]
    import hashlib
    assert profs[0]["hlo_sha256"] == hashlib.sha256(b"\x7fELF fwd").hexdigest()
    assert profs[0]["hlo_bytes"] == 8 and profs[0]["cost"] is None
    assert profs[0]["memory"]["registers_max"] == 128
    assert profs[-1]["cost"] == {"flops": 1.5e9} and profs[-1]["hlo_bytes"] == 11
    programs = json.loads((run / "run.json").read_text())["programs"]
    assert sorted(programs) == sorted(names) and all(len(v) == 1 for v in programs.values())
    events = [r for r in _records(run) if r.get("name") == attrib.PROGRAM_EVENT]
    assert [e["program"] for e in events] == names * 2
    # the JAX package's explain reads the port's fingerprints
    theirs = jexplain.run_evidence(run)["programs"]
    assert {k: [p["hlo_sha256"] for p in v] for k, v in theirs.items()} == \
        {p["name"]: [p["hlo_sha256"]] for p in profs}


def test_profile_boundary_never_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "loaded_paths", lambda: {"gone": str(tmp_path / "missing.so")})
    with obs_pkg.session(tmp_path / "run"):
        assert attrib.profile_boundary("compile:x") is None


def test_nvcc_runs_count_as_backend_compiles(tmp_path, monkeypatch):
    """A stand-in compiler writes the library: each build is one
    ``backend_compiles`` step in the stream, a warm cache none."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'lib')\nprint('ptxas info    : Used 8 registers')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "cuda")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    before = _build.compiles()
    run = tmp_path / "run"
    with obs_pkg.session(run):
        with _build._lock:
            _build._build_locked(["lstm_fwd", "weight_sum"])
            _build._build_locked(["lstm_fwd"])            # cached: no compile
    assert _build.compiles() - before == 2
    counters = [r for r in _records(run) if r.get("name") == "backend_compiles"]
    assert [(c["value"], c["delta"]) for c in counters] == [(2, 2)]
    assert report.summarize(run)["backend_compiles"] == 2
    assert _build.build_log("weight_sum").startswith("ptxas info")


# ------------------------------------------------ obs on = obs off, bit for bit
def _gan_cfg():
    return ExperimentConfig(
        model=ModelConfig(family="mtss_wgan_gp", features=4, window=8, hidden=8),
        train=TrainConfig(epochs=6, batch_size=4, n_critic=2, steps_per_call=2, seed=3))


def test_training_bit_identical_with_attribution_on(tmp_path):
    ds = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 8, 4))
                          .astype(np.float32))
    off = GanTrainer(_gan_cfg(), ds, device="cpu")
    off.train()
    with obs_pkg.session(tmp_path / "run"):
        on = GanTrainer(_gan_cfg(), ds, device="cpu")
        on.train()
    assert off.history == on.history
    for (ka, a), (kb, b) in zip(off.state.generator.state_dict().items(),
                                on.state.generator.state_dict().items()):
        assert ka == kb and torch.equal(a, b)
    recs = _records(tmp_path / "run")
    assert any(r.get("name") == "program_profile" and r.get("program") == "compile:multi_step"
               and r.get("cost") == {"flops": on._block_flops()} for r in recs)
    windows = [r for r in recs if r.get("name") == "timeline_window"]
    assert windows and all(w["drive"] == "gan_block" for w in windows)


def test_ae_chunk_drive_bit_identical_and_attributed(tmp_path):
    xs = scaled_panel(40, 4, seed=5)
    cfg = AEConfig(n_factors=4, latent_dim=3, epochs=12, batch_size=16, patience=50, seed=1,
                   chunk_epochs=2)
    runs = []
    for on in (False, True):
        for db in (True, False):
            c = dataclasses.replace(cfg, double_buffer=db)
            with obs_pkg.session(tmp_path / f"run{on}{db}" if on else None):
                runs.append(sweep_autoencoders_chunked(1, xs, c, [1, 2, 3], device="cpu"))
    (a, sa), (b, sb) = runs[0], runs[2]
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert torch.equal(a.train_loss, b.train_loss) and torch.equal(a.stop_epoch, b.stop_epoch)
    assert sa == sb
    (c_, _), (d, _) = runs[1], runs[3]
    assert all(torch.equal(c_.params[k], d.params[k]) for k in c_.params)
    for db in (True, False):
        gauges = _gauges(tmp_path / f"runTrue{db}")
        names = {g["name"] for g in gauges}
        assert names == {"attrib/dispatch_ms", "attrib/compute_ms", "attrib/dispatch_frac"}
        assert all(np.isfinite(g["value"]) and g["step"] == "ae_chunk" for g in gauges)
        windows = [r for r in _records(tmp_path / f"runTrue{db}")
                   if r.get("name") == "timeline_window" and r.get("drive") == "ae_chunk"]
        assert windows and windows[0]["warmup"]
    assert attrib.window_calls() == 0                # the last chunk did not bleed out


def test_attrib_imports_no_jax():
    import subprocess
    code = ("import sys, hfrep_tpu_torch.obs.attrib\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hfrep_tpu')))")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(root)))
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr
