#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hfrep_tpu_torch``) on one card.

    python3 chip_smoke.py [--out results.json]

Imports nothing of JAX or of the JAX package.  Phases, each of which
exits non-zero on failure:

1. build   — every ``hfrep_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
             one process per source, started together; prints ptxas's
             registers, shared memory and spills per kernel;
2. parity  — each kernel against its plain PyTorch version on the card,
             at the serving shapes (W, F) in {(48, 35), (168, 36)}, H=100,
             B in {8, 64}, activations sigmoid/tanh/linear, float32 and
             bf16 operand streams; bars: f32 atol 2e-5 (the dot sums in
             another order than torch.matmul), bf16 atol 1e-2 (an h that
             rounds differently to bf16 feeds the next step);
3. server  — the main path: ``ReplicationServer`` on ``cuda`` with the
             fixture AE head and the ``mtss_wgan_gp`` generator, then the
             ``mtss_wgan_gp_prod`` one: start, ``warm_server`` (the program
             grid plus one real batch per path), 64 requests through
             ``drive_load(..., sample_every=2)``, drain.  Launch counts
             are set to 0 just before each and read just after; every
             request must end in a result, every answer be finite and
             shaped, the kernel must have launched, and answers must agree
             with the same models run through the plain path on the CPU;
4. timing  — CUDA events over many launches after warm-up, at the shapes
             the server gives the kernel, beside its bound (bytes over
             3.35 TB/s, operations over the card's peak for their type),
             the plain version and cuDNN's LSTM (``library_ms``: tanh,
             same weights, input projection included; timed here only,
             never called by the port);
5. profile — ``torch.profiler`` over 20 sample dispatches per preset:
             device time by kernel name and the device's busy share.

The last lines are the card's name and power limit, one JSON object
listing each ported kernel, and ``{"ok": true, "device": {...}}``.
TF32 is off for matmuls and cuDNN, so every float32 product is full
float32.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
SHAPES = ((48, 35), (168, 36))                  # (W, F): headline, production
HIDDEN = 100
BARS = {"float32": 2e-5, "bfloat16": 1e-2}
ACTS = ("sigmoid", "tanh", "linear")
TPU_KERNEL = "hfrep_tpu/ops/pallas_lstm.py:168"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str = "") -> None:
    print(msg, flush=True)


def card_line(torch) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or f"{torch.cuda.get_device_name(0)}, power limit not readable"


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phases
def phase_build(_build) -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s: "
        f"{', '.join(sorted(logs))}")
    for name, log in sorted(logs.items()):
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                t = re.search(r"kernelI(.+?)Li(\d)E", entry)
                entry = f"{t.group(1)},act={t.group(2)}" if t else entry
            elif "registers" in line or "spill" in line:
                say(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}")


def lstm_inputs(torch, w, f, b, act, dtype, seed):
    """xz and rec as the server makes them: a Keras-initialised layer's
    projection of standard-normal noise."""
    from hfrep_tpu_torch.ops.lstm import KerasLSTM

    g = torch.Generator()
    g.manual_seed(seed)
    layer = KerasLSTM(f, HIDDEN, activation=act, device="cuda", generator=g)
    x = torch.randn((b, w, f), generator=g).cuda()
    with torch.no_grad():
        xz = (x.reshape(b * w, f) @ layer.kernel + layer.bias).reshape(b, w, 4 * HIDDEN)
        xz = xz.transpose(0, 1).contiguous().to(dtype)
        rec = layer.recurrent_kernel.detach().to(dtype).contiguous()
    return layer, x, xz, rec


def phase_parity(torch, cuda_lstm) -> dict:
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for w, f in SHAPES:
        for b in (8, 64):
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, xz, rec = lstm_inputs(torch, w, f, b, act, dtype,
                                                seed=w + b)
                    with torch.no_grad():
                        hs = cuda_lstm.lstm_fwd_cuda(xz, rec, act)
                        ref = cuda_lstm.lstm_seq_plain(xz, rec, act)
                    torch.cuda.synchronize()
                    if hs.shape != ref.shape or not torch.isfinite(hs).all():
                        fail(f"kernel output not finite/shaped at W={w} B={b} {act} {name}")
                    err = float((hs - ref).abs().max())
                    worst[name] = max(worst[name], err)
                    say(f"[parity] lstm_fwd W={w:3d} B={b:2d} {act:7s} {name:8s} "
                        f"max|kernel-plain| = {err:.3e} (limit {BARS[name]:.0e})")
                    if not err <= BARS[name]:
                        fail(f"kernel disagrees with its plain version: {err} > "
                             f"{BARS[name]} at W={w} B={b} {act} {name}")
    return worst


def check_answers(torch, np, srv, futures, panels, preset_cfg) -> None:
    """Every answer finite and shaped; a few held against the plain path
    of the same models on the CPU."""
    from hfrep_tpu_torch.serve import aot

    w, f = preset_cfg.window, preset_cfg.features
    n_rep = 0
    for j, fut in enumerate(futures):
        value = fut.result().value
        if "windows" in value:
            win = value["windows"]
            if win.shape != (1, w, f) or not np.isfinite(win).all():
                fail(f"sample answer {j}: shape {win.shape}, finite "
                     f"{bool(np.isfinite(win).all())}")
        else:
            rec = value["reconstruction"]
            p = panels[j % len(panels)]
            if rec.shape != p.shape or not np.isfinite(rec).all():
                fail(f"replicate answer {j}: shape {rec.shape}")
            n_rep += 1
    # replicate: the served answer against the head run on the CPU
    ae_cpu = aot.AEServeModel(cfg=srv.ae_model.cfg,
                              module=copy.deepcopy(srv.ae_model.module).cpu(),
                              decoder_host=srv.ae_model.decoder_host)
    for j in (0, 2):
        p = panels[j % len(panels)]
        x, n = aot.pad_panel_batch([p], 1, aot.bucket_for(p.shape[0], srv.cfg.row_buckets),
                                   p.shape[1], device="cpu")
        recon, _ = aot.ae_batch_fn(ae_cpu)(x, n, aot.full_mask(ae_cpu.cfg, device="cpu"))
        got = futures[j].result().value["reconstruction"]
        err = float(np.max(np.abs(got - recon[0, : p.shape[0]].numpy())))
        if not err <= 1e-5:
            fail(f"replicate answer {j} differs from the CPU head by {err}")
    # sample: the generator on the card (kernel) and on the CPU (plain)
    gen_cpu = aot.GenServeModel(cfg=srv.gen_model.cfg,
                                module=copy.deepcopy(srv.gen_model.module).cpu())
    g = torch.Generator()
    g.manual_seed(11)
    noise = torch.randn((8, w, f), generator=g)
    on_card = aot.gen_batch_fn(srv.gen_model)(noise.cuda()).cpu()
    on_cpu = aot.gen_batch_fn(gen_cpu)(noise)
    err = float((on_card - on_cpu).abs().max())
    say(f"[server] {preset_cfg.family} W={w}: {n_rep} replicate answers checked; "
        f"generator on card vs CPU plain path max|diff| = {err:.3e} (limit 1e-4)")
    if not err <= 1e-4:
        fail(f"generator on the card differs from the CPU plain path by {err}")


def phase_server(torch, np, cuda_lstm) -> dict:
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.serve.fixture import fixture_server, warm_server
    from hfrep_tpu_torch.serve.loadgen import drive_load, make_panels
    from hfrep_tpu_torch.serve.server import ServeConfig

    panels = make_panels(0, 22, (12, 48, 96, 200))
    out = {"launches": 0, "runs": []}
    for preset in ("mtss_wgan_gp", "mtss_wgan_gp_prod"):
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        srv = fixture_server(ServeConfig(), preset=preset, device="cuda")
        programs = warm_server(srv, panels)     # program grid + one batch per path
        report = drive_load(srv, 64, panels, sample_every=2, timeout_ms=30000,
                            keep_futures=True)
        doc = srv.drain(timeout=60)
        torch.cuda.synchronize()
        launches = cuda_lstm.launches
        wall = time.perf_counter() - t0
        futures = report.pop("futures")
        say(f"[server] {preset}: {programs} programs warmed; submitted "
            f"{report['submitted']}, terminal {report['terminal']}, results "
            f"{report['results']}, worker faults {doc['worker_faults']}; "
            f"p50 {report['p50_ms']:.3f} ms, p95 {report['p95_ms']:.3f} ms, "
            f"{report['qps']} req/s; lstm_fwd launches {launches}; {wall:.1f} s")
        if not (report["terminal"] == report["submitted"] == 64
                and doc["terminal"] == doc["submitted"]):
            fail(f"{preset}: terminal != submitted ({report}, {doc})")
        if report["results"] != 64 or doc["results"] != doc["submitted"]:
            fail(f"{preset}: not every request got a result ({report}, {doc})")
        if launches < 1:
            fail(f"{preset}: the server ran no lstm_fwd kernel")
        check_answers(torch, np, srv, futures, panels, get_preset(preset).model)
        out["launches"] += launches
        out["runs"].append({"preset": preset, "launches": launches,
                            "p50_ms": report["p50_ms"], "p95_ms": report["p95_ms"],
                            "qps": report["qps"], "results": report["results"]})
    return out


def bound_ms(w, b, h, dtype_name) -> tuple:
    item = 4 if dtype_name == "float32" else 2
    nbytes = (w * b * 4 * h + h * 4 * h) * item + w * b * h * 4
    ops = 2 * w * b * h * 4 * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(torch, cuda_lstm) -> list:
    rows = []
    for w, f in SHAPES:
        for b in (8, 64):
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                layer, x, xz, rec = lstm_inputs(torch, w, f, b, "sigmoid", dtype, seed=1)
                with torch.no_grad():
                    kernel = time_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "sigmoid"), 200)
                    plain = time_ms(torch, lambda: cuda_lstm.lstm_seq_plain(xz, rec, "sigmoid"), 5, 1)
                    kx = layer.kernel.to(dtype)
                    kb = layer.bias.to(dtype)
                    xd = x.to(dtype)

                    def with_projection():
                        z = (xd.reshape(b * w, f) @ kx + kb).reshape(b, w, 4 * HIDDEN)
                        cuda_lstm.lstm_fwd_cuda(z.transpose(0, 1).contiguous(), rec, "sigmoid")

                    kernel_proj = time_ms(torch, with_projection, 200)
                    library = None
                    if name == "float32":
                        lstm = torch.nn.LSTM(f, HIDDEN).cuda()
                        lstm.weight_ih_l0.copy_(layer.kernel.T)
                        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
                        lstm.bias_ih_l0.copy_(layer.bias)
                        lstm.bias_hh_l0.zero_()
                        xt = x.transpose(0, 1).contiguous()
                        library = time_ms(torch, lambda: lstm(xt), 200)
                bnd, by = bound_ms(w, b, HIDDEN, name)
                row = {"W": w, "F": f, "B": b, "dtype": name, "ms": kernel,
                       "ms_with_projection": kernel_proj, "plain_ms": plain,
                       "library_ms": library, "bound_ms": bnd, "bound_by": by}
                rows.append(row)
                lib_s = "n/a" if library is None else f"{library:.4f}"
                say(f"[timing] lstm_fwd W={w:3d} B={b:2d} {name:8s}: kernel {kernel:.4f} ms "
                    f"(+projection {kernel_proj:.4f}), plain {plain:.3f} ms, "
                    f"cuDNN LSTM {lib_s} ms, bound {bnd:.5f} ms ({by})")
    return rows


def phase_profile(torch) -> list:
    """``torch.profiler`` over 20 sample dispatches of the generator at
    the served batch (bucket 8), per preset: device time by kernel name
    and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    from hfrep_tpu_torch.serve import aot
    from hfrep_tpu_torch.serve.fixture import fixture_gen_model

    out = []
    for preset in ("mtss_wgan_gp", "mtss_wgan_gp_prod"):
        model = fixture_gen_model(preset, device="cuda")
        fn = aot.gen_batch_fn(model)
        w, f = model.cfg.window, model.cfg.features
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        noises = [torch.randn((8, w, f), generator=g, device="cuda") for _ in range(20)]
        for z in noises[:3]:
            fn(z).cpu()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for z in noises:
                fn(z).cpu()                      # the server copies each answer out
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
        busy_us = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row = {"preset": preset, "dispatches": len(noises), "wall_us": wall_us,
               "device_busy_us": busy_us,
               "busy_share": busy_us / wall_us if busy_us else None,
               "top": [{"name": k[:80], "us": v} for k, v in top]}
        out.append(row)
        if not busy_us:
            say(f"[profile] {preset}: the profiler reported no device time (not measured)")
            continue
        say(f"[profile] {preset}: 20 dispatches at B=8 in {wall_us:.0f} us, device busy "
            f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}% of the window)")
        for k, v in top:
            say(f"[profile]   {v:9.1f} us  {100 * v / busy_us:5.1f}%  {k[:80]}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test runs on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hfrep_tpu_torch.ops import _build, cuda_lstm
    except ImportError as e:
        fail(f"the port (hfrep_tpu_torch) is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line(torch)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    say("TF32 off for matmuls and cuDNN: every float32 product is full float32")

    t0 = time.perf_counter()
    phase_build(_build)
    worst = phase_parity(torch, cuda_lstm)
    server = phase_server(torch, np, cuda_lstm)
    timing = phase_timing(torch, cuda_lstm)
    profiled = phase_profile(torch)
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s on {card}")

    head = next(r for r in timing if r["W"] == 48 and r["B"] == 8 and r["dtype"] == "float32")
    kernels = {"kernels": [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "hfrep_tpu_torch/csrc/lstm_fwd.cu", "replaces": TPU_KERNEL,
        "launches": server["launches"], "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": "W=48 B=8 H=100 float32"}]}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": kernels["kernels"], "server": server,
                       "timing": timing, "parity_max_abs_err": worst,
                       "profile": profiled}, fh, indent=1)
    say(card)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
