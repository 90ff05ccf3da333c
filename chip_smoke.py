#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hfrep_tpu_torch``) on one card.

    python3 chip_smoke.py [--out results.json]

Imports nothing of JAX or of the JAX package.  Phases, each of which
exits non-zero on failure:

1. build   — every ``hfrep_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
             one process per source, started together; prints ptxas's
             registers and spills per kernel, and the dynamic shared
             memory each LSTM kernel asks for at H=100;
2. parity  — the forward kernel (primal mode) against its plain PyTorch
             version on the card, at the serving shapes (W, F) in
             {(48, 35), (168, 36)}, H=100, B in {8, 64}, activations
             sigmoid/tanh/linear, float32 and bf16 operand streams; bars:
             f32 atol 2e-5 (the dot sums in another order than
             torch.matmul), bf16 atol 1e-2 (an h that rounds differently to
             bf16 feeds the next step);
   grad    — the forward kernel's with_cs mode, the backward kernel (plain,
             dcs and with_carries modes) and the adjoint kernel against
             their plain versions, at the epoch's shapes W in {48, 168},
             H=100, B in {32, 64}, every activation, float32 and bf16; the
             error is max|kernel - plain| / max(1, max|plain|) over every
             output; bars: f32 1e-4 (drec and urec are sums over up to
             W*B = 10,752 rows, taken in another order), bf16 1e-2 (as the
             forward);
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
5. train   — the slice-2 main path: for ``mtss_wgan_gp`` and
             ``mtss_wgan_gp_prod`` at full width (H=100), float32, batch
             32, n_critic 5, on a seeded uniform dataset of 1,000 windows:
             ``init_gan_state`` then ``make_multi_step`` for 3 epochs, with
             every launch count set to 0 just before and read just after;
             the losses must be finite and every kernel must have launched.
             Then 3 more epochs timed (host clock around synchronised
             work), one epoch under ``torch.profiler``, and one epoch on the
             card against the same epoch — same state, same draws — through
             the plain path on the CPU: d_loss and g_loss rtol 1e-4, every
             param atol 1e-5 + rtol 1e-4 (the JAX package's bar for its
             kernel-vs-scan epoch);
6. timing  — CUDA events for each kernel at the served shapes, beside its
             bound, its plain version and ``library_ms`` (cuDNN's LSTM at
             tanh: the forward in training mode for with_cs, backward =
             forward-and-backward minus forward for lstm_bwd; none for the
             adjoint: no PyTorch call computes it, the cuDNN RNN has no
             double backward);
7. profile — ``torch.profiler`` over 20 sample dispatches per preset:
             device time by kernel name and the device's busy share.

The last lines are the card's name and power limit, one JSON object
listing each ported kernel, and ``{"ok": true, "device": {...}}``.
TF32 is off for matmuls and cuDNN, so every float32 product is full
float32.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
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
GRAD_BARS = {"float32": 1e-4, "bfloat16": 1e-2}   # scaled by max(1, max|plain|)
ACTS = ("sigmoid", "tanh", "linear")
TPU_KERNEL = "hfrep_tpu/ops/pallas_lstm.py:168"
TPU_KERNELS = {"lstm_fwd": TPU_KERNEL, "lstm_fwd_cs": TPU_KERNEL,
               "lstm_bwd": "hfrep_tpu/ops/pallas_lstm.py:263",
               "lstm_adj": "hfrep_tpu/ops/pallas_lstm.py:415"}
SOURCES = {"lstm_fwd": "lstm_fwd.cu", "lstm_fwd_cs": "lstm_fwd.cu",
           "lstm_bwd": "lstm_bwd.cu", "lstm_adj": "lstm_adj.cu"}
TRAIN_PRESETS = ("mtss_wgan_gp", "mtss_wgan_gp_prod")
TRAIN_EPOCHS = 3
TRAIN_BATCHES = (32, 64)        # penalty and generator passes; critic scores (2B)


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
def entry_name(mangled: str) -> str:
    """A readable name for a kernel's mangled entry: base<dtype,act,mode>."""
    m = re.search(r"(lstm_(?:fwd|bwd|adj)_kernel)I(f|13__nv_bfloat16)Li(\d)E(?:Lb(\d)E)?",
                  mangled)
    if m:
        mode = {None: "", "0": ",primal", "1": ",with_cs"}[m.group(4)]
        return f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'},act={m.group(3)}{mode}>"
    m = re.search(r"outer_sum_partialILi(\d)E", mangled)
    if m:
        return f"outer_sum_partial<{m.group(1)}>"
    return "sum_splits" if "sum_splits" in mangled else mangled


def phase_build(torch, _build, cuda_lstm) -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s: "
        f"{', '.join(sorted(logs))}")
    for name, log in sorted(logs.items()):
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = entry_name(m.group(1))
            elif "registers" in line or "spill" in line:
                say(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}")
    for kernel in ("lstm_fwd", "lstm_bwd", "lstm_adj"):
        sm = {n: cuda_lstm.smem_bytes(HIDDEN, dt, 1, kernel)
              for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        say(f"[build] {kernel}: dynamic shared memory at H={HIDDEN}, one row a block: "
            f"{sm['f32']} B f32, {sm['bf16']} B bf16 (+{cuda_lstm.smem_bytes(HIDDEN, torch.float32, 2, kernel) - sm['f32']} B a further row)")


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


def scaled_err(got, ref) -> float:
    """max|got - ref| / max(1, max|ref|)."""
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.abs().max()))


def phase_grad_parity(torch, cuda_lstm) -> dict:
    """Kernel 1 with_cs, kernel 2 (plain, dcs, with_carries) and kernel 3
    against their plain versions on the same inputs: the forward's from
    ``lstm_inputs``, hs and cs from the kernel, seeded cotangents."""
    names = ("lstm_fwd_cs", "lstm_bwd", "lstm_adj")
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    worst_abs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    h = HIDDEN
    for w, f in SHAPES:
        for b in TRAIN_BATCHES:
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, xz, rec = lstm_inputs(torch, w, f, b, act, dtype, seed=w + b + 1)
                    g = torch.Generator(device="cuda")
                    g.manual_seed(w * b)
                    rnd = lambda *shape: 0.3 * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
                    with torch.no_grad():
                        hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs=True)
                        errs = {"lstm_fwd_cs": list(zip(
                            (hs, cs), cuda_lstm.lstm_seq_plain(xz, rec, act, with_cs=True)))}
                        dhs, dcs = rnd(w, b, h), rnd(w, b, h)
                        errs["lstm_bwd"] = []
                        for dcs_, carries in ((None, False), (dcs, False), (None, True)):
                            errs["lstm_bwd"] += list(zip(
                                cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, dcs_, act, carries),
                                cuda_lstm.lstm_bwd_plain(xz, rec, hs, cs, dhs, dcs_, act, carries)))
                        _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None,
                                                                 act, True)
                        u, v = rnd(w, b, 4 * h), rnd(h, 4 * h)
                        errs["lstm_adj"] = list(zip(
                            cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, dhT, dcT, u, v, act),
                            cuda_lstm.lstm_adj_plain(xz, rec, hs, cs, dhT, dcT, u, v, act)))
                    torch.cuda.synchronize()
                    line = []
                    for k, pairs in errs.items():
                        for got, ref in pairs:
                            if got.shape != ref.shape or not torch.isfinite(got).all():
                                fail(f"{k} output not finite/shaped at W={w} B={b} {act} {name}")
                        err = max(scaled_err(a, r) for a, r in pairs)
                        worst[k][name] = max(worst[k][name], err)
                        worst_abs[k][name] = max(worst_abs[k][name], max(
                            float((a - r).abs().max()) for a, r in pairs))
                        line.append(f"{k} {err:.2e}")
                        if not err <= GRAD_BARS[name]:
                            fail(f"{k} disagrees with its plain version: {err} > "
                                 f"{GRAD_BARS[name]} at W={w} B={b} {act} {name}")
                    say(f"[grad] W={w:3d} B={b:2d} {act:7s} {name:8s} scaled max err: "
                        f"{', '.join(line)} (limit {GRAD_BARS[name]:.0e})")
    return {"scaled": worst, "abs": worst_abs}


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


def device_time_by_name(prof) -> dict:
    """Device time by kernel name, from the device's own events only: a
    CPU-side op (``aten::mul``, an autograd node) also reports the device
    time of the kernels it launched, and summing both counts them twice."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us
    return by_name


def profile_epoch(torch, step, state, draws) -> dict:
    """One epoch under ``torch.profiler``: device time by kernel name and
    the device's busy share of the epoch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, draws)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_time_by_name(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "busy_share": busy_us / wall_us if busy_us else None,
            "top": [{"name": k[:80], "us": v} for k, v in top]}


def epoch_parity(torch, mcfg, tcfg, pair, dataset, state, draws) -> dict:
    """One epoch on the card and the same epoch — a copy of the state, the
    same draws — through the plain path on the CPU."""
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.train import Draws, make_train_step

    cpu_state = state.to("cpu")
    cpu_draws = Draws(*(None if t is None else t.cpu()
                        for t in (draws.idx, draws.noises, draws.alphas)))
    state, m = make_train_step(pair, tcfg, dataset)(state, draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cpu_pair = build_gan(mcfg, device="cpu")
    cpu_state, mc = make_train_step(cpu_pair, tcfg, dataset.cpu())(cpu_state, cpu_draws)
    cpu_s = time.perf_counter() - t0
    rel = {k: abs(float(m[k]) - float(mc[k])) / max(abs(float(mc[k])), 1e-30)
           for k in ("d_loss", "g_loss")}
    worst, worst_at, max_diff = 0.0, None, 0.0
    for net, card_mod, cpu_mod in (("g", state.generator, cpu_state.generator),
                                   ("d", state.discriminator, cpu_state.discriminator)):
        for (n, a), (_, r) in zip(card_mod.named_parameters(), cpu_mod.named_parameters()):
            diff = (a.detach().cpu() - r.detach()).abs()
            ratio = float((diff / (1e-5 + 1e-4 * r.detach().abs())).max())
            max_diff = max(max_diff, float(diff.max()))
            if ratio > worst:
                worst, worst_at = ratio, f"{net}.{n}"
    return {"d_loss": float(m["d_loss"]), "d_loss_cpu": float(mc["d_loss"]),
            "g_loss": float(m["g_loss"]), "g_loss_cpu": float(mc["g_loss"]),
            "loss_rel_diff": rel, "param_max_abs_diff": max_diff,
            "param_worst_ratio": worst, "param_worst_at": worst_at, "cpu_epoch_s": cpu_s,
            "ok": all(v <= 1e-4 for v in rel.values()) and worst <= 1.0}


def phase_train(torch, cuda_lstm) -> list:
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.train import (init_gan_state, make_multi_step,
                                       make_train_step, sample_draws)

    out = []
    for k, preset in enumerate(TRAIN_PRESETS):
        cfg = get_preset(preset)
        mcfg = cfg.model
        tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5,
                                   steps_per_call=TRAIN_EPOCHS)
        w = mcfg.window
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + k)
        dataset = torch.rand((1000, w, mcfg.features), generator=g, device="cuda")
        pair = build_gan(mcfg, device="cuda")
        state = init_gan_state(k, mcfg, device="cuda")
        multi = make_multi_step(pair, tcfg, dataset)
        torch.cuda.synchronize()
        cuda_lstm.reset_launches()
        t0 = time.perf_counter()
        state, metrics = multi(state, generator=g)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = cuda_lstm.launch_counts()
        d_loss, g_loss = metrics["d_loss"].cpu(), metrics["g_loss"].cpu()
        if d_loss.shape != (TRAIN_EPOCHS,) or not (torch.isfinite(d_loss).all()
                                                   and torch.isfinite(g_loss).all()):
            fail(f"{preset}: losses not finite/shaped: {d_loss}, {g_loss}")
        idle = [n for n, c in launches.items() if c < 1]
        if idle:
            fail(f"{preset}: the training epochs launched no {idle} kernel ({launches})")
        per_epoch = {n: c / TRAIN_EPOCHS for n, c in launches.items()}
        say(f"[train] {preset} W={w}: {TRAIN_EPOCHS} epochs in {first_s:.2f} s; d_loss "
            f"{[round(float(x), 5) for x in d_loss]}, g_loss {[round(float(x), 5) for x in g_loss]}; "
            f"launches per epoch: " + ", ".join(f"{n} {c:g}" for n, c in per_epoch.items()))
        t0 = time.perf_counter()
        state, _ = multi(state, generator=g)
        torch.cuda.synchronize()
        ms_epoch = (time.perf_counter() - t0) / TRAIN_EPOCHS * 1e3
        one = dataclasses.replace(tcfg, steps_per_call=1)
        prof = profile_epoch(torch, make_train_step(pair, one, dataset), state,
                             sample_draws(g, pair, one, dataset))
        parity = epoch_parity(torch, mcfg, one, pair, dataset, state,
                              sample_draws(g, pair, one, dataset))
        busy = ("not measured" if not prof["device_busy_us"] else
                f"device busy {prof['device_busy_us']:.0f} of {prof['wall_us']:.0f} us "
                f"({100 * prof['busy_share']:.1f}%)")
        say(f"[train] {preset} W={w}: {ms_epoch:.2f} ms/epoch over {TRAIN_EPOCHS} epochs "
            f"(host clock, synchronised); profiled epoch: {busy}")
        for row in prof["top"]:
            share = 100 * row["us"] / prof["device_busy_us"]
            say(f"[train]   {row['us']:9.1f} us  {share:5.1f}%  {row['name']}")
        say(f"[train] {preset} W={w}: one epoch, card vs CPU plain path: d_loss "
            f"{parity['d_loss']:.7g} vs {parity['d_loss_cpu']:.7g} (rel {parity['loss_rel_diff']['d_loss']:.2e}), "
            f"g_loss {parity['g_loss']:.7g} vs {parity['g_loss_cpu']:.7g} "
            f"(rel {parity['loss_rel_diff']['g_loss']:.2e}; limit 1e-4); params max|diff| "
            f"{parity['param_max_abs_diff']:.2e}, worst |diff|/(1e-5+1e-4|cpu|) "
            f"{parity['param_worst_ratio']:.3f} at {parity['param_worst_at']} (limit 1); "
            f"CPU epoch {parity['cpu_epoch_s']:.1f} s")
        if not parity["ok"]:
            fail(f"{preset}: the card's epoch differs from the CPU plain path: {parity}")
        out.append({"preset": preset, "W": w, "F": mcfg.features, "launches": launches,
                    "launches_per_epoch": per_epoch, "d_loss": d_loss.tolist(),
                    "g_loss": g_loss.tolist(), "first_epochs_s": first_s,
                    "ms_per_epoch": ms_epoch, "profile": prof, "parity": parity})
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


def grad_bounds(w, b, h, dtype_name) -> dict:
    """Least time for each new kernel at (W, B, H): each input read once,
    each output written once, over 3.35 TB/s; each product of 2*W*B*H*4H
    over the peak for its operands' type (products with rec are in the
    operand dtype, products with v and the drec/urec sums in float32)."""
    item = 4 if dtype_name == "float32" else 2
    seq, g32 = w * b * h * 4, w * b * 4 * h * 4
    xzb, recb, mat32 = w * b * 4 * h * item, 4 * h * h * item, 4 * h * h * 4
    prod = 2 * w * b * h * 4 * h
    peak, f32 = PEAK_OPS_PER_S[dtype_name], PEAK_OPS_PER_S["float32"]
    work = {"lstm_fwd_cs": (xzb + recb + 2 * seq, prod / peak),
            "lstm_bwd": (xzb + recb + 3 * seq + g32 + mat32, 2 * prod / peak + prod / f32),
            "lstm_adj": (xzb + recb + mat32 + 4 * seq + 2 * g32 + 3 * seq + mat32,
                         3 * prod / peak + 4 * prod / f32)}
    out = {}
    for k, (nbytes, t_ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[k] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_grad_timing(torch, cuda_lstm) -> list:
    rows = []
    h = HIDDEN
    for w, f in SHAPES:
        for b in TRAIN_BATCHES:
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                layer, x, xz, rec = lstm_inputs(torch, w, f, b, "tanh", dtype, seed=3)
                g = torch.Generator(device="cuda")
                g.manual_seed(4)
                with torch.no_grad():
                    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs=True)
                    dhs = 0.3 * torch.randn((w, b, h), generator=g, device="cuda")
                    _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None,
                                                             "tanh", True)
                    u = 0.3 * torch.randn((w, b, 4 * h), generator=g, device="cuda")
                    v = 0.3 * torch.randn((h, 4 * h), generator=g, device="cuda")
                    calls = {
                        "lstm_fwd_cs": (
                            lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs=True),
                            lambda: cuda_lstm.lstm_seq_plain(xz, rec, "tanh", with_cs=True)),
                        "lstm_bwd": (
                            lambda: cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, dhs, None, "tanh"),
                            lambda: cuda_lstm.lstm_bwd_plain(xz, rec, hs, cs, dhs, None, "tanh")),
                        "lstm_adj": (
                            lambda: cuda_lstm.lstm_adj_cuda(xz, rec, hs, cs, dhT, dcT, u, v, "tanh"),
                            lambda: cuda_lstm.lstm_adj_plain(xz, rec, hs, cs, dhT, dcT, u, v,
                                                             "tanh"))}
                    times = {k: (time_ms(torch, kern, 50), time_ms(torch, plain, 2, 1))
                             for k, (kern, plain) in calls.items()}
                    # the primal at the same shape and activation, beside with_cs
                    primal = time_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh"), 50)
                library = {"lstm_fwd_cs": None, "lstm_bwd": None, "lstm_adj": None}
                if name == "float32":
                    lstm = torch.nn.LSTM(f, h).cuda()
                    with torch.no_grad():
                        lstm.weight_ih_l0.copy_(layer.kernel.T)
                        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
                        lstm.bias_ih_l0.copy_(layer.bias)
                        lstm.bias_hh_l0.zero_()
                    xt = x.transpose(0, 1).contiguous().requires_grad_(True)
                    gout = torch.randn((w, b, h), generator=g, device="cuda")

                    def fwd_bwd():
                        out, _ = lstm(xt)
                        out.backward(gout)

                    fwd = time_ms(torch, lambda: lstm(xt), 50)
                    library["lstm_fwd_cs"] = fwd
                    library["lstm_bwd"] = time_ms(torch, fwd_bwd, 50) - fwd
                bounds = grad_bounds(w, b, h, name)
                for k, (ms, plain) in times.items():
                    bnd, by = bounds[k]
                    rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": name,
                                 "ms": ms, "plain_ms": plain, "library_ms": library[k],
                                 "bound_ms": bnd, "bound_by": by})
                    lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
                    extra = ""
                    if k == "lstm_fwd_cs":
                        rows[-1]["primal_ms"] = primal
                        extra = f" (primal, same tanh: {primal:.4f})"
                    say(f"[timing] {k:11s} W={w:3d} B={b:2d} {name:8s}: kernel {ms:.4f} ms{extra}, "
                        f"plain {plain:.3f} ms, cuDNN {lib_s} ms, bound {bnd:.5f} ms ({by})")
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
        by_name = device_time_by_name(prof)
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
    phase_build(torch, _build, cuda_lstm)
    worst = phase_parity(torch, cuda_lstm)
    grad = phase_grad_parity(torch, cuda_lstm)
    server = phase_server(torch, np, cuda_lstm)
    train = phase_train(torch, cuda_lstm)
    timing = phase_timing(torch, cuda_lstm)
    grad_timing = phase_grad_timing(torch, cuda_lstm)
    profiled = phase_profile(torch)
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s on {card}")

    trained = {k: sum(r["launches"][k] for r in train) for k in TPU_KERNELS}
    head = next(r for r in timing if r["W"] == 48 and r["B"] == 8 and r["dtype"] == "float32")
    rows = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "hfrep_tpu_torch/csrc/lstm_fwd.cu", "replaces": TPU_KERNEL,
        "launches": server["launches"] + trained["lstm_fwd"],
        "launches_by_path": {"serve": server["launches"], "train": trained["lstm_fwd"]},
        "max_abs_err": worst["float32"], "max_abs_err_bf16": worst["bfloat16"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": "W=48 B=8 H=100 float32"}]
    for k in ("lstm_fwd_cs", "lstm_bwd", "lstm_adj"):
        r = next(x for x in grad_timing if x["kernel"] == k and x["W"] == 48
                 and x["B"] == 32 and x["dtype"] == "float32")
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": trained[k],
            "launches_by_path": {"train": trained[k]},
            "max_abs_err": grad["abs"][k]["float32"],
            "max_abs_err_bf16": grad["abs"][k]["bfloat16"],
            "max_scaled_err": grad["scaled"][k]["float32"],
            "max_scaled_err_bf16": grad["scaled"][k]["bfloat16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": "W=48 B=32 H=100 float32"})
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    kernels = {"kernels": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": rows, "server": server, "train": train,
                       "timing": timing, "grad_timing": grad_timing,
                       "parity_max_abs_err": worst, "grad_parity": grad,
                       "profile": profiled}, fh, indent=1)
    say(card)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
