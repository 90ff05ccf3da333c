#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``hfrep_tpu_torch``) on one card.

    python3 chip_smoke.py [--out results.json]

Imports nothing of JAX or of the JAX package.  Phases, each of which
exits non-zero on failure:

1. build   — every ``hfrep_tpu_torch/csrc/*.cu`` with ``nvcc`` for sm_90a,
             one process per source, started together; prints ptxas's
             registers and spills per kernel (and fails if an lstm_fwd
             instantiation spills), the forward's launch rule at H=100
             and at its wide widths, and the dynamic shared memory each
             LSTM kernel (single-layer and fused stack) asks for at H=100;
2. parity  — the forward kernel (primal mode) against its plain PyTorch
             version on the card, at the serving shapes (W, F) in
             {(48, 35), (168, 36)}, H=100, B in {8, 64}, activations
             sigmoid/tanh/linear, float32 and bf16 operand streams; bars:
             f32 atol 2e-5 (the dot sums in another order than
             torch.matmul), bf16 atol 1e-2 (an h that rounds differently to
             bf16 feeds the next step);
   layout  — the forward kernel's four modes (primal, with_cs, carry
             primal, carry with_cs) in its register layout at H=100,
             B=133 (two batch rows a block) and in its wide layout
             (H=120 f32, H=160 bf16; B 8 and 133), every activation,
             against the plain version at the bars below, each launched
             twice and bit-equal;
   grad    — the forward kernel's with_cs mode, the backward kernel (plain,
             dcs and with_carries modes) and the adjoint kernel against
             their plain versions, at the epoch's shapes W in {48, 168},
             H=100, B in {32, 64}, every activation, float32 and bf16; the
             error is max|kernel - plain| / max(1, max|plain|) over every
             output; bars: f32 1e-4 (drec and urec are sums over up to
             W*B = 10,752 rows, taken in another order), bf16 1e-2 (as the
             forward);
   carry   — (a) the carry modes of the single-layer kernels (forward
             carry primal and carry with_cs; backward carry0 alone, with
             dcs and with the per-step carries, each with dc_fin; adjoint
             carry with mu0) against their plain versions from a nonzero
             (h0, c0), at the grad phase's shapes, activations, dtypes and
             bars; (b) the carry path at full width: the W=168, B=32
             window as four chunks of 42 passing (h, c) through
             ``lstm_seq_carry``, forward, first order and the gp_like
             second order against the whole window (``lstm_seq`` from a
             zero start, the plain carry forward from a nonzero one) at
             the JAX suite's bars, with the launch counts set to 0 just
             before the chunked runs and exactly the four carry modes
             launched;
   stack   — the fused two-layer stack's kernels: the forward (primal and
             with_res), the backward (plain, direct cotangents,
             with_carries) and the adjoint against their plain versions,
             at the same shapes, activations, dtypes and bars;
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
5. train   — the training paths: for ``mtss_wgan_gp`` and
             ``mtss_wgan_gp_prod`` at full width (H=100), float32, batch
             32, n_critic 5, on a seeded uniform dataset of 1,000 windows,
             the critic on its default route (the fused stack, slice 3's
             main path): ``init_gan_state`` then ``make_multi_step`` for 3
             epochs, with every launch count set to 0 just before and read
             just after; the losses must be finite and exactly the route's
             kernels must have launched (``ROUTE_KERNELS``).  Then 3 more
             epochs timed (host clock around synchronised work), one epoch
             under ``torch.profiler``, and one epoch on the card against
             the same epoch — same state, same draws — through the plain
             path on the CPU: d_loss and g_loss rtol 1e-4, every param
             atol 1e-5 + rtol 1e-4 (the JAX package's bar for its
             kernel-vs-scan epoch).  The same for ``mtss_wgan_gp`` with
             the critic on the chained route (slice 2's path, which runs
             the single-layer adjoint);
6. timing  — CUDA events for each kernel at the served shapes, beside its
             bound, its plain version and ``library_ms`` (cuDNN's LSTM at
             tanh: the forward in training mode for with_cs, backward =
             forward-and-backward minus forward for lstm_bwd; none for the
             adjoint: no PyTorch call computes it, the cuDNN RNN has no
             double backward); each carry mode at W=48, B=32 beside its
             carry-free mode, its bound, its plain version and cuDNN's
             LSTM called with hx=(h0, c0); each stack kernel also beside
             the chained single-layer pair it replaces, its library the
             two-layer cuDNN LSTM;
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
               "lstm_adj": "hfrep_tpu/ops/pallas_lstm.py:415",
               "lstm_fwd_carry": TPU_KERNEL,
               "lstm_bwd_carry": "hfrep_tpu/ops/pallas_lstm.py:263",
               "lstm_adj_carry": "hfrep_tpu/ops/pallas_lstm.py:415",
               "stack_fwd": "hfrep_tpu/ops/pallas_lstm_stack.py:71",
               "stack_bwd": "hfrep_tpu/ops/pallas_lstm_stack.py:134",
               "stack_adj": "hfrep_tpu/ops/pallas_lstm_stack.py:250"}
SOURCES = {"lstm_fwd": "lstm_fwd.cu", "lstm_fwd_cs": "lstm_fwd.cu",
           "lstm_bwd": "lstm_bwd.cu", "lstm_adj": "lstm_adj.cu",
           "lstm_fwd_carry": "lstm_fwd.cu", "lstm_bwd_carry": "lstm_bwd.cu",
           "lstm_adj_carry": "lstm_adj.cu",
           "stack_fwd": "lstm_stack_fwd.cu", "stack_bwd": "lstm_stack_bwd.cu",
           "stack_adj": "lstm_stack_adj.cu"}
TRAIN_PRESETS = ("mtss_wgan_gp", "mtss_wgan_gp_prod")
#: batches whose forward layout the build phase prints; 133 is two rows a block
FWD_BATCHES = (8, 32, 64, 133)
#: (H, dtype) of the forward's wide layout: widths the register file cannot hold
WIDE_CASES = ((120, "float32"), (160, "bfloat16"))
TRAIN_EPOCHS = 3
TRAIN_BATCHES = (32, 64)        # penalty and generator passes; critic scores (2B)
#: the kernels each critic route's epoch must launch, and no others: the
#: generator's single-layer kernels, then the critic's fused stack
#: ("auto", slice 3) or its two chained single-layer LSTMs (slice 2)
ROUTE_KERNELS = {
    "auto": {"lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "stack_fwd_res", "stack_bwd",
             "stack_adj"},
    "chained": {"lstm_fwd", "lstm_fwd_cs", "lstm_bwd", "lstm_adj"},
}


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


def device_ms(torch, fn, iters: int, match: str = "lstm_fwd") -> float:
    """Mean device time, in ms, of one call of ``fn``, from
    ``torch.profiler``'s device events over ``iters`` calls.  With a
    ``match`` that names the one kernel a call launches, its time over
    its own count of events (so a window the profiler did not record
    whole is not read as a short one); with ``match=""``, every kernel of
    the calls over ``iters``.  A kernel shorter than its wrapper's host
    time leaves the card idle between back-to-back launches, and
    ``time_ms`` then measures the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, calls = 0.0, 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA or match not in ev.key:
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
        calls += ev.count
    calls = calls if match else iters
    return us / calls / 1e3 if us and calls else float("nan")


# ------------------------------------------------------------------ phases
#: the bool template flags of each kernel, in order
KERNEL_FLAGS = {"lstm_fwd": ("with_cs", "carry"), "lstm_bwd": ("carry",),
                "lstm_adj": ("carry",), "stack_fwd": ("with_res",)}


def entry_name(mangled: str) -> str:
    """A readable name for a kernel's mangled entry: base<dtype,act,modes>."""
    m = re.search(r"(((?:lstm|stack)_(?:fwd|bwd|adj))(?:_wide)?_kernel)I(f|13__nv_bfloat16)"
                  r"Li(\d)E((?:Lb\dE)*)", mangled)
    if m:
        flags = re.findall(r"Lb(\d)E", m.group(5))
        mode = ""
        for k, (name, on) in enumerate(zip(KERNEL_FLAGS.get(m.group(2), ()), flags)):
            if on == "1":
                mode += f",{name}"
            elif k == 0 and m.group(2).endswith("fwd"):
                mode += ",primal"
        return f"{m.group(1)}<{'f32' if m.group(3) == 'f' else 'bf16'},act={m.group(4)}{mode}>"
    m = re.search(r"outer_sum_partialILi(\d)ELb(\d)E", mangled)
    if m:
        return f"outer_sum_partial<{m.group(1)}{',head' if m.group(2) == '1' else ''}>"
    return "sum_splits" if "sum_splits" in mangled else mangled


def phase_build(torch, _build, cuda_lstm, cuda_lstm_stack) -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"[build] {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s: "
        f"{', '.join(sorted(logs))}")
    spilled = []
    for name, log in sorted(logs.items()):
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = entry_name(m.group(1))
            elif "registers" in line or "spill" in line:
                say(f"[build] {name} {entry}: {line.split(':', 1)[-1].strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if name == "lstm_fwd" and m and (int(m.group(1)) or int(m.group(2))):
                    spilled.append(entry)
    if spilled:
        fail(f"lstm_fwd spills registers in {spilled}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        plans = {b: cuda_lstm.fwd_layout(HIDDEN, dt, b, sms, limit) for b in FWD_BATCHES}
        say(f"[build] lstm_fwd layout at H={HIDDEN} {n} (layout, threads, rows a block) by B: "
            + ", ".join(f"B={b} {p}" for b, p in plans.items())
            + f"; {cuda_lstm.smem_bytes(HIDDEN, dt)} B of shared memory (KS={cuda_lstm.FWD_KS}, "
            f"{cuda_lstm.FWD_KEEP} rows in registers); no spills")
    for h, name in WIDE_CASES:
        dt = getattr(torch, name)
        say(f"[build] lstm_fwd layout at H={h} {name}, B=133: "
            f"{cuda_lstm.fwd_layout(h, dt, 133, sms, limit)}, "
            f"{cuda_lstm.smem_bytes(h, dt, -(-133 // sms))} B of shared memory")
    for kernel in ("lstm_bwd", "lstm_adj"):
        sm = {n: cuda_lstm.smem_bytes(HIDDEN, dt, 1, kernel)
              for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        say(f"[build] {kernel}: dynamic shared memory at H={HIDDEN}, one row a block: "
            f"{sm['f32']} B f32, {sm['bf16']} B bf16 (+{cuda_lstm.smem_bytes(HIDDEN, torch.float32, 2, kernel) - sm['f32']} B a further row)")
    rows = [cuda_lstm_stack.stack_rows(b, HIDDEN, torch.float32, sms, limit)
            for b in TRAIN_BATCHES]
    for kernel in ("stack_fwd", "stack_bwd", "stack_adj"):
        sm = {n: cuda_lstm_stack.stack_smem_bytes(HIDDEN, dt, 1, kernel)
              for n, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
        extra = cuda_lstm_stack.stack_smem_bytes(HIDDEN, torch.float32, 2, kernel) - sm["f32"]
        say(f"[build] {kernel}: dynamic shared memory at H={HIDDEN}, one row a block: "
            f"{sm['f32']} B f32, {sm['bf16']} B bf16 (+{extra} B a further row); "
            f"{limit} B allowed; rows a block at B={TRAIN_BATCHES}: {rows}")


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


#: the forward's four modes: (name, with_cs, carried)
FWD_MODES = (("lstm_fwd", False, False), ("lstm_fwd_cs", True, False),
             ("lstm_fwd_carry", False, True), ("lstm_fwd_cs_carry", True, True))


def phase_fwd_layouts(torch, cuda_lstm) -> dict:
    """The forward kernel's four modes in both layouts against the plain
    version: the register layout at H=100 with B=133 (two batch rows a
    block), the wide layout at ``WIDE_CASES`` with B in {8, 133}; W=48,
    every activation, seeded inputs (xz 0.5 N(0,1), rec N(0,1)/sqrt(H),
    carry 0.5 N(0,1)).  Bars: the primal abs f32 2e-5 / bf16 1e-2, the
    other modes scaled by max(1, max|plain|), f32 1e-4 / bf16 1e-2.  Each
    mode launched twice must give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    limit = cuda_lstm._lib().hfrep_max_smem_optin(0)
    cases = [(HIDDEN, "float32", 133), (HIDDEN, "bfloat16", 133)]
    cases += [(h, name, b) for h, name in WIDE_CASES for b in (8, 133)]
    worst = {}
    for h, name, b in cases:
        dtype = getattr(torch, name)
        layout = cuda_lstm.fwd_layout(h, dtype, b, sms, limit)[0]
        g = torch.Generator(device="cuda")
        g.manual_seed(h + b)
        xz = (0.5 * torch.randn((48, b, 4 * h), generator=g, device="cuda")).to(dtype)
        rec = (torch.randn((h, 4 * h), generator=g, device="cuda") / h ** 0.5).to(dtype)
        carry = tuple(0.5 * torch.randn((b, h), generator=g, device="cuda") for _ in range(2))
        line = []
        for act in ACTS:
            for mode, with_cs, carried in FWD_MODES:
                c = carry if carried else None
                with torch.no_grad():
                    got = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs, c)
                    again = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs, c)
                    ref = cuda_lstm.lstm_seq_plain(xz, rec, act, with_cs, c)
                torch.cuda.synchronize()
                got, again, ref = ((x,) if torch.is_tensor(x) else x for x in (got, again, ref))
                for a, r in zip(got, ref):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"{mode} ({layout}) not finite/shaped at H={h} B={b} {act} {name}")
                if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
                    fail(f"{mode} ({layout}): two launches differ at H={h} B={b} {act} {name}")
                if mode == "lstm_fwd":
                    err, bar = float((got[0] - ref[0]).abs().max()), BARS[name]
                else:
                    err, bar = max(scaled_err(a, r) for a, r in zip(got, ref)), GRAD_BARS[name]
                key = f"{layout} {mode} {name}"
                worst[key] = max(worst.get(key, 0.0), err)
                if act == "tanh":
                    line.append(f"{mode} {err:.2e}")
                if not err <= bar:
                    fail(f"{mode} ({layout}) disagrees with its plain version: {err} > {bar} "
                         f"at H={h} B={b} {act} {name}")
        say(f"[layout] lstm_fwd {layout} H={h} W=48 B={b} {name}: every mode within its bar "
            f"and bitwise repeatable; tanh errors: {', '.join(line)}")
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


def stack_inputs(torch, w, f, b, act, dtype, seed):
    """xz1, rec1, k2, b2 and rec2 as the critic makes them: two
    Keras-initialised layers (F -> H, H -> H) and layer 1's projection of
    standard-normal windows; also the layers and the windows."""
    from hfrep_tpu_torch.ops.lstm import KerasLSTM

    g = torch.Generator()
    g.manual_seed(seed)
    l0 = KerasLSTM(f, HIDDEN, activation=act, device="cuda", generator=g)
    l1 = KerasLSTM(HIDDEN, HIDDEN, activation=act, device="cuda", generator=g)
    x = torch.randn((b, w, f), generator=g).cuda()
    with torch.no_grad():
        xz1 = (x.reshape(b * w, f) @ l0.kernel + l0.bias).reshape(b, w, 4 * HIDDEN)
        weights = (xz1.transpose(0, 1).contiguous(), l0.recurrent_kernel, l1.kernel,
                   l1.bias, l1.recurrent_kernel)
        weights = tuple(t.detach().to(dtype).contiguous() for t in weights)
    return (l0, l1), x, weights


def phase_stack_parity(torch, cuda_lstm_stack) -> dict:
    """Kernels 4 (primal, with_res), 5 (plain, directs, with_carries) and
    6 against their plain versions on the same inputs: the forward's from
    ``stack_inputs``, the residuals from the kernel, seeded cotangents."""
    cls = cuda_lstm_stack
    names = ("stack_fwd", "stack_bwd", "stack_adj")
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    worst_abs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    h = HIDDEN
    for w, f in SHAPES:
        for b in TRAIN_BATCHES:
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, wts = stack_inputs(torch, w, f, b, act, dtype, seed=w + b + 2)
                    g = torch.Generator(device="cuda")
                    g.manual_seed(w * b + 1)
                    rnd = lambda *shape: 0.3 * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
                    with torch.no_grad():
                        res = cls.stack_fwd_cuda(*wts, act, with_res=True)
                        errs = {"stack_fwd": [(cls.stack_fwd_cuda(*wts, act),
                                               cls.stack_seq_plain(*wts, act))]
                                + list(zip(res, cls.stack_seq_plain(*wts, act, True)))}
                        dhs2 = rnd(w, b, h)
                        directs = (rnd(w, b, h), rnd(w, b, h), rnd(w, b, h))
                        errs["stack_bwd"] = []
                        for d, carries in ((None, False), (directs, False), (None, True)):
                            errs["stack_bwd"] += list(zip(
                                cls.stack_bwd_cuda(*wts, *res, dhs2, d, act, carries),
                                cls.stack_bwd_plain(*wts, *res, dhs2, d, act, carries)))
                        carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, act, True)[5:]
                        cots = (rnd(w, b, 4 * h), rnd(h, 4 * h), rnd(h, 4 * h), rnd(4 * h),
                                rnd(h, 4 * h))
                        errs["stack_adj"] = list(zip(
                            cls.stack_adj_cuda(*wts, *res, *carried, *cots, act),
                            cls.stack_adj_plain(*wts, *res, *carried, *cots, act)))
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
                    say(f"[stack] W={w:3d} B={b:2d} {act:7s} {name:8s} scaled max err: "
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
    """One epoch on the card and the same epoch — a copy of the state (its
    critic route included), the same draws — through the plain path on
    the CPU."""
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


def phase_train(torch, cuda_lstm, route: str, presets=TRAIN_PRESETS) -> list:
    """The training path on one critic route: ``auto`` (the fused stack,
    slice 3's main path) or ``chained`` (two single-layer LSTMs, slice
    2's), each preset with every launch count set to 0 just before its
    counted epochs and read just after."""
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.train import (init_gan_state, make_multi_step,
                                       make_train_step, sample_draws)

    out = []
    tag = f"[train:{route}]"
    for k, preset in enumerate(presets):
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
        state.discriminator.stack = route
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
        launched = {n for n, c in launches.items() if c > 0}
        if launched != ROUTE_KERNELS[route]:
            fail(f"{preset} ({route} route): the epochs launched {sorted(launched)}, "
                 f"expected {sorted(ROUTE_KERNELS[route])} ({launches})")
        per_epoch = {n: c / TRAIN_EPOCHS for n, c in launches.items() if c}
        say(f"{tag} {preset} W={w}: {TRAIN_EPOCHS} epochs in {first_s:.2f} s; d_loss "
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
        say(f"{tag} {preset} W={w}: {ms_epoch:.2f} ms/epoch over {TRAIN_EPOCHS} epochs "
            f"(host clock, synchronised); profiled epoch: {busy}")
        for row in prof["top"]:
            share = 100 * row["us"] / prof["device_busy_us"]
            say(f"{tag}   {row['us']:9.1f} us  {share:5.1f}%  {row['name']}")
        say(f"{tag} {preset} W={w}: one epoch, card vs CPU plain path: d_loss "
            f"{parity['d_loss']:.7g} vs {parity['d_loss_cpu']:.7g} (rel {parity['loss_rel_diff']['d_loss']:.2e}), "
            f"g_loss {parity['g_loss']:.7g} vs {parity['g_loss_cpu']:.7g} "
            f"(rel {parity['loss_rel_diff']['g_loss']:.2e}; limit 1e-4); params max|diff| "
            f"{parity['param_max_abs_diff']:.2e}, worst |diff|/(1e-5+1e-4|cpu|) "
            f"{parity['param_worst_ratio']:.3f} at {parity['param_worst_at']} (limit 1); "
            f"CPU epoch {parity['cpu_epoch_s']:.1f} s")
        if not parity["ok"]:
            fail(f"{preset}: the card's epoch differs from the CPU plain path: {parity}")
        out.append({"route": route, "preset": preset, "W": w, "F": mcfg.features,
                    "launches": launches,
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
                    dev = device_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "sigmoid"), 50)
                    plain = time_ms(torch, lambda: cuda_lstm.lstm_seq_plain(xz, rec, "sigmoid"), 5, 1)
                    kx = layer.kernel.to(dtype)
                    kb = layer.bias.to(dtype)
                    xd = x.to(dtype)

                    def with_projection():
                        z = (xd.reshape(b * w, f) @ kx + kb).reshape(b, w, 4 * HIDDEN)
                        cuda_lstm.lstm_fwd_cuda(z.transpose(0, 1).contiguous(), rec, "sigmoid")

                    kernel_proj = time_ms(torch, with_projection, 200)
                    library = library_dev = None
                    if name == "float32":
                        lstm = torch.nn.LSTM(f, HIDDEN).cuda()
                        lstm.weight_ih_l0.copy_(layer.kernel.T)
                        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
                        lstm.bias_ih_l0.copy_(layer.bias)
                        lstm.bias_hh_l0.zero_()
                        xt = x.transpose(0, 1).contiguous()
                        library = time_ms(torch, lambda: lstm(xt), 200)
                        library_dev = device_ms(torch, lambda: lstm(xt), 50, match="")
                bnd, by = bound_ms(w, b, HIDDEN, name)
                row = {"W": w, "F": f, "B": b, "dtype": name, "ms": kernel,
                       "us_per_step": kernel / w * 1e3, "device_ms": dev,
                       "ms_with_projection": kernel_proj, "plain_ms": plain,
                       "library_ms": library, "library_device_ms": library_dev,
                       "bound_ms": bnd, "bound_by": by}
                rows.append(row)
                lib_s = ("n/a" if library is None
                         else f"{library:.4f} (device {library_dev:.4f})")
                say(f"[timing] lstm_fwd W={w:3d} B={b:2d} {name:8s}: kernel {kernel:.4f} ms "
                    f"({kernel / w * 1e3:.3f} us a step; device {dev:.4f} ms, "
                    f"{dev / w * 1e3:.3f} us a step; +projection {kernel_proj:.4f}), "
                    f"plain {plain:.3f} ms, cuDNN LSTM {lib_s} ms, bound {bnd:.5f} ms ({by})")
    return rows


def grad_work(w, b, h, dtype_name) -> dict:
    """{kernel: (bytes, seconds of operations)} for the single-layer
    kernels at (W, B, H): each input read once and each output written
    once; each product of 2*W*B*H*4H over the peak for its operands' type
    (products with rec are in the operand dtype, products with v and the
    drec/urec sums in float32).  The carry modes add their (B, H) arrays
    — forward: h0, c0 and c_fin (with_cs: h0, c0); backward: h0, c0,
    dc_fin, dh0, dc0; adjoint: h0, c0, mu_h0, mu_c0, cot(dc_fin),
    cot(h0), cot(c0) — and no operations: the step-0 products replace
    products with zero rows that the carry-free reckoning counts too."""
    item = 4 if dtype_name == "float32" else 2
    seq, g32, st = w * b * h * 4, w * b * 4 * h * 4, b * h * 4
    xzb, recb, mat32 = w * b * 4 * h * item, 4 * h * h * item, 4 * h * h * 4
    prod = 2 * w * b * h * 4 * h
    peak, f32 = PEAK_OPS_PER_S[dtype_name], PEAK_OPS_PER_S["float32"]
    work = {"lstm_fwd": (xzb + recb + seq, prod / peak),
            "lstm_fwd_cs": (xzb + recb + 2 * seq, prod / peak),
            "lstm_bwd": (xzb + recb + 3 * seq + g32 + mat32, 2 * prod / peak + prod / f32),
            "lstm_adj": (xzb + recb + mat32 + 4 * seq + 2 * g32 + 3 * seq + mat32,
                         3 * prod / peak + 4 * prod / f32)}
    for k, extra in (("lstm_fwd", 3), ("lstm_fwd_cs", 2), ("lstm_bwd", 5), ("lstm_adj", 7)):
        nbytes, t_ops = work[k]
        work[f"{k}_carry"] = (nbytes + extra * st, t_ops)
    return work


def grad_bounds(w, b, h, dtype_name) -> dict:
    """Least time for each kernel and mode of :func:`grad_work` at
    (W, B, H): the larger of its bytes over 3.35 TB/s and its operations'
    time, in ms, with which of the two bounds it."""
    out = {}
    for k, (nbytes, t_ops) in grad_work(w, b, h, dtype_name).items():
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
                    dev = {"lstm_fwd_cs": device_ms(torch, calls["lstm_fwd_cs"][0], 30),
                           "primal": device_ms(torch, lambda: cuda_lstm.lstm_fwd_cuda(
                               xz, rec, "tanh"), 30)}
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
                    dev["library"] = device_ms(torch, lambda: lstm(xt), 30, match="")
                bounds = grad_bounds(w, b, h, name)
                for k, (ms, plain) in times.items():
                    bnd, by = bounds[k]
                    rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": name,
                                 "ms": ms, "plain_ms": plain, "library_ms": library[k],
                                 "bound_ms": bnd, "bound_by": by})
                    lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
                    extra = ""
                    if k == "lstm_fwd_cs":
                        rows[-1].update(primal_ms=primal, us_per_step=ms / w * 1e3,
                                        device_ms=dev[k], primal_device_ms=dev["primal"],
                                        library_device_ms=dev.get("library"))
                        extra = (f" ({ms / w * 1e3:.3f} us a step; device {dev[k]:.4f} ms, "
                                 f"{dev[k] / w * 1e3:.3f} us a step; primal, same tanh: "
                                 f"{primal:.4f}, device {dev['primal']:.4f})")
                        if "library" in dev:
                            lib_s += f" (device {dev['library']:.4f})"
                    say(f"[timing] {k:11s} W={w:3d} B={b:2d} {name:8s}: kernel {ms:.4f} ms{extra}, "
                        f"plain {plain:.3f} ms, cuDNN {lib_s} ms, bound {bnd:.5f} ms ({by})")
    return rows


def carry_draws(torch, w, b, seed):
    """A nonzero carry (h0, c0) at chip_check_carry's 0.5 scale and seeded
    cotangents at the grad phase's 0.3: dhs, dcs, dc_fin, u, v and mu0."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rnd = lambda s, *shape: s * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    h = HIDDEN
    carry = (rnd(0.5, b, h), rnd(0.5, b, h))
    cots = dict(dhs=rnd(0.3, w, b, h), dcs=rnd(0.3, w, b, h), dc_fin=rnd(0.3, b, h),
                u=rnd(0.3, w, b, 4 * h), v=rnd(0.3, h, 4 * h),
                mu0=(rnd(0.3, b, h), rnd(0.3, b, h)))
    return carry, cots


def carry_calls(cuda_lstm, xz, rec, act, carry, c, kernel: bool) -> dict:
    """{row: [outputs of each mode]}: the kernel wrappers (``kernel``) or
    the plain versions, every carry mode on the same inputs."""
    fwd = cuda_lstm.lstm_fwd_cuda if kernel else cuda_lstm.lstm_seq_plain
    bwd = cuda_lstm.lstm_bwd_cuda if kernel else cuda_lstm.lstm_bwd_plain
    adj = cuda_lstm.lstm_adj_cuda if kernel else cuda_lstm.lstm_adj_plain
    hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, carry)    # the residuals, as the path
    _, _, dhT, dcT, _, _ = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], None, act, True,
                                                   carry, c["dc_fin"])
    return {"lstm_fwd_carry": [fwd(xz, rec, act, False, carry), fwd(xz, rec, act, True, carry)],
            "lstm_bwd_carry": [bwd(xz, rec, hs, cs, c["dhs"], dcs, act, carries, carry,
                                   c["dc_fin"])
                               for dcs, carries in ((None, False), (c["dcs"], False),
                                                    (None, True))],
            "lstm_adj_carry": [adj(xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], act, carry,
                                   c["mu0"])]}


def phase_carry_parity(torch, cuda_lstm) -> dict:
    """(a) Each carry mode of kernels 1–3 against its plain version on the
    same inputs, at the grad phase's shapes, activations, dtypes and
    scaled bars: the forward's carry primal and with_cs modes, the
    backward's carry0 mode alone, with dcs and with the per-step carries
    (each with dc_fin), the adjoint's carry mode (with mu0)."""
    names = ("lstm_fwd_carry", "lstm_bwd_carry", "lstm_adj_carry")
    worst = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    worst_abs = {k: {"float32": 0.0, "bfloat16": 0.0} for k in names}
    t0 = time.perf_counter()
    for w, f in SHAPES:
        for b in TRAIN_BATCHES:
            for act in ACTS:
                for name, dtype in (("float32", torch.float32),
                                    ("bfloat16", torch.bfloat16)):
                    _, _, xz, rec = lstm_inputs(torch, w, f, b, act, dtype, seed=w + b + 3)
                    carry, c = carry_draws(torch, w, b, seed=w * b + 3)
                    with torch.no_grad():
                        got = carry_calls(cuda_lstm, xz, rec, act, carry, c, True)
                        ref = carry_calls(cuda_lstm, xz, rec, act, carry, c, False)
                    torch.cuda.synchronize()
                    line = []
                    for k in names:
                        pairs = [(a, r) for g_, r_ in zip(got[k], ref[k]) for a, r in zip(g_, r_)]
                        for a, r in pairs:
                            if a.shape != r.shape or not torch.isfinite(a).all():
                                fail(f"{k} output not finite/shaped at W={w} B={b} {act} {name}")
                        err = max(scaled_err(a, r) for a, r in pairs)
                        worst[k][name] = max(worst[k][name], err)
                        worst_abs[k][name] = max(worst_abs[k][name], max(
                            float((a - r).abs().max()) for a, r in pairs))
                        line.append(f"{k} {err:.2e}")
                        if not err <= GRAD_BARS[name]:
                            fail(f"{k} disagrees with its plain version: {err} > "
                                 f"{GRAD_BARS[name]} at W={w} B={b} {act} {name}")
                    say(f"[carry] W={w:3d} B={b:2d} {act:7s} {name:8s} scaled max err: "
                        f"{', '.join(line)} (limit {GRAD_BARS[name]:.0e})")
    seconds = time.perf_counter() - t0
    say(f"[carry] parity in {seconds:.1f} s")
    return {"scaled": worst, "abs": worst_abs, "seconds": seconds}


def allclose_err(got, ref, atol, rtol) -> float:
    """max |got - ref| / (atol + rtol |ref|): at most 1 within the bar."""
    return float(((got.float() - ref.float()).abs() / (atol + rtol * ref.float().abs())).max())


def phase_carry_path(torch, cuda_lstm) -> dict:
    """(b) The carry path at full width: the W=168, B=32, H=100 window in
    float32 as four chunks of 42 that pass (h, c) on through
    ``lstm_seq_carry``, against the whole window, for sigmoid and tanh.

    From a zero start the whole window is ``lstm_seq`` (the carry-free
    kernels): hs, the final c (``lstm_seq``'s residual cs at W-1), the
    gradients of xz and rec under a loss on hs, and the ``gp_like``
    second order (the input-gradient penalty of sum(hs)) in xz and rec.
    From chip_check_carry's nonzero (h0, c0) the whole window is the
    plain carry forward, differentiated by torch: hs and the final c,
    the gradients of xz, rec, h0 and c0 under chip_check_carry's loss
    (hs·wts + c_fin·u), and its ``gp_like`` in all four.  Bars: the JAX
    suite's, forward atol 1e-5, gradients atol 1e-5 + rtol 1e-4, second
    order atol 2e-4 + rtol 1e-4.  Every whole-window reference is formed
    first; then every launch count is set to 0, the chunked runs go, and
    exactly the four carry modes must have launched."""
    h, w, f, b, cut = HIDDEN, 168, 36, 32, 42
    t_phase = time.perf_counter()
    bars = {"forward": (1e-5, 0.0), "first": (1e-5, 1e-4), "second": (2e-4, 1e-4)}

    def chunked(xz, rec, h0, c0, act):
        hs, hh, cc = [], h0, c0
        for k in range(0, w, cut):
            hs_k, cc = cuda_lstm.lstm_seq_carry(xz[k:k + cut], rec, hh, cc, act)
            hs.append(hs_k)
            hh = hs_k[-1]
        return torch.cat(hs), cc

    def gp_like(fn, args, wrt, act):
        hs, c_fin = fn(*args, act)
        gr = torch.autograd.grad(hs.sum() + (0 if c_fin is None else c_fin.sum()),
                                 [args[i] for i in wrt], create_graph=True)
        pen = (1.0 - torch.sqrt(sum((t ** 2).sum() for t in gr) + 1e-12)) ** 2
        return torch.autograd.grad(pen, args)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    cases, refs = [], []
    for act in ("sigmoid", "tanh"):
        _, _, xz, rec = lstm_inputs(torch, w, f, b, act, torch.float32, seed=168)
        g = torch.Generator(device="cuda")
        g.manual_seed(42)
        h0, c0 = (0.5 * torch.randn((b, h), generator=g, device="cuda") for _ in range(2))
        wts = torch.randn((w, b, h), generator=g, device="cuda")
        u = torch.randn((b, h), generator=g, device="cuda")
        zero = torch.zeros((b, h), device="cuda")
        cases.append((act, xz, rec, h0, c0, wts, u, zero))
        # zero start: the whole window through lstm_seq's kernels
        ref = {}
        with torch.no_grad():
            ref["zero hs"], cs = cuda_lstm.lstm_fwd(xz, rec, act, with_cs=True)
            ref["zero c_fin"] = cs[-1]
        args = leaves(xz, rec)
        ref["zero first"] = torch.autograd.grad((cuda_lstm.lstm_seq(*args, act) * wts).sum(),
                                                args)
        ref["zero second"] = gp_like(lambda x, r, a: (cuda_lstm.lstm_seq(x, r, a), None),
                                     leaves(xz, rec), (0,), act)
        # nonzero start: the whole window through the plain carry forward
        def plain(x, r, a, b_, act_):
            return cuda_lstm.lstm_seq_plain(x, r, act_, carry=(a, b_))
        with torch.no_grad():
            ref["carry hs"], ref["carry c_fin"] = plain(xz, rec, h0, c0, act)
        args = leaves(xz, rec, h0, c0)
        hs_p, cf_p = plain(*args, act)
        ref["carry first"] = torch.autograd.grad((hs_p * wts).sum() + (cf_p * u).sum(), args)
        ref["carry second"] = gp_like(plain, leaves(xz, rec, h0, c0), (0, 2, 3), act)
        refs.append(ref)
    torch.cuda.synchronize()

    cuda_lstm.reset_launches()
    t0 = time.perf_counter()
    gots = []
    for act, xz, rec, h0, c0, wts, u, zero in cases:
        got = {}
        with torch.no_grad():
            got["zero hs"], got["zero c_fin"] = chunked(xz, rec, zero, zero, act)
            got["carry hs"], got["carry c_fin"] = chunked(xz, rec, h0, c0, act)
        args = leaves(xz, rec, zero, zero)
        got["zero first"] = torch.autograd.grad((chunked(*args, act)[0] * wts).sum(),
                                                args[:2])
        args = leaves(xz, rec, zero, zero)
        got["zero second"] = gp_like(lambda x, r, a, c_, act_: (chunked(x, r, a, c_, act_)[0],
                                                                None),
                                     args, (0,), act)[:2]
        args = leaves(xz, rec, h0, c0)
        hs_c, cf_c = chunked(*args, act)
        got["carry first"] = torch.autograd.grad((hs_c * wts).sum() + (cf_c * u).sum(), args)
        got["carry second"] = gp_like(chunked, leaves(xz, rec, h0, c0), (0, 2, 3), act)
        gots.append(got)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_lstm.launch_counts()
    launched = {k for k, n in launches.items() if n}
    want = {"lstm_fwd_carry", "lstm_fwd_cs_carry", "lstm_bwd_carry", "lstm_adj_carry"}
    if launched != want:
        fail(f"the carry path launched {sorted(launched)}, expected exactly {sorted(want)} "
             f"({launches})")
    worst = {}
    for (act, *_), got, ref in zip(cases, gots, refs):
        line = []
        for key in got:
            order = key.split()[-1] if key.split()[-1] in bars else "forward"
            atol, rtol = bars[order]
            outs = got[key] if isinstance(got[key], (tuple, list)) else [got[key]]
            refs_ = ref[key] if isinstance(ref[key], (tuple, list)) else [ref[key]]
            err = 0.0
            for a, r in zip(outs, refs_):
                if a.shape != r.shape or not torch.isfinite(a).all():
                    fail(f"carry path {act} {key}: not finite/shaped")
                err = max(err, allclose_err(a.detach(), r.detach(), atol, rtol))
            worst[f"{act} {key}"] = err
            line.append(f"{key} {err:.3f}")
            if not err <= 1.0:
                fail(f"carry path {act}: {key} differs from the whole window "
                     f"({err:.3f} of the bar atol {atol:g} + rtol {rtol:g})")
        say(f"[carry] path W={w} as {w // cut} chunks of {cut}, B={b}, {act}: error as a share "
            f"of the bar: {', '.join(line)}")
    seconds = time.perf_counter() - t_phase
    say("[carry] path launches: " + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
        + f"; chunked runs {wall:.2f} s, phase {seconds:.1f} s")
    return {"launches": launches, "worst_share_of_bar": worst, "chunked_s": wall,
            "seconds": seconds}


def phase_carry_timing(torch, cuda_lstm) -> list:
    """(c) CUDA events for each carry mode at W=48, B=32, H=100, float32,
    tanh, beside the same kernel's carry-free mode, its bound
    (``grad_bounds``), its plain version and ``library_ms``: cuDNN's LSTM
    called with hx=(h0, c0) — under no_grad for the carry primal forward,
    in training mode for the carry with_cs forward, forward and backward
    (h0 and c0 needing a gradient) minus forward for the backward; none
    for the adjoint."""
    w, f, b, h = 48, 35, 32, HIDDEN
    layer, x, xz, rec = lstm_inputs(torch, w, f, b, "tanh", torch.float32, seed=3)
    carry, c = carry_draws(torch, w, b, seed=4)
    with torch.no_grad():
        hs, cs = cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", True, carry)
        dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs, c["dhs"], None, "tanh", True,
                                           carry, c["dc_fin"])[2:4]
        args = {"fwd": (xz, rec, "tanh"), "bwd": (xz, rec, hs, cs, c["dhs"], None, "tanh"),
                "adj": (xz, rec, hs, cs, dhT, dcT, c["u"], c["v"], "tanh")}
        calls = {   # carry mode, its carry-free mode, the plain carry version
            "lstm_fwd_carry": (lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], False, carry),
                               lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], False),
                               lambda: cuda_lstm.lstm_seq_plain(*args["fwd"], False, carry)),
            "lstm_fwd_cs_carry": (lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], True, carry),
                                  lambda: cuda_lstm.lstm_fwd_cuda(*args["fwd"], True),
                                  lambda: cuda_lstm.lstm_seq_plain(*args["fwd"], True, carry)),
            "lstm_bwd_carry": (
                lambda: cuda_lstm.lstm_bwd_cuda(*args["bwd"], False, carry, c["dc_fin"]),
                lambda: cuda_lstm.lstm_bwd_cuda(*args["bwd"]),
                lambda: cuda_lstm.lstm_bwd_plain(*args["bwd"], False, carry, c["dc_fin"])),
            "lstm_adj_carry": (lambda: cuda_lstm.lstm_adj_cuda(*args["adj"], carry, c["mu0"]),
                               lambda: cuda_lstm.lstm_adj_cuda(*args["adj"]),
                               lambda: cuda_lstm.lstm_adj_plain(*args["adj"], carry, c["mu0"]))}
        times = {k: (time_ms(torch, kern, 50), time_ms(torch, free, 50), time_ms(torch, plain, 2, 1))
                 for k, (kern, free, plain) in calls.items()}
        dev = {k: (device_ms(torch, calls[k][0], 30), device_ms(torch, calls[k][1], 30))
               for k in ("lstm_fwd_carry", "lstm_fwd_cs_carry")}
    lstm = torch.nn.LSTM(f, h).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(layer.kernel.T)
        lstm.weight_hh_l0.copy_(layer.recurrent_kernel.T)
        lstm.bias_ih_l0.copy_(layer.bias)
        lstm.bias_hh_l0.zero_()
    xt = x.transpose(0, 1).contiguous().requires_grad_(True)
    hx = tuple(t[None].clone().requires_grad_(True) for t in carry)
    gout = torch.randn((w, b, h), device="cuda")

    def fwd_bwd():
        out, _ = lstm(xt, hx)
        out.backward(gout)

    with torch.no_grad():
        lib_primal = time_ms(torch, lambda: lstm(xt, hx), 50)
        lib_dev = {"lstm_fwd_carry": device_ms(torch, lambda: lstm(xt, hx), 30, match="")}
    fwd = time_ms(torch, lambda: lstm(xt, hx), 50)
    lib_dev["lstm_fwd_cs_carry"] = device_ms(torch, lambda: lstm(xt, hx), 30, match="")
    library = {"lstm_fwd_carry": lib_primal, "lstm_fwd_cs_carry": fwd,
               "lstm_bwd_carry": time_ms(torch, fwd_bwd, 50) - fwd, "lstm_adj_carry": None}
    bounds = grad_bounds(w, b, h, "float32")
    rows = []
    for k, (ms, free_ms, plain) in times.items():
        bnd, by = bounds[k]
        rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": "float32", "ms": ms,
                     "us_per_step": ms / w * 1e3,
                     "carry_free_ms": free_ms, "plain_ms": plain, "library_ms": library[k],
                     "bound_ms": bnd, "bound_by": by})
        lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
        say(f"[timing] {k:17s} W={w} B={b} float32: kernel {ms:.4f} ms ({ms / w * 1e3:.3f} "
            f"us a step; carry-free {free_ms:.4f}, {100 * (ms / free_ms - 1):+.1f}%), plain "
            f"{plain:.3f} ms, cuDNN with hx {lib_s} ms, bound {bnd:.5f} ms ({by})")
        if k in dev:
            rows[-1].update(device_ms=dev[k][0], carry_free_device_ms=dev[k][1],
                            library_device_ms=lib_dev[k])
            say(f"[timing] {k:17s} W={w} B={b} float32: device {dev[k][0]:.4f} ms "
                f"({dev[k][0] / w * 1e3:.3f} us a step; carry-free {dev[k][1]:.4f}), "
                f"cuDNN with hx device {lib_dev[k]:.4f} ms")
    return rows


def stack_bounds(w, b, h, dtype_name) -> dict:
    """Least time for each stack kernel at (W, B, H), as ``grad_bounds``
    reckons: each input read once and each output written once (the
    sweeps' workspaces are not counted) over 3.35 TB/s; each product of
    2*W*B*H*4H over the peak for its operands' type — products with an
    operand-dtype matrix in that dtype, products with a v-stream and the
    W*B-row sums in float32.  Forward: 3 products; backward: 6 + 3 sums;
    adjoint: 9 + 12."""
    item = 4 if dtype_name == "float32" else 2
    seq, g32 = w * b * h * 4, w * b * 4 * h * 4
    xzb, mat, vec = w * b * 4 * h * item, 4 * h * h * item, 4 * h * item
    mat32, vec32 = 4 * h * h * 4, 4 * h * 4
    weights = xzb + 3 * mat + vec
    prod = 2 * w * b * h * 4 * h
    peak, f32 = PEAK_OPS_PER_S[dtype_name], PEAK_OPS_PER_S["float32"]
    work = {"stack_fwd": (weights + 4 * seq, 3 * prod / peak),
            "stack_bwd": (weights + 5 * seq + g32 + 3 * mat32 + vec32,
                          6 * prod / peak + 3 * prod / f32),
            "stack_adj": (weights + 8 * seq + g32 + 3 * mat32 + vec32
                          + g32 + 3 * mat32 + vec32 + 5 * seq,
                          9 * prod / peak + 12 * prod / f32)}
    out = {}
    for k, (nbytes, t_ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[k] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_stack_timing(torch, cuda_lstm, cuda_lstm_stack) -> list:
    """CUDA events for each stack kernel in the mode the epoch runs it
    (forward with_res, plain backward, adjoint), beside its bound, its
    plain version, ``library_ms`` and the chained pair it replaces: the
    two single-layer kernels of the same mode at the same shape, with the
    layer-2 projection matmul between the forwards and the dz2 . k2^T
    matmul between the backwards (the adjoints: the two kernels alone).
    The library is ``torch.nn.LSTM(F, H, num_layers=2)`` at tanh with the
    same weights: its forward in training mode (input projection
    included, so the kernel's "+projection" time stands beside it) for
    the forward, forward-and-backward minus forward for the backward,
    none for the adjoint (the cuDNN RNN has no double backward)."""
    cls = cuda_lstm_stack
    rows = []
    h = HIDDEN
    for w, f in SHAPES:
        for b in TRAIN_BATCHES:
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                (l0, l1), x, wts = stack_inputs(torch, w, f, b, "tanh", dtype, seed=5)
                xz1, rec1, k2, b2, rec2 = wts
                g = torch.Generator(device="cuda")
                g.manual_seed(6)
                rnd = lambda *shape: 0.3 * torch.randn(shape, generator=g, device="cuda")  # noqa: E731
                with torch.no_grad():
                    res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                    hs1, cs1, hs2, cs2 = res
                    dhs2 = rnd(w, b, h)
                    carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh", True)[5:]
                    cots = (rnd(w, b, 4 * h), rnd(h, 4 * h), rnd(h, 4 * h), rnd(4 * h),
                            rnd(h, 4 * h))
                    xz2 = ((hs1.reshape(w * b, h).to(dtype) @ k2 + b2)
                           .reshape(w, b, 4 * h).contiguous())
                    hs2c, cs2c = cuda_lstm.lstm_fwd_cuda(xz2, rec2, "tanh", with_cs=True)
                    _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz1, rec1, hs1, cs1, dhs2, None,
                                                             "tanh", True)
                    u, v = cots[0], cots[1]

                    def chained_fwd():
                        h1, _ = cuda_lstm.lstm_fwd_cuda(xz1, rec1, "tanh", with_cs=True)
                        z2 = (h1.reshape(w * b, h).to(dtype) @ k2 + b2).reshape(w, b, 4 * h)
                        cuda_lstm.lstm_fwd_cuda(z2.contiguous(), rec2, "tanh", with_cs=True)

                    def chained_bwd():
                        dxz2, _ = cuda_lstm.lstm_bwd_cuda(xz2, rec2, hs2c, cs2c, dhs2, None,
                                                          "tanh")
                        dh1 = (dxz2.reshape(w * b, 4 * h) @ k2.float().T).reshape(w, b, h)
                        cuda_lstm.lstm_bwd_cuda(xz1, rec1, hs1, cs1, dh1.contiguous(), None,
                                                "tanh")

                    def chained_adj():
                        cuda_lstm.lstm_adj_cuda(xz1, rec1, hs1, cs1, dhT, dcT, u, v, "tanh")
                        cuda_lstm.lstm_adj_cuda(xz2, rec2, hs2c, cs2c, dhT, dcT, u, v, "tanh")

                    calls = {
                        "stack_fwd": (lambda: cls.stack_fwd_cuda(*wts, "tanh", with_res=True),
                                      lambda: cls.stack_seq_plain(*wts, "tanh", with_res=True),
                                      chained_fwd),
                        "stack_bwd": (lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh"),
                                      lambda: cls.stack_bwd_plain(*wts, *res, dhs2, None, "tanh"),
                                      chained_bwd),
                        "stack_adj": (lambda: cls.stack_adj_cuda(*wts, *res, *carried, *cots,
                                                                 "tanh"),
                                      lambda: cls.stack_adj_plain(*wts, *res, *carried, *cots,
                                                                  "tanh"),
                                      chained_adj)}
                    times = {k: (time_ms(torch, kern, 30), time_ms(torch, plain, 2, 1),
                                 time_ms(torch, pair, 30))
                             for k, (kern, plain, pair) in calls.items()}
                    xd = x.to(dtype)
                    k1, bb1 = l0.kernel.detach().to(dtype), l0.bias.detach().to(dtype)

                    def with_projection():
                        z = (xd.reshape(b * w, f) @ k1 + bb1).reshape(b, w, 4 * h)
                        cls.stack_fwd_cuda(z.transpose(0, 1).contiguous(), rec1, k2, b2, rec2,
                                           "tanh", with_res=True)

                    fwd_proj = time_ms(torch, with_projection, 30)
                library = {"stack_fwd": None, "stack_bwd": None, "stack_adj": None}
                if name == "float32":
                    lstm = torch.nn.LSTM(f, h, num_layers=2).cuda()
                    with torch.no_grad():
                        for layer, mod in enumerate((l0, l1)):
                            getattr(lstm, f"weight_ih_l{layer}").copy_(mod.kernel.T)
                            getattr(lstm, f"weight_hh_l{layer}").copy_(mod.recurrent_kernel.T)
                            getattr(lstm, f"bias_ih_l{layer}").copy_(mod.bias)
                            getattr(lstm, f"bias_hh_l{layer}").zero_()
                    xt = x.transpose(0, 1).contiguous().requires_grad_(True)
                    gout = torch.randn((w, b, h), generator=g, device="cuda")

                    def fwd_bwd():
                        out, _ = lstm(xt)
                        out.backward(gout)

                    fwd = time_ms(torch, lambda: lstm(xt), 30)
                    library["stack_fwd"] = fwd
                    library["stack_bwd"] = time_ms(torch, fwd_bwd, 30) - fwd
                bounds = stack_bounds(w, b, h, name)
                for k, (ms, plain, pair) in times.items():
                    bnd, by = bounds[k]
                    rows.append({"kernel": k, "W": w, "F": f, "B": b, "dtype": name,
                                 "ms": ms, "plain_ms": plain, "library_ms": library[k],
                                 "chained_ms": pair, "bound_ms": bnd, "bound_by": by})
                    extra = ""
                    if k == "stack_fwd":
                        rows[-1]["ms_with_projection"] = fwd_proj
                        extra = f" (+projection {fwd_proj:.4f})"
                    lib_s = "n/a" if library[k] is None else f"{library[k]:.4f}"
                    say(f"[timing] {k:9s} W={w:3d} B={b:2d} {name:8s}: kernel {ms:.4f} ms{extra}, "
                        f"chained pair {pair:.4f} ms, plain {plain:.3f} ms, cuDNN 2-layer "
                        f"{lib_s} ms, bound {bnd:.5f} ms ({by})")
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
        from hfrep_tpu_torch.ops import _build, cuda_lstm, cuda_lstm_stack
    except ImportError as e:
        fail(f"the port (hfrep_tpu_torch) is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line(torch)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    say("TF32 off for matmuls and cuDNN: every float32 product is full float32")

    t0 = time.perf_counter()
    phase_build(torch, _build, cuda_lstm, cuda_lstm_stack)
    worst = phase_parity(torch, cuda_lstm)
    layouts = phase_fwd_layouts(torch, cuda_lstm)
    grad = phase_grad_parity(torch, cuda_lstm)
    carry = phase_carry_parity(torch, cuda_lstm)
    carry_path = phase_carry_path(torch, cuda_lstm)
    stack = phase_stack_parity(torch, cuda_lstm_stack)
    server = phase_server(torch, np, cuda_lstm)
    train = phase_train(torch, cuda_lstm, "auto")
    train_chained = phase_train(torch, cuda_lstm, "chained", TRAIN_PRESETS[:1])
    timing = phase_timing(torch, cuda_lstm)
    grad_timing = phase_grad_timing(torch, cuda_lstm)
    carry_timing = phase_carry_timing(torch, cuda_lstm)
    stack_timing = phase_stack_timing(torch, cuda_lstm, cuda_lstm_stack)
    profiled = phase_profile(torch)
    say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s on {card}")

    # launches on the main paths: the fused epochs (slice 3) and the
    # chained ones (slice 2), each read just after its own run
    by_route = {}
    for route, runs in (("train_fused", train), ("train_chained", train_chained)):
        counts = {k: sum(r["launches"][k] for r in runs) for k in cuda_lstm.launch_counts()}
        counts["stack_fwd"] += counts.pop("stack_fwd_res")
        by_route[route] = counts
    trained = {k: sum(c[k] for c in by_route.values()) for k in by_route["train_fused"]}
    head = next(r for r in timing if r["W"] == 48 and r["B"] == 8 and r["dtype"] == "float32")
    rows = [{
        "name": "lstm_fwd", "route": "cuda",
        "source": "hfrep_tpu_torch/csrc/lstm_fwd.cu", "replaces": TPU_KERNEL,
        "launches": server["launches"] + trained["lstm_fwd"],
        "launches_by_path": {"serve": server["launches"],
                             **{p: c["lstm_fwd"] for p, c in by_route.items()}},
        "max_abs_err": worst["float32"], "max_abs_err_bf16": worst["bfloat16"],
        "max_err_by_layout": layouts, "us_per_step": head["us_per_step"],
        "device_ms": head["device_ms"], "library_device_ms": head["library_device_ms"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": "W=48 B=8 H=100 float32"}]
    for k in ("lstm_fwd_cs", "lstm_bwd", "lstm_adj"):
        r = next(x for x in grad_timing if x["kernel"] == k and x["W"] == 48
                 and x["B"] == 32 and x["dtype"] == "float32")
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": trained[k],
            "launches_by_path": {p: c[k] for p, c in by_route.items()},
            "max_abs_err": grad["abs"][k]["float32"],
            "max_abs_err_bf16": grad["abs"][k]["bfloat16"],
            "max_scaled_err": grad["scaled"][k]["float32"],
            "max_scaled_err_bf16": grad["scaled"][k]["bfloat16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": "W=48 B=32 H=100 float32"})
        if "device_ms" in r:
            rows[-1].update(device_ms=r["device_ms"], library_device_ms=r["library_device_ms"])
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    # the carry modes: launches from the carry path's run (phase_carry_path)
    timed = {r["kernel"]: r for r in carry_timing}
    path_launches = carry_path["launches"]
    for k, modes in (("lstm_fwd_carry", ("lstm_fwd_carry", "lstm_fwd_cs_carry")),
                     ("lstm_bwd_carry", ("lstm_bwd_carry",)),
                     ("lstm_adj_carry", ("lstm_adj_carry",))):
        r = timed["lstm_fwd_cs_carry" if k == "lstm_fwd_carry" else k]
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": sum(path_launches[m] for m in modes),
            "launches_by_mode": {m: path_launches[m] for m in modes},
            "max_abs_err": carry["abs"][k]["float32"],
            "max_abs_err_bf16": carry["abs"][k]["bfloat16"],
            "max_scaled_err": carry["scaled"][k]["float32"],
            "max_scaled_err_bf16": carry["scaled"][k]["bfloat16"],
            "ms": r["ms"], "carry_free_ms": r["carry_free_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": "W=48 B=32 H=100 float32"})
        if "device_ms" in r:
            rows[-1].update(device_ms=r["device_ms"], library_device_ms=r["library_device_ms"])
    primal = timed["lstm_fwd_carry"]
    rows[-3]["mode"] = "with_cs carry (the differentiable path's); launches count both modes"
    rows[-3]["primal_carry"] = {k: primal[k] for k in ("ms", "device_ms", "carry_free_ms",
                                                       "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms", "library_device_ms")}
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    for k in ("stack_fwd", "stack_bwd", "stack_adj"):
        r = next(x for x in stack_timing if x["kernel"] == k and x["W"] == 48
                 and x["B"] == 32 and x["dtype"] == "float32")
        rows.append({
            "name": k, "route": "cuda", "source": f"hfrep_tpu_torch/csrc/{SOURCES[k]}",
            "replaces": TPU_KERNELS[k], "launches": trained[k],
            "launches_by_path": {p: c[k] for p, c in by_route.items()},
            "max_abs_err": stack["abs"][k]["float32"],
            "max_abs_err_bf16": stack["abs"][k]["bfloat16"],
            "max_scaled_err": stack["scaled"][k]["float32"],
            "max_scaled_err_bf16": stack["scaled"][k]["bfloat16"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "chained_ms": r["chained_ms"], "shape": "W=48 B=32 H=100 float32"})
    rows[-3]["mode"] = "with_res (the epoch's); launches count both modes"
    rows[-1]["library"] = "none: no PyTorch call computes it (the cuDNN RNN has no double backward)"
    kernels = {"kernels": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": rows, "server": server, "train": train,
                       "train_chained": train_chained, "timing": timing,
                       "grad_timing": grad_timing, "stack_timing": stack_timing,
                       "carry_parity": carry, "carry_path": carry_path,
                       "carry_timing": carry_timing,
                       "parity_max_abs_err": worst, "fwd_layouts": layouts,
                       "grad_parity": grad,
                       "stack_parity": stack, "profile": profiled}, fh, indent=1)
    say(card)
    say(json.dumps(kernels))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
