#!/usr/bin/env python3
"""The stack sweeps' cluster layouts, and the single-layer backward's and
adjoint's register layouts, on one card: register rows and device time.

    python3 tools/torch_stack_fwd_sweep.py [--kernel fwd|bwd|adj|lstm_bwd|lstm_adj] [--rows] [--write] [--time]

``--rows`` compiles the kernel's source (``csrc/lstm_stack_fwd.cu``,
``csrc/lstm_stack_bwd.cu`` with ``--kernel bwd``,
``csrc/lstm_stack_adj.cu`` with ``--kernel adj``, ``csrc/lstm_bwd.cu``
with ``--kernel lstm_bwd`` or ``csrc/lstm_adj.cu`` with ``--kernel
lstm_adj``) once for each pair of register row counts
(KR1 for layer 1's block, KR2 for layer 2's; the same pair for both
operand types; the backwards' "rows" are chunks of four columns; the
single-layer kernels' one count is KR) and prints ptxas's spill bytes
of every cluster-layout (register-layout) instantiation, by type.  ptxas grants the kernels' 13 warps 128 registers
a thread, and which pairs spill moves with any change to a kernel, so the
counts are chosen by compiling.  With ``--write`` the first pair in the
kernel's preference list that spills in no instantiation of a type is
written into the source (``KR1_F32 ...``) and into
``cuda_lstm_stack.STACK_KEEP`` (``STACK_BWD_KEEP``, ``STACK_ADJ_KEEP``;
``cuda_lstm.BWD_KEEP`` and ``ADJ_KEEP`` for the single-layer backward and
adjoint).  ``--time`` prints
the card's name and power limit, then the profiler's device time of the
kernel at W in {1, 2, 48, 168} in float32 and bf16 (W=1 reads the
prologue) — ``stack_fwd_cuda`` with_res and primal, or every kernel of a
``stack_bwd_cuda`` call in its plain and carries modes and, apart, its
recompute, its sweep and its four weight sums (without their split
sums), or every kernel of a ``stack_adj_cuda`` call and, apart, its
pre-pass, its sweep, its post-pass and its four weight sums — and of
the chained pair it replaces (two ``lstm_fwd`` with_cs launches and the
layer-2 projection; two ``lstm_bwd`` launches and the dz2 . k2^T
product; two ``lstm_adj`` launches) — or, for ``lstm_bwd``, every kernel
of an ``lstm_bwd_cuda`` call and, apart, its gate recompute, its sweep
and its weight sum, sigmoid and tanh, beside the same call in the wide
layout — or, for ``lstm_adj``, every kernel of an ``lstm_adj_cuda`` call
in both modes (the carry mode with a nonzero carry and mu0) and, apart,
its pre-pass, its sweep, its post-pass and its weight sum, sigmoid and
tanh, beside the same call in the wide layout.  Builds go to
``build/sweep/``.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "hfrep_tpu_torch" / "csrc"
PY = ROOT / "hfrep_tpu_torch" / "ops" / "cuda_lstm_stack.py"
PY_LSTM = ROOT / "hfrep_tpu_torch" / "ops" / "cuda_lstm.py"
#: per kernel: its source, the name of its row counts in the wrapper, the
#: pairs to compile in order of preference
KERNELS = {
    "fwd": ("lstm_stack_fwd.cu", "STACK_KEEP",
            [(20, 20), (19, 20), (19, 19), (18, 19), (18, 18), (17, 18), (17, 17), (16, 16)]),
    "bwd": ("lstm_stack_bwd.cu", "STACK_BWD_KEEP",
            # below 15 in float32 the block's shared memory passes the card's
            # limit (cuda_lstm_stack.cluster_bwd_smem_bytes)
            [(19, 19), (18, 19), (18, 18), (17, 18), (17, 17), (16, 17), (16, 16), (15, 16),
             (15, 15)]),
    "adj": ("lstm_stack_adj.cu", "STACK_ADJ_KEEP",
            # below 13 in float32 the block's shared memory passes the card's
            # limit (cuda_lstm_stack.cluster_adj_smem_bytes)
            [(19, 19), (18, 19), (18, 18), (17, 18), (17, 17), (16, 17), (16, 16), (15, 16),
             (15, 15), (14, 15), (14, 14), (13, 14), (13, 13)]),
    # one count (KR) a type; pairs (KR, KR)
    "lstm_bwd": ("lstm_bwd.cu", "BWD_KEEP", [(r, r) for r in range(25, 13, -1)]),
    "lstm_adj": ("lstm_adj.cu", "ADJ_KEEP", [(r, r) for r in range(25, 12, -1)]),
}
#: the single-layer sources: one count a type, their keep in cuda_lstm.py
ONE_COUNT = ("lstm_bwd.cu", "lstm_adj.cu")
SRC = CSRC / KERNELS["fwd"][0]
LINE = r"constexpr int KR1_F32 = \d+, KR2_F32 = \d+, KR1_BF16 = \d+, KR2_BF16 = \d+;"
LINE_ONE = r"constexpr int KR_F32 = \d+, KR_BF16 = \d+;"


def variant(f32: tuple, bf16: tuple) -> str:
    if SRC.name in ONE_COUNT:
        return re.sub(LINE_ONE, f"constexpr int KR_F32 = {f32[0]}, KR_BF16 = {bf16[0]};",
                      SRC.read_text())
    return re.sub(LINE, f"constexpr int KR1_F32 = {f32[0]}, KR2_F32 = {f32[1]}, "
                        f"KR1_BF16 = {bf16[0]}, KR2_BF16 = {bf16[1]};", SRC.read_text())


def checked(entry: str) -> bool:
    """An instantiation whose register rows the counts set: the cluster
    layouts' sweeps, or the single-layer backward's or adjoint's register
    layout."""
    if SRC.name in ONE_COUNT:
        return f"{SRC.stem}_kernel" in entry
    return "cluster" in entry


def spills(pair: tuple) -> tuple:
    """(pair, nvcc exit code, {type: [spill bytes of each instantiation]})."""
    from hfrep_tpu_torch.ops import _build

    d = ROOT / "build" / "sweep" / f"{SRC.stem}-kr{pair[0]}_{pair[1]}"
    d.mkdir(parents=True, exist_ok=True)
    for f in SRC.parent.iterdir():
        (d / f.name).write_text(f.read_text())
    (d / SRC.name).write_text(variant(pair, pair))
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "x.so"),
                        str(d / SRC.name)], capture_output=True, text=True)
    out, entry = {"f32": [], "bf16": []}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry and checked(entry):
            out["bf16" if "nv_bfloat16" in entry else "f32"].append(int(m.group(1)) + int(m.group(2)))
    return pair, r.returncode, out


def rows(write: bool, pref: list, keep: str) -> None:
    with ThreadPoolExecutor(len(pref)) as ex:
        res = list(ex.map(spills, pref))
    pick = {}
    for pair, rc, sp in res:
        print(f"KR1={pair[0]} KR2={pair[1]}: nvcc exit {rc}, spill bytes f32 {sp['f32']}, "
              f"bf16 {sp['bf16']}", flush=True)
        for t in ("f32", "bf16"):
            if t not in pick and rc == 0 and sp[t] and not any(sp[t]):
                pick[t] = pair
    print(f"spill-free: {pick}")
    if write:
        if len(pick) < 2:
            sys.exit("no spill-free pair for each type")
        SRC.write_text(variant(pick["f32"], pick["bf16"]))
        py = PY_LSTM if SRC.name in ONE_COUNT else PY
        py.write_text(re.sub(keep + r" = \{torch.float32: \d+, torch.bfloat16: \d+\}",
                             f"{keep} = {{torch.float32: {min(pick['f32'])}, "
                             f"torch.bfloat16: {min(pick['bf16'])}}}", py.read_text()))


def timing_bwd() -> None:
    import torch

    import chip_smoke as cs
    from hfrep_tpu_torch.ops import cuda_lstm, cuda_lstm_stack as cls

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(torch), flush=True)
    for dt in (torch.float32, torch.bfloat16):
        line = []
        for w, b in ((1, 32), (2, 32), (48, 32), (48, 64), (168, 64)):
            wts = cs.stack_inputs(torch, w, 35, b, "tanh", dt, seed=5)[2]
            g = torch.Generator(device="cuda")
            g.manual_seed(6)
            with torch.no_grad():
                res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                dhs2 = 0.3 * torch.randn((w, b, 100), generator=g, device="cuda")
                for carries in (False, True):
                    call = lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh", carries)  # noqa: E731
                    parts = {k: cs.device_ms(torch, call, 20, match=m)
                             for k, m in (("call", ""), ("recompute", "stack_gates"),
                                          ("sweep", "stack_bwd_cluster"),
                                          ("sums", "hfrep::ws::"))}
                    line.append(f"W={w} B={b} {'carries' if carries else 'plain'} "
                                + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in parts.items())
                                + " us")
        print(f"stack_bwd {dt}: " + "; ".join(line), flush=True)
    for w, b in ((48, 32), (168, 64)):
        wts = cs.stack_inputs(torch, w, 35, b, "tanh", torch.float32, seed=5)[2]
        xz1, rec1, k2, b2, rec2 = wts
        with torch.no_grad():
            hs1, cs1, _, _ = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
            xz2 = (hs1.reshape(-1, 100) @ k2 + b2).reshape(w, b, 400).contiguous()
            hs2, cs2 = cuda_lstm.lstm_fwd_cuda(xz2, rec2, "tanh", with_cs=True)
            dhs2 = torch.ones_like(hs2) * 0.1

            def chained():
                dxz2, _ = cuda_lstm.lstm_bwd_cuda(xz2, rec2, hs2, cs2, dhs2, None, "tanh")
                dh1 = (dxz2.reshape(w * b, 400) @ k2.T).reshape(w, b, 100)
                cuda_lstm.lstm_bwd_cuda(xz1, rec1, hs1, cs1, dh1.contiguous(), None, "tanh")

            ms = cs.device_ms(torch, chained, 20, match="")
        print(f"chained pair W={w} B={b} float32: {ms * 1e3:.1f} us", flush=True)


def timing_lstm_bwd() -> None:
    import torch

    import chip_smoke as cs
    from hfrep_tpu_torch.ops import cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(torch), flush=True)
    def wide(hidden, dtype, batch, sm_count, smem_limit):
        rows = cuda_lstm.rows_per_block(batch, hidden, sm_count)
        return "wide", 32 * -(-rows * hidden // 32), rows

    rule = cuda_lstm.bwd_layout
    for dt in (torch.float32, torch.bfloat16):
        for act in ("sigmoid", "tanh"):
            line = []
            for w, b in ((1, 32), (2, 32), (48, 32), (48, 64), (168, 32), (168, 64)):
                _, _, xz, rec = cs.lstm_inputs(torch, w, 35, b, act, dt, seed=3)
                g = torch.Generator(device="cuda")
                g.manual_seed(4)
                with torch.no_grad():
                    hs, cs_ = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs=True)
                    dhs = 0.3 * torch.randn((w, b, 100), generator=g, device="cuda")
                    call = lambda: cuda_lstm.lstm_bwd_cuda(xz, rec, hs, cs_, dhs, None, act)  # noqa: E731
                    parts = {k: cs.device_ms(torch, call, 20, match=m)
                             for k, m in (("call", ""), ("recompute", "stack_gates"),
                                          ("sweep", "lstm_bwd_kernel"), ("sum", "hfrep::ws::"))}
                    cuda_lstm.bwd_layout = wide
                    try:
                        parts["wide call"] = cs.device_ms(torch, call, 20, match="")
                    finally:
                        cuda_lstm.bwd_layout = rule
                line.append(f"W={w} B={b} " + ", ".join(f"{k} {v * 1e3:.1f}"
                                                       for k, v in parts.items()) + " us")
            print(f"lstm_bwd {dt} {act}: " + "; ".join(line), flush=True)


def timing_lstm_adj() -> None:
    import torch

    import chip_smoke as cs
    from hfrep_tpu_torch.ops import cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(torch), flush=True)

    def wide(hidden, dtype, batch, sm_count, smem_limit):
        rows = cuda_lstm.rows_per_block(batch, hidden, sm_count)
        return "wide", 32 * -(-rows * hidden // 32), rows

    rule = cuda_lstm.adj_layout
    for dt in (torch.float32, torch.bfloat16):
        for act in ("sigmoid", "tanh"):
            for carried in (False, True):
                line = []
                for w, b in ((1, 32), (2, 32), (42, 32), (48, 32), (168, 64)):
                    _, _, xz, rec = cs.lstm_inputs(torch, w, 35, b, act, dt, seed=3)
                    carry, c = cs.carry_draws(torch, w, b, seed=4)
                    if not carried:
                        carry = None
                    with torch.no_grad():
                        hs, cs_ = cuda_lstm.lstm_fwd_cuda(xz, rec, act, True, carry)
                        dhT, dcT = cuda_lstm.lstm_bwd_cuda(
                            xz, rec, hs, cs_, c["dhs"], None, act, True, carry,
                            c["dc_fin"] if carried else None)[2:4]
                        mu0 = c["mu0"] if carried else None
                        call = lambda: cuda_lstm.lstm_adj_cuda(  # noqa: E731
                            xz, rec, hs, cs_, dhT, dcT, c["u"], c["v"], act, carry, mu0)
                        parts = {k: cs.device_ms(torch, call, 20, match=m)
                                 for k, m in (("call", ""), ("pre-pass", "stack_gates"),
                                              ("sweep", "lstm_adj_kernel"),
                                              ("post-pass", "lstm_adj_post"),
                                              ("sum", "hfrep::ws::"))}
                        cuda_lstm.adj_layout = wide
                        try:
                            parts["wide call"] = cs.device_ms(torch, call, 20, match="")
                        finally:
                            cuda_lstm.adj_layout = rule
                    line.append(f"W={w} B={b} " + ", ".join(f"{k} {v * 1e3:.1f}"
                                                           for k, v in parts.items()) + " us")
                print(f"lstm_adj{' carry' if carried else ''} {dt} {act}: " + "; ".join(line),
                      flush=True)


def timing_adj() -> None:
    import torch

    import chip_smoke as cs
    from hfrep_tpu_torch.ops import cuda_lstm, cuda_lstm_stack as cls

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(torch), flush=True)
    for dt in (torch.float32, torch.bfloat16):
        line = []
        for w, b in ((1, 32), (2, 32), (48, 32), (48, 64), (168, 64)):
            wts = cs.stack_inputs(torch, w, 35, b, "tanh", dt, seed=5)[2]
            g = torch.Generator(device="cuda")
            g.manual_seed(6)
            rnd = lambda *s: 0.3 * torch.randn(s, generator=g, device="cuda")  # noqa: E731
            with torch.no_grad():
                res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                carried = cls.stack_bwd_cuda(*wts, *res, rnd(w, b, 100), None, "tanh", True)[5:]
                cots = (rnd(w, b, 400), rnd(100, 400), rnd(100, 400), rnd(400), rnd(100, 400))
                call = lambda: cls.stack_adj_cuda(*wts, *res, *carried, *cots, "tanh")  # noqa: E731
                parts = {k: cs.device_ms(torch, call, 20, match=m)
                         for k, m in (("call", ""), ("pre-pass", "stack_gates"),
                                      ("sweep", "stack_adj_cluster"),
                                      ("post-pass", "stack_adj_post"),
                                      ("sums", "hfrep::ws::"))}
            line.append(f"W={w} B={b} " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in parts.items())
                        + f" us (sums {100 * parts['sums'] / parts['call']:.1f}% of the call)")
        print(f"stack_adj {dt}: " + "; ".join(line), flush=True)
    for w, b in ((48, 32), (168, 64)):
        wts = cs.stack_inputs(torch, w, 35, b, "tanh", torch.float32, seed=5)[2]
        xz1, rec1, k2, b2, rec2 = wts
        g = torch.Generator(device="cuda")
        g.manual_seed(6)
        with torch.no_grad():
            hs1, cs1, _, _ = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
            xz2 = (hs1.reshape(-1, 100) @ k2 + b2).reshape(w, b, 400).contiguous()
            hs2, cs2 = cuda_lstm.lstm_fwd_cuda(xz2, rec2, "tanh", with_cs=True)
            dhs = 0.3 * torch.randn((w, b, 100), generator=g, device="cuda")
            _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz1, rec1, hs1, cs1, dhs, None, "tanh", True)
            u = 0.3 * torch.randn((w, b, 400), generator=g, device="cuda")
            v = 0.3 * torch.randn((100, 400), generator=g, device="cuda")

            def chained():
                cuda_lstm.lstm_adj_cuda(xz1, rec1, hs1, cs1, dhT, dcT, u, v, "tanh")
                cuda_lstm.lstm_adj_cuda(xz2, rec2, hs2, cs2, dhT, dcT, u, v, "tanh")

            ms = cs.device_ms(torch, chained, 20, match="")
        print(f"chained pair W={w} B={b} float32: {ms * 1e3:.1f} us", flush=True)


def timing() -> None:
    import torch

    import chip_smoke as cs
    from hfrep_tpu_torch.ops import cuda_lstm, cuda_lstm_stack as cls

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(torch), flush=True)
    for dt in (torch.float32, torch.bfloat16):
        line = []
        for w, b in ((1, 32), (2, 32), (48, 32), (48, 64), (168, 64)):
            wts = cs.stack_inputs(torch, w, 35, b, "tanh", dt, seed=5)[2]
            for res in (True, False):
                with torch.no_grad():
                    ms = cs.device_ms(torch, lambda: cls.stack_fwd_cuda(*wts, "tanh", res), 20,
                                      match="stack_fwd")
                line.append(f"W={w} B={b} {'with_res' if res else 'primal'} {ms * 1e3:.1f} us")
        print(f"stack_fwd {dt}: " + "; ".join(line), flush=True)
    for w, b in ((48, 32), (168, 64)):
        xz1, rec1, k2, b2, rec2 = cs.stack_inputs(torch, w, 35, b, "tanh", torch.float32, seed=5)[2]

        def chained():
            h1, _ = cuda_lstm.lstm_fwd_cuda(xz1, rec1, "tanh", with_cs=True)
            z2 = (h1.reshape(-1, 100) @ k2 + b2).reshape(w, b, 400)
            cuda_lstm.lstm_fwd_cuda(z2.contiguous(), rec2, "tanh", with_cs=True)

        with torch.no_grad():
            ms = cs.device_ms(torch, chained, 20, match="")
        print(f"chained pair W={w} B={b} float32: {ms * 1e3:.1f} us", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="fwd")
    ap.add_argument("--rows", action="store_true", help="compile each register row pair")
    ap.add_argument("--write", action="store_true", help="write the spill-free pairs (with --rows)")
    ap.add_argument("--time", action="store_true", help="device time on the card")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    global SRC
    src, keep, pref = KERNELS[args.kernel]
    SRC = CSRC / src
    if args.rows:
        rows(args.write, pref, keep)
    if args.time:
        {"fwd": timing, "bwd": timing_bwd, "adj": timing_adj,
         "lstm_bwd": timing_lstm_bwd, "lstm_adj": timing_lstm_adj}[args.kernel]()


if __name__ == "__main__":
    main()
