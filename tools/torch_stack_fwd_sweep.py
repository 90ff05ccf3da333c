#!/usr/bin/env python3
"""The stack forward's cluster layout on one card: register rows and device time.

    python3 tools/torch_stack_fwd_sweep.py [--rows] [--write] [--time]

``--rows`` compiles ``csrc/lstm_stack_fwd.cu`` once for each pair of
register row counts (KR1 for layer 1's block, KR2 for layer 2's; the
same pair for both operand types) and prints ptxas's spill bytes of every
cluster-layout instantiation, by type.  ptxas grants the kernel's 13 warps
128 registers a thread, and which pairs spill moves with any change to
the kernel, so the counts are chosen by compiling.  With ``--write`` the
first pair in ``PREF`` that spills in no instantiation of a type is
written into the source (``KR1_F32 ...``) and into
``cuda_lstm_stack.STACK_KEEP``.  ``--time`` prints the card's name and
power limit, then the profiler's device time of ``stack_fwd_cuda`` (with_res
and primal, tanh, H=100) at W in {1, 2, 48, 168} in float32 and bf16 (W=1
reads the prologue), and of the chained pair it replaces (two
``lstm_fwd`` with_cs launches and the layer-2 projection).  Builds go to
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
SRC = ROOT / "hfrep_tpu_torch" / "csrc" / "lstm_stack_fwd.cu"
PY = ROOT / "hfrep_tpu_torch" / "ops" / "cuda_lstm_stack.py"
PREF = [(20, 20), (19, 20), (19, 19), (18, 19), (18, 18), (17, 18), (17, 17), (16, 16)]
LINE = r"constexpr int KR1_F32 = \d+, KR2_F32 = \d+, KR1_BF16 = \d+, KR2_BF16 = \d+;"


def variant(f32: tuple, bf16: tuple) -> str:
    return re.sub(LINE, f"constexpr int KR1_F32 = {f32[0]}, KR2_F32 = {f32[1]}, "
                        f"KR1_BF16 = {bf16[0]}, KR2_BF16 = {bf16[1]};", SRC.read_text())


def spills(pair: tuple) -> tuple:
    """(pair, nvcc exit code, {type: [spill bytes of each instantiation]})."""
    from hfrep_tpu_torch.ops import _build

    d = ROOT / "build" / "sweep" / f"kr{pair[0]}_{pair[1]}"
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
        if m and entry and "cluster" in entry:
            out["bf16" if "nv_bfloat16" in entry else "f32"].append(int(m.group(1)) + int(m.group(2)))
    return pair, r.returncode, out


def rows(write: bool) -> None:
    with ThreadPoolExecutor(len(PREF)) as ex:
        res = list(ex.map(spills, PREF))
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
        PY.write_text(re.sub(r"STACK_KEEP = \{torch.float32: \d+, torch.bfloat16: \d+\}",
                             f"STACK_KEEP = {{torch.float32: {min(pick['f32'])}, "
                             f"torch.bfloat16: {min(pick['bf16'])}}}", PY.read_text()))


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
    ap.add_argument("--rows", action="store_true", help="compile each register row pair")
    ap.add_argument("--write", action="store_true", help="write the spill-free pairs (with --rows)")
    ap.add_argument("--time", action="store_true", help="device time on the card")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.rows:
        rows(args.write)
    if args.time:
        timing()


if __name__ == "__main__":
    main()
