#!/usr/bin/env python3
"""The weight sums (``csrc/weight_sum.cuh``) alone on one card: right, repeatable, timed.

    python3 tools/torch_weight_sum.py [--quick]

Builds the port's kernels, prints ptxas's registers and spills of each
weight-sum instantiation (and fails on a spill), then:

* holds ``cuda_lstm.weight_sums_cuda`` against ``weight_sum_plain`` (in
  float64, and in float32 on the card) at W in {1, 48, 168} x B in {1, 32,
  64, 133} rows, one and two pairs, with and without head operands, M in
  {100, 37, 1}, one sum and three, every forced cluster size:
  max|kernel - plain| / max(1, max|plain|) within 1e-4;
  two launches bit-equal; a zero head gives the bits of no head; the C++
  split rule equals ``cuda_lstm.sum_splits``;
* times each sum shape of the epoch (R = W*B in {1536, 3072, 5376,
  10752}; one pair, two pairs, three sums of one pair — the stack
  backward's launch — three of two pairs — the adjoint's — and the
  column sum, M = 1) by the profiler's device time
  (``chip_smoke.device_ms``): the rule's cluster size and each forced
  size, beside one PyTorch call computing the same
  function (``torch.matmul`` of the shifted A^T and B — two pairs stacked
  along the rows, three sums as ``torch.bmm`` — or ``torch.sum``), float32
  with TF32 off, and the bound (operations over 67 TFLOP/s, bytes over
  3.35 TB/s).

``--quick`` times only the rule's pick.  Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EPOCH_ROWS = (1536, 3072, 5376, 10752)
H = 100


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_weight_sum: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from hfrep_tpu_torch.ops import _build, cuda_lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all()
    entry, spilled = None, []
    for line in _build.build_log("weight_sum").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = cs.entry_name(m.group(1))
        elif "registers" in line or "spill" in line:
            print(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spilled.append(entry)
    if spilled:
        sys.exit(f"torch_weight_sum: spills in {spilled}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731

    def case(nsum, npair, r, m, n, shift, heads):
        return [([(None if m == 1 else rnd(r, m), rnd(r, n),
                   rnd(shift, m) if heads else None) for _ in range(npair)], shift)
                for _ in range(nsum)]

    def plain(sums, dtype):
        return [cuda_lstm.weight_sum_plain(
            [(None if a is None else a.to(dtype), b.to(dtype),
              None if h is None else h.to(dtype)) for a, b, h in terms], shift)
                for terms, shift in sums]

    # ------------------------------------------------------------ right
    worst, n_cases = 0.0, 0
    lib = cuda_lstm._lib("weight_sum")
    for w in (1, 48, 168):
        for b in (1, 32, 64, 133):
            r = w * b
            for m, n in ((H, 4 * H), (37, 148), (1, 4 * H)):
                for npair in (1, 2):
                    for nsum in (1, 3):
                        for heads in ((False, True) if m != 1 else (False,)):
                            sums = case(nsum, npair, r, m, n, b, heads)
                            ref64 = plain(sums, torch.float64)
                            ref32 = plain(sums, torch.float32)
                            for splits in (0, 1, 2, 4, 8, 16):
                                got = cuda_lstm.weight_sums_cuda(sums, splits)
                                again = cuda_lstm.weight_sums_cuda(sums, splits)
                                torch.cuda.synchronize()
                                for x, y, p64, p32 in zip(got, again, ref64, ref32):
                                    if not torch.equal(x, y):
                                        sys.exit(f"two launches differ at W={w} B={b} "
                                                 f"M={m} npair={npair} splits={splits}")
                                    err = max(cs.scaled_err(x.double(), p64),
                                              cs.scaled_err(x, p32))
                                    worst = max(worst, err)
                                    if not err <= 1e-4:
                                        sys.exit(f"weight sum off by {err} at W={w} B={b} "
                                                 f"M={m} npair={npair} nsum={nsum} "
                                                 f"heads={heads} splits={splits}")
                                n_cases += 1
                            if heads:       # a zero head reads as no head, bit for bit
                                zero = [([(a, bb, torch.zeros_like(h)) for a, bb, h in t], s)
                                        for t, s in sums]
                                none = [([(a, bb, None) for a, bb, _ in t], s) for t, s in sums]
                                if not all(torch.equal(x, y) for x, y in zip(
                                        cuda_lstm.weight_sums_cuda(zero),
                                        cuda_lstm.weight_sums_cuda(none))):
                                    sys.exit(f"a zero head differs from no head at W={w} B={b}")
                            rule = cuda_lstm.sum_plan(nsum, npair, r, m, n, sms)[2]
                            if lib.hfrep_weight_sum_splits(nsum, npair, r, m, n, sms) != rule:
                                sys.exit(f"the C++ split rule differs from sum_splits at R={r}")
    print(f"right: {n_cases} cases within 1e-4 (worst scaled error {worst:.3e}), bit-equal "
          f"over two launches; a zero head = no head; the C++ rule = sum_splits", flush=True)

    # ------------------------------------------------------------ timed
    shapes = (("1 pair", 1, 1, H), ("2 pairs", 1, 2, H), ("3 x 1 pair", 3, 1, H),
              ("3 x 2 pairs", 3, 2, H), ("column sum", 1, 1, 1))
    for r in EPOCH_ROWS:
        for name, nsum, npair, m in shapes:
            n = 4 * H
            sums = case(nsum, npair, r, m, n, 32, False)
            tiles, pieces, rule = cuda_lstm.sum_plan(nsum, npair, r, m, n, sms)
            times = {}
            for splits in (0,) if args.quick else (0, 1, 2, 4, 8, 16):
                times[splits] = cs.device_ms(
                    torch, lambda: cuda_lstm.weight_sums_cuda(sums, splits), 20,
                    match="hfrep::ws::")
            # one PyTorch call computing the same function
            if m == 1:
                bb = torch.cat([b for _, b, _ in sums[0][0]])
                lib_call = lambda: torch.sum(bb, 0)  # noqa: E731
            else:
                at = torch.stack([torch.cat([torch.cat([torch.zeros(shift, m, device="cuda"),
                                                        a[:r - shift]]) for a, _, _ in t])
                                  for t, shift in sums])
                bt = torch.stack([torch.cat([b for _, b, _ in t]) for t, _ in sums])
                if nsum == 1:
                    a2, b2 = at[0], bt[0]
                    lib_call = lambda: torch.matmul(a2.T, b2)  # noqa: E731
                else:
                    att = at.transpose(1, 2)
                    lib_call = lambda: torch.bmm(att, bt)  # noqa: E731
            library = cs.device_ms(torch, lib_call, 20, match="")
            ops = 2.0 * nsum * npair * r * m * n
            nbytes = 4.0 * (nsum * npair * (r * (m if m != 1 else 0) + r * n) + nsum * m * n)
            t_ops, t_bytes = ops / 67e12 * 1e3, nbytes / 3.35e12 * 1e3
            bound = max(t_ops, t_bytes)
            pick = times[0]
            line = ", ".join(f"s{s} {t:.4f}" for s, t in times.items() if s)
            print(f"time R={r:5d} {name:11s}: rule (splits {rule}, {tiles} tiles, {pieces} pieces) "
                  f"{pick:.4f} ms ({ops / pick / 1e9:.1f} TFLOP/s); torch {library:.4f} ms; bound "
                  f"{bound:.5f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
                  + (f"; forced: {line}" if line else ""), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
