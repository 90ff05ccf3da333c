#!/usr/bin/env python3
"""The tp step's per-step gather on one card, three ways.

    python3 tools/torch_tp_gather.py [--calls 2000] [--rows 32 64]

Two gloo ranks share the card (as ``chip_smoke.py``'s mesh phase runs
them) and all_reduce a (rows, 100) float32 CUDA tensor, the size of a
tp=2 rank's gathered h at H=100, ``--calls`` times a way, in turns A, B,
C, C, B, A: (A) the tp axis's all_reduce (``parallel/chain.py::Chain.all_reduce_``,
the tp step's) on the CUDA tensor, gloo's own device path; (B) the same
through a host copy (``.cpu()``, the all_reduce on the host tensor, a
copy back); (C) ``Mesh.all_gather_cat`` of each rank's half (host
copies, joined on the card).  Prints each way's ms a call
(host clock, the card synchronised at the ends) and the card's name and
power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank(r: int, store: str, calls: int, rows: list, out: str) -> None:
    import torch

    from hfrep_tpu_torch.parallel import (MeshSpec, build_mesh, initialize_distributed,
                                          shutdown_distributed)
    from hfrep_tpu_torch.parallel.chain import Chain

    initialize_distributed("file://" + store, 2, r)
    try:
        mesh = build_mesh(MeshSpec(tp=2))
        ax = Chain(mesh, "tp")

        def via_device(t):
            ax.all_reduce_(t)

        def via_host(t):
            t.copy_(ax.all_reduce_(t.cpu()))

        def gather_host(t):
            t.copy_(mesh.all_gather_cat(t[:, 50 * r:50 * (r + 1)], dim=1))

        res = {}
        for n in rows:
            t = torch.full((n, 100), float(r + 1), device="cuda")
            for name, fn in (("device", via_device), ("host", via_host),
                             ("gather", gather_host), ("gather", gather_host),
                             ("host", via_host), ("device", via_device)):
                for _ in range(20):
                    fn(t.fill_(1.0))
                torch.cuda.synchronize()
                mesh.barrier()
                t0 = time.perf_counter()  # noqa: HF009
                for _ in range(calls):
                    fn(t.fill_(1.0))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / calls * 1e3  # noqa: HF009
                if name != "gather" and float(t[0, 0]) != 2.0:
                    raise SystemExit(f"{name}: the sum is {float(t[0, 0])}, not 2")
                res.setdefault(f"{n} rows {name}", []).append(ms)
        with open(out + f".{r}", "w") as fh:
            json.dump(res, fh)
    finally:
        shutdown_distributed()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rows", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank(args.rank, args.store, args.calls, args.rows, args.out)
        return
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("this tool runs on a card")
    tmp = tempfile.mkdtemp(prefix="tp_gather_")
    out = os.path.join(tmp, "res")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--store", os.path.join(tmp, "store"), "--out", out,
                               "--calls", str(args.calls), "--rows", *map(str, args.rows)],
                              env=env) for r in (0, 1)]
    if any(p.wait(timeout=600) != 0 for p in procs):
        chip_smoke.fail("a rank failed")
    for r in (0, 1):
        with open(out + f".{r}") as fh:
            res = json.load(fh)
        for k, v in res.items():
            print(f"rank {r}: {k}: " + ", ".join(f"{x:.4f}" for x in v) + " ms a call")
    print(chip_smoke.card_line(torch))


if __name__ == "__main__":
    main()
