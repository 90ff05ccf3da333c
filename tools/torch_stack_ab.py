#!/usr/bin/env python3
"""Compare two builds of the port's fused-stack kernels on one card.

    python3 tools/torch_stack_ab.py BASE_CSRC [--rounds 2]

BASE_CSRC is another ``hfrep_tpu_torch/csrc`` tree (for example the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory).  Both trees are built with ``nvcc`` into their own build
directories; then, in the order base, change, change, base (``--rounds``
pairs), each build times ``stack_fwd`` (with_res), ``stack_bwd`` and
``stack_adj`` with CUDA events at W=48, B=32 and W=168, B=64 (H=100,
float32, tanh), checks the adjoint against its plain version, and times
three MTSS-WGAN-GP epochs (W=48, batch 32, n_critic 5) on the fused
route, printing their losses.  Only the stack sources differ between
the builds; the Python wrappers are this tree's.  Prints the card's name
and power limit first and each build's ptxas register counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STACK = ("lstm_stack_fwd", "lstm_stack_bwd", "lstm_stack_adj")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", help="the csrc tree to compare this tree's against")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_stack_ab: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from hfrep_tpu_torch.ops import _build, cuda_lstm_stack as cls

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    trees = {"base": Path(args.base).resolve(), "change": _build.CSRC}

    def use(name):
        _build.CSRC = trees[name]
        _build.BUILD_DIR = ROOT / "build" / f"ab-{name}"
        _build._libs.clear()

    for name in trees:
        use(name)
        _build.build_all()
        for src in STACK:
            regs = [ln.split("Used")[1].split(",")[0].strip()
                    for ln in _build.build_log(src).splitlines() if "Used" in ln]
            print(f"{name} {src} ptxas: {', '.join(regs)}")

    def kernels():
        out = {}
        for w, f, b in ((48, 35, 32), (168, 36, 64)):
            _, _, wts = cs.stack_inputs(torch, w, f, b, "tanh", torch.float32, seed=5)
            g = torch.Generator(device="cuda")
            g.manual_seed(6)
            rnd = lambda *s: 0.3 * torch.randn(s, generator=g, device="cuda")  # noqa: E731
            with torch.no_grad():
                res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                dhs2 = rnd(w, b, 100)
                carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh", True)[5:]
                cots = (rnd(w, b, 400), rnd(100, 400), rnd(100, 400), rnd(400), rnd(100, 400))
                calls = {"stack_fwd": lambda: cls.stack_fwd_cuda(*wts, "tanh", with_res=True),
                         "stack_bwd": lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh"),
                         "stack_adj": lambda: cls.stack_adj_cuda(*wts, *res, *carried, *cots,
                                                                 "tanh")}
                for k, fn in calls.items():
                    out[f"{k} W={w} B={b}"] = f"{cs.time_ms(torch, fn, 20):.4f} ms"
                err = max(cs.scaled_err(a, r) for a, r in zip(
                    calls["stack_adj"](), cls.stack_adj_plain(*wts, *res, *carried, *cots,
                                                              "tanh")))
                out[f"stack_adj scaled err W={w}"] = f"{err:.2e}"
        return out

    def epochs():
        from hfrep_tpu_torch.config import get_preset
        from hfrep_tpu_torch.models.registry import build_gan
        from hfrep_tpu_torch.train import init_gan_state, make_multi_step

        cfg = get_preset("mtss_wgan_gp")
        tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5, steps_per_call=3)
        g = torch.Generator(device="cuda")
        g.manual_seed(100)
        data = torch.rand((1000, cfg.model.window, cfg.model.features), generator=g,
                          device="cuda")
        pair = build_gan(cfg.model, device="cuda")
        state = init_gan_state(0, cfg.model, device="cuda")
        multi = make_multi_step(pair, tcfg, data)
        state, _ = multi(state, generator=g)
        torch.cuda.synchronize()
        # the port has no timeline ledger: the host clock around
        # synchronised epochs, as chip_smoke.py times them
        t0 = time.perf_counter()  # noqa: HF009
        state, m = multi(state, generator=g)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / 3 * 1e3,  # noqa: HF009
                [float(x) for x in m["d_loss"].cpu()])

    for name in ["base", "change", "change", "base"] * (args.rounds // 2):
        use(name)
        row = kernels()
        ms, d_loss = epochs()
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in row.items())
              + f"; fused epoch W=48 {ms:.2f} ms, d_loss {d_loss}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
