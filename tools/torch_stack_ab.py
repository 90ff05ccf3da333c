#!/usr/bin/env python3
"""Compare two builds of the port's fused-stack kernels on one card.

    python3 tools/torch_stack_ab.py BASE_CSRC [--rounds 2]

BASE_CSRC is another ``hfrep_tpu_torch/csrc`` tree (for example the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory).  Both trees are built with ``nvcc`` into their own build
directories; then, in the order base, change, change, base (``--rounds``
pairs), each build times ``stack_fwd`` (with_res), ``stack_bwd`` (with
the carries, and plain) and ``stack_adj`` by the profiler's device time
(``chip_smoke.device_ms``, every kernel of a call but the forward's) at
W=48, B in {32, 64} and W=168, B=64 (H=100, tanh), in float32 and bf16,
with each kernel's largest difference from the first build's outputs,
and runs the MTSS-WGAN-GP epoch on the fused route (batch 32, n_critic 5)
at both presets (W=48 and W=168): the device time of one profiled epoch,
the host clock over three epochs and their losses.  The Python wrappers
are this tree's: a base library whose C entry takes fewer trailing
arguments than this tree passes (the sweeps' layout and threads) runs
its own single layout and leaves the extra arguments unread; a base
backward or adjoint without the cluster layout is driven through this
tree's wrapper in the wide layout, which its C entry runs (with the
transposed copies it reads).  Prints the card's name and power limit
first and each build's ptxas register counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STACK = ("lstm_stack_fwd", "lstm_stack_bwd", "lstm_stack_adj")
SHAPES = ((48, 35, 32), (48, 35, 64), (168, 36, 64))
PRESETS = ("mtss_wgan_gp", "mtss_wgan_gp_prod")


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
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    trees = {"base": Path(args.base).resolve(), "change": _build.CSRC}

    rules = {k: getattr(cls, f"{k}_layout") for k in ("stack_bwd", "stack_adj")}

    def wide_rule(hidden, dtype, batch, sm_count, smem_limit):
        rows = cls.stack_rows(batch, hidden, dtype, sm_count, smem_limit)
        return "wide", 32 * math.ceil(rows * hidden / 32), rows

    def use(name):
        _build.CSRC = trees[name]
        _build.BUILD_DIR = ROOT / "build" / f"ab-{name}"
        _build._libs.clear()
        for k, rule in rules.items():
            clustered = f"hfrep_{k}_clusters" in (trees[name] / f"lstm_{k}.cu").read_text()
            setattr(cls, f"{k}_layout", rule if clustered else wide_rule)

    for name in trees:
        use(name)
        _build.build_all()
        for src in STACK:
            regs = [ln.split("Used")[1].split(",")[0].strip()
                    for ln in _build.build_log(src).splitlines() if "Used" in ln]
            print(f"{name} {src} ptxas: {', '.join(regs)}")

    def kernels():
        """{kernel shape dtype: (device ms, outputs)}."""
        out = {}
        for w, f, b in SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                _, _, wts = cs.stack_inputs(torch, w, f, b, "tanh", dt, seed=5)
                g = torch.Generator(device="cuda")
                g.manual_seed(6)
                rnd = lambda *s: 0.3 * torch.randn(s, generator=g, device="cuda")  # noqa: E731
                with torch.no_grad():
                    res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                    dhs2 = rnd(w, b, 100)
                    bwd = cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh", True)
                    plain = cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh")
                    cots = (rnd(w, b, 400), rnd(100, 400), rnd(100, 400), rnd(400),
                            rnd(100, 400))
                    adj = cls.stack_adj_cuda(*wts, *res, *bwd[5:], *cots, "tanh")
                    calls = {
                        "stack_fwd": (lambda: cls.stack_fwd_cuda(*wts, "tanh", with_res=True), res),
                        "stack_bwd": (lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh",
                                                                 True), bwd),
                        "stack_bwd plain": (lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None,
                                                                       "tanh"), plain),
                        "stack_adj": (lambda: cls.stack_adj_cuda(*wts, *res, *bwd[5:], *cots,
                                                                 "tanh"), adj)}
                    for k, (fn, outs) in calls.items():
                        ms = cs.device_ms(torch, fn, 20,
                                          match="stack_fwd" if k == "stack_fwd" else "")
                        name = "f32" if dt == torch.float32 else "bf16"
                        out[f"{k} W={w} B={b} {name}"] = (ms, outs)
        return out

    def epochs():
        """{preset: (host ms an epoch over three, device us of one, d_loss)}."""
        from hfrep_tpu_torch.config import get_preset
        from hfrep_tpu_torch.models.registry import build_gan
        from hfrep_tpu_torch.train import (init_gan_state, make_multi_step, make_train_step,
                                           sample_draws)

        out = {}
        for k, preset in enumerate(PRESETS):
            cfg = get_preset(preset)
            tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5, steps_per_call=3)
            g = torch.Generator(device="cuda")
            g.manual_seed(100 + k)
            data = torch.rand((1000, cfg.model.window, cfg.model.features), generator=g,
                              device="cuda")
            pair = build_gan(cfg.model, device="cuda")
            state = init_gan_state(k, cfg.model, device="cuda")
            multi = make_multi_step(pair, tcfg, data)
            state, _ = multi(state, generator=g)
            torch.cuda.synchronize()
            # the port has no timeline ledger: the host clock around
            # synchronised epochs, as chip_smoke.py times them
            t0 = time.perf_counter()  # noqa: HF009
            state, m = multi(state, generator=g)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3  # noqa: HF009
            one = dataclasses.replace(tcfg, steps_per_call=1)
            prof = cs.profile_epoch(torch, make_train_step(pair, one, data), state,
                                    sample_draws(g, pair, one, data))
            out[preset] = (ms, prof["device_busy_us"], [float(x) for x in m["d_loss"].cpu()])
        return out

    first = {}              # the first build's outputs, to compare against
    for name in ["base", "change", "change", "base"] * (args.rounds // 2):
        use(name)
        row = kernels()
        for key, (ms, outs) in row.items():
            ref = first.get(key, (ms, outs))[1]
            diff = max(float((a - r).abs().max()) for a, r in zip(outs, ref))
            w = int(key.split("W=")[1].split()[0])
            print(f"{name}: {key}: device {ms:.4f} ms ({ms / w * 1e3:.3f} us a step), "
                  f"max|this - first build| {diff:.3e}", flush=True)
        if not first:
            first.update(row)
        for preset, (ms, dev_us, d_loss) in epochs().items():
            print(f"{name}: fused epoch {preset}: device {dev_us:.1f} us, host {ms:.2f} ms "
                  f"an epoch, d_loss {d_loss}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
