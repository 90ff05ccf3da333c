#!/usr/bin/env python3
"""Compare two builds of the port's backward and adjoint kernels on one card.

    python3 tools/torch_stack_ab.py BASE_ROOT [--rounds 2]

BASE_ROOT is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a git-ignored directory such
as ``build/parent``).  Each build runs in a process of its own, with its
own ``hfrep_tpu_torch`` (its Python wrappers and its ``csrc``, built with
``nvcc`` into its own ``build/cuda``), in the order base, change, change,
base (``--rounds`` pairs), so that two trees whose C entries differ are
each driven by their own wrappers.  Each build times, by the profiler's
device time (every kernel of a call; ``chip_smoke.device_ms``):

* ``stack_fwd`` (with_res), ``stack_bwd`` (with the carries, and plain)
  and ``stack_adj`` at W=48, B in {32, 64} and W=168, B=64 (H=100, tanh),
  float32 and bf16;
* ``lstm_bwd`` at the generator's shape in the epoch (W=48, B=32, sigmoid)
  and at W=48, B=32 and W=168, B=64 with tanh, float32 and bf16, and
  ``lstm_adj`` at W=48, B=32 tanh float32;
* the weight sums inside those calls (the device time of the sum kernels
  of one call: the earlier ``outer_sum_partial`` and ``sum_splits``, or
  ``weight_sum.cuh``'s kernels);
* the MTSS-WGAN-GP epoch (batch 32, n_critic 5) on the fused route at both
  presets (W=48 and W=168) and on the chained route at W=48: the device
  time of one profiled epoch, the host clock over three epochs and their
  losses.

Each output of each call is held against the first build's: its largest
difference is printed.  Prints the card's name and power limit first and
each build's ptxas register counts of the sweeps.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STACK = ("lstm_stack_fwd", "lstm_stack_bwd", "lstm_stack_adj", "lstm_bwd")
STACK_SHAPES = ((48, 35, 32), (48, 35, 64), (168, 36, 64))
BWD_SHAPES = ((48, 35, 32, "sigmoid"), (48, 35, 32, "tanh"), (168, 36, 64, "tanh"))
SUM_KERNELS = ("outer_sum", "sum_splits", "hfrep::ws::")
EPOCHS = (("mtss_wgan_gp", "auto"), ("mtss_wgan_gp_prod", "auto"), ("mtss_wgan_gp", "chained"))


def worker(tree: Path, out: Path) -> None:
    """Time and run every call with ``tree``'s package; write the times
    (JSON) and the outputs (``out`` + .pt)."""
    sys.path.insert(0, str(tree))
    import torch

    spec = importlib.util.spec_from_file_location("ab_chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from hfrep_tpu_torch.ops import _build, cuda_lstm, cuda_lstm_stack as cls

    assert Path(cls.__file__).resolve().is_relative_to(tree.resolve()), cls.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    regs = {src: [ln.split("Used")[1].split(",")[0].strip()
                  for ln in _build.build_log(src).splitlines() if "Used" in ln]
            for src in STACK}
    times, outs = {}, {}

    def run(key, fn, w):
        with torch.no_grad():
            res = fn()
            outs[key] = [t.detach().cpu() for t in (res if isinstance(res, (tuple, list)) else [res])]
            times[key] = {"us": cs.device_ms(torch, fn, 20, match="") * 1e3, "w": w,
                          "sums_us": cs.device_ms(torch, fn, 20, match=SUM_KERNELS) * 1e3}

    for w, f, b in STACK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            _, _, wts = cs.stack_inputs(torch, w, f, b, "tanh", dt, seed=5)
            g = torch.Generator(device="cuda")
            g.manual_seed(6)
            rnd = lambda *s: 0.3 * torch.randn(s, generator=g, device="cuda")  # noqa: E731
            with torch.no_grad():
                res = cls.stack_fwd_cuda(*wts, "tanh", with_res=True)
                dhs2 = rnd(w, b, 100)
                carried = cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh", True)[5:]
                cots = (rnd(w, b, 400), rnd(100, 400), rnd(100, 400), rnd(400), rnd(100, 400))
            tag = f"W={w} B={b} {name}"
            run(f"stack_fwd {tag}", lambda: cls.stack_fwd_cuda(*wts, "tanh", with_res=True), w)
            run(f"stack_bwd {tag}", lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None, "tanh",
                                                               True), w)
            run(f"stack_bwd plain {tag}", lambda: cls.stack_bwd_cuda(*wts, *res, dhs2, None,
                                                                     "tanh"), w)
            run(f"stack_adj {tag}", lambda: cls.stack_adj_cuda(*wts, *res, *carried, *cots,
                                                               "tanh"), w)
    for w, f, b, act in BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            _, _, xz, rec = cs.lstm_inputs(torch, w, f, b, act, dt, seed=3)
            g = torch.Generator(device="cuda")
            g.manual_seed(4)
            with torch.no_grad():
                hs, c_s = cuda_lstm.lstm_fwd_cuda(xz, rec, act, with_cs=True)
                dhs = 0.3 * torch.randn((w, b, 100), generator=g, device="cuda")
                _, _, dhT, dcT = cuda_lstm.lstm_bwd_cuda(xz, rec, hs, c_s, dhs, None, act, True)
                u = 0.3 * torch.randn((w, b, 400), generator=g, device="cuda")
                v = 0.3 * torch.randn((100, 400), generator=g, device="cuda")
            tag = f"W={w} B={b} {act} {name}"
            run(f"lstm_bwd {tag}", lambda: cuda_lstm.lstm_bwd_cuda(xz, rec, hs, c_s, dhs, None,
                                                                   act), w)
            if (w, b, act, name) == (48, 32, "tanh", "f32"):
                run(f"lstm_adj {tag}", lambda: cuda_lstm.lstm_adj_cuda(xz, rec, hs, c_s, dhT,
                                                                       dcT, u, v, act), w)
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.models.registry import build_gan
    from hfrep_tpu_torch.train import (init_gan_state, make_multi_step, make_train_step,
                                       sample_draws)

    epochs = {}
    for k, (preset, route) in enumerate(EPOCHS):
        cfg = get_preset(preset)
        tcfg = dataclasses.replace(cfg.train, batch_size=32, n_critic=5, steps_per_call=3)
        g = torch.Generator(device="cuda")
        g.manual_seed(100 + k)
        data = torch.rand((1000, cfg.model.window, cfg.model.features), generator=g,
                          device="cuda")
        pair = build_gan(cfg.model, device="cuda")
        state = init_gan_state(k, cfg.model, device="cuda")
        state.discriminator.stack = route
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
        epochs[f"{route} {preset}"] = {"host_ms": ms, "device_us": prof["device_busy_us"],
                                       "d_loss": [float(x) for x in m["d_loss"].cpu()]}
    torch.save(outs, str(out) + ".pt")
    out.write_text(json.dumps({"regs": regs, "times": times, "epochs": epochs}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", nargs="?", help="the checkout to compare this one against")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker), Path(args.out))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_stack_ab: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"base": Path(args.base).resolve(), "change": ROOT}
    outdir = ROOT / "build" / "ab"
    outdir.mkdir(parents=True, exist_ok=True)
    first = None
    for i, name in enumerate(["base", "change", "change", "base"] * (args.rounds // 2)):
        out = outdir / f"{i}-{name}.json"
        r = subprocess.run([sys.executable, __file__, "--worker", str(trees[name]), "--out",
                            str(out)], cwd=ROOT)
        if r.returncode != 0:
            sys.exit(f"torch_stack_ab: the {name} build's run failed ({r.returncode})")
        doc = json.loads(out.read_text())
        outs = torch.load(str(out) + ".pt")
        if first is None:
            first = outs
            for src, regs in doc["regs"].items():
                print(f"{name} {src} ptxas registers: {', '.join(regs)}", flush=True)
        elif i == 1:
            for src, regs in doc["regs"].items():
                print(f"{name} {src} ptxas registers: {', '.join(regs)}", flush=True)
        for key, t in doc["times"].items():
            diffs = [float((a - b).abs().max()) for a, b in zip(outs[key], first[key])]
            sums = "" if t["sums_us"] != t["sums_us"] else f", sums {t['sums_us']:.1f} us"
            print(f"{name}: {key}: device {t['us']:.1f} us ({t['us'] / t['w']:.3f} us a step)"
                  f"{sums}; max|this - first build| by output "
                  f"{', '.join(f'{d:.2e}' for d in diffs)}", flush=True)
        for key, e in doc["epochs"].items():
            print(f"{name}: epoch {key}: device {e['device_us']:.1f} us, host "
                  f"{e['host_ms']:.2f} ms an epoch, d_loss {e['d_loss']}", flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
