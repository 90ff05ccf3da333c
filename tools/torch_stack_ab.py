#!/usr/bin/env python3
"""Compare two builds of the port's fused-stack and forward kernels on one card.

    python3 tools/torch_stack_ab.py BASE_CSRC [--rounds 2]

BASE_CSRC is another ``hfrep_tpu_torch/csrc`` tree (for example the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory).  Both trees are built with ``nvcc`` into their own build
directories; then, in the order base, change, change, base (``--rounds``
pairs), each build times ``stack_fwd`` (with_res), ``stack_bwd`` and
``stack_adj`` with CUDA events at W=48, B=32 and W=168, B=64 (H=100,
float32, tanh), checks the adjoint against its plain version, times the
four modes of ``lstm_fwd`` (primal, with_cs, carry primal, carry with_cs;
tanh, H=100) at W=48, B in {8, 32} and W=168, B=64, in float32 and bf16
(CUDA events over back-to-back calls, and the kernel's own device time
from ``torch.profiler``),
and times three MTSS-WGAN-GP epochs (W=48, batch 32, n_critic 5) on the
fused route, printing their losses.  The Python wrappers are this
tree's, except the forward's: a base tree whose ``hfrep_lstm_fwd`` takes
no layout (the single shared-memory layout, with ``rows`` a block from
``rows_per_block``) is driven through that older entry, in the epochs
too.  Each forward mode's largest difference between the two builds'
outputs is printed beside its times.  Prints the card's name and power
limit first and each build's ptxas register counts.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STACK = ("lstm_stack_fwd", "lstm_stack_bwd", "lstm_stack_adj")
FWD_SHAPES = ((48, 35, 8), (48, 35, 32), (168, 36, 64))
_P, _I = ctypes.c_void_p, ctypes.c_int


def shared_layout_fwd(torch, cuda_lstm, so_path):
    """A forward wrapper for a build whose C entries take ``rows`` and no
    layout: the same outputs as ``lstm_fwd_cuda`` through that entry."""
    lib = ctypes.CDLL(str(so_path))
    lib.hfrep_lstm_fwd.restype = lib.hfrep_lstm_fwd_carry.restype = _I
    lib.hfrep_lstm_fwd.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    lib.hfrep_lstm_fwd_carry.argtypes = [_P] * 7 + [_I] * 7 + [_P]

    def fwd(xz, rec, activation="tanh", with_cs=False, carry=None):
        w, b, g = xz.shape
        h = g // 4
        hs = torch.empty((w, b, h), device=xz.device)
        cs = torch.empty_like(hs) if with_cs else None
        c_fin = torch.empty((b, h), device=xz.device) if carry is not None and not with_cs \
            else None
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tail = (w, b, h, cuda_lstm.act_code(activation), int(xz.dtype == torch.bfloat16),
                cuda_lstm.rows_per_block(b, h, sms), 0, torch.cuda.current_stream().cuda_stream)
        ptr = cuda_lstm._ptr
        if carry is None:
            err = lib.hfrep_lstm_fwd(xz.data_ptr(), rec.data_ptr(), hs.data_ptr(), ptr(cs), *tail)
        else:
            err = lib.hfrep_lstm_fwd_carry(xz.data_ptr(), rec.data_ptr(), carry[0].data_ptr(),
                                           carry[1].data_ptr(), hs.data_ptr(), ptr(cs),
                                           ptr(c_fin), *tail)
        if err:
            raise RuntimeError(f"base lstm_fwd launch failed: cudaError {err}")
        return (hs, cs) if with_cs else (hs, c_fin) if c_fin is not None else hs

    return fwd


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
    from hfrep_tpu_torch.ops import _build, cuda_lstm, cuda_lstm_stack as cls

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    trees = {"base": Path(args.base).resolve(), "change": _build.CSRC}
    own_fwd = cuda_lstm.lstm_fwd_cuda
    fwd_of = {}

    def use(name):
        _build.CSRC = trees[name]
        _build.BUILD_DIR = ROOT / "build" / f"ab-{name}"
        _build._libs.clear()
        cuda_lstm.lstm_fwd_cuda = fwd_of.get(name, own_fwd)

    for name in trees:
        use(name)
        _build.build_all()
        if "layout" not in (trees[name] / "lstm_fwd.cu").read_text():
            fwd_of[name] = shared_layout_fwd(torch, cuda_lstm, _build._target("lstm_fwd"))
        for src in STACK + ("lstm_fwd",):
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

    def forward():
        """{mode shape dtype: (ms by CUDA events, device ms, outputs)} for
        the four forward modes."""
        out = {}
        for w, f, b in FWD_SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                _, _, xz, rec = cs.lstm_inputs(torch, w, f, b, "tanh", dt, seed=3)
                carry, _ = cs.carry_draws(torch, w, b, seed=4)
                for mode, with_cs, c in (("primal", False, None), ("with_cs", True, None),
                                         ("carry", False, carry),
                                         ("carry_cs", True, carry)):
                    with torch.no_grad():
                        fn = lambda: cuda_lstm.lstm_fwd_cuda(xz, rec, "tanh", with_cs, c)  # noqa: E731
                        got = fn()
                        ms = cs.time_ms(torch, fn, 50)
                        dev = cs.device_ms(torch, fn, 30)
                    key = f"{mode} W={w} B={b} {'f32' if dt == torch.float32 else 'bf16'}"
                    out[key] = (ms, dev, got if isinstance(got, tuple) else (got,))
        return out

    first_fwd = {}          # the first build's forward outputs, to compare against

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
        fwd = forward()
        ms, d_loss = epochs()
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in row.items())
              + f"; fused epoch W=48 {ms:.2f} ms, d_loss {d_loss}", flush=True)
        for key, (t, dev, outs) in fwd.items():
            ref = first_fwd.get(key, (None, None, outs))[2]
            diff = max(float((a - r).abs().max()) for a, r in zip(outs, ref))
            w = int(key.split("W=")[1].split()[0])
            print(f"{name}: lstm_fwd {key}: {t:.4f} ms (events), device {dev:.4f} ms, "
                  f"{dev / w * 1e3:.3f} us a step, max|this - first build| {diff:.3e}",
                  flush=True)
        if not first_fwd:
            first_fwd.update(fwd)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
