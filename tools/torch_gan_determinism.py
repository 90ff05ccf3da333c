#!/usr/bin/env python3
"""Is the ``gan_ckpt`` chaos subject's training a pure function of its
seed on one card, across processes and within one?

    python3 tools/torch_gan_determinism.py [--runs 3] [--device cuda] [--out F]

Each fresh process builds the subject's trainer (mtss_wgan_gp, H=100,
W=8, F=4, batch 4, n_critic 1, 2 epochs a call, 4 epochs; the fixture
of ``hfrep_tpu_torch/resilience/drive_fixtures.py::run_gan_ckpt``
without checkpoints), trains it twice in the same process, and prints a
digest of each run's generator and critic parameters and its per-epoch
losses.  ``--runs`` processes run one after another; a last process runs
under ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), which raises at the first
operation PyTorch knows to be nondeterministic and names it; one more
fills the caching allocator's free blocks with NaN before each run
(``--poison``: a kernel that reads memory it did not write then gives
another result), and one runs with the caching allocator off
(``PYTORCH_NO_CUDA_MEMORY_CACHING=1``), and one runs a tiny second-order
backward on the device before its first training (``--warm``); each
process trains three times.  ``--trace-ops`` instead
trains two epochs twice in one process under a ``TorchDispatchMode``
that digests every aten operation's inputs and outputs, and names the
first operation whose inputs agree between the runs while its outputs
differ, or whose inputs differ while every earlier output agreed (then a
hand kernel, which writes its outputs outside aten, made them); and the
same for every call of a hand kernel's wrapper (``*_cuda`` in
``ops/cuda_lstm.py`` and ``ops/cuda_lstm_stack.py``).  Prints one JSON
document.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:12]


def _poison(torch, device: str) -> None:
    """Leave NaN in free blocks of every size class of the allocator."""
    held = [torch.full((n,), float("nan"), device=device) for n in
            [2 ** k for k in range(8, 25)] + [3 * 2 ** k for k in range(8, 23)]]
    del held


def _warm_double_backward(torch, device: str) -> None:
    """One tiny second-order backward on ``device`` before any training."""
    x = torch.ones(3, device=device, requires_grad=True)
    (g,) = torch.autograd.grad((x ** 3).sum(), x, create_graph=True)
    (g ** 2).sum().backward()


def child(device: str, deterministic: bool, poison: bool = False, warm: bool = False,
          n_runs: int = 2) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if deterministic:
        torch.use_deterministic_algorithms(True)
    from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.train.trainer import GanTrainer

    cfg = ExperimentConfig(
        model=ModelConfig(features=4, window=8, hidden=100, family="mtss_wgan_gp"),
        train=TrainConfig(epochs=4, batch_size=4, n_critic=1, steps_per_call=2, seed=0))
    ds = torch.from_numpy(np.random.default_rng(2000).standard_normal((12, 8, 4))
                          .astype(np.float32))
    runs = []
    if warm:
        _warm_double_backward(torch, device)
    for _ in range(n_runs):
        if poison:
            _poison(torch, device)
        tr = GanTrainer(cfg, ds, device=device)
        try:
            tr.train()
        except RuntimeError as e:
            print(json.dumps({"error": str(e)[:600]}))
            return
        runs.append({"generator": _digest(tr.state.generator.state_dict().values()),
                     "critic": _digest(tr.state.discriminator.state_dict().values()),
                     "losses": [[round(float(h[k]), 9) for k in sorted(h) if k != "epoch"]
                                for h in tr.history]})
    print(json.dumps({"runs": runs}))


def trace_ops(device: str) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from hfrep_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from hfrep_tpu_torch.train.trainer import GanTrainer

    def dig(x):
        out = []
        for t in (x if isinstance(x, (list, tuple)) else [x]):
            if isinstance(t, torch.Tensor):
                out.append(_digest([t.float() if t.dtype == torch.bool else t]))
        return out

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ins = [d for a in list(args) + list((kwargs or {}).values()) for d in dig(a)]
            out = func(*args, **(kwargs or {}))
            # an uninitialised allocation's bytes are no result
            where = ""
            if len(self.ops) < 400:
                import traceback
                where = " < ".join(f"{fr.name}:{fr.lineno}" for fr in reversed(
                    traceback.extract_stack()) if "hfrep_tpu_torch" in fr.filename)[:300]
            self.ops.append((str(func), ins, [] if "empty" in str(func) else dig(out), where))
            return out

    cfg = ExperimentConfig(
        model=ModelConfig(features=4, window=8, hidden=100, family="mtss_wgan_gp"),
        train=TrainConfig(epochs=2, batch_size=4, n_critic=1, steps_per_call=2, seed=0))
    ds = torch.from_numpy(np.random.default_rng(2000).standard_normal((12, 8, 4))
                          .astype(np.float32))
    from hfrep_tpu_torch.ops import cuda_lstm, cuda_lstm_stack

    calls = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            ins = [d for a in list(args) + list(kwargs.values()) for d in dig(a)]
            out = fn(*args, **kwargs)
            if device == "cuda":
                torch.cuda.synchronize()
            flat = out if isinstance(out, (list, tuple)) else [out]
            calls.append((name, ins, [d for o in flat for d in dig(o)]))
            return out
        setattr(mod, name, wrapped)

    for mod in (cuda_lstm, cuda_lstm_stack):
        for name in [n for n in dir(mod) if n.endswith("_cuda")]:
            wrap(mod, name)
    logs, kernel_logs = [], []
    for _ in range(2):
        calls.clear()
        tr = GanTrainer(cfg, ds, device=device)
        with Log() as log:
            tr.train()
        logs.append(log.ops)
        kernel_logs.append(list(calls))
    a, b = logs
    doc = {"ops": [len(a), len(b)], "first": None, "kernel_calls": len(kernel_logs[0]),
           "kernels": []}
    for i, (x, y) in enumerate(zip(*kernel_logs)):
        if x[1] == y[1] and x[2] != y[2] or x[1] != y[1]:
            doc["kernels"].append({"index": i, "kernel": x[0], "inputs_equal": x[1] == y[1],
                                   "outputs_equal": [p == q for p, q in zip(x[2], y[2])]})
            if len(doc["kernels"]) >= 6:
                break
    for i, (x, y) in enumerate(zip(a, b)):
        if x[1] != y[1] and not x[2]:
            continue
        if x[0] != y[0]:
            doc["first"] = {"index": i, "why": "different op", "ops": [x[0], y[0]],
                            "run1": [(o[0], o[3]) for o in a[max(0, i - 8):i + 4]],
                            "run2": [(o[0], o[3]) for o in b[max(0, i - 8):i + 4]]}
            break
        if x[1] == y[1] and x[2] != y[2]:
            doc["first"] = {"index": i, "why": "same inputs, other outputs", "op": x[0]}
            break
        if x[1] != y[1]:
            doc["first"] = {"index": i, "why": "inputs differ, every earlier output agreed",
                            "op": x[0], "previous": [o[0] for o in a[max(0, i - 6):i]],
                            "inputs_equal": [p == q for p, q in zip(x[1], y[1])]}
            break
    print(json.dumps(doc))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--deterministic", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--poison", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--warm", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--trace-ops", action="store_true")
    args = ap.parse_args()
    if args.trace_ops:
        trace_ops(args.device)
        return
    if args.child:
        child(args.device, args.deterministic, args.poison, args.warm, n_runs=3)
        return
    doc = {"processes": []}
    modes = ["plain"] * args.runs + ["deterministic", "poison", "no_caching", "warm"]
    for mode in modes:
        env = dict(os.environ, PYTHONPATH=ROOT)
        extra = []
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            extra = ["--deterministic"]
        elif mode == "poison":
            extra = ["--poison"]
        elif mode == "warm":
            extra = ["--warm"]
        elif mode == "no_caching":
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        cmd = [sys.executable, __file__, "--child", "--device", args.device]
        proc = subprocess.run(cmd + extra, env=env, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        out = json.loads(lines[-1]) if lines else {"stderr": proc.stderr[-1500:]}
        out["mode"] = mode
        doc["processes"].append(out)
    digests = [(r["generator"], r["critic"]) for p in doc["processes"] for r in p.get("runs", [])]
    doc["distinct_param_digests"] = len(set(digests))
    print(json.dumps(doc, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)


if __name__ == "__main__":
    main()
