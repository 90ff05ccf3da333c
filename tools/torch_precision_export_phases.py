#!/usr/bin/env python3
"""chip_smoke.py's precision, server and serve_drain phases alone, on one card.

    python3 tools/torch_precision_export_phases.py [--out results.json]

Builds the hand kernels, runs chip_smoke's train phases (whose per-epoch
launch counts the precision phase holds the bf16 epochs to), then
``chip_smoke.phase_precision`` (a bf16 epoch a route against the CPU,
``train-gan --dtype bfloat16`` with a resume, ``sweep --dtype bfloat16``
and the bf16 lane sweep against the CPU), ``chip_smoke.phase_server``
(every bucket a loaded ``torch.export`` program, bit for bit the eager
one, warm seconds with export on and off), trains a W=168
``mtss_wgan_gp_prod`` checkpoint for 2 epochs with ``train-gan`` and runs
``chip_smoke.phase_serve_drain`` on it, then the forward's timing rows
(the direct launch beside the dispatcher op).  Prints the phases' lines,
their seconds and the card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke
    from hfrep_tpu_torch.ops import _build, cuda_lstm, cuda_lstm_stack

    if not torch.cuda.is_available():
        chip_smoke.fail("this tool runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    seconds = {}
    t0 = time.perf_counter()  # noqa: HF009
    chip_smoke.phase_build(torch, _build, cuda_lstm, cuda_lstm_stack)
    train = chip_smoke.phase_train(torch, cuda_lstm, "auto")
    train_chained = chip_smoke.phase_train(torch, cuda_lstm, "chained",
                                           chip_smoke.TRAIN_PRESETS[:1])
    seconds["build_and_train"] = time.perf_counter() - t0  # noqa: HF009
    keep = tempfile.mkdtemp(prefix="precision_export_")
    out = {}
    try:
        t = time.perf_counter()  # noqa: HF009
        out["precision"] = chip_smoke.phase_precision(torch, np, cuda_lstm, train,
                                                      train_chained, keep)
        seconds["precision"] = time.perf_counter() - t  # noqa: HF009
        t = time.perf_counter()  # noqa: HF009
        out["server"] = chip_smoke.phase_server(torch, np, cuda_lstm)
        seconds["server"] = time.perf_counter() - t  # noqa: HF009
        rc, _ = chip_smoke.run_cli(
            ["train-gan", "--preset", "mtss_wgan_gp_prod", "--epochs", "2", "--cleaned-dir",
             os.path.join(ROOT, chip_smoke.CLEANED_DIR), "--checkpoint-dir",
             os.path.join(keep, "prod"), "--quiet"])
        if rc != 0:
            chip_smoke.fail(f"train-gan exited {rc}")
        t = time.perf_counter()  # noqa: HF009
        out["serve_drain"] = chip_smoke.phase_serve_drain(torch, np, keep,
                                                          os.path.join(keep, "prod", "ckpt_2"))
        seconds["serve_drain"] = time.perf_counter() - t  # noqa: HF009
        t = time.perf_counter()  # noqa: HF009
        out["timing"] = chip_smoke.phase_timing(torch, cuda_lstm)
        seconds["timing"] = time.perf_counter() - t  # noqa: HF009
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    out["seconds"] = seconds
    out["total_s"] = time.perf_counter() - t0  # noqa: HF009
    print(f"seconds {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; total "
          f"{out['total_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    print(chip_smoke.card_line(torch))


if __name__ == "__main__":
    main()
