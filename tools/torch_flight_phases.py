#!/usr/bin/env python3
"""chip_smoke.py's health and serve_drain phases alone, on one card.

    python3 tools/torch_flight_phases.py [--out results.json]

Builds the hand kernels, runs chip_smoke's train phases (whose per-epoch
launch counts the health phase holds its runs to), trains a W=168
``mtss_wgan_gp_prod`` checkpoint for 2 epochs with ``train-gan``, then
runs ``chip_smoke.phase_health`` (health off = on bit for bit on both
routes and the AE drive, its cost over alternated steady blocks, the
tripwire, ``train-gan --profile-dir``) and ``chip_smoke.phase_serve_drain``
on that checkpoint.  Prints the phases' lines, their seconds and the
card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
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
    t0 = time.perf_counter()  # noqa: HF009
    chip_smoke.phase_build(torch, _build, cuda_lstm, cuda_lstm_stack)
    train = chip_smoke.phase_train(torch, cuda_lstm, "auto")
    train_chained = chip_smoke.phase_train(torch, cuda_lstm, "chained",
                                           chip_smoke.TRAIN_PRESETS[:1])
    keep = tempfile.mkdtemp(prefix="flight_phases_")
    rc, text = chip_smoke.run_cli(
        ["train-gan", "--preset", "mtss_wgan_gp_prod", "--epochs", "2", "--cleaned-dir",
         os.path.join(ROOT, chip_smoke.CLEANED_DIR), "--checkpoint-dir",
         os.path.join(keep, "prod"), "--quiet"])
    if rc != 0:
        chip_smoke.fail(f"train-gan exited {rc}")
    out = {"health": chip_smoke.phase_health(torch, np, cuda_lstm, train, train_chained),
           "serve_drain": chip_smoke.phase_serve_drain(torch, np, keep,
                                                       os.path.join(keep, "prod", "ckpt_2"))}
    out["total_s"] = time.perf_counter() - t0  # noqa: HF009
    print(f"total {out['total_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    print(chip_smoke.card_line(torch))


if __name__ == "__main__":
    main()
