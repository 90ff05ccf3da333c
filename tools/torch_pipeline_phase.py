#!/usr/bin/env python3
"""chip_smoke.py's pipeline phase alone, on one card.

    python3 tools/torch_pipeline_phase.py [--epochs N] [--out results.json]

Builds the hand kernels, trains a W=168 ``mtss_wgan_gp_prod`` checkpoint
for 2 epochs with ``train-gan`` (as chip_smoke's trainer phase does for
5), then runs ``chip_smoke.phase_pipeline`` on it: the undisturbed
``pipeline`` run, the drained run and its resume, the killed run and the
in-process item check.  ``--epochs`` caps the AE epochs of every run
(default: ``AEConfig()``'s 1000, chip_smoke's own phase uses 200).
Prints each run's wall seconds, restarts, queue depth and launches, the
phase's seconds and the card's name and power limit.  Imports no JAX.
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
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke
    from hfrep_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        chip_smoke.fail("this tool runs on a card")
    t0 = time.perf_counter()  # noqa: HF009
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)  # noqa: HF009
    keep = tempfile.mkdtemp(prefix="pipeline_phase_")
    rc, text = chip_smoke.run_cli(
        ["train-gan", "--preset", "mtss_wgan_gp_prod", "--epochs", "2", "--cleaned-dir",
         os.path.join(ROOT, chip_smoke.CLEANED_DIR), "--checkpoint-dir",
         os.path.join(keep, "prod"), "--quiet"])
    if rc != 0:
        chip_smoke.fail(f"train-gan exited {rc}")
    t0 = time.perf_counter()  # noqa: HF009
    out = chip_smoke.phase_pipeline(torch, np, keep, os.path.join(keep, "prod", "ckpt_2"),
                                    epochs=args.epochs)
    out["phase_s"] = time.perf_counter() - t0  # noqa: HF009
    print(f"phase {out['phase_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    print(chip_smoke.card_line(torch))


if __name__ == "__main__":
    main()
