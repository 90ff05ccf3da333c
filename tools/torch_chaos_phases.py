#!/usr/bin/env python3
"""chip_smoke.py's forensics and chaos phases alone, on one card.

    python3 tools/torch_chaos_phases.py [--out results.json]

Builds the hand kernels, runs the ``health`` phase's profiled
``train-gan --profile-dir --obs-dir`` (``chip_smoke.profiled_train_gan``),
then ``chip_smoke.phase_forensics`` over it and ``chip_smoke.phase_chaos``.
Prints the phases' lines, their seconds and the card's name and power
limit.  Imports no JAX.
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
    t0 = time.perf_counter()  # noqa: HF009
    chip_smoke.phase_build(torch, _build, cuda_lstm, cuda_lstm_stack)
    keep = tempfile.mkdtemp(prefix="chaos_phases_")
    try:
        prof = chip_smoke.profiled_train_gan(torch, cuda_lstm, keep,
                                             os.path.join(ROOT, chip_smoke.CLEANED_DIR),
                                             "[profile]")
        out = {"forensics": chip_smoke.phase_forensics(torch, np, cuda_lstm, keep,
                                                       {"profile": prof})}
        out["chaos"] = chip_smoke.phase_chaos(torch, np, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    out["total_s"] = time.perf_counter() - t0  # noqa: HF009
    print(f"total {out['total_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    print(chip_smoke.card_line(torch))


if __name__ == "__main__":
    main()
