#!/usr/bin/env python3
"""chip_smoke.py's mesh phase alone, on one card.

    python3 tools/torch_mesh_phase.py [--out results.json]

Builds the hand kernels, runs chip_smoke's fused train phase (whose
per-epoch launch counts the mesh phase holds its blocks to), then
``chip_smoke.phase_mesh``: dp=1 and dp=2, the window, layer and
hidden-unit axes (pp=2, sp=2, tp=2) in the rank processes,
``train-gan --coordinator`` and ``--dp-sp 1x2`` with their resumes, the
lane drives and the seed mesh; then ``chip_smoke.DpTpVerb``, ``--dp-tp
1x2`` with its resume (``chip_smoke.py`` runs it beside its analysis
phase), and ``chip_smoke.phase_tile``, dp×sp×tp 1×2×2 as four rank
processes (not in ``chip_smoke.py``'s own run, for its time).
Prints the phase's lines, its seconds and the card's name and power
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
    train = chip_smoke.phase_train(torch, cuda_lstm, "auto", chip_smoke.TRAIN_PRESETS[:1])
    keep = tempfile.mkdtemp(prefix="mesh_phase_")
    try:
        out = {"mesh": chip_smoke.phase_mesh(torch, np, cuda_lstm, train, keep)}
        dp_tp = chip_smoke.DpTpVerb(keep)
        try:
            out["dp_tp"] = dp_tp.finish(torch)
        finally:
            dp_tp.stop()
        out["tile"] = chip_smoke.phase_tile(torch, keep)
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
