#!/usr/bin/env python3
"""chip_smoke.py's obs_tier phase alone, on one card.

    python3 tools/torch_obs_phase.py [--out results.json]

Builds the hand kernels, trains a W=168 ``mtss_wgan_gp_prod`` checkpoint
for 5 epochs with ``train-gan --obs-dir`` (as chip_smoke's trainer phase
does, launch counts set to 0 just before), runs
``chip_smoke.phase_serve_drain`` on it, then ``chip_smoke.phase_obs_tier``
over those run dirs.  Prints the phases' lines, their seconds and the
card's name and power limit.  Imports no JAX.
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
    keep = tempfile.mkdtemp(prefix="obs_phase_")
    try:
        cli_obs = os.path.join(keep, "prod_obs")
        cuda_lstm.reset_launches()
        rc, text = chip_smoke.run_cli(
            ["train-gan", "--preset", "mtss_wgan_gp_prod", "--epochs",
             str(chip_smoke.CLI_EPOCHS), "--cleaned-dir",
             os.path.join(ROOT, chip_smoke.CLEANED_DIR), "--checkpoint-dir",
             os.path.join(keep, "prod"), "--obs-dir", cli_obs, "--quiet"])
        torch.cuda.synchronize()
        launches = cuda_lstm.launch_counts()
        if rc != 0:
            chip_smoke.fail(f"train-gan exited {rc}")
        ckpt = os.path.join(keep, "prod", f"ckpt_{chip_smoke.CLI_EPOCHS}")
        out = {"serve_drain": chip_smoke.phase_serve_drain(torch, np, keep, ckpt)}
        out["obs_tier"] = chip_smoke.phase_obs_tier(torch, np, keep, cli_obs, launches)
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
