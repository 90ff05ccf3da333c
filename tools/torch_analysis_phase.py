#!/usr/bin/env python3
"""chip_smoke.py's analysis phase alone, on one card.

    python3 tools/torch_analysis_phase.py [--out results.json]

Runs ``chip_smoke.phase_analysis``: the port's static-analysis gate
and its program audit (``audit --device cuda``, the serve rows'
programs exported on the card) in two subprocesses side by side, while
this process builds ``serve:sample`` at full width on the card (both
presets, the server's first bucket: its ``hfrep.lstm_fwd`` nodes and
launches, bit-equal to the eager path, close to the plain version), the
seeded defects (one JPX002, one JPX004), and checks each function that
carries a shape contract on card tensors (on = off bit for bit, bad
shapes refused, the check's cost a call).  The whole script hands the
phase the eval phase's GanEval covariances and the train phase's epoch
times; alone, the covariances are those of two disjoint sets of 500
real windows of the committed panel at each preset, and the epoch times
are stand-ins.  Builds the forward kernel (``csrc/lstm_fwd.cu``) from
the checkout, the one kernel the serve programs launch.  Prints the
phase's lines, its seconds and the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke
    from hfrep_tpu_torch.config import get_preset
    from hfrep_tpu_torch.core.data import build_gan_dataset, load_panel
    from hfrep_tpu_torch.metrics import gan_eval
    from hfrep_tpu_torch.obs.timeline import clock

    if not torch.cuda.is_available():
        chip_smoke.fail("this tool runs on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = clock()
    panel = load_panel(os.path.join(ROOT, chip_smoke.CLEANED_DIR), device="cuda")
    covs = {}
    for preset in chip_smoke.TRAIN_PRESETS:
        cfg = get_preset(preset)
        windows = build_gan_dataset(cfg.data, cfg.data.seed, panel).windows
        covs[preset] = tuple(gan_eval._cov(gan_eval._flatten_rows(c))
                             for c in (windows[:500], windows[500:1000]))
    train = [{"ms_per_epoch": ms} for ms in (40.0, 45.0)]      # stand-ins
    out = {"analysis": chip_smoke.phase_analysis(torch, np, covs, train)}
    out["total_s"] = clock() - t0
    print(f"total {out['total_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=str)
    print(chip_smoke.card_line(torch))


if __name__ == "__main__":
    main()
