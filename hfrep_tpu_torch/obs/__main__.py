"""``python -m hfrep_tpu_torch.obs`` entry point (the obs CLI of
:mod:`hfrep_tpu_torch.obs.report`)."""

import sys

from hfrep_tpu_torch.obs.report import main

if __name__ == "__main__":
    sys.exit(main())
