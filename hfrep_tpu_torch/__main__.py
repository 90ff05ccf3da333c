"""``python -m hfrep_tpu_torch``: the port's CLI (:mod:`hfrep_tpu_torch.experiments.cli`)."""

import sys

from hfrep_tpu_torch.experiments.cli import main

if __name__ == "__main__":
    sys.exit(main())
