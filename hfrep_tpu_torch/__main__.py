"""``python -m hfrep_tpu_torch``: the port's CLI (:mod:`hfrep_tpu_torch.experiments.cli`),
with the verbs ``clean``, ``train-gan``, ``sweep`` and ``serve``."""

import sys

from hfrep_tpu_torch.experiments.cli import main

if __name__ == "__main__":
    sys.exit(main())
