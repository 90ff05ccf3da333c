"""``python -m hfrep_tpu_torch.analysis`` entry point."""

from __future__ import annotations

import sys

from hfrep_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
