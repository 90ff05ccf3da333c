"""Scenario factory (``hfrep_tpu/scenario``): regime labels, the
conditional GAN's banks, walk-forward sweeps and synthetic universes.

* :mod:`~hfrep_tpu_torch.scenario.regimes`: host-side vol-state labels
  of a panel (the condition vocabulary);
* :mod:`~hfrep_tpu_torch.scenario.conditional`: the conditional GAN's
  training drive and deterministic scenario banks;
* :mod:`~hfrep_tpu_torch.scenario.walkforward`: the AE sweep rolled
  forward, every (window × latent) a lane of one padded grid;
* :mod:`~hfrep_tpu_torch.scenario.universe`: synthetic universes driven
  through the walk-forward.

CLI: ``python -m hfrep_tpu_torch scenario {bank,walkforward,universe}``.
"""

from hfrep_tpu_torch.scenario.regimes import (label_regimes, one_hot,  # noqa: F401
                                              window_conditions)
from hfrep_tpu_torch.scenario.conditional import (generate_bank,  # noqa: F401
                                                  replay_block_digest)
from hfrep_tpu_torch.scenario.walkforward import (WalkForwardSpec,  # noqa: F401
                                                  run_walkforward)
from hfrep_tpu_torch.scenario.universe import (UniverseSpec, drive_universe,  # noqa: F401
                                               synthesize_universe)
