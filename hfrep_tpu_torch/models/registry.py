"""Model-family registry, generator column (``hfrep_tpu/models/registry.py``).

Families are named for what they are: ``mtss_*`` carry the LSTM
generator, the others the Dense one.  The critics and ``build_gan``
arrive with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.config import ModelConfig
from hfrep_tpu_torch.core.device import DeviceLike, dtype_of
from hfrep_tpu_torch.core.precision import Policy, policy_from  # noqa: F401
from hfrep_tpu_torch.models.generators import DenseGenerator, LSTMGenerator

FAMILIES = {
    "gan": DenseGenerator,
    "wgan": DenseGenerator,
    "wgan_gp": DenseGenerator,
    "mtss_gan": LSTMGenerator,
    "mtss_wgan": LSTMGenerator,
    "mtss_wgan_gp": LSTMGenerator,
}


def build_generator(cfg: ModelConfig, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """The family's generator at ``cfg``'s widths and precision policy,
    Keras-default initialised from ``generator``."""
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown GAN family {cfg.family!r}; "
                       f"available: {sorted(FAMILIES)}")
    policy = policy_from(cfg.dtype, cfg.param_dtype)
    return FAMILIES[cfg.family](
        features=cfg.features, hidden=cfg.hidden, slope=cfg.leaky_slope,
        dtype=dtype_of(cfg.dtype) if cfg.dtype else None,
        param_dtype=policy.param_dtype, device=device, generator=generator)
