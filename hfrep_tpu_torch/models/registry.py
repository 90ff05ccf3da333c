"""Model-family registry: config → (generator, discriminator, loss kind)
(``hfrep_tpu/models/registry.py``).

Families are named for what they are: ``mtss_*`` carry the LSTM
generator and an LSTM critic, the others the Dense ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.config import ModelConfig
from hfrep_tpu_torch.core.device import DeviceLike, dtype_of, resolve_device
from hfrep_tpu_torch.core.precision import Policy, policy_from
from hfrep_tpu_torch.models.discriminators import (
    DenseCritic, DenseDiscriminator, DenseFlatCritic,
    LSTMCritic, LSTMDiscriminator, LSTMFlatCritic,
)
from hfrep_tpu_torch.models.generators import DenseGenerator, LSTMGenerator

FAMILIES = {
    #        generator        discriminator      loss
    "gan":          (DenseGenerator, DenseDiscriminator, "bce"),
    "wgan":         (DenseGenerator, DenseCritic,        "wgan_clip"),
    "wgan_gp":      (DenseGenerator, DenseFlatCritic,    "wgan_gp"),
    "mtss_gan":     (LSTMGenerator,  LSTMDiscriminator,  "bce"),
    "mtss_wgan":    (LSTMGenerator,  LSTMCritic,         "wgan_clip"),
    "mtss_wgan_gp": (LSTMGenerator,  LSTMFlatCritic,     "wgan_gp"),
}


@dataclasses.dataclass(frozen=True)
class GanPair:
    """A family's two networks as built (Keras-default init), its loss
    kind and the precision policy the train steps read (``Policy.accum``
    lifts scores to float32 before any reduction)."""

    generator: nn.Module
    discriminator: nn.Module
    loss: str            # "bce" | "wgan_clip" | "wgan_gp"
    family: str
    policy: Policy = Policy()


def _family(cfg: ModelConfig) -> tuple:
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown GAN family {cfg.family!r}; "
                       f"available: {sorted(FAMILIES)}")
    return FAMILIES[cfg.family]


def build_generator(cfg: ModelConfig, device: DeviceLike = None,
                    generator: Optional[torch.Generator] = None,
                    in_features: Optional[int] = None) -> nn.Module:
    """The family's generator at ``cfg``'s widths and precision policy,
    Keras-default initialised from ``generator``; ``in_features`` widens
    its input (a conditional body's)."""
    g_cls = _family(cfg)[0]
    policy = policy_from(cfg.dtype, cfg.param_dtype)
    return g_cls(features=cfg.features, hidden=cfg.hidden, slope=cfg.leaky_slope,
                 dtype=dtype_of(cfg.dtype) if cfg.dtype else None,
                 param_dtype=policy.param_dtype, device=device, generator=generator,
                 in_features=in_features)


def build_discriminator(cfg: ModelConfig, device: DeviceLike = None,
                        generator: Optional[torch.Generator] = None,
                        in_features: Optional[int] = None) -> nn.Module:
    """The family's critic for (``cfg.window``, ``cfg.features``) windows,
    or ``in_features`` columns (a conditional body's)."""
    d_cls = _family(cfg)[1]
    policy = policy_from(cfg.dtype, cfg.param_dtype)
    kw = dict(features=in_features or cfg.features, window=cfg.window, hidden=cfg.hidden,
              dtype=dtype_of(cfg.dtype) if cfg.dtype else None,
              param_dtype=policy.param_dtype, device=device, generator=generator)
    if d_cls in (DenseCritic, LSTMCritic):
        kw["slope"] = cfg.leaky_slope
    return d_cls(**kw)


def build_gan(cfg: ModelConfig, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> GanPair:
    """Both networks on ``device`` (``None``: the card), the generator
    initialised first and then the critic from the one ``generator``."""
    dev = resolve_device(device)
    _, _, loss = _family(cfg)
    gen = build_generator(cfg, dev, generator)
    disc = build_discriminator(cfg, dev, generator)
    return GanPair(generator=gen, discriminator=disc, loss=loss,
                   family=cfg.family, policy=policy_from(cfg.dtype, cfg.param_dtype))


def build_conditional_gan(cfg: ModelConfig, cond_dim: int, device: DeviceLike = None,
                          generator: Optional[torch.Generator] = None) -> GanPair:
    """:func:`~hfrep_tpu_torch.models.conditional.build_conditional_gan`:
    the literal :func:`build_gan` pair when ``cond_dim`` is 0."""
    from hfrep_tpu_torch.models.conditional import build_conditional_gan as build
    return build(cfg, cond_dim, device=device, generator=generator)
