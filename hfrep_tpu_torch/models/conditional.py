"""Regime-conditioned generator and critic (``hfrep_tpu/models/conditional.py``).

The conditioning is input concatenation: the condition vector (a regime
one-hot, (B, C) or (C,)) is tiled over the window axis and concatenated
onto the feature axis of the generator's noise and of the critic's
input.  Both bodies are the unconditional networks with a first layer
``F + C`` wide; the generator still emits ``features`` columns, so a
conditional sample cube fits every consumer of an unconditional one.

``build_conditional_gan(cfg, 0)`` returns the literal
:func:`~hfrep_tpu_torch.models.registry.build_gan` pair, not a wrapper
that reduces to it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.config import ModelConfig
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.core.precision import policy_from
from hfrep_tpu_torch.models.registry import (GanPair, _family, build_discriminator,
                                             build_gan, build_generator)


def concat_condition(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """(B, W, F) ⊕ condition → (B, W, F+C): the condition tiles over the
    window axis (every step of a window lives in one regime), cast to
    ``x``'s dtype."""
    cond = torch.as_tensor(cond).to(device=x.device, dtype=x.dtype)
    if cond.dim() == 1:
        cond = cond.expand(x.shape[0], cond.shape[0])
    if cond.dim() != 2 or cond.shape[0] != x.shape[0]:
        raise ValueError(f"condition {tuple(cond.shape)} does not align with "
                         f"batch {tuple(x.shape)}")
    tiled = cond[:, None, :].expand(x.shape[0], x.shape[1], cond.shape[1])
    return torch.cat([x, tiled], dim=-1)


class _Conditional(nn.Module):
    """An unconditional body behind a condition-concat input."""

    FLAX_NAMES = {"body": "body"}

    def __init__(self, body: nn.Module, cond_dim: int):
        super().__init__()
        self.body = body
        self.cond_dim = cond_dim

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        if cond.shape[-1] != self.cond_dim:
            raise ValueError(f"condition width {cond.shape[-1]} != cond_dim {self.cond_dim}")
        return self.body(concat_condition(x, cond))


class ConditionalGenerator(_Conditional):
    """``(z, cond) -> (B, W, F)``."""


class ConditionalDiscriminator(_Conditional):
    """``(x, cond) -> scores``; an MTSS body's ``stack`` route is
    ``self.body.stack``."""


def build_conditional_gan(cfg: ModelConfig, cond_dim: int, device: DeviceLike = None,
                          generator: Optional[torch.Generator] = None) -> GanPair:
    """A :class:`GanPair` whose members take ``(input, cond)`` when
    ``cond_dim > 0``, both bodies built ``features + cond_dim`` wide, the
    generator first, from ``generator``; the literal unconditional pair
    when ``cond_dim`` is 0."""
    if cond_dim <= 0:
        return build_gan(cfg, device=device, generator=generator)
    dev = resolve_device(device)
    width = cfg.features + cond_dim
    gen = build_generator(cfg, dev, generator, in_features=width)
    disc = build_discriminator(cfg, dev, generator, in_features=width)
    return GanPair(generator=ConditionalGenerator(gen, cond_dim),
                   discriminator=ConditionalDiscriminator(disc, cond_dim),
                   loss=_family(cfg)[2], family=cfg.family,
                   policy=policy_from(cfg.dtype, cfg.param_dtype))
