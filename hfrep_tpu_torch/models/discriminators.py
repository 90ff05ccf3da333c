"""Discriminator / critic networks for the six GAN families
(``hfrep_tpu/models/discriminators.py``).

All emit **logits** (no output sigmoid): the BCE families apply the
sigmoid inside the loss.  Per-timestep vs flattened heads, as in the
reference:

* GAN D: ``Dense(100) → Dense(100) → Dense(1)`` per timestep → (B, W, 1).
* WGAN critic: ``Dense(100) → LeakyReLU → LN → Dense(100) → LeakyReLU →
  LN → Dense(1)`` → (B, W, 1).
* WGAN-GP critic: ``Dense(100) → Dense(100) → Flatten → Dense(1)`` → (B, 1).
* MTSS-GAN D: ``LSTM(100) → LSTM(100) → Dense(1)`` → (B, W, 1), tanh.
* MTSS-WGAN critic: ``LSTM(100, act=None) → LeakyReLU → LN →
  LSTM(100, act=None) → LeakyReLU → LN → Dense(1)`` → (B, W, 1).
* MTSS-WGAN-GP critic: ``LSTM(100) → LSTM(100) → Flatten → Dense(1)`` →
  (B, 1).

Flax infers input widths at init; here each critic is built with the
window ``W`` and features ``F`` it scores (the flattened heads need
``W``).  :data:`FLAX_NAMES` on each class maps the JAX param tree's
submodule names to this module's attributes
(:mod:`hfrep_tpu_torch.utils.bridge`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.ops.cuda_lstm_stack import keras_lstm_stack, stack_fits
from hfrep_tpu_torch.ops.layers import KerasDense, KerasLayerNorm, leaky_relu
from hfrep_tpu_torch.ops.lstm import KerasLSTM


def _kw(dtype, param_dtype, device, generator) -> dict:
    return dict(dtype=dtype, param_dtype=param_dtype,
                device=resolve_device(device), generator=generator)


class DenseDiscriminator(nn.Module):
    """Vanilla GAN discriminator; logits (B, W, 1)."""

    FLAX_NAMES = {"KerasDense_0": "dense0", "KerasDense_1": "dense1",
                  "KerasDense_2": "out"}

    def __init__(self, features: int, window: int, hidden: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(dtype, param_dtype, device, generator)
        self.dense0 = KerasDense(features, hidden, **kw)
        self.dense1 = KerasDense(hidden, hidden, **kw)
        self.out = KerasDense(hidden, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.dense1(self.dense0(x)))


class DenseCritic(nn.Module):
    """WGAN (weight-clipped) critic; scores (B, W, 1)."""

    FLAX_NAMES = {"KerasDense_0": "dense0", "KerasLayerNorm_0": "norm0",
                  "KerasDense_1": "dense1", "KerasLayerNorm_1": "norm1",
                  "KerasDense_2": "out"}

    def __init__(self, features: int, window: int, hidden: int = 100,
                 slope: float = 0.2, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(dtype, param_dtype, device, generator)
        self.slope = slope
        self.dense0 = KerasDense(features, hidden, **kw)
        self.norm0 = KerasLayerNorm(hidden, **kw)
        self.dense1 = KerasDense(hidden, hidden, **kw)
        self.norm1 = KerasLayerNorm(hidden, **kw)
        self.out = KerasDense(hidden, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm0(leaky_relu(self.dense0(x), self.slope))
        x = self.norm1(leaky_relu(self.dense1(x), self.slope))
        return self.out(x)


class DenseFlatCritic(nn.Module):
    """WGAN-GP critic; one score per window, (B, 1)."""

    FLAX_NAMES = {"KerasDense_0": "dense0", "KerasDense_1": "dense1",
                  "KerasDense_2": "out"}

    def __init__(self, features: int, window: int, hidden: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(dtype, param_dtype, device, generator)
        self.dense0 = KerasDense(features, hidden, **kw)
        self.dense1 = KerasDense(hidden, hidden, **kw)
        self.out = KerasDense(window * hidden, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense1(self.dense0(x))
        return self.out(x.reshape(x.shape[0], -1))


STACK_ROUTES = ("auto", "chained")


def _plain_stack(lstm0: KerasLSTM, lstm1: KerasLSTM, x: torch.Tensor,
                 stack: str = "auto") -> torch.Tensor:
    """Two stacked default-activation (tanh) ``KerasLSTM``s: the
    plain-stack topology of the MTSS critics (``_plain_stack``).

    Routed as the JAX package routes it: with ``stack="auto"`` the pair
    runs as ONE fused two-layer kernel chain
    (:func:`~hfrep_tpu_torch.ops.cuda_lstm_stack.keras_lstm_stack`,
    kernels 4–6) wherever :func:`~hfrep_tpu_torch.ops.cuda_lstm_stack.stack_fits`
    admits the width and compute dtype, and as two chained single-layer
    LSTMs (kernels 1–3 per layer) otherwise.  ``stack="chained"`` asks
    for the chained route, as the JAX caller's ``backend`` argument
    does.  The parameters stay on ``lstm0``/``lstm1`` either way."""
    if stack not in STACK_ROUTES:
        raise ValueError(f"stack must be one of {STACK_ROUTES}, got {stack!r}")
    dt = lstm0.dtype or x.dtype
    if stack == "chained" or not stack_fits(lstm0.features, dt):
        return lstm1(lstm0(x))
    # the fused kernel takes one activation for both layers
    assert lstm0.activation == lstm1.activation, (lstm0.activation, lstm1.activation)
    return keras_lstm_stack(dict(lstm0.named_parameters()), dict(lstm1.named_parameters()),
                            x, lstm0.activation, lstm0.recurrent_activation, dtype=dt)


class LSTMDiscriminator(nn.Module):
    """MTSS-GAN discriminator; logits (B, W, 1).  ``stack`` picks the
    LSTM pair's route (:func:`_plain_stack`)."""

    FLAX_NAMES = {"KerasLSTM_0": "lstm0", "KerasLSTM_1": "lstm1",
                  "KerasDense_0": "out"}

    def __init__(self, features: int, window: int, hidden: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 stack: str = "auto"):
        super().__init__()
        kw = _kw(dtype, param_dtype, device, generator)
        self.stack = stack
        self.lstm0 = KerasLSTM(features, hidden, **kw)
        self.lstm1 = KerasLSTM(hidden, hidden, **kw)
        self.out = KerasDense(hidden, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(_plain_stack(self.lstm0, self.lstm1, x, self.stack))


class LSTMCritic(nn.Module):
    """MTSS-WGAN critic; scores (B, W, 1); linear LSTM activations."""

    FLAX_NAMES = {"KerasLSTM_0": "lstm0", "KerasLayerNorm_0": "norm0",
                  "KerasLSTM_1": "lstm1", "KerasLayerNorm_1": "norm1",
                  "KerasDense_0": "out"}

    def __init__(self, features: int, window: int, hidden: int = 100,
                 slope: float = 0.2, dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _kw(dtype, param_dtype, device, generator)
        self.slope = slope
        self.lstm0 = KerasLSTM(features, hidden, activation=None, **kw)
        self.norm0 = KerasLayerNorm(hidden, **kw)
        self.lstm1 = KerasLSTM(hidden, hidden, activation=None, **kw)
        self.norm1 = KerasLayerNorm(hidden, **kw)
        self.out = KerasDense(hidden, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm0(leaky_relu(self.lstm0(x), self.slope))
        x = self.norm1(leaky_relu(self.lstm1(x), self.slope))
        return self.out(x)


class LSTMFlatCritic(nn.Module):
    """MTSS-WGAN-GP critic; one score per window, (B, 1).  ``stack``
    picks the LSTM pair's route (:func:`_plain_stack`)."""

    FLAX_NAMES = {"KerasLSTM_0": "lstm0", "KerasLSTM_1": "lstm1",
                  "KerasDense_0": "out"}

    def __init__(self, features: int, window: int, hidden: int = 100,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 stack: str = "auto"):
        super().__init__()
        kw = _kw(dtype, param_dtype, device, generator)
        self.stack = stack
        self.lstm0 = KerasLSTM(features, hidden, **kw)
        self.lstm1 = KerasLSTM(hidden, hidden, **kw)
        self.out = KerasDense(window * hidden, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _plain_stack(self.lstm0, self.lstm1, x, self.stack)
        return self.out(x.reshape(x.shape[0], -1))
