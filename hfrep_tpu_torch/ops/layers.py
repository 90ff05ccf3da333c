"""Keras-default layer primitives as ``nn.Module``s (``hfrep_tpu/ops/layers.py``).

The reference models are built from four Keras layers — ``Dense``,
``LSTM``, ``LayerNormalization``, ``LeakyReLU``.  PyTorch's defaults
differ from Keras's in initializer and LayerNorm epsilon (1e-5 vs
1e-3); these modules pin the Keras defaults and keep the Keras layout
(``kernel`` is (in, out)), so parameters cross from the JAX package
without a transpose (:mod:`hfrep_tpu_torch.utils.bridge`).

Initialisation draws from an explicit CPU ``torch.Generator`` and the
result is then moved to the module's device, so one seed gives the same
weights on every device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from hfrep_tpu_torch.core.device import DeviceLike, resolve_device


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """Keras ``LeakyReLU(alpha=.2)``.  The slope is rounded to ``x``'s
    dtype before the product, as JAX does with a Python scalar."""
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` with each operation in ``x``'s dtype — the
    expansion JAX lowers ``jax.nn.sigmoid`` to.  Under bf16 it rounds
    differently from ``torch.sigmoid``, which rounds once."""
    return 1.0 / (1.0 + torch.exp(-x))


ACTIVATIONS: dict[Optional[str], Callable] = {
    None: lambda x: x,
    "linear": lambda x: x,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
}


# ------------------------------------------------------------ initializers
def glorot_uniform_(t: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Keras ``glorot_uniform`` on a (fan_in, fan_out) kernel."""
    fan_in, fan_out = t.shape[0], t.shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def orthogonal_(t: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Keras/Flax ``orthogonal`` on a 2-D kernel."""
    return nn.init.orthogonal_(t, generator=generator)


def new_param(shape, param_dtype: torch.dtype, init, device: torch.device,
              generator: Optional[torch.Generator]) -> nn.Parameter:
    """A parameter initialised on the CPU from ``generator``, then moved."""
    t = torch.empty(shape, dtype=param_dtype)
    init(t, generator)
    return nn.Parameter(t.to(device))


def zeros_(t, generator=None):
    with torch.no_grad():
        return t.zero_()


def ones_(t, generator=None):
    with torch.no_grad():
        return t.fill_(1.0)


def compute_dtype(explicit: Optional[torch.dtype], *tensors) -> torch.dtype:
    """Flax's promotion: the explicit ``dtype``, else the promoted type of
    the operands (bf16 input with float32 weights computes in float32)."""
    if explicit is not None:
        return explicit
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


# ------------------------------------------------------------------ layers
class KerasDense(nn.Module):
    """``keras.layers.Dense``: glorot_uniform kernel (in, out), zeros bias.

    Acts on the trailing axis, so on (B, W, F) inputs it is applied per
    timestep, as Keras ``Dense`` is on 3-D tensors.
    """

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = None, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.activation = activation
        self.dtype = dtype
        self.kernel = new_param((in_features, features), param_dtype,
                                glorot_uniform_, dev, generator)
        self.bias = (new_param((features,), param_dtype, zeros_, dev, generator)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x, self.kernel)
        y = x.to(dt) @ self.kernel.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return ACTIVATIONS[self.activation](y)


class KerasLayerNorm(nn.Module):
    """``keras.layers.LayerNormalization`` defaults: last axis, eps=1e-3.

    Statistics follow Flax's ``LayerNorm`` exactly, since that is the
    reference: mean and variance in float32 even under bf16, variance as
    ``max(0, E[x²] − E[x]²)``, then ``(x − mean) · (rsqrt(var + eps) ·
    scale) + bias`` in float32, cast to the compute dtype at the end.
    """

    def __init__(self, features: int, epsilon: float = 1e-3,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = new_param((features,), param_dtype, ones_, dev, generator)
        self.bias = new_param((features,), param_dtype, zeros_, dev, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.epsilon, self.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-3, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:class:`KerasLayerNorm`'s arithmetic on explicit parameters (the
    parallel forwards' param-level form)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + epsilon) * scale
    y = (xf - mean) * mul + bias
    return y.to(compute_dtype(dtype, x, scale))
