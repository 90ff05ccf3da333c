"""Generator networks for the six GAN families (``hfrep_tpu/models/generators.py``).

* Dense body (GAN / WGAN / WGAN-GP):
  ``Dense(100, sigmoid) → LeakyReLU(0.2) → LayerNorm → Dense(100, sigmoid)
  → LeakyReLU(0.2) → LayerNorm → Dense(F)``.
* LSTM body (MTSS-GAN / MTSS-WGAN / MTSS-WGAN-GP):
  ``LSTM(100, act=sigmoid) → LayerNorm → LSTM(100, act=sigmoid)
  → LeakyReLU(0.2) → LayerNorm → Dense(F)``.

Noise has the shape of the output window, (B, W, F).  :data:`FLAX_NAMES`
on each class maps the JAX param tree's submodule names to this
module's attributes (:mod:`hfrep_tpu_torch.utils.bridge`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.ops.layers import KerasDense, KerasLayerNorm, leaky_relu
from hfrep_tpu_torch.ops.lstm import KerasLSTM


class DenseGenerator(nn.Module):
    FLAX_NAMES = {"KerasDense_0": "dense0", "KerasLayerNorm_0": "norm0",
                  "KerasDense_1": "dense1", "KerasLayerNorm_1": "norm1",
                  "KerasDense_2": "out"}

    def __init__(self, features: int, hidden: int = 100, slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev,
                  generator=generator)
        self.slope = slope
        self.dense0 = KerasDense(features, hidden, activation="sigmoid", **kw)
        self.norm0 = KerasLayerNorm(hidden, **kw)
        self.dense1 = KerasDense(hidden, hidden, activation="sigmoid", **kw)
        self.norm1 = KerasLayerNorm(hidden, **kw)
        self.out = KerasDense(hidden, features, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.norm0(leaky_relu(self.dense0(z), self.slope))
        x = self.norm1(leaky_relu(self.dense1(x), self.slope))
        return self.out(x)


class LSTMGenerator(nn.Module):
    FLAX_NAMES = {"KerasLSTM_0": "lstm0", "KerasLayerNorm_0": "norm0",
                  "KerasLSTM_1": "lstm1", "KerasLayerNorm_1": "norm1",
                  "KerasDense_0": "out"}

    def __init__(self, features: int, hidden: int = 100, slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=dev,
                  generator=generator)
        self.slope = slope
        self.lstm0 = KerasLSTM(features, hidden, activation="sigmoid", **kw)
        self.norm0 = KerasLayerNorm(hidden, **kw)
        self.lstm1 = KerasLSTM(hidden, hidden, activation="sigmoid", **kw)
        self.norm1 = KerasLayerNorm(hidden, **kw)
        self.out = KerasDense(hidden, features, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.norm0(self.lstm0(z))
        x = leaky_relu(self.lstm1(x), self.slope)
        return self.out(self.norm1(x))
