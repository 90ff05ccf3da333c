"""Keras-semantics LSTM as an ``nn.Module`` (``hfrep_tpu/ops/lstm.py``).

The reference's generators are ``LSTM(100, activation='sigmoid')``: in
Keras ``activation=`` replaces the tanh of the candidate cell state and
of the output transform, while the three gates keep sigmoid.
``torch.nn.LSTM`` (cuDNN) hard-wires tanh, so it cannot stand in.

Parameters keep the Keras layout: ``kernel`` (F, 4H),
``recurrent_kernel`` (H, 4H), ``bias`` (4H,), gate blocks ordered
[input, forget, candidate, output], a unit forget-gate bias, a
glorot-uniform kernel and an orthogonal recurrent kernel.  The input
projection for all timesteps is hoisted into one matmul; the recurrence
runs through :func:`hfrep_tpu_torch.ops.cuda_lstm.lstm_seq` — the Hopper
kernel on a CUDA tensor, the plain step loop on a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.ops.cuda_lstm import keras_lstm
from hfrep_tpu_torch.ops.layers import glorot_uniform_, new_param, orthogonal_


def unit_forget_bias_(t: torch.Tensor, generator=None) -> torch.Tensor:
    h = t.shape[0] // 4
    with torch.no_grad():
        t.zero_()
        t[h:2 * h] = 1.0
    return t


class KerasLSTM(nn.Module):
    """``keras.layers.LSTM(features, return_sequences=True)``:
    (B, W, F) → (B, W, H)."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[str] = "tanh",
                 recurrent_activation: str = "sigmoid",
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.features = features
        self.activation = activation
        self.recurrent_activation = recurrent_activation
        self.dtype = dtype
        h4 = 4 * features
        self.kernel = new_param((in_features, h4), param_dtype,
                                glorot_uniform_, dev, generator)
        self.recurrent_kernel = new_param((features, h4), param_dtype,
                                          orthogonal_, dev, generator)
        self.bias = new_param((h4,), param_dtype, unit_forget_bias_, dev,
                              generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return keras_lstm(self.kernel, self.recurrent_kernel, self.bias, x,
                          self.activation or "linear",
                          self.recurrent_activation,
                          dtype=self.dtype or x.dtype)
