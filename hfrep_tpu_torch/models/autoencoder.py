"""Linear autoencoder replication core (``hfrep_tpu/models/autoencoder.py``).

A one-hidden-layer, bias-free autoencoder (``Autoencoder_encapsulate.py:
19-35``): encoder ``Dense(latent, use_bias=False) + LeakyReLU(0.2)``,
decoder ``Dense(F, use_bias=False) + LeakyReLU(0.2)``.  Every latent
width uses the same (F, max_latent) parameters, and a binary latent mask
zeroes the columns beyond the width served, so a masked model is the
smaller model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.ops.layers import glorot_uniform_, leaky_relu, new_param


class Autoencoder(nn.Module):
    def __init__(self, n_features: int = 22, latent_dim: int = 21,
                 slope: float = 0.2, dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.slope = slope
        #: compute dtype of the two matmuls (``None`` = operand dtype);
        #: parameters are float32 master weights
        self.dtype = dtype
        self.encoder_kernel = new_param((n_features, latent_dim), torch.float32,
                                        glorot_uniform_, dev, generator)
        self.decoder_kernel = new_param((latent_dim, n_features), torch.float32,
                                        glorot_uniform_, dev, generator)

    def encode(self, x: torch.Tensor,
               latent_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ae_encode(x, self.encoder_kernel, latent_mask, self.slope, self.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return leaky_relu(_cast(z, self.dtype) @ _cast(self.decoder_kernel, self.dtype),
                          self.slope)

    def forward(self, x: torch.Tensor,
                latent_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(x, latent_mask))


def latent_mask(latent_dim: int, max_latent: int,
                device: DeviceLike = None) -> torch.Tensor:
    """(max_latent,) float32 mask with ones in the first ``latent_dim`` slots."""
    dev = resolve_device(device)
    return (torch.arange(max_latent, device=dev) < latent_dim).to(torch.float32)


# ------------------------------------------------ the lane grid's batched form
def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def ae_encode(x: torch.Tensor, encoder_kernel: torch.Tensor,
              latent_mask: Optional[torch.Tensor] = None, slope: float = 0.2,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:meth:`Autoencoder.encode` with the kernel passed in: ``x`` (..., R, F)
    against ``encoder_kernel`` (..., F, M), leading (lane) dims broadcast;
    ``latent_mask`` (..., M) masks each lane's latent columns.  ``dtype``
    is the product's compute dtype, both operands cast to it (``None``: no
    cast, the float32 path's graph); the result is in it."""
    z = leaky_relu(_cast(x, dtype) @ _cast(encoder_kernel, dtype), slope)
    if latent_mask is not None:
        z = z * latent_mask.to(z.dtype).unsqueeze(-2)
    return z


def ae_apply(x: torch.Tensor, encoder_kernel: torch.Tensor, decoder_kernel: torch.Tensor,
             latent_mask: Optional[torch.Tensor] = None, slope: float = 0.2,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:meth:`Autoencoder.forward` over a lane grid: (..., R, F) → (..., R, F),
    each of the two products in ``dtype`` (:func:`ae_encode`)."""
    z = ae_encode(x, encoder_kernel, latent_mask, slope, dtype)
    return leaky_relu(_cast(z, dtype) @ _cast(decoder_kernel, dtype), slope)
