"""MinMax scaling on tensors (``hfrep_tpu/core/scaler.py``).

The semantics of sklearn's default ``MinMaxScaler(feature_range=(0, 1))``:
a column with zero range scales by 1.0.  Min, max, subtraction and
division are exact IEEE operations, so in float32 the port's results
are the JAX package's bit for bit.  The params ride along in
checkpoints, so generated samples can always be inverse-transformed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ScalerParams(NamedTuple):
    data_min: torch.Tensor   # (F,)
    data_max: torch.Tensor   # (F,)

    @property
    def scale(self) -> torch.Tensor:
        rng = self.data_max - self.data_min
        return torch.where(rng == 0.0, torch.ones_like(rng), rng)


def fit(x: torch.Tensor) -> ScalerParams:
    """Fit over axis 0 of a (T, F) panel."""
    return ScalerParams(x.amin(dim=0), x.amax(dim=0))


def transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return (x - params.data_min) / params.scale


def inverse_transform(params: ScalerParams, x: torch.Tensor) -> torch.Tensor:
    return x * params.scale + params.data_min


def fit_transform(x: torch.Tensor) -> tuple[ScalerParams, torch.Tensor]:
    p = fit(x)
    return p, transform(p, x)


class MinMaxScaler:
    """Object wrapper over :class:`ScalerParams` and the free functions."""

    def __init__(self) -> None:
        self.params: Optional[ScalerParams] = None

    def fit(self, x) -> "MinMaxScaler":
        self.params = fit(torch.as_tensor(x))
        return self

    def transform(self, x):
        assert self.params is not None, "fit first"
        return transform(self.params, torch.as_tensor(x))

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def inverse_transform(self, x):
        assert self.params is not None, "fit first"
        return inverse_transform(self.params, torch.as_tensor(x))
