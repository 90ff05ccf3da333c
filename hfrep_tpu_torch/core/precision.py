"""Mixed-precision policy over torch dtypes (``hfrep_tpu/core/precision.py``).

bf16 compute over float32 master weights: parameters live in
``param_dtype``; layers cast weights and inputs to ``compute_dtype`` at
use; everything that accumulates is lifted to ``output_dtype`` (float32)
first via :meth:`Policy.accum`.  On the float32 policy every method is
the identity and returns its argument unchanged.

The bf16 products accumulate in float32, as the JAX package's flags
promise: importing :mod:`hfrep_tpu_torch` turns off
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from hfrep_tpu_torch.core.device import dtype_of


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    """What dtype each role runs in: ``compute_dtype`` (matmuls and
    activations), ``param_dtype`` (master weights), ``output_dtype``
    (accumulations and everything handed back to the caller)."""

    compute_dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    output_dtype: Any = torch.float32

    @property
    def mixed(self) -> bool:
        """True when compute runs below the output/accumulation width."""
        return self.compute_dtype != self.output_dtype

    def compute(self, tree):
        """Cast tensor leaves to the compute dtype."""
        if not self.mixed:
            return tree
        return _tree_map(lambda x: x.to(self.compute_dtype), tree)

    def accum(self, tree):
        """Lift tensor leaves to the output dtype before any reduction."""
        if not self.mixed:
            return tree
        return _tree_map(lambda x: x.to(self.output_dtype), tree)

    def describe(self) -> dict:
        """Plain-data form for run manifests."""
        name = lambda d: str(d).replace("torch.", "")  # noqa: E731
        return {"compute": name(self.compute_dtype),
                "param": name(self.param_dtype),
                "output": name(self.output_dtype)}


def policy_from(dtype: str | None, param_dtype: str | None = None) -> Policy:
    """Config strings → :class:`Policy`; ``None`` means float32."""
    return Policy(compute_dtype=dtype_of(dtype) or torch.float32,
                  param_dtype=dtype_of(param_dtype) or torch.float32,
                  output_dtype=torch.float32)
