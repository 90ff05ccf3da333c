"""Window sampling (``hfrep_tpu/core/sampling.py``).

Port of ``helper.py:44-62`` (``random_sampling``): ``n_sample`` random
contiguous windows of length ``window`` from a (T, F) panel.  Starts run
over ``[0, T - window]`` inclusive, as the reference's Python
``randint(0, T - window)`` does, so the last start yields
``data[T-window : T]``.  The gather is one indexing op over a (N, W)
index grid, on the panel's device.  The JAX package's contract is
``*,(T,F)->(N,W,F)``: its leading ``*`` is the PRNG key, which the port's
signature does not take (the draws come from ``generator`` or ``starts``).
"""

from __future__ import annotations

from typing import Optional

import torch

from hfrep_tpu_torch.analysis.contracts import contract


@contract("(T,F)->(N,W,F)")
def sample_windows(data: torch.Tensor, n_sample: int, window: int,
                   generator: Optional[torch.Generator] = None,
                   starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_sample, window, F) random contiguous windows of (T, F) ``data``.

    The starts are drawn with ``torch.randint(0, T - window + 1)`` from
    ``generator`` (on the generator's device, then moved to the panel's),
    or taken as given in ``starts`` (n_sample,)."""
    t, _ = data.shape
    if window > t:
        raise ValueError(f"window {window} longer than panel length {t}")
    if starts is None:
        gen_dev = generator.device if generator is not None else torch.device("cpu")
        starts = torch.randint(0, t - window + 1, (n_sample,), generator=generator,
                               device=gen_dev)
    starts = torch.as_tensor(starts, dtype=torch.long).to(data.device)
    if starts.shape != (n_sample,):
        raise ValueError(f"want {n_sample} starts, got shape {tuple(starts.shape)}")
    grid = starts[:, None] + torch.arange(window, device=data.device)[None, :]
    return data[grid]


def factor_hf_split(arr: torch.Tensor, split_pos: int, reshape: bool = True):
    """Split a (N, W, F) cube into leading-factor and trailing-HF blocks.

    Port of ``helper.py:133-153``: columns ``[:split_pos]`` are factors,
    ``[split_pos:]`` hedge-fund (and optionally rf) returns; with
    ``reshape`` the window axis is flattened into rows."""
    if arr.dim() != 3:
        raise ValueError("expected (N, W, F) cube")
    if not 0 < split_pos < arr.shape[2]:
        raise ValueError(f"split_pos {split_pos} outside (0, {arr.shape[2]})")
    factor = arr[:, :, :split_pos]
    hf = arr[:, :, split_pos:]
    if reshape:
        factor = factor.reshape(-1, factor.shape[2])
        hf = hf.reshape(-1, hf.shape[2])
    return factor, hf
