"""The port's one device rule.

Entry points take an explicit ``device``; ``None`` means the card.  A
call that did not ask for the CPU on a machine with no card raises
instead of carrying on there: a number computed on the CPU must never
pass for the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hfrep_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """Config dtype string → ``torch.dtype`` (``None`` stays ``None``)."""
    if name is None:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
