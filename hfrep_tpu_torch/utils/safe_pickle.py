"""Restricted unpickling (the port's copy of ``hfrep_tpu/utils/safe_pickle.py``).

The committed panel's name maps (``*_fullname.pkl``, ``*_name.pkl``)
are plain str→str dicts, and the reference's sample cube is a numpy
array, so an allowlist of numpy's reconstruction globals covers
everything legitimately present; any other global named in the stream
raises ``UnpicklingError`` instead of executing.
"""

from __future__ import annotations

import io
import pickle

_ALLOWED_GLOBALS = {
    # numpy ndarray/dtype reconstruction (module path moved in numpy 2.x)
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _ALLOWED_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"blocked pickle global {module}.{name!r}: only plain-data "
            "pickles (builtins + numpy arrays) may be loaded")


def safe_pickle_load(fh) -> object:
    """``pickle.load`` with the restricted allowlist."""
    return _RestrictedUnpickler(fh).load()


def safe_pickle_loads(data: bytes) -> object:
    return _RestrictedUnpickler(io.BytesIO(data)).load()
