"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``hfrep_tpu_torch/csrc/<name>.cu`` becomes one shared library with
a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/cuda/<name>-<hash>.so <name>.cu

The library goes into ``build/cuda/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  ``nvcc``'s output
(the ``-Xptxas -v`` register, shared-memory and spill report) is kept
beside it as ``<name>-<hash>.log``.

Nothing builds at import time.  :func:`load` builds on first use under a
lock, so two server workers asking at once build once; a server's
``warm()`` reaches it before the workers dispatch.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

This route (a C interface bound with ``ctypes``) rather than
``torch.utils.cpp_extension.load``: a source that includes PyTorch's
headers takes minutes to compile and needs ``ninja``; this one takes
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of hfrep_tpu_torch "
                       "are built on the machine with the card")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _build_locked(names: Iterable[str]) -> None:
    """Compile every missing library of ``names`` in parallel (lock held)."""
    todo = [(n, _target(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, so in todo:
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def build_all() -> Dict[str, str]:
    """Build every source under ``csrc/`` (one ``nvcc`` each, in
    parallel); return ``{name: nvcc output}``."""
    names = sources()
    with _lock:
        _build_locked(names)
    return {n: build_log(n) for n in names}


def build_log(name: str) -> str:
    """``nvcc``'s output for the current build of ``name`` ('' if none)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries loaded so far, by source name."""
    with _lock:
        return dict(_libs)


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to ``(restype, [argtypes])``;
    they are declared once, when the library is first loaded.  Pointers
    and the stream must be ``ctypes.c_void_p``, or ctypes passes them as
    32-bit ints.  A function the library lacks (an older ``csrc`` tree,
    built to compare against) is skipped; calling it raises.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _build_locked([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (restype, argtypes) in (signatures or {}).items():
            f = getattr(lib, fn, None)
            if f is not None:
                f.restype, f.argtypes = restype, argtypes
        _libs[name] = lib
        return lib
