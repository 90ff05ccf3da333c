"""The LSTM forward recurrence: CUDA kernel, plain version, dispatch.

Counterpart of ``hfrep_tpu/ops/pallas_lstm.py``'s primal forward
(``_fwd_kernel`` through ``_lstm_seq_fwd_impl``, ``lstm_seq``,
``pallas_keras_lstm``).  Three layers:

* :func:`lstm_fwd_cuda` — the wrapper of the hand-written Hopper kernel
  ``csrc/lstm_fwd.cu``: checks device, dtype, shape and contiguity,
  allocates the output, launches on PyTorch's current stream, raises if
  the launch was refused, and counts the launch in :data:`launches`;
* :func:`lstm_seq_plain` — the same function as a plain PyTorch step
  loop with the same mixed-precision contract (the CPU tests use it, and
  ``chip_smoke.py`` holds the kernel against it on the card);
* :func:`lstm_seq` — the one dispatch rule: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version.  There is no fallback: on a
  CUDA tensor the kernel runs or the call raises.

The layout is the unpadded Keras one: xz (W, B, 4H) time-major with
gate blocks [i, f, c, o], rec (H, 4H).  The TPU kernel's 128-lane gate
padding is a TPU fact and is not carried over.  Gates are sigmoid;
``activation`` (sigmoid, tanh or linear) transforms the candidate and
the output.  Operands stream as float32 or bf16; h, c, the gate math and
the accumulation are float32, and h is rounded to the operand dtype
before the recurrent dot.  hs comes back float32.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from hfrep_tpu_torch.ops import _build
from hfrep_tpu_torch.ops.layers import sigmoid

ACT_CODES = {"linear": 0, None: 0, "sigmoid": 1, "tanh": 2}
_PLAIN_ACT = {0: lambda x: x, 1: sigmoid, 2: torch.tanh}
STREAM_DTYPES = (torch.float32, torch.bfloat16)
MAX_THREADS = 1024

_SIGNATURES = {
    "hfrep_lstm_fwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,      # xz, rec, hs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                # W, B, H
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # act, bf16, rows, device
        ctypes.c_void_p]),                                       # stream
    "hfrep_max_smem_optin": (ctypes.c_int, [ctypes.c_int]),
    "hfrep_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}

#: kernel launches made by :func:`lstm_fwd_cuda` (reset with
#: :func:`reset_launches`); only a successful launch counts
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


def _count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def act_code(activation: Optional[str]) -> int:
    if activation not in ACT_CODES:
        raise NotImplementedError(
            f"LSTM kernel: unsupported activation {activation!r}; "
            f"supported: sigmoid, tanh, linear")
    return ACT_CODES[activation]


def smem_bytes(hidden: int, dtype: torch.dtype, rows: int = 1) -> int:
    """Dynamic shared memory of one block: rec plus two h buffers."""
    item = torch.empty((), dtype=dtype).element_size()
    return (4 * hidden * hidden + 2 * rows * hidden) * item


def rows_per_block(batch: int, hidden: int, sm_count: int) -> int:
    """As few batch rows per block as fill the SMs: each row adds a
    thread per hidden unit but not to the per-step chain."""
    return max(1, min(math.ceil(batch / sm_count), MAX_THREADS // hidden))


def check_fits(hidden: int, dtype: torch.dtype, rows: int, smem_limit: int) -> None:
    """The kernel's eligibility rule: one block holds rec and two h
    buffers in shared memory and one thread per (row, hidden unit)."""
    if rows * hidden > MAX_THREADS:
        raise ValueError(f"LSTM kernel: {rows} rows x hidden width {hidden} "
                         f"exceeds {MAX_THREADS} threads a block")
    need = smem_bytes(hidden, dtype, rows)
    if need > smem_limit:
        raise ValueError(
            f"LSTM kernel: hidden width {hidden} in {dtype} needs {need} B of "
            f"shared memory for rec and h; one block of this card may use "
            f"{smem_limit} B")


def _lib():
    return _build.load("lstm_fwd", _SIGNATURES)


# ------------------------------------------------------------ the kernel
def lstm_fwd_cuda(xz: torch.Tensor, rec: torch.Tensor,
                  activation: Optional[str] = "tanh") -> torch.Tensor:
    """Launch ``csrc/lstm_fwd.cu``: xz (W, B, 4H), rec (H, 4H) → hs
    (W, B, H) float32, on CUDA tensors only."""
    act = act_code(activation)
    if not (isinstance(xz, torch.Tensor) and isinstance(rec, torch.Tensor)):
        raise TypeError("lstm_fwd_cuda takes tensors")
    if xz.dtype not in STREAM_DTYPES or rec.dtype != xz.dtype:
        raise TypeError(f"lstm_fwd_cuda streams float32 or bfloat16 with xz and "
                        f"rec alike; got {xz.dtype} and {rec.dtype}")
    if xz.dim() != 3 or rec.dim() != 2:
        raise ValueError(f"want xz (W, B, 4H) and rec (H, 4H); got "
                         f"{tuple(xz.shape)} and {tuple(rec.shape)}")
    w, b, g = xz.shape
    h = rec.shape[0]
    if h < 1 or g != 4 * h or rec.shape[1] != 4 * h:
        raise ValueError(f"want xz (W, B, 4H) and rec (H, 4H); got "
                         f"{tuple(xz.shape)} and {tuple(rec.shape)}")
    if not (xz.is_contiguous() and rec.is_contiguous()):
        raise ValueError("lstm_fwd_cuda needs contiguous xz and rec")
    if not (xz.is_cuda and rec.is_cuda):
        raise ValueError(f"lstm_fwd_cuda runs on CUDA tensors; got xz on "
                         f"{xz.device}, rec on {rec.device}")
    if xz.device != rec.device:
        raise ValueError(f"xz on {xz.device} but rec on {rec.device}")
    if torch.is_grad_enabled() and (xz.requires_grad or rec.requires_grad):
        raise NotImplementedError(
            "lstm_fwd_cuda is forward-only: the backward kernel is not "
            "ported yet; call it under torch.no_grad()/inference_mode()")
    hs = torch.empty((w, b, h), dtype=torch.float32, device=xz.device)
    if w == 0 or b == 0:
        return hs
    lib = _lib()
    dev = xz.device.index if xz.device.index is not None else torch.cuda.current_device()
    rows = rows_per_block(b, h, torch.cuda.get_device_properties(dev).multi_processor_count)
    check_fits(h, xz.dtype, rows, lib.hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz.device).cuda_stream
    err = lib.hfrep_lstm_fwd(xz.data_ptr(), rec.data_ptr(), hs.data_ptr(),
                             w, b, h, act, int(xz.dtype == torch.bfloat16),
                             rows, dev, stream)
    if err != 0:
        msg = lib.hfrep_cuda_error_string(err).decode()
        raise RuntimeError(f"lstm_fwd kernel launch failed: {msg} (cudaError {err})")
    _count_launch()
    return hs


# ------------------------------------------------------ the plain version
def lstm_seq_plain(xz: torch.Tensor, rec: torch.Tensor,
                   activation: Optional[str] = "tanh") -> torch.Tensor:
    """The kernel's function as a plain step loop (``lstm_cell_step``).

    Same contract: h is rounded to the operand dtype before the dot, and
    the dot (exact products of bf16 values, summed in float32), state and
    gate math are float32.  Returns hs (W, B, H) float32.
    """
    act = _PLAIN_ACT[act_code(activation)]
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    hs = torch.empty((w, b, h), dtype=torch.float32, device=xz.device)
    h_t = torch.zeros((b, h), dtype=torch.float32, device=xz.device)
    c = torch.zeros_like(h_t)
    for t in range(w):
        lhs = h_t if rec.dtype == torch.float32 else h_t.to(rec.dtype).float()
        z = xz[t].float() + lhs @ rec32
        gates = sigmoid(z)                       # one sigmoid over i, f, _, o
        c = gates[:, h:2 * h] * c + gates[:, :h] * act(z[:, 2 * h:3 * h])
        h_t = gates[:, 3 * h:] * act(c)
        hs[t] = h_t
    return hs


# ---------------------------------------------------------------- dispatch
def lstm_seq(xz: torch.Tensor, rec: torch.Tensor,
             activation: Optional[str] = "tanh") -> torch.Tensor:
    """(W, B, 4H) × (H, 4H) → (W, B, H) float32: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if xz.is_cuda:
        return lstm_fwd_cuda(xz, rec, activation)
    if xz.device.type == "cpu":
        return lstm_seq_plain(xz, rec, activation)
    raise ValueError(f"LSTM recurrence: unsupported device {xz.device}")


def keras_lstm(kernel: torch.Tensor, recurrent: torch.Tensor,
               bias: torch.Tensor, x: torch.Tensor,
               activation: Optional[str] = "tanh",
               recurrent_activation: str = "sigmoid",
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Keras-layout entry: (B, W, F) → (B, W, H) in the compute dtype.

    The input projection for every timestep is one ``torch.matmul``
    hoisted out of the recurrence; the recurrence is :func:`lstm_seq`;
    hs is cast back to the compute dtype (``pallas_keras_lstm``'s
    contract).
    """
    if recurrent_activation != "sigmoid":
        raise NotImplementedError(
            f"LSTM supports sigmoid gates only, got {recurrent_activation!r}")
    act_code(activation)
    dt = dtype or x.dtype
    if dt not in STREAM_DTYPES:
        raise NotImplementedError(f"LSTM streams float32/bfloat16, got {dt}")
    b, w, f = x.shape
    hidden = recurrent.shape[0]
    xz = (x.to(dt).reshape(b * w, f) @ kernel.to(dt) + bias.to(dt)
          ).reshape(b, w, 4 * hidden)
    xz = xz.transpose(0, 1).contiguous()                       # (W, B, 4H)
    hs = lstm_seq(xz, recurrent.to(dt).contiguous(), activation or "linear")
    return hs.transpose(0, 1).to(dt)
