"""The LSTM recurrence and its derivatives: CUDA kernels, plain versions,
dispatch and autograd.

Counterpart of ``hfrep_tpu/ops/pallas_lstm.py`` (``_fwd_kernel`` in its
primal and ``with_cs`` modes, ``_bwd_kernel``, ``_adj_kernel``, and the
nested ``custom_vjp``s ``lstm_seq`` / ``lstm_fwd_res`` /
``lstm_bwd_seq`` over them).  Four layers:

* the wrappers of the hand-written Hopper kernels —
  :func:`lstm_fwd_cuda` (``csrc/lstm_fwd.cu``), :func:`lstm_bwd_cuda`
  (``csrc/lstm_bwd.cu``) and :func:`lstm_adj_cuda` (``csrc/lstm_adj.cu``):
  each checks device, dtype, shape and contiguity, allocates its outputs
  with ``torch.empty``, launches on PyTorch's current stream, raises if a
  launch was refused, and counts its launches (:func:`launch_counts`);
* the plain versions — :func:`lstm_seq_plain`, :func:`lstm_bwd_plain`,
  :func:`lstm_adj_plain`: the same functions as plain PyTorch step loops
  with the same mixed-precision contract (the CPU tests use them, and
  ``chip_smoke.py`` holds each kernel against its own on the card);
* the dispatch — :func:`lstm_fwd`, :func:`lstm_bwd`, :func:`lstm_adj`: a
  CUDA tensor goes to the kernel, a CPU tensor to the plain version.
  There is no fallback: on a CUDA tensor the kernel runs or the call
  raises;
* autograd — :class:`LSTMFwdRes` and :class:`LSTMBwdSeq`, nested as the
  JAX ``custom_vjp``s are, so the WGAN-GP penalty's second order runs
  the adjoint kernel; :func:`lstm_seq` and :func:`keras_lstm` are the
  differentiable entries.

The layout is the unpadded Keras one: xz (W, B, 4H) time-major with
gate blocks [i, f, c, o], rec (H, 4H).  The TPU kernels' 128-lane gate
padding is a TPU fact and is not carried over.  Gates are sigmoid;
``activation`` (sigmoid, tanh or linear) transforms the candidate and
the output.  xz and rec stream as float32 or bf16; h, c, the gate math,
the accumulation and every other array are float32.  A float32 vector
dotted with rec or recᵀ is first rounded to rec's dtype, as the TPU
kernels cast it.
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
# d act / d z and its derivative, from the value a = act(z)
_PRIME = {0: torch.ones_like, 1: lambda a: a * (1.0 - a), 2: lambda a: 1.0 - a * a}
_PRIME2 = {0: torch.zeros_like, 1: lambda a: 1.0 - 2.0 * a, 2: lambda a: -2.0 * a}
STREAM_DTYPES = (torch.float32, torch.bfloat16)
MAX_THREADS = 1024
#: the reduction kernel's output tile edge (``lstm_common.cuh``: OS_TILE)
REDUCE_TILE = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_fwd": {
        "hfrep_lstm_fwd": (_I, [_P, _P, _P, _P,          # xz, rec, hs, cs
                                _I, _I, _I,              # W, B, H
                                _I, _I, _I, _I,          # act, bf16, rows, device
                                _P]),                    # stream
        "hfrep_max_smem_optin": (_I, [_I]),
        "hfrep_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "lstm_bwd": {
        "hfrep_lstm_bwd": (_I, [_P] * 11                 # xz rec hs cs dhs dcs dxz dhT dcT drec part
                           + [_I] * 9                    # W B H act bf16 rows splits rps device
                           + [_P]),                      # stream
    },
    "lstm_adj": {
        "hfrep_lstm_adj": (_I, [_P] * 15                 # xz rec v hs cs dhT dcT u uxz uhs ucs udhs urec dzw part
                           + [_I] * 9
                           + [_P]),
    },
}

#: kernel launches, one counter per kernel and mode, each a plain int
#: raised by one where its wrapper launches (reset with
#: :func:`reset_launches`; read all with :func:`launch_counts`)
launches = 0        # lstm_fwd, primal mode
launches_cs = 0     # lstm_fwd, with_cs mode
launches_bwd = 0    # lstm_bwd
launches_adj = 0    # lstm_adj
_COUNTERS = {"lstm_fwd": "launches", "lstm_fwd_cs": "launches_cs",
             "lstm_bwd": "launches_bwd", "lstm_adj": "launches_adj"}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for var in _COUNTERS.values():
            globals()[var] = 0


def launch_counts() -> dict:
    """``{kernel: launches}`` for lstm_fwd, lstm_fwd_cs, lstm_bwd, lstm_adj."""
    with _count_lock:
        return {k: globals()[var] for k, var in _COUNTERS.items()}


def _count_launch(kernel: str) -> None:
    with _count_lock:
        globals()[_COUNTERS[kernel]] += 1


def act_code(activation: Optional[str]) -> int:
    if activation not in ACT_CODES:
        raise NotImplementedError(
            f"LSTM kernel: unsupported activation {activation!r}; "
            f"supported: sigmoid, tanh, linear")
    return ACT_CODES[activation]


# ------------------------------------------------------- eligibility rule
def smem_bytes(hidden: int, dtype: torch.dtype, rows: int = 1,
               kernel: str = "lstm_fwd") -> int:
    """Dynamic shared memory of one block of ``kernel``.

    lstm_fwd: rec plus two h buffers in the operand dtype.  lstm_bwd and
    lstm_adj: rec with a one-entry row pad (rounded up to 16 B), plus
    float32 staging per batch row — h_{t-1} and dz (5H) for the backward;
    h_{t-1}, mu_h, dz and zbar (10H) for the adjoint."""
    item = torch.empty((), dtype=dtype).element_size()
    if kernel == "lstm_fwd":
        return (4 * hidden * hidden + 2 * rows * hidden) * item
    rec = -(-hidden * (4 * hidden + 1) * item // 16) * 16
    per_row = {"lstm_bwd": 5, "lstm_adj": 10}[kernel] * hidden * 4
    return rec + rows * per_row


def rows_per_block(batch: int, hidden: int, sm_count: int) -> int:
    """As few batch rows per block as fill the SMs: each row adds a
    thread per hidden unit but not to the per-step chain."""
    return max(1, min(math.ceil(batch / sm_count), MAX_THREADS // hidden))


def check_fits(hidden: int, dtype: torch.dtype, rows: int, smem_limit: int,
               kernel: str = "lstm_fwd") -> None:
    """The kernels' eligibility rule: one block holds rec and its staging
    buffers in shared memory and one thread per (row, hidden unit)."""
    if rows * hidden > MAX_THREADS:
        raise ValueError(f"{kernel} kernel: {rows} rows x hidden width {hidden} "
                         f"exceeds {MAX_THREADS} threads a block")
    need = smem_bytes(hidden, dtype, rows, kernel)
    if need > smem_limit:
        raise ValueError(
            f"{kernel} kernel: hidden width {hidden} in {dtype} needs {need} B "
            f"of shared memory for rec and its buffers; one block of this card "
            f"may use {smem_limit} B")


def reduce_splits(nrows: int, hidden: int, sm_count: int) -> tuple:
    """How the drec/urec reduction cuts its ``nrows`` = W·B rows:
    ``(splits, rows_per_split)``, enough slices that the (H, 4H) tiles
    times the slices give about four blocks an SM."""
    tiles = math.ceil(4 * hidden / REDUCE_TILE) * math.ceil(hidden / REDUCE_TILE)
    want = max(1, math.ceil(4 * sm_count / tiles))
    per = math.ceil(math.ceil(nrows / want) / REDUCE_TILE) * REDUCE_TILE
    per = max(per, REDUCE_TILE)
    return math.ceil(nrows / per), per


def _lib(name: str = "lstm_fwd"):
    return _build.load(name, _SIGNATURES[name])


# ---------------------------------------------------------- the wrappers
def _check_operands(fn: str, xz: torch.Tensor, rec: torch.Tensor) -> tuple:
    """xz (W, B, 4H) and rec (H, 4H): alike in dtype, contiguous, on one
    CUDA device, not needing a gradient; returns (W, B, H)."""
    if not (isinstance(xz, torch.Tensor) and isinstance(rec, torch.Tensor)):
        raise TypeError(f"{fn} takes tensors")
    if xz.dtype not in STREAM_DTYPES or rec.dtype != xz.dtype:
        raise TypeError(f"{fn} streams float32 or bfloat16 with xz and "
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
        raise ValueError(f"{fn} needs contiguous xz and rec")
    if not (xz.is_cuda and rec.is_cuda):
        raise ValueError(f"{fn} runs on CUDA tensors; got xz on "
                         f"{xz.device}, rec on {rec.device}")
    if xz.device != rec.device:
        raise ValueError(f"xz on {xz.device} but rec on {rec.device}")
    if torch.is_grad_enabled() and (xz.requires_grad or rec.requires_grad):
        raise NotImplementedError(
            f"{fn} is not differentiable itself: differentiate through "
            f"cuda_lstm.lstm_seq / keras_lstm, whose autograd runs the "
            f"backward and adjoint kernels")
    return w, b, h


def _check_f32(fn: str, device: torch.device, shapes: dict) -> None:
    """Each named tensor (None skipped) is float32, contiguous, on
    ``device`` and of the shape given beside it."""
    for name, (t, shape) in shapes.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: want {name} {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} needs a contiguous {name}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} on {t.device}, xz on {device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_setup(xz: torch.Tensor, b: int, h: int, kernel: str) -> tuple:
    """(device index, rows per block, SM count, stream), after the fit
    check."""
    dev = xz.device.index if xz.device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = rows_per_block(b, h, sms)
    check_fits(h, xz.dtype, rows, _lib().hfrep_max_smem_optin(dev), kernel)
    return dev, rows, sms, torch.cuda.current_stream(xz.device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = _lib().hfrep_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} (cudaError {err})")


def lstm_fwd_cuda(xz: torch.Tensor, rec: torch.Tensor,
                  activation: Optional[str] = "tanh", with_cs: bool = False):
    """Launch ``csrc/lstm_fwd.cu``: xz (W, B, 4H), rec (H, 4H) → hs
    (W, B, H) float32, and with ``with_cs`` also cs (W, B, H) float32, on
    CUDA tensors only."""
    act = act_code(activation)
    w, b, h = _check_operands("lstm_fwd_cuda", xz, rec)
    hs = torch.empty((w, b, h), dtype=torch.float32, device=xz.device)
    cs = torch.empty_like(hs) if with_cs else None
    if w == 0 or b == 0:
        return (hs, cs) if with_cs else hs
    dev, rows, _, stream = _launch_setup(xz, b, h, "lstm_fwd")
    err = _lib().hfrep_lstm_fwd(xz.data_ptr(), rec.data_ptr(), hs.data_ptr(),
                                _ptr(cs), w, b, h, act,
                                int(xz.dtype == torch.bfloat16), rows, dev, stream)
    _raise_on(err, "lstm_fwd")
    _count_launch("lstm_fwd_cs" if with_cs else "lstm_fwd")
    return (hs, cs) if with_cs else hs


def lstm_bwd_cuda(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                  cs: torch.Tensor, dhs: torch.Tensor,
                  dcs: Optional[torch.Tensor] = None,
                  activation: Optional[str] = "tanh",
                  with_carries: bool = False) -> tuple:
    """Launch ``csrc/lstm_bwd.cu``: (dxz (W, B, 4H), drec (H, 4H)) and,
    with ``with_carries``, the per-step (dhT, dcT) (W, B, H); every output
    float32.  ``dcs`` is an optional direct cotangent on cs."""
    act = act_code(activation)
    w, b, h = _check_operands("lstm_bwd_cuda", xz, rec)
    seq = (w, b, h)
    _check_f32("lstm_bwd_cuda", xz.device,
               {"hs": (hs, seq), "cs": (cs, seq), "dhs": (dhs, seq), "dcs": (dcs, seq)})
    f32 = dict(dtype=torch.float32, device=xz.device)
    dxz = torch.empty((w, b, 4 * h), **f32)
    drec = torch.empty((h, 4 * h), **f32)
    dhT = torch.empty(seq, **f32) if with_carries else None
    dcT = torch.empty(seq, **f32) if with_carries else None
    outs = (dxz, drec) + ((dhT, dcT) if with_carries else ())
    if w == 0 or b == 0:
        drec.zero_()
        return outs
    dev, rows, sms, stream = _launch_setup(xz, b, h, "lstm_bwd")
    splits, per = reduce_splits(w * b, h, sms)
    part = torch.empty((splits, h, 4 * h), **f32) if splits > 1 else None
    err = _lib("lstm_bwd").hfrep_lstm_bwd(
        xz.data_ptr(), rec.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
        _ptr(dcs), dxz.data_ptr(), _ptr(dhT), _ptr(dcT), drec.data_ptr(), _ptr(part),
        w, b, h, act, int(xz.dtype == torch.bfloat16), rows, splits, per, dev, stream)
    _raise_on(err, "lstm_bwd")
    _count_launch("lstm_bwd")
    return outs


def lstm_adj_cuda(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                  cs: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                  u: torch.Tensor, v: torch.Tensor,
                  activation: Optional[str] = "tanh") -> tuple:
    """Launch ``csrc/lstm_adj.cu``: given u = cot(dxz) (W, B, 4H) and
    v = cot(drec) (H, 4H), the cotangents (uxz, urec, uhs, ucs, udhs) of
    the backward's inputs xz, rec, hs, cs and dhs, all float32."""
    act = act_code(activation)
    w, b, h = _check_operands("lstm_adj_cuda", xz, rec)
    seq = (w, b, h)
    _check_f32("lstm_adj_cuda", xz.device,
               {"hs": (hs, seq), "cs": (cs, seq), "dhT": (dhT, seq), "dcT": (dcT, seq),
                "u": (u, (w, b, 4 * h)), "v": (v, (h, 4 * h))})
    f32 = dict(dtype=torch.float32, device=xz.device)
    uxz = torch.empty((w, b, 4 * h), **f32)
    urec = torch.empty((h, 4 * h), **f32)
    uhs, ucs, udhs = (torch.empty(seq, **f32) for _ in range(3))
    if w == 0 or b == 0:
        urec.zero_()
        return uxz, urec, uhs, ucs, udhs
    dev, rows, sms, stream = _launch_setup(xz, b, h, "lstm_adj")
    splits, per = reduce_splits(w * b, h, sms)
    part = torch.empty((splits, h, 4 * h), **f32) if splits > 1 else None
    dzw = torch.empty((w, b, 4 * h), **f32)          # the backward's dz, for urec
    err = _lib("lstm_adj").hfrep_lstm_adj(
        xz.data_ptr(), rec.data_ptr(), v.data_ptr(), hs.data_ptr(), cs.data_ptr(),
        dhT.data_ptr(), dcT.data_ptr(), u.data_ptr(), uxz.data_ptr(), uhs.data_ptr(),
        ucs.data_ptr(), udhs.data_ptr(), urec.data_ptr(), dzw.data_ptr(), _ptr(part),
        w, b, h, act, int(xz.dtype == torch.bfloat16), rows, splits, per, dev, stream)
    _raise_on(err, "lstm_adj")
    _count_launch("lstm_adj")
    return uxz, urec, uhs, ucs, udhs


# ------------------------------------------------------ the plain versions
def _rounder(rec: torch.Tensor):
    """float32 → float32 through rec's dtype: the cast the TPU kernels make
    before a dot with rec or recᵀ (the identity for float32)."""
    if rec.dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(rec.dtype).float()


def _shifted(seq: torch.Tensor) -> torch.Tensor:
    """Per-step previous-state sequence: step 0 sees zeros."""
    return torch.cat([torch.zeros_like(seq[:1]), seq[:-1]], dim=0)


def _gates(z: torch.Tensor, h: int, act):
    return (sigmoid(z[:, :h]), sigmoid(z[:, h:2 * h]), act(z[:, 2 * h:3 * h]),
            sigmoid(z[:, 3 * h:]))


def lstm_seq_plain(xz: torch.Tensor, rec: torch.Tensor,
                   activation: Optional[str] = "tanh", with_cs: bool = False):
    """The forward kernel's function as a plain step loop
    (``lstm_cell_step``): hs (W, B, H) float32, and with ``with_cs`` also
    cs.  h is rounded to the operand dtype before the dot; the dot (exact
    products of bf16 values, summed in float32), state and gate math are
    float32.  Built from differentiable torch ops, so torch's own autograd
    can differentiate it (the tests' reference)."""
    act = _PLAIN_ACT[act_code(activation)]
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = _rounder(rec)
    h_t = torch.zeros((b, h), dtype=torch.float32, device=xz.device)
    c = torch.zeros_like(h_t)
    hs, cs = [], []
    for t in range(w):
        z = xz[t].float() + rnd(h_t) @ rec32
        gates = sigmoid(z)                       # one sigmoid over i, f, _, o
        c = gates[:, h:2 * h] * c + gates[:, :h] * act(z[:, 2 * h:3 * h])
        h_t = gates[:, 3 * h:] * act(c)
        hs.append(h_t)
        cs.append(c)
    empty = torch.zeros((0, b, h), dtype=torch.float32, device=xz.device)
    hs_t = torch.stack(hs) if hs else empty
    if not with_cs:
        return hs_t
    return hs_t, (torch.stack(cs) if cs else empty.clone())


def lstm_bwd_plain(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dhs: torch.Tensor,
                   dcs: Optional[torch.Tensor] = None,
                   activation: Optional[str] = "tanh",
                   with_carries: bool = False) -> tuple:
    """The backward kernel's function as a plain reverse-time step loop
    (``_bwd_kernel`` / ``_lstm_bwd_scan``): (dxz, drec) [+ (dhT, dcT)]."""
    code = act_code(activation)
    act, p = _PLAIN_ACT[code], _PRIME[code]
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = _rounder(rec)
    h_prev, c_prev = _shifted(hs), _shifted(cs)
    f32 = dict(dtype=torch.float32, device=xz.device)
    dxz = torch.empty((w, b, g), **f32)
    dhT = torch.empty((w, b, h), **f32)
    dcT = torch.empty((w, b, h), **f32)
    dh_c = torch.zeros((b, h), **f32)
    dc_c = torch.zeros((b, h), **f32)
    for t in reversed(range(w)):
        z = xz[t].float() + rnd(h_prev[t]) @ rec32
        i, f, gc, o = _gates(z, h, act)
        a_c = act(cs[t])
        dh = dhs[t] + dh_c
        do = dh * a_c
        dzo = do * o * (1.0 - o)
        dc = dc_c + dh * o * p(a_c)
        if dcs is not None:
            dc = dc + dcs[t]
        dzi = dc * gc * i * (1.0 - i)
        dzf = dc * c_prev[t] * f * (1.0 - f)
        dzc = dc * i * p(gc)
        dz = torch.cat([dzi, dzf, dzc, dzo], dim=-1)
        dxz[t] = dz
        dhT[t] = dh
        dcT[t] = dc
        dh_c = rnd(dz) @ rec32.T
        dc_c = dc * f
    drec = h_prev.reshape(w * b, h).T @ dxz.reshape(w * b, g)
    return (dxz, drec, dhT, dcT) if with_carries else (dxz, drec)


def lstm_adj_plain(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor,
                   activation: Optional[str] = "tanh") -> tuple:
    """The adjoint kernel's function as a plain forward-time step loop
    (``_adj_kernel``, with ``_adj_call``'s output shift):
    (uxz, urec, uhs, ucs, udhs)."""
    code = act_code(activation)
    act, p, pp = _PLAIN_ACT[code], _PRIME[code], _PRIME2[code]
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = _rounder(rec)
    h_prev, c_prev = _shifted(hs), _shifted(cs)
    f32 = dict(dtype=torch.float32, device=xz.device)
    uxz = torch.empty((w, b, g), **f32)
    uhp, ucp, uc, udhs = (torch.empty((w, b, h), **f32) for _ in range(4))
    urec = torch.zeros((h, g), **f32)
    muh = torch.zeros((b, h), **f32)
    muc = torch.zeros((b, h), **f32)
    for t in range(w):
        hp_s, cp_s, dh, dc = h_prev[t], c_prev[t], dhT[t], dcT[t]
        z = xz[t].float() + rnd(hp_s) @ rec32
        i, f, gc, o = _gates(z, h, act)
        a_c = act(cs[t])
        qi, qf, qo = i * (1.0 - i), f * (1.0 - f), o * (1.0 - o)
        do = dh * a_c
        dz = torch.cat([dc * gc * qi, dc * cp_s * qf, dc * i * p(gc), do * qo], dim=-1)

        dzbar = u[t] + rnd(muh) @ rec32 + hp_s @ v
        dzbi, dzbf = dzbar[:, :h], dzbar[:, h:2 * h]
        dzbc, dzbo = dzbar[:, 2 * h:3 * h], dzbar[:, 3 * h:]
        dcTbar = muc * f
        fbar = muc * dc
        dcTbar = dcTbar + dzbi * gc * qi
        gbar = dzbi * dc * qi
        ibar = dzbi * dc * gc * (1.0 - 2.0 * i)
        dcTbar = dcTbar + dzbf * cp_s * qf
        cpbar = dzbf * dc * qf
        fbar = fbar + dzbf * dc * cp_s * (1.0 - 2.0 * f)
        dcTbar = dcTbar + dzbc * i * p(gc)
        ibar = ibar + dzbc * dc * p(gc)
        gbar = gbar + dzbc * dc * i * pp(gc)
        dobar = dzbo * qo
        obar = dzbo * do * (1.0 - 2.0 * o)
        dhTbar = dcTbar * o * p(a_c)
        obar = obar + dcTbar * dh * p(a_c)
        aCbar = dcTbar * dh * o * pp(a_c)
        dhTbar = dhTbar + dobar * a_c
        aCbar = aCbar + dobar * dh
        zbar = torch.cat([ibar * qi, fbar * qf, gbar * p(gc), obar * qo], dim=-1)

        uxz[t] = zbar
        udhs[t] = dhTbar
        uhp[t] = dz @ v.T + rnd(zbar) @ rec32.T
        ucp[t] = cpbar
        uc[t] = aCbar * p(a_c)
        urec = urec + (muh.T @ dz + hp_s.T @ zbar)
        muh, muc = dhTbar, dcTbar
    # uhp_t is the cotangent of hs_{t-1}, ucp_t of cs_{t-1}, uc_t of cs_t
    zero = torch.zeros_like(uhp[:1])
    uhs = torch.cat([uhp[1:], zero], dim=0)
    ucs = uc + torch.cat([ucp[1:], zero], dim=0)
    return uxz, urec, uhs, ucs, udhs


# ---------------------------------------------------------------- dispatch
def _device_rule(xz: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if xz.is_cuda:
        return True
    if xz.device.type == "cpu":
        return False
    raise ValueError(f"LSTM {what}: unsupported device {xz.device}")


def lstm_fwd(xz: torch.Tensor, rec: torch.Tensor,
             activation: Optional[str] = "tanh", with_cs: bool = False):
    """hs [, cs]: the forward kernel on a CUDA tensor, the plain version
    on a CPU tensor.  Not differentiable; see :func:`lstm_seq`."""
    if _device_rule(xz, "forward"):
        return lstm_fwd_cuda(xz, rec, activation, with_cs)
    return lstm_seq_plain(xz, rec, activation, with_cs)


def lstm_bwd(xz, rec, hs, cs, dhs, dcs=None, activation="tanh",
             with_carries=False) -> tuple:
    """The backward sweep: the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  Not differentiable; see :class:`LSTMBwdSeq`."""
    fn = lstm_bwd_cuda if _device_rule(xz, "backward") else lstm_bwd_plain
    return fn(xz, rec, hs, cs, dhs, dcs, activation, with_carries)


def lstm_adj(xz, rec, hs, cs, dhT, dcT, u, v, activation="tanh") -> tuple:
    """The adjoint sweep: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    fn = lstm_adj_cuda if _device_rule(xz, "adjoint") else lstm_adj_plain
    return fn(xz, rec, hs, cs, dhT, dcT, u, v, activation)


# ---------------------------------------------------------------- autograd
def _cast_like(cot: torch.Tensor, primal: torch.Tensor) -> torch.Tensor:
    """A kernel cotangent (float32) in its primal's dtype: the whole bf16
    boundary, as ``pallas_lstm._cast_like``."""
    return cot if cot.dtype == primal.dtype else cot.to(primal.dtype)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


class LSTMFwdRes(torch.autograd.Function):
    """``lstm_fwd_res``: (xz, rec) → (hs, cs) through the forward kernel in
    its ``with_cs`` mode.

    cs is an output, not only a saved tensor, so that at second order the
    adjoint's cotangent of cs reaches this node's backward (a tensor that
    a Function saves but does not return carries no gradient).  The
    backward is the differentiable :class:`LSTMBwdSeq` while autograd is
    recording (``create_graph=True``: the penalty's ∇ₓc), and the raw
    backward kernel otherwise — with a direct cs cotangent (its ``dcs``
    mode) when one arrives, which happens only at second order."""

    @staticmethod
    def forward(ctx, xz, rec, activation):
        hs, cs = lstm_fwd(xz, rec, activation, with_cs=True)
        ctx.save_for_backward(xz, rec, hs, cs)
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        xz, rec, hs, cs = ctx.saved_tensors
        dhs = torch.zeros_like(hs) if dhs is None else _f32(dhs)
        if torch.is_grad_enabled():
            if dcs is not None:
                raise NotImplementedError(
                    "LSTM: a recorded backward with a cell-state cotangent "
                    "(third order) is not supported")
            dxz, drec = LSTMBwdSeq.apply(xz, rec, hs, cs, dhs, ctx.activation)
        else:
            dcs = None if dcs is None else _f32(dcs)
            dxz, drec = lstm_bwd(xz, rec, hs, cs, dhs, dcs, ctx.activation)
        return _cast_like(dxz, xz), _cast_like(drec, rec), None


class LSTMBwdSeq(torch.autograd.Function):
    """``lstm_bwd_seq``: the first-order backward (dxz, drec) as a
    differentiable-once node.  Its forward runs the backward kernel with
    the per-step carries; its backward is the adjoint kernel, returning
    the cotangents of xz, rec, hs, cs and dhs."""

    @staticmethod
    def forward(ctx, xz, rec, hs, cs, dhs, activation):
        dxz, drec, dhT, dcT = lstm_bwd(xz, rec, hs, cs, dhs, None, activation,
                                       with_carries=True)
        ctx.save_for_backward(xz, rec, hs, cs, dhT, dcT)
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return dxz, drec

    @staticmethod
    def backward(ctx, u, v):
        if torch.is_grad_enabled():
            raise NotImplementedError("LSTM: third-order derivatives are not supported")
        xz, rec, hs, cs, dhT, dcT = ctx.saved_tensors
        u = torch.zeros(xz.shape, dtype=torch.float32, device=xz.device) if u is None else _f32(u)
        v = torch.zeros(rec.shape, dtype=torch.float32, device=xz.device) if v is None else _f32(v)
        uxz, urec, uhs, ucs, udhs = lstm_adj(xz, rec, hs, cs, dhT, dcT, u, v,
                                             ctx.activation)
        return _cast_like(uxz, xz), _cast_like(urec, rec), uhs, ucs, udhs, None


def lstm_seq(xz: torch.Tensor, rec: torch.Tensor,
             activation: Optional[str] = "tanh") -> torch.Tensor:
    """(W, B, 4H) × (H, 4H) → (W, B, H) float32, twice differentiable.

    Under autograd with an operand that needs a gradient it runs
    :class:`LSTMFwdRes` (the forward kernel with cs); otherwise — under
    ``no_grad`` / ``inference_mode``, as serving calls it — the primal
    forward kernel, with no cs at all.  Kernel on a CUDA tensor, plain
    version on a CPU tensor."""
    if torch.is_grad_enabled() and (xz.requires_grad or rec.requires_grad):
        return LSTMFwdRes.apply(xz, rec, activation)[0]
    return lstm_fwd(xz, rec, activation)


def keras_lstm(kernel: torch.Tensor, recurrent: torch.Tensor,
               bias: torch.Tensor, x: torch.Tensor,
               activation: Optional[str] = "tanh",
               recurrent_activation: str = "sigmoid",
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Keras-layout entry: (B, W, F) → (B, W, H) in the compute dtype.

    The input projection for every timestep is one ``torch.matmul``
    hoisted out of the recurrence; the recurrence is :func:`lstm_seq`;
    hs is cast back to the compute dtype (``pallas_keras_lstm``'s
    contract).  Differentiable to second order; under bf16 the kernels'
    float32 cotangents are cast back to the operand dtype."""
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
