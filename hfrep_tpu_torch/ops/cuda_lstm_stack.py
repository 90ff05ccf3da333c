"""The fused two-layer LSTM stack of the MTSS critics and its derivatives:
CUDA kernels, plain versions, dispatch and autograd.

Counterpart of ``hfrep_tpu/ops/pallas_lstm_stack.py``
(``_stack_fwd_kernel`` in its primal and ``with_res`` modes,
``_stack_bwd_kernel``, ``_stack_adj_kernel``, and the nested
``custom_vjp``s ``stack_seq`` / ``stack_fwd_res`` / ``stack_bwd_seq``
over them).  The stack is ``LSTM(H) → LSTM(H)`` with one activation for
both layers; layer 2 consumes layer 1's h at the same step::

    z1_t = xz1_t + h1_{t-1} . rec1
    z2_t = b2 + h1_t . k2 + h2_{t-1} . rec2

Its layers are those of :mod:`.cuda_lstm`, on whose helpers, dispatch
rule and launch counters it is built:

* the wrappers of the hand-written Hopper kernels —
  :func:`stack_fwd_cuda` (``csrc/lstm_stack_fwd.cu``),
  :func:`stack_bwd_cuda` (``csrc/lstm_stack_bwd.cu``) and
  :func:`stack_adj_cuda` (``csrc/lstm_stack_adj.cu``);
* the plain versions — :func:`stack_seq_plain`, :func:`stack_bwd_plain`,
  :func:`stack_adj_plain`;
* the dispatch — :func:`stack_fwd`, :func:`stack_bwd`, :func:`stack_adj`:
  the kernel on a CUDA tensor, the plain version on a CPU tensor, no
  fallback;
* autograd — :class:`StackFwdRes` and :class:`StackBwdSeq`;
  :func:`stack_seq` and :func:`keras_lstm_stack` are the differentiable
  entries;
* the eligibility rule — :func:`stack_fits`: the widths and dtypes whose
  three kernels fit one Hopper block; the critics take the chained
  single-layer route for the others;
* the launch rules — :func:`stack_fwd_layout`, :func:`stack_bwd_layout`
  and :func:`stack_adj_layout`: the cluster layout (two blocks a batch
  row, one layer a block) up to 100 hidden units, the wide layout above.

Layout and precision as in :mod:`.cuda_lstm`: xz1 (W, B, 4H) time-major,
rec1, k2, rec2 (H, 4H) and b2 (4H,) in the operand dtype (float32 or
bf16, all alike); state, gate math, accumulation and every other array
float32; a float32 vector dotted with a matrix of the operand dtype is
first rounded to it.  b2 is cast to float32 and added, so ``h1 . k2 + b2``
is never rounded as a whole (the chained route's projection is).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from hfrep_tpu_torch.ops import _build, cuda_lstm
from hfrep_tpu_torch.ops.cuda_lstm import (
    FWD_KS, FWD_KSP, FWD_THREADS, FWD_ZP, MAX_THREADS, STREAM_DTYPES, WS_COUNTER_SIGNATURE,
    _PLAIN_ACT, _PRIME, _adj_step, _cast_like, _check_f32, _check_operands,
    _count_launch, _device_rule, _f32, _gates, _ptr, _raise_on, _rounder, _shifted, act_code,
    rows_per_block, weight_sum_plain,
)

#: dynamic shared memory one Hopper (sm_90) block may opt into
HOPPER_SMEM_BYTES = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_stack_fwd": {
        "hfrep_stack_fwd": (_I, [_P] * 9                 # xz1 rec1 k2 b2 rec2 hs1 cs1 hs2 cs2
                            + [_I] * 7                   # W B H act bf16 rows device
                            + [_P]                       # stream
                            + [_I] * 2),                 # layout threads
        "hfrep_stack_fwd_clusters": (_I, [_I] * 3),      # H bf16 device
    },
    "lstm_stack_bwd": {
        "hfrep_stack_bwd": (_I, [_P] * 25                # operands, streams, outputs, workspace
                            + [_I] * 7                   # W B H act bf16 rows device
                            + [_P]                       # stream
                            + [_I] * 2),                 # layout threads
        "hfrep_stack_bwd_clusters": (_I, [_I] * 3),      # H bf16 device
        **WS_COUNTER_SIGNATURE,
    },
    "lstm_stack_adj": {
        "hfrep_stack_adj": (_I, [_P] * 37                # operands, streams, outputs, workspaces
                            + [_I] * 7                   # W B H act bf16 rows device
                            + [_P]                       # stream
                            + [_I] * 2),                 # layout threads
        "hfrep_stack_adj_clusters": (_I, [_I] * 3),      # H bf16 device
        **WS_COUNTER_SIGNATURE,
    },
}

#: float32 staging per batch row, in units of H: the backward stages
#: h1_{t-1}, h1_t, h2_{t-1} and the two layers' dz (3 + 4 + 4); the
#: adjoint h1_{t-1}, mu_h1, h1_t, h2_{t-1}, mu_h2, dhTbar1 and the two
#: layers' dz and zbar (6 + 16)
_STAGING = {"stack_bwd": 11, "stack_adj": 22}


def _lib(name: str):
    return _build.load(name, _SIGNATURES[name])


# ------------------------------------------------------- eligibility rule
def stack_smem_bytes(hidden: int, dtype: torch.dtype, rows: int = 1,
                     kernel: str = "stack_adj") -> int:
    """Dynamic shared memory of one block of ``kernel``: rec1 in the
    operand dtype (unpadded for the forward, which walks it by columns
    only; with the one-entry row pad of ``lstm_common.cuh`` for the
    backward and the adjoint, which walk it both ways) plus the staging
    buffers of ``rows`` batch rows (the forward's double-buffered h1 and
    h2 in the operand dtype; see ``_STAGING``).  k2, rec2 and the adjoint's
    float32 v-streams are read from global memory (L2)."""
    item = torch.empty((), dtype=dtype).element_size()
    if kernel == "stack_fwd":
        return (4 * hidden * hidden + 4 * rows * hidden) * item
    rec = -(-hidden * (4 * hidden + 1) * item // 16) * 16
    return rec + rows * _STAGING[kernel] * hidden * 4


def stack_fits(hidden: int, dtype: torch.dtype, rows: int = 1,
               smem_limit: int = HOPPER_SMEM_BYTES) -> bool:
    """The fused stack's eligibility rule (the port's counterpart of
    ``kernel_eligible(..., layers=2)``): float32 or bf16 operands, one
    thread per (row, hidden unit) within a block, and each of the three
    kernels' shared memory within ``smem_limit`` (Hopper's by default).
    At ``rows=1`` that admits H <= 117 in float32 and H <= 164 in bf16."""
    if dtype not in STREAM_DTYPES or rows * hidden > MAX_THREADS:
        return False
    return all(stack_smem_bytes(hidden, dtype, rows, k) <= smem_limit
               for k in ("stack_fwd", "stack_bwd", "stack_adj"))


#: the forward's cluster layout (``csrc/lstm_stack_fwd.cu``): each block of
#: a two-block cluster is ``lstm_fwd``'s register layout over one layer's
#: recurrent matrix (FWD_THREADS threads, a quad a unit, up to 4 * FWD_KS
#: units), at least STACK_KEEP[dtype] of a thread's FWD_KS rows in
#: registers and the rest in shared memory, beside its part of k2
#: (STACK_K2_ROWS rows a thread at most); layer 2's block holds a ring of
#: STACK_RING slots, each h1_t and layer 1's part of h1_t . k2
STACK_RING, STACK_K2_ROWS = 4, 13
STACK_KEEP = {torch.float32: 18, torch.bfloat16: 19}
#: the layout codes of both stack sweeps' C entries
STACK_FWD_LAYOUTS = {"cluster": 0, "wide": 1}


def cluster_smem_bytes(hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of either block of the forward's cluster
    layout: float32 h and z buffers, the rows of the recurrent matrix past
    STACK_KEEP[dtype] (a float4 a thread), the ring, its STACK_RING mbarriers and
    a read counter (16 bytes);
    the block's part of k2 (STACK_K2_ROWS x FWD_THREADS x 4 entries); a
    staging area for half the recurrent matrix's rows, or STACK_K2_ROWS
    rows of k2 if that is more."""
    item = torch.empty((), dtype=dtype).element_size()
    slot = 4 * FWD_KSP + 4 * FWD_ZP
    fixed = (4 * FWD_KSP + 4 * FWD_ZP + 4 * (FWD_KS - STACK_KEEP[dtype]) * FWD_THREADS
             + STACK_RING * slot + 2 * STACK_RING + 4)
    stage = max((hidden + 1) // 2, STACK_K2_ROWS) * 4 * hidden * item
    return fixed * 4 + STACK_K2_ROWS * FWD_THREADS * 4 * item + stage


def stack_fwd_layout(hidden: int, dtype: torch.dtype, batch: int, sm_count: int,
                     smem_limit: int) -> tuple:
    """The forward kernel's launch rule: ``(layout, threads, rows)``.

    Up to 4 * FWD_KS hidden units the cluster layout: FWD_THREADS threads a
    block, a cluster of two blocks (layer 1, layer 2) walking ceil(B /
    (SMs / 2)) batch rows.  Wider, within :func:`stack_fits`, the wide
    layout: :func:`stack_rows` rows a block and a thread per (row, unit);
    a width the fused stack does not take raises.  Pure arithmetic on the
    shapes and the card's limits: the wrapper never tries a layout and
    falls back."""
    return _stack_layout("stack_fwd", cluster_smem_bytes, hidden, dtype, batch, sm_count,
                         smem_limit)


def _stack_layout(kernel: str, cluster_bytes, hidden: int, dtype: torch.dtype, batch: int,
                  sm_count: int, smem_limit: int) -> tuple:
    """Both sweeps' launch rule, ``cluster_bytes(hidden, dtype)`` being the
    shared memory of one block of ``kernel``'s cluster layout."""
    if dtype in STREAM_DTYPES and hidden <= 4 * FWD_KS:
        need = cluster_bytes(hidden, dtype)
        if need > smem_limit:
            raise ValueError(f"{kernel} kernel: the cluster layout needs {need} B of "
                             f"shared memory; one block of this card may use {smem_limit} B")
        return "cluster", FWD_THREADS, max(1, math.ceil(batch / max(1, sm_count // 2)))
    rows = stack_rows(batch, hidden, dtype, sm_count, smem_limit)
    return "wide", 32 * math.ceil(rows * hidden / 32), rows


#: the backward's cluster layout (``csrc/lstm_stack_bwd.cu``): each block
#: of a two-block cluster holds its layer's recurrent matrix for the
#: transposed product, thread (k, q) FWD_KS chunks of four of row k's
#: gate-q columns, at least STACK_BWD_KEEP[dtype] chunks in registers and
#: the rest in shared memory, beside its chunks of k2 (STACK_BWD_K2_CHUNKS
#: a thread at most); layer 1's block holds a ring of STACK_RING slots,
#: each round(dz2_t) (a dz buffer of 4 x FWD_ZP floats) and layer 2's part
#: of dz2_t . k2^T (FWD_ZP floats)
STACK_BWD_KEEP = {torch.float32: 15, torch.bfloat16: 15}
STACK_BWD_K2_CHUNKS = 13


def cluster_bwd_smem_bytes(hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of either block of the backward's cluster
    layout: two float32 dz buffers, each thread's two step inputs staged
    for two steps, the chunks of the recurrent matrix past
    STACK_BWD_KEEP[dtype] (a float4 a thread), the ring, its STACK_RING
    mbarriers and a read counter (16 bytes); the block's chunks of k2
    (STACK_BWD_K2_CHUNKS x FWD_THREADS x 4 entries); a staging area for a
    third of the recurrent matrix's rows."""
    item = torch.empty((), dtype=dtype).element_size()
    fixed = (8 * FWD_ZP + 4 * FWD_THREADS + 4 * (FWD_KS - STACK_BWD_KEEP[dtype]) * FWD_THREADS
             + STACK_RING * 5 * FWD_ZP + 2 * STACK_RING + 4)
    stage = -(-hidden // 3) * 4 * hidden * item
    return fixed * 4 + STACK_BWD_K2_CHUNKS * FWD_THREADS * 4 * item + stage


def stack_bwd_layout(hidden: int, dtype: torch.dtype, batch: int, sm_count: int,
                     smem_limit: int) -> tuple:
    """The backward kernel's launch rule, the forward's
    (:func:`stack_fwd_layout`) with the backward's shared memory: the
    cluster layout (a pre-pass that recomputes every step's gates, then
    two blocks a batch row) up to 4 * FWD_KS hidden units, the wide layout
    above; a width the fused stack does not take raises."""
    return _stack_layout("stack_bwd", cluster_bwd_smem_bytes, hidden, dtype, batch, sm_count,
                         smem_limit)


#: the adjoint's cluster layout (``csrc/lstm_stack_adj.cu``): the forward's
#: (FWD_THREADS threads a block, a quad a unit, STACK_K2_ROWS rows of k2 a
#: thread at most), at least STACK_ADJ_KEEP[dtype] of a thread's FWD_KS
#: rows of its layer's recurrent matrix in registers; layer 2's block holds
#: the ring of round(dhTbar1_t) and layer 1's part of its product with k2
STACK_ADJ_KEEP = {torch.float32: 17, torch.bfloat16: 17}
#: step inputs each thread stages: its gate, its base, one state value
_ADJ_STAGED = 3


def cluster_adj_smem_bytes(hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of either block of the adjoint's cluster
    layout: two float32 h buffers, each thread's _ADJ_STAGED step inputs
    staged for two steps, the rows of the recurrent matrix past
    STACK_ADJ_KEEP[dtype] (a float4 a thread), the ring, its STACK_RING
    mbarriers and a read counter (16 bytes); the block's part of k2
    (STACK_K2_ROWS x FWD_THREADS x 4 entries); a staging area for a third
    of the recurrent matrix's rows, or STACK_K2_ROWS rows of k2 if that is
    more."""
    item = torch.empty((), dtype=dtype).element_size()
    slot = 4 * FWD_KSP + 4 * FWD_ZP
    fixed = (8 * FWD_KSP + 2 * _ADJ_STAGED * FWD_THREADS
             + 4 * (FWD_KS - STACK_ADJ_KEEP[dtype]) * FWD_THREADS
             + STACK_RING * slot + 2 * STACK_RING + 4)
    stage = max(-(-hidden // 3), STACK_K2_ROWS) * 4 * hidden * item
    return fixed * 4 + STACK_K2_ROWS * FWD_THREADS * 4 * item + stage


def stack_adj_layout(hidden: int, dtype: torch.dtype, batch: int, sm_count: int,
                     smem_limit: int) -> tuple:
    """The adjoint kernel's launch rule, the forward's
    (:func:`stack_fwd_layout`) with the adjoint's shared memory: the
    cluster layout (a pre-pass over every step's gates and v-stream
    products, two blocks a batch row, a post-pass for the transposed
    products) up to 4 * FWD_KS hidden units, the wide layout above; a
    width the fused stack does not take raises."""
    return _stack_layout("stack_adj", cluster_adj_smem_bytes, hidden, dtype, batch, sm_count,
                         smem_limit)


def stack_rows(batch: int, hidden: int, dtype: torch.dtype, sm_count: int,
               smem_limit: int) -> int:
    """Batch rows per block: :func:`~.cuda_lstm.rows_per_block`, cut
    until the staging buffers fit; raises if one row does not."""
    rows = rows_per_block(batch, hidden, sm_count)
    while rows > 1 and not stack_fits(hidden, dtype, rows, smem_limit):
        rows -= 1
    if not stack_fits(hidden, dtype, rows, smem_limit):
        raise ValueError(
            f"fused LSTM stack: hidden width {hidden} in {dtype} does not fit one "
            f"block ({stack_smem_bytes(hidden, dtype, 1)} B of shared memory for "
            f"the adjoint, {smem_limit} B allowed); take the chained route")
    return rows


# ---------------------------------------------------------- the wrappers
def _check_stack(fn: str, xz1, rec1, k2, b2, rec2) -> tuple:
    """xz1 and the four weights alike in dtype, contiguous, on one CUDA
    device and not needing a gradient; returns (W, B, H)."""
    w, b, h = _check_operands(fn, xz1, rec1)
    for name, t, shape in (("k2", k2, (h, 4 * h)), ("rec2", rec2, (h, 4 * h)),
                           ("b2", b2, (4 * h,))):
        if not isinstance(t, torch.Tensor) or t.dtype != xz1.dtype:
            raise TypeError(f"{fn}: {name} must be a {xz1.dtype} tensor like xz1")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: want {name} {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} needs a contiguous {name}")
        if t.device != xz1.device:
            raise ValueError(f"{fn}: {name} on {t.device}, xz1 on {xz1.device}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                f"{fn} is not differentiable itself: differentiate through "
                f"cuda_lstm_stack.stack_seq / keras_lstm_stack")
    return w, b, h


def _transposed(*mats: torch.Tensor) -> tuple:
    """Transposed copies: the kernels walk every matrix in global memory
    by columns, so neighbouring threads read neighbouring words.  The
    caller holds them until the launch (a copy freed before it could hand
    its block to the next one)."""
    return tuple(m.t().contiguous() for m in mats)


def stack_fwd_cuda(xz1, rec1, k2, b2, rec2, activation: Optional[str] = "tanh",
                   with_res: bool = False):
    """Launch ``csrc/lstm_stack_fwd.cu`` in the layout
    :func:`stack_fwd_layout` picks: hs2 (W, B, H) float32, or with
    ``with_res`` (hs1, cs1, hs2, cs2), on CUDA tensors only."""
    act = act_code(activation)
    w, b, h = _check_stack("stack_fwd_cuda", xz1, rec1, k2, b2, rec2)
    f32 = dict(dtype=torch.float32, device=xz1.device)
    hs2 = torch.empty((w, b, h), **f32)
    hs1, cs1, cs2 = ((torch.empty_like(hs2) for _ in range(3)) if with_res
                     else (None, None, None))
    out = (hs1, cs1, hs2, cs2) if with_res else hs2
    if w == 0 or b == 0:
        return out
    dev = xz1.device.index if xz1.device.index is not None else torch.cuda.current_device()
    layout, threads, rows = stack_fwd_layout(
        h, xz1.dtype, b, torch.cuda.get_device_properties(dev).multi_processor_count,
        cuda_lstm._lib().hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz1.device).cuda_stream
    err = _lib("lstm_stack_fwd").hfrep_stack_fwd(
        xz1.data_ptr(), rec1.data_ptr(), k2.data_ptr(), b2.data_ptr(), rec2.data_ptr(),
        _ptr(hs1), _ptr(cs1), hs2.data_ptr(), _ptr(cs2), w, b, h, act,
        int(xz1.dtype == torch.bfloat16), rows, dev, stream, STACK_FWD_LAYOUTS[layout],
        threads)
    _raise_on(err, "stack_fwd")
    _count_launch("stack_fwd_res" if with_res else "stack_fwd")
    return out


def stack_bwd_cuda(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2,
                   directs: Optional[tuple] = None,
                   activation: Optional[str] = "tanh",
                   with_carries: bool = False) -> tuple:
    """Launch ``csrc/lstm_stack_bwd.cu`` in the layout
    :func:`stack_bwd_layout` picks: (dxz1, drec1, dk2, db2, drec2)
    and, with ``with_carries``, the per-step (dhT1, dcT1, dhT2, dcT2);
    every output float32.  ``directs`` = (dhs1, dcs1, dcs2) are direct
    cotangents on the residual streams (second order)."""
    act = act_code(activation)
    w, b, h = _check_stack("stack_bwd_cuda", xz1, rec1, k2, b2, rec2)
    seq = (w, b, h)
    dhs1, dcs1, dcs2 = directs if directs is not None else (None, None, None)
    _check_f32("stack_bwd_cuda", xz1.device,
               {"hs1": (hs1, seq), "cs1": (cs1, seq), "hs2": (hs2, seq), "cs2": (cs2, seq),
                "dhs2": (dhs2, seq), "dhs1": (dhs1, seq), "dcs1": (dcs1, seq),
                "dcs2": (dcs2, seq)})
    if directs is not None and any(d is None for d in directs):
        raise ValueError("stack_bwd_cuda: directs are (dhs1, dcs1, dcs2), all given")
    f32 = dict(dtype=torch.float32, device=xz1.device)
    dxz1 = torch.empty((w, b, 4 * h), **f32)
    drec1, dk2, drec2 = (torch.empty((h, 4 * h), **f32) for _ in range(3))
    db2 = torch.empty((4 * h,), **f32)
    carries = tuple(torch.empty(seq, **f32) for _ in range(4)) if with_carries else ()
    outs = (dxz1, drec1, dk2, db2, drec2) + carries
    if w == 0 or b == 0:
        for s in (drec1, dk2, db2, drec2):
            s.zero_()
        return outs
    dev = xz1.device.index if xz1.device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layout, threads, rows = stack_bwd_layout(h, xz1.dtype, b, sms,
                                             cuda_lstm._lib().hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz1.device).cuda_stream
    dz2w = torch.empty((w, b, 4 * h), **f32)          # layer 2's dz, for its sums
    dhT1, dcT1, dhT2, dcT2 = carries if with_carries else (None,) * 4
    # the wide layout reads k2 and rec2 transposed as well
    k2t, rec2t = _transposed(k2, rec2) if layout == "wide" else (None, None)
    err = _lib("lstm_stack_bwd").hfrep_stack_bwd(
        xz1.data_ptr(), rec1.data_ptr(), k2.data_ptr(), _ptr(k2t), b2.data_ptr(),
        rec2.data_ptr(), _ptr(rec2t),
        hs1.data_ptr(), cs1.data_ptr(), hs2.data_ptr(), cs2.data_ptr(), dhs2.data_ptr(),
        _ptr(dhs1), _ptr(dcs1), _ptr(dcs2), dxz1.data_ptr(), dz2w.data_ptr(),
        _ptr(dhT1), _ptr(dcT1), _ptr(dhT2), _ptr(dcT2),
        drec1.data_ptr(), dk2.data_ptr(), db2.data_ptr(), drec2.data_ptr(),
        w, b, h, act, int(xz1.dtype == torch.bfloat16), rows, dev, stream,
        STACK_FWD_LAYOUTS[layout], threads)
    _raise_on(err, "stack_bwd")
    _count_launch("stack_bwd")
    return outs


def stack_adj_cuda(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                   dhT1, dcT1, dhT2, dcT2, u1, vr1, vk2, vb2, vr2,
                   activation: Optional[str] = "tanh") -> tuple:
    """Launch ``csrc/lstm_stack_adj.cu`` in the layout
    :func:`stack_adj_layout` picks: given the cotangents u1 of dxz1 and
    (vr1, vk2, vb2, vr2) of (drec1, dk2, db2, drec2), those of the
    backward's inputs — (uxz1, ur1, uk2, ub2, ur2, uhs1, ucs1, uhs2,
    ucs2, udhs2), all float32."""
    act = act_code(activation)
    w, b, h = _check_stack("stack_adj_cuda", xz1, rec1, k2, b2, rec2)
    seq, mat = (w, b, h), (h, 4 * h)
    _check_f32("stack_adj_cuda", xz1.device,
               {"hs1": (hs1, seq), "cs1": (cs1, seq), "hs2": (hs2, seq), "cs2": (cs2, seq),
                "dhT1": (dhT1, seq), "dcT1": (dcT1, seq), "dhT2": (dhT2, seq),
                "dcT2": (dcT2, seq), "u1": (u1, (w, b, 4 * h)), "vr1": (vr1, mat),
                "vk2": (vk2, mat), "vb2": (vb2, (4 * h,)), "vr2": (vr2, mat)})
    f32 = dict(dtype=torch.float32, device=xz1.device)
    uxz1 = torch.empty((w, b, 4 * h), **f32)
    ur1, uk2, ur2 = (torch.empty(mat, **f32) for _ in range(3))
    ub2 = torch.empty((4 * h,), **f32)
    uhs1, ucs1, uhs2, ucs2, udhs2 = (torch.empty(seq, **f32) for _ in range(5))
    outs = (uxz1, ur1, uk2, ub2, ur2, uhs1, ucs1, uhs2, ucs2, udhs2)
    if w == 0 or b == 0:
        for s in (ur1, uk2, ub2, ur2):
            s.zero_()
        return outs
    dev = xz1.device.index if xz1.device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    layout, threads, rows = stack_adj_layout(h, xz1.dtype, b, sms,
                                             cuda_lstm._lib().hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz1.device).cuda_stream
    # the two layers' dz, layer 2's zbar and layer 1's dhTbar, for the sums
    # (the cluster layout's pre-pass puts the gates and v-stream terms there
    # first)
    dz1w, dz2w, zb2w = (torch.empty((w, b, 4 * h), **f32) for _ in range(3))
    dhtb1w = torch.empty(seq, **f32)
    # the wide layout reads the five matrices transposed as well
    k2t, rec2t, vr1t, vk2t, vr2t = (_transposed(k2, rec2, vr1, vk2, vr2) if layout == "wide"
                                    else (None,) * 5)
    err = _lib("lstm_stack_adj").hfrep_stack_adj(
        xz1.data_ptr(), rec1.data_ptr(), k2.data_ptr(), _ptr(k2t), b2.data_ptr(),
        rec2.data_ptr(), _ptr(rec2t), vr1.data_ptr(), _ptr(vr1t),
        vk2.data_ptr(), _ptr(vk2t), vb2.data_ptr(), vr2.data_ptr(), _ptr(vr2t),
        hs1.data_ptr(), cs1.data_ptr(), hs2.data_ptr(), cs2.data_ptr(),
        dhT1.data_ptr(), dcT1.data_ptr(), dhT2.data_ptr(), dcT2.data_ptr(), u1.data_ptr(),
        uxz1.data_ptr(), uhs1.data_ptr(), ucs1.data_ptr(), uhs2.data_ptr(), ucs2.data_ptr(),
        udhs2.data_ptr(), dz1w.data_ptr(), dz2w.data_ptr(), zb2w.data_ptr(),
        dhtb1w.data_ptr(), ur1.data_ptr(), uk2.data_ptr(), ub2.data_ptr(), ur2.data_ptr(),
        w, b, h, act, int(xz1.dtype == torch.bfloat16), rows,
        dev, stream, STACK_FWD_LAYOUTS[layout], threads)
    _raise_on(err, "stack_adj")
    _count_launch("stack_adj")
    return outs


# ------------------------------------------------------ the plain versions
def _bwd_step(p, i, f, gc, o, c_prev, c, a_c, dh_in, dh, dc) -> tuple:
    """``_bwd_step`` of the fused kernel: (dz, dcT, dhT) from the gates,
    the direct dh input and the carries."""
    dhT = dh_in + dh
    do = dhT * a_c
    dcT = dc + dhT * o * p(a_c)
    dz = torch.cat([dcT * gc * i * (1.0 - i), dcT * c_prev * f * (1.0 - f),
                    dcT * i * p(gc), do * o * (1.0 - o)], dim=-1)
    return dz, dcT, dhT


def stack_seq_plain(xz1, rec1, k2, b2, rec2, activation: Optional[str] = "tanh",
                    with_res: bool = False):
    """The forward kernel's function as a plain step loop: hs2 (W, B, H)
    float32, or with ``with_res`` (hs1, cs1, hs2, cs2).  Built from
    differentiable torch ops, so torch's own autograd can differentiate
    it (the tests' reference)."""
    act = _PLAIN_ACT[act_code(activation)]
    w, b, g = xz1.shape
    h = g // 4
    r1, kk, r2, bb = rec1.float(), k2.float(), rec2.float(), b2.float()
    rnd = _rounder(rec1)
    h1 = torch.zeros((b, h), dtype=torch.float32, device=xz1.device)
    c1, h2, c2 = torch.zeros_like(h1), torch.zeros_like(h1), torch.zeros_like(h1)
    out = ([], [], [], [])
    for t in range(w):
        i, f, gc, o = _gates(xz1[t].float() + rnd(h1) @ r1, h, act)
        c1 = f * c1 + i * gc
        h1 = o * act(c1)
        i, f, gc, o = _gates(bb + rnd(h1) @ kk + rnd(h2) @ r2, h, act)
        c2 = f * c2 + i * gc
        h2 = o * act(c2)
        for lst, v in zip(out, (h1, c1, h2, c2)):
            lst.append(v)
    empty = torch.zeros((0, b, h), dtype=torch.float32, device=xz1.device)
    hs1, cs1, hs2, cs2 = (torch.stack(v) if v else empty.clone() for v in out)
    return (hs1, cs1, hs2, cs2) if with_res else hs2


def stack_bwd_plain(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2,
                    directs: Optional[tuple] = None,
                    activation: Optional[str] = "tanh",
                    with_carries: bool = False) -> tuple:
    """The backward kernel's function as a plain reverse-time step loop
    (``_stack_bwd_kernel``): (dxz1, drec1, dk2, db2, drec2) [+ (dhT1,
    dcT1, dhT2, dcT2)]."""
    code = act_code(activation)
    act, p = _PLAIN_ACT[code], _PRIME[code]
    w, b, g = xz1.shape
    h = g // 4
    r1, kk, r2, bb = rec1.float(), k2.float(), rec2.float(), b2.float()
    rnd = _rounder(rec1)
    h1p, c1p, h2p, c2p = (_shifted(s) for s in (hs1, cs1, hs2, cs2))
    dhs1, dcs1, dcs2 = directs if directs is not None else (None, None, None)
    f32 = dict(dtype=torch.float32, device=xz1.device)
    dxz1, dz2s = torch.empty((w, b, g), **f32), torch.empty((w, b, g), **f32)
    carries = [torch.empty((w, b, h), **f32) for _ in range(4)]
    dh1 = torch.zeros((b, h), **f32)
    dc1, dh2, dc2 = torch.zeros_like(dh1), torch.zeros_like(dh1), torch.zeros_like(dh1)
    for t in reversed(range(w)):
        i1, f1, g1, o1 = _gates(xz1[t].float() + rnd(h1p[t]) @ r1, h, act)
        i2, f2, g2, o2 = _gates(bb + rnd(hs1[t]) @ kk + rnd(h2p[t]) @ r2, h, act)
        dc2_in = dc2 + dcs2[t] if directs is not None else dc2
        dz2, dcT2, dhT2 = _bwd_step(p, i2, f2, g2, o2, c2p[t], cs2[t], act(cs2[t]),
                                    dhs2[t], dh2, dc2_in)
        dh1_in = rnd(dz2) @ kk.T
        if directs is not None:
            dh1_in = dh1_in + dhs1[t]
        dc1_in = dc1 + dcs1[t] if directs is not None else dc1
        dz1, dcT1, dhT1 = _bwd_step(p, i1, f1, g1, o1, c1p[t], cs1[t], act(cs1[t]),
                                    dh1_in, dh1, dc1_in)
        dxz1[t], dz2s[t] = dz1, dz2
        for s, v in zip(carries, (dhT1, dcT1, dhT2, dcT2)):
            s[t] = v
        dh1, dc1 = rnd(dz1) @ r1.T, dcT1 * f1
        dh2, dc2 = rnd(dz2) @ r2.T, dcT2 * f2
    rows = lambda s: s.reshape(w * b, -1)          # noqa: E731
    drec1 = weight_sum_plain([(rows(hs1), rows(dxz1), None)], b)
    dk2 = weight_sum_plain([(rows(hs1), rows(dz2s), None)], 0)
    db2 = weight_sum_plain([(None, rows(dz2s), None)], 0)[0]
    drec2 = weight_sum_plain([(rows(hs2), rows(dz2s), None)], b)
    out = (dxz1, drec1, dk2, db2, drec2)
    return out + tuple(carries) if with_carries else out


def stack_adj_plain(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                    dhT1, dcT1, dhT2, dcT2, u1, vr1, vk2, vb2, vr2,
                    activation: Optional[str] = "tanh") -> tuple:
    """The adjoint kernel's function as a plain forward-time step loop
    (``_stack_adj_kernel``, with ``_stack_adj_call``'s output shift:
    uhs1 = uh1 + shift(uh1p), ucs = uc + shift(ucp), but uhs2 =
    shift(uh2p) alone): (uxz1, ur1, uk2, ub2, ur2, uhs1, ucs1, uhs2, ucs2,
    udhs2)."""
    code = act_code(activation)
    w, b, g = xz1.shape
    h = g // 4
    r1, kk, r2, bb = rec1.float(), k2.float(), rec2.float(), b2.float()
    rnd = _rounder(rec1)
    h1p, c1p, h2p, c2p = (_shifted(s) for s in (hs1, cs1, hs2, cs2))
    f32 = dict(dtype=torch.float32, device=xz1.device)
    uxz1 = torch.empty((w, b, g), **f32)
    uh1, uh1p, uc1p, uc1, uh2p, uc2p, uc2, udhs2 = (
        torch.empty((w, b, h), **f32) for _ in range(8))
    ur1, uk2, ur2 = (torch.zeros((h, g), **f32) for _ in range(3))
    ub2 = torch.zeros((g,), **f32)
    muh1, muc1, muh2, muc2 = (torch.zeros((b, h), **f32) for _ in range(4))
    for t in range(w):
        # layer 1 first: it ran last in the backward's step
        z1 = xz1[t].float() + rnd(h1p[t]) @ r1
        dzbar1 = u1[t] + rnd(muh1) @ r1 + h1p[t] @ vr1
        dz1, zbar1, dhTbar1, dcTbar1, uc1p[t], uc1[t] = _adj_step(
            code, z1, cs1[t], c1p[t], dhT1[t], dcT1[t], muc1, dzbar1)
        uh1p[t] = dz1 @ vr1.T + rnd(zbar1) @ r1.T
        ur1 += muh1.T @ dz1 + h1p[t].T @ zbar1
        # layer 2's dz cotangent: through dh1_in = dz2 . k2^T, dk2 and db2
        z2 = bb + rnd(hs1[t]) @ kk + rnd(h2p[t]) @ r2
        u2 = rnd(dhTbar1) @ kk + hs1[t] @ vk2 + vb2
        dzbar2 = u2 + rnd(muh2) @ r2 + h2p[t] @ vr2
        dz2, zbar2, dhTbar2, dcTbar2, uc2p[t], uc2[t] = _adj_step(
            code, z2, cs2[t], c2p[t], dhT2[t], dcT2[t], muc2, dzbar2)
        uh2p[t] = dz2 @ vr2.T + rnd(zbar2) @ r2.T
        ur2 += muh2.T @ dz2 + h2p[t].T @ zbar2
        # zbar2 is the cotangent of z2's additive inputs h1 . k2 and b2
        uh1[t] = rnd(zbar2) @ kk.T + dz2 @ vk2.T
        uk2 += hs1[t].T @ zbar2 + dhTbar1.T @ dz2
        ub2 += zbar2.sum(0)
        uxz1[t], udhs2[t] = zbar1, dhTbar2
        muh1, muc1, muh2, muc2 = dhTbar1, dcTbar1, dhTbar2, dcTbar2
    # uh?p_t is the cotangent of h?_{t-1}, uc?p_t of c?_{t-1}
    nxt = lambda s: torch.cat([s[1:], torch.zeros_like(s[:1])], dim=0)   # noqa: E731
    return (uxz1, ur1, uk2, ub2, ur2, uh1 + nxt(uh1p), uc1 + nxt(uc1p), nxt(uh2p),
            uc2 + nxt(uc2p), udhs2)


# ---------------------------------------------------------------- dispatch
def stack_fwd(xz1, rec1, k2, b2, rec2, activation="tanh", with_res=False):
    """hs2 [or (hs1, cs1, hs2, cs2)]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor.  Not differentiable; see
    :func:`stack_seq`."""
    fn = stack_fwd_cuda if _device_rule(xz1, "stack forward") else stack_seq_plain
    return fn(xz1, rec1, k2, b2, rec2, activation, with_res)


def stack_bwd(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2, directs=None,
              activation="tanh", with_carries=False) -> tuple:
    """The fused backward sweep: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  Not differentiable; see :class:`StackBwdSeq`."""
    fn = stack_bwd_cuda if _device_rule(xz1, "stack backward") else stack_bwd_plain
    return fn(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2, directs, activation,
              with_carries)


def stack_adj(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhT1, dcT1, dhT2, dcT2,
              u1, vr1, vk2, vb2, vr2, activation="tanh") -> tuple:
    """The fused adjoint sweep: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    fn = stack_adj_cuda if _device_rule(xz1, "stack adjoint") else stack_adj_plain
    return fn(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhT1, dcT1, dhT2, dcT2,
              u1, vr1, vk2, vb2, vr2, activation)


# ---------------------------------------------------------------- autograd
def _cast_all(grads, primals) -> tuple:
    return tuple(_cast_like(g, p) for g, p in zip(grads, primals))


class StackFwdRes(torch.autograd.Function):
    """``stack_fwd_res``: (xz1, rec1, k2, b2, rec2) → (hs1, cs1, hs2, cs2)
    through the forward kernel in its ``with_res`` mode.

    All four are outputs, so that at second order the adjoint's
    cotangents on hs1, cs1, hs2 and cs2 reach this node's backward.  The
    backward is the differentiable :class:`StackBwdSeq` while autograd
    is recording (the penalty's ∇ₓc), and the raw backward kernel
    otherwise — in its direct-cotangent mode when a cotangent on hs1,
    cs1 or cs2 arrives, which happens only at second order."""

    @staticmethod
    def forward(ctx, xz1, rec1, k2, b2, rec2, activation):
        res = stack_fwd(xz1, rec1, k2, b2, rec2, activation, with_res=True)
        ctx.save_for_backward(xz1, rec1, k2, b2, rec2, *res)
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return res

    @staticmethod
    def backward(ctx, dhs1, dcs1, dhs2, dcs2):
        xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2 = ctx.saved_tensors
        dhs2 = torch.zeros_like(hs2) if dhs2 is None else _f32(dhs2)
        directs = (dhs1, dcs1, dcs2)
        if torch.is_grad_enabled():
            if any(d is not None for d in directs):
                raise NotImplementedError(
                    "LSTM stack: a recorded backward with a residual-stream "
                    "cotangent (third order) is not supported")
            grads = StackBwdSeq.apply(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                                      dhs2, ctx.activation)
        else:
            directs = (None if all(d is None for d in directs) else
                       tuple(torch.zeros_like(hs1) if d is None else _f32(d)
                             for d in directs))
            grads = stack_bwd(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2,
                              directs, ctx.activation)
        return _cast_all(grads, (xz1, rec1, k2, b2, rec2)) + (None,)


class StackBwdSeq(torch.autograd.Function):
    """``stack_bwd_seq``: the first-order backward (dxz1, drec1, dk2, db2,
    drec2) as a differentiable-once node.  Its forward runs the backward
    kernel with the per-step carries; its backward is the adjoint
    kernel, returning the cotangents of every input but the activation."""

    @staticmethod
    def forward(ctx, xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2, activation):
        out = stack_bwd(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, dhs2, None,
                        activation, with_carries=True)
        ctx.save_for_backward(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2, *out[5:])
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return out[:5]

    @staticmethod
    def backward(ctx, u1, vr1, vk2, vb2, vr2):
        if torch.is_grad_enabled():
            raise NotImplementedError("LSTM stack: third-order derivatives are not supported")
        (xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
         dhT1, dcT1, dhT2, dcT2) = ctx.saved_tensors
        f32 = dict(dtype=torch.float32, device=xz1.device)
        cots = [torch.zeros(p.shape, **f32) if c is None else _f32(c)
                for c, p in zip((u1, vr1, vk2, vb2, vr2), (xz1, rec1, k2, b2, rec2))]
        out = stack_adj(xz1, rec1, k2, b2, rec2, hs1, cs1, hs2, cs2,
                        dhT1, dcT1, dhT2, dcT2, *cots, ctx.activation)
        return _cast_all(out[:5], (xz1, rec1, k2, b2, rec2)) + out[5:] + (None,)


def stack_seq(xz1, rec1, k2, b2, rec2, activation: Optional[str] = "tanh"):
    """Fused two-layer recurrence: (W, B, 4H) → layer 2's hs (W, B, H)
    float32, twice differentiable.  Under autograd with an operand that
    needs a gradient it runs :class:`StackFwdRes`; otherwise the primal
    forward kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xz1, rec1, k2, b2, rec2)):
        return StackFwdRes.apply(xz1, rec1, k2, b2, rec2, activation)[2]
    return stack_fwd(xz1, rec1, k2, b2, rec2, activation)


def keras_lstm_stack(params0: dict, params1: dict, x: torch.Tensor,
                     activation: Optional[str] = "tanh",
                     recurrent_activation: str = "sigmoid",
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The fused plain stack from two Keras-layout parameter dicts
    (``{kernel, recurrent_kernel, bias}``): (B, W, F) → (B, W, H) in the
    compute dtype (``pallas_keras_lstm_stack``).  Layer 1's input
    projection is one ``torch.matmul``; the recurrence of both layers is
    :func:`stack_seq`."""
    if recurrent_activation != "sigmoid":
        raise NotImplementedError(
            f"LSTM supports sigmoid gates only, got {recurrent_activation!r}")
    act = activation or "linear"
    act_code(act)
    h = params0["recurrent_kernel"].shape[0]
    if params1["recurrent_kernel"].shape[0] != h:
        raise NotImplementedError("fused stack requires equal layer widths")
    dt = dtype or x.dtype
    if dt not in STREAM_DTYPES:
        raise NotImplementedError(f"LSTM stack streams float32/bfloat16, got {dt}")
    b, w, f = x.shape
    xz1 = (x.to(dt).reshape(b * w, f) @ params0["kernel"].to(dt)
           + params0["bias"].to(dt)).reshape(b, w, 4 * h)
    weights = (params0["recurrent_kernel"], params1["kernel"], params1["bias"],
               params1["recurrent_kernel"])
    hs2 = stack_seq(xz1.transpose(0, 1).contiguous(),
                    *(m.to(dt).contiguous() for m in weights), act)
    return hs2.transpose(0, 1).to(dt)
