"""The single-layer LSTM recurrence and its derivatives: CUDA kernels,
plain versions, dispatch and autograd.

Counterpart of ``hfrep_tpu/ops/pallas_lstm.py`` (``_fwd_kernel`` in its
primal and ``with_cs`` modes, ``_bwd_kernel``, ``_adj_kernel``, each also
in its carry mode, and the nested ``custom_vjp``s ``lstm_seq`` /
``lstm_fwd_res`` / ``lstm_bwd_seq`` and ``lstm_seq_carry`` /
``lstm_fwd_res_carry`` / ``lstm_bwd_seq_carry`` over them).  The fused two-layer stack of the MTSS
critics (``pallas_lstm_stack.py``, three more kernels) is
:mod:`hfrep_tpu_torch.ops.cuda_lstm_stack`, built the same way on this
module's helpers and launch counters.  Four layers:

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
  raises.  The carry-free forward is also the dispatcher op
  ``hfrep::lstm_fwd`` (:func:`lstm_fwd_op`), with a fake implementation
  for ``torch.export``: the no-grad forward goes through it, so an
  exported serving program keeps the kernel as one node;
* autograd — :class:`LSTMFwdRes` and :class:`LSTMBwdSeq`, nested as the
  JAX ``custom_vjp``s are, so the WGAN-GP penalty's second order runs
  the adjoint kernel; :func:`lstm_seq` and :func:`keras_lstm` are the
  differentiable entries.  The carry modes (an injected initial (h0, c0),
  the final c out, the cotangents of h0, c0 and of the final c) have
  their own pair, :class:`LSTMFwdResCarry` and :class:`LSTMBwdSeqCarry`,
  behind :func:`lstm_seq_carry`, :func:`lstm_fwd_res_carry` and
  :func:`lstm_bwd_seq_carry`: a window run in chunks that pass (h, c)
  from one to the next, at first and second order.

The layout is the unpadded Keras one: xz (W, B, 4H) time-major with
gate blocks [i, f, c, o], rec (H, 4H).  The TPU kernels' 128-lane gate
padding is a TPU fact and is not carried over.  Gates are sigmoid;
``activation`` (sigmoid, tanh or linear) transforms the candidate and
the output.  xz and rec stream as float32 or bf16; h, c, the gate math,
the accumulation and every other array are float32 (the carries h0, c0,
their cotangents and dc_fin too).  A float32 vector
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
#: the weight sums (``csrc/weight_sum.cuh``): a block's output tile
#: (WS_TILE x WS_TILE) and its rows a piece (WS_K); the column sum's
#: columns a block with float4 loads (WS_COLS); the split rule's most
#: blocks an output tile, blocks an SM and pieces a block; most sums a launch
WS_TILE, WS_K, WS_COLS = 64, 16, 64
WS_MAX_SPLITS, WS_BLOCKS_PER_SM, WS_MIN_PIECES, WS_MAX_SUMS = 16, 8, 4, 3

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_fwd": {
        "hfrep_lstm_fwd": (_I, [_P, _P, _P, _P,          # xz, rec, hs, cs
                                _I, _I, _I,              # W, B, H
                                _I, _I,                  # act, bf16
                                _I, _I, _I, _I,          # layout, threads, rows, device
                                _P]),                    # stream
        "hfrep_lstm_fwd_carry": (_I, [_P] * 7             # xz rec h0 c0 hs cs cfin
                                 + [_I] * 9              # W B H act bf16 layout threads rows device
                                 + [_P]),
        "hfrep_max_smem_optin": (_I, [_I]),
        "hfrep_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "lstm_bwd": {
        "hfrep_lstm_bwd": (_I, [_P] * 10                 # xz rec hs cs dhs dcs dxz dhT dcT drec
                           + [_I] * 7                    # W B H act bf16 rows device
                           + [_P]                        # stream
                           + [_I] * 2),                  # layout threads
        # xz rec hs cs dhs dcs h0 c0 dcfin dxz dhT dcT dh0 dc0 drec
        "hfrep_lstm_bwd_carry": (_I, [_P] * 15 + [_I] * 7 + [_P] + [_I] * 2),
    },
    "lstm_adj": {
        "hfrep_lstm_adj": (_I, [_P] * 14                 # xz rec v hs cs dhT dcT u uxz uhs ucs udhs urec dzw
                           + [_I] * 7                    # W B H act bf16 rows device
                           + [_P]                        # stream
                           + [_I] * 2),                  # layout threads
        # xz rec v hs cs dhT dcT u h0 c0 muh0 muc0 uxz uhs ucs udhs urec dzw
        # udcfin uh0 uc0
        "hfrep_lstm_adj_carry": (_I, [_P] * 21 + [_I] * 7 + [_P] + [_I] * 2),
    },
    "weight_sum": {
        # a b head out (arrays of pointers), shift (array of ints)
        "hfrep_weight_sum": (_I, [ctypes.POINTER(_P)] * 4 + [ctypes.POINTER(_I)]
                             + [_I] * 7          # nsum npair R M N splits device
                             + [_P]),            # stream
        "hfrep_weight_sum_splits": (_I, [_I] * 6),   # nsum npair R M N sms
    },
}
#: every library that launches weight sums (``csrc/weight_sum.cuh``)
#: exports its own launch counters: (out, reset) -> their number
WS_COUNTER_SIGNATURE = {
    "hfrep_weight_sum_launches": (_I, [ctypes.POINTER(ctypes.c_longlong), _I])}
for _name in ("lstm_bwd", "lstm_adj", "weight_sum"):
    _SIGNATURES[_name].update(WS_COUNTER_SIGNATURE)

#: kernel launches, one counter per kernel and mode, each a plain int
#: raised by one where its wrapper launches (reset with
#: :func:`reset_launches`; read all with :func:`launch_counts`).  The
#: fused two-layer stack's wrappers (:mod:`.cuda_lstm_stack`) count here
#: too, so one dict carries every kernel.
launches = 0                # lstm_fwd, primal mode
launches_cs = 0             # lstm_fwd, with_cs mode
launches_bwd = 0            # lstm_bwd
launches_adj = 0            # lstm_adj
launches_fwd_carry = 0      # lstm_fwd, carry primal mode
launches_cs_carry = 0       # lstm_fwd, carry with_cs mode
launches_bwd_carry = 0      # lstm_bwd, carry0 mode (with any mix of dcs, carries)
launches_adj_carry = 0      # lstm_adj, carry mode
launches_stack_fwd = 0      # stack_fwd, primal mode
launches_stack_res = 0      # stack_fwd, with_res mode
launches_stack_bwd = 0      # stack_bwd
launches_stack_adj = 0      # stack_adj
_COUNTERS = {"lstm_fwd": "launches", "lstm_fwd_cs": "launches_cs",
             "lstm_bwd": "launches_bwd", "lstm_adj": "launches_adj",
             "lstm_fwd_carry": "launches_fwd_carry", "lstm_fwd_cs_carry": "launches_cs_carry",
             "lstm_bwd_carry": "launches_bwd_carry", "lstm_adj_carry": "launches_adj_carry",
             "stack_fwd": "launches_stack_fwd", "stack_fwd_res": "launches_stack_res",
             "stack_bwd": "launches_stack_bwd", "stack_adj": "launches_stack_adj"}
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for var in _COUNTERS.values():
            globals()[var] = 0
    weight_sum_launches(reset=True)


def launch_counts() -> dict:
    """``{kernel: launches}`` for lstm_fwd, lstm_fwd_cs, lstm_bwd, lstm_adj,
    their carry modes (lstm_fwd_carry, lstm_fwd_cs_carry, lstm_bwd_carry,
    lstm_adj_carry), stack_fwd, stack_fwd_res, stack_bwd and stack_adj."""
    with _count_lock:
        return {k: globals()[var] for k, var in _COUNTERS.items()}


def _count_launch(kernel: str) -> None:
    with _count_lock:
        globals()[_COUNTERS[kernel]] += 1


def weight_sum_launches(reset: bool = False) -> dict:
    """The weight sums' launches (``csrc/weight_sum.cuh``), as counted in
    C where ``weight_sums`` launches them, summed over the loaded libraries
    (the backward and adjoint entries and ``weight_sum.cu``'s): ``{(sums a
    launch, pairs, column sum): launches}`` for 1 to WS_MAX_SUMS sums, 1
    or 2 pairs, the M > 1 kernel (False) and the column sum (True).
    ``reset``: set the counters to zero as they are read (as
    :func:`reset_launches` does).  A library not yet loaded has launched
    nothing; none is built to be asked."""
    keys = [(nsum, npair, column) for column in (False, True) for npair in (1, 2)
            for nsum in range(1, WS_MAX_SUMS + 1)]
    total = dict.fromkeys(keys, 0)
    buf = (ctypes.c_longlong * len(keys))()
    for lib in _build.loaded().values():
        read = getattr(lib, "hfrep_weight_sum_launches", None)
        if read is None:
            continue
        if read(buf, int(reset)) != len(keys):
            raise RuntimeError("weight_sum.cuh's launch shapes differ from weight_sum_launches'")
        for k, n in zip(keys, buf):
            total[k] += n
    return total


def act_code(activation: Optional[str]) -> int:
    if activation not in ACT_CODES:
        raise NotImplementedError(
            f"LSTM kernel: unsupported activation {activation!r}; "
            f"supported: sigmoid, tanh, linear")
    return ACT_CODES[activation]


# ------------------------------------------------------- eligibility rule
#: the forward's register layout (``csrc/lstm_fwd.cu``): a thread holds
#: FWD_KS rows of rec's k range for its hidden unit's four gate columns
#: (FWD_KEEP of them in registers, the rest in shared memory), four
#: threads a unit in FWD_THREADS, so widths up to 4 * FWD_KS; in shared
#: memory h's quarters sit FWD_KSP floats apart and z's gates FWD_ZP
FWD_KS, FWD_KSP, FWD_KEEP, FWD_ZP, FWD_THREADS = 25, 28, 22, 104, 416
FWD_LAYOUTS = {"registers": 0, "wide": 1}


def smem_bytes(hidden: int, dtype: torch.dtype, rows: int = 1,
               kernel: str = "lstm_fwd") -> int:
    """Dynamic shared memory of one block of ``kernel``.

    lstm_fwd, at widths the register layout takes (H <= 4 * FWD_KS): the
    float32 h buffer (four quarters of FWD_KSP) and z buffer (four gates
    of FWD_ZP), the rows of rec not held in registers (float32), and rec
    itself in the operand dtype, staged there once; nothing grows with the
    rows.  Wider, the wide layout: rec plus two h buffers per row, in the
    operand dtype.  lstm_bwd and lstm_adj in their wide layouts (the
    layout rules :func:`bwd_layout` and :func:`adj_layout` take them above
    4 * FWD_KS hidden units; their register layouts are
    :func:`reg_bwd_smem_bytes` and :func:`reg_adj_smem_bytes`): rec with
    a one-entry row pad (rounded up to 16 B), plus float32 staging per
    batch row — h_{t-1} and dz (5H) for the backward; h_{t-1}, mu_h, dz
    and zbar (10H) for the adjoint."""
    item = torch.empty((), dtype=dtype).element_size()
    if kernel == "lstm_fwd" and hidden <= 4 * FWD_KS:
        own = 4 * FWD_KSP + 4 * FWD_ZP + (FWD_KS - FWD_KEEP) * 4 * FWD_THREADS
        return own * 4 + 4 * hidden * hidden * item
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


def fwd_layout(hidden: int, dtype: torch.dtype, batch: int, sm_count: int,
               smem_limit: int) -> tuple:
    """The forward kernel's launch rule: ``(layout, threads, rows)``.

    Up to 4 * FWD_KS hidden units the register layout: FWD_THREADS threads,
    a quad per unit holding rec in registers, ceil(B / SMs) batch rows a
    block walked one after another.  Wider, the wide layout under
    :func:`check_fits` (which raises what it refuses), with
    :func:`rows_per_block` rows a block and a thread per (row, unit).
    Pure arithmetic on the shapes and the card's limits: the wrapper never
    tries a layout and falls back."""
    if hidden <= 4 * FWD_KS:
        need = smem_bytes(hidden, dtype, 1, "lstm_fwd")
        if need > smem_limit:
            raise ValueError(f"lstm_fwd kernel: the register layout needs {need} B of "
                             f"shared memory; one block of this card may use {smem_limit} B")
        return "registers", FWD_THREADS, max(1, math.ceil(batch / sm_count))
    rows = rows_per_block(batch, hidden, sm_count)
    check_fits(hidden, dtype, rows, smem_limit, "lstm_fwd")
    return "wide", 32 * math.ceil(rows * hidden / 32), rows


#: the backward's register layout (``csrc/lstm_bwd.cu``): the stack
#: backward's quad layout (FWD_THREADS threads, a quad a unit, FWD_KS chunks
#: of four columns a thread), BWD_KEEP[dtype] chunks in registers and the
#: rest in shared memory; the prologue stages rec a BWD_PARTS-th of its rows
#: at a time
BWD_KEEP = {torch.float32: 17, torch.bfloat16: 17}
BWD_PARTS = 2
BWD_LAYOUTS = {"registers": 0, "wide": 1}


def reg_bwd_smem_bytes(hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the backward's register layout: two
    float32 dz buffers (4 x FWD_ZP floats each), each thread's two step
    inputs staged for two steps, the chunks of rec past BWD_KEEP[dtype] (a
    float4 a thread), and a staging area for a BWD_PARTS-th of rec's rows
    in the operand dtype."""
    item = torch.empty((), dtype=dtype).element_size()
    fixed = 8 * FWD_ZP + 4 * FWD_THREADS + 4 * (FWD_KS - BWD_KEEP[dtype]) * FWD_THREADS
    return fixed * 4 + -(-hidden // BWD_PARTS) * 4 * hidden * item


def _quad_layout(kernel: str, reg_bytes: int, hidden: int, dtype: torch.dtype, batch: int,
                 sm_count: int, smem_limit: int) -> tuple:
    """The single-layer backward's and adjoint's launch rule:
    ``(layout, threads, rows)``.  Up to 4 * FWD_KS hidden units the
    register layout, which needs ``reg_bytes`` of shared memory: a pre-pass
    of tiled products, then FWD_THREADS threads a block, a quad per unit
    holding its part of rec, ceil(B / SMs) batch rows a block walked one
    after another.  Wider, the wide layout under :func:`check_fits` (which
    raises what it refuses), with :func:`rows_per_block` rows a block and a
    thread per (row, unit).  Pure arithmetic on the shapes and the card's
    limits: the wrapper never tries a layout and falls back."""
    if hidden <= 4 * FWD_KS:
        if reg_bytes > smem_limit:
            raise ValueError(f"{kernel} kernel: the register layout needs {reg_bytes} B of "
                             f"shared memory; one block of this card may use {smem_limit} B")
        return "registers", FWD_THREADS, max(1, math.ceil(batch / sm_count))
    rows = rows_per_block(batch, hidden, sm_count)
    check_fits(hidden, dtype, rows, smem_limit, kernel)
    return "wide", 32 * math.ceil(rows * hidden / 32), rows


def bwd_layout(hidden: int, dtype: torch.dtype, batch: int, sm_count: int,
               smem_limit: int) -> tuple:
    """The backward kernel's launch rule (:func:`_quad_layout`): the
    register layout (a gate-recompute pre-pass, then a quad per unit
    holding its row of rec) up to 4 * FWD_KS hidden units, the wide layout
    above."""
    return _quad_layout("lstm_bwd", reg_bwd_smem_bytes(hidden, dtype), hidden, dtype, batch,
                        sm_count, smem_limit)


#: the adjoint's register layout (``csrc/lstm_adj.cu``): the stack
#: adjoint's cluster block on one layer (FWD_THREADS threads, a quad a unit,
#: thread (j, q) holding FWD_KS rows of k-quarter q of unit j's four gate
#: columns), ADJ_KEEP[dtype] rows in registers and the rest in shared
#: memory; each thread stages _ADJ_STAGED step inputs (its gate, its base,
#: one state value); the prologue stages rec an ADJ_PARTS-th of its rows at
#: a time
ADJ_KEEP = {torch.float32: 21, torch.bfloat16: 21}
ADJ_PARTS = 2
ADJ_LAYOUTS = {"registers": 0, "wide": 1}
_ADJ_STAGED = 3


def reg_adj_smem_bytes(hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the adjoint's register layout: two float32
    h buffers (4 x FWD_KSP floats each), each thread's _ADJ_STAGED step
    inputs staged for two steps, the rows of rec past ADJ_KEEP[dtype] (a
    float4 a thread), and a staging area for an ADJ_PARTS-th of rec's rows
    in the operand dtype."""
    item = torch.empty((), dtype=dtype).element_size()
    fixed = (8 * FWD_KSP + 2 * _ADJ_STAGED * FWD_THREADS
             + 4 * (FWD_KS - ADJ_KEEP[dtype]) * FWD_THREADS)
    return fixed * 4 + -(-hidden // ADJ_PARTS) * 4 * hidden * item


def adj_layout(hidden: int, dtype: torch.dtype, batch: int, sm_count: int,
               smem_limit: int) -> tuple:
    """The adjoint kernel's launch rule (:func:`_quad_layout`): the
    register layout (a pre-pass of the gates and u + h_{t-1} . v, a quad
    per unit holding its k-quarter of rec for round(mu_h) . rec, a
    post-pass of the transposed products) up to 4 * FWD_KS hidden units,
    the wide layout above; both modes alike."""
    return _quad_layout("lstm_adj", reg_adj_smem_bytes(hidden, dtype), hidden, dtype, batch,
                        sm_count, smem_limit)


def sum_plan(nsum: int, npair: int, nrows: int, m: int, n: int, sm_count: int) -> tuple:
    """How ``csrc/weight_sum.cuh`` launches ``nsum`` sums of ``npair``
    pairs over ``nrows`` rows, each C (m, n), operands aligned:
    ``(tiles, pieces, splits)`` — the output tiles of the launch (64 x 64
    a block; for m = 1 the column sum's WS_COLS columns), the pieces of
    WS_K rows in a tile's k range, and the blocks of the cluster each
    tile's k range is split over (:func:`sum_splits`).  The C++ twin is
    ``hfrep_weight_sum_splits``."""
    if m == 1:
        tiles = math.ceil(n / WS_COLS) * nsum
    else:
        tiles = math.ceil(n / WS_TILE) * math.ceil(m / WS_TILE) * nsum
    pieces = npair * math.ceil(nrows / WS_K)
    return tiles, pieces, sum_splits(tiles, pieces, sm_count)


def sum_splits(tiles: int, pieces: int, sm_count: int) -> int:
    """The weight sums' split rule: the most of 16, 8, 4, 2, 1 blocks an
    output tile that keeps the launch within WS_BLOCKS_PER_SM blocks an SM
    and gives each block at least WS_MIN_PIECES pieces.  A split shortens
    each block's chain of pieces when the (H, 4H) tiles alone would leave
    most SMs idle; its cost is the cluster's reduction."""
    s = WS_MAX_SPLITS
    while s > 1:
        if s * tiles <= WS_BLOCKS_PER_SM * sm_count and pieces >= s * WS_MIN_PIECES:
            return s
        s //= 2
    return 1


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


def _carry_pair(fn: str, name: str, pair, nullable: bool = False) -> tuple:
    """``pair`` as a 2-tuple of tensors ((None, None) for None); with
    ``nullable`` either may be None."""
    if pair is None:
        return None, None
    if not (isinstance(pair, (tuple, list)) and len(pair) == 2
            and (nullable or all(t is not None for t in pair))):
        raise TypeError(f"{fn}: {name} is a pair of (B, H) tensors")
    return tuple(pair)


def _no_carry_extra(fn: str, carry, name: str, extra) -> None:
    if carry is None and extra is not None:
        raise ValueError(f"{fn}: {name} belongs to the carry mode; pass carry=(h0, c0)")


def _check_carry(fn: str, device: torch.device, state: tuple, named: dict) -> None:
    """The carry modes' (B, H) tensors (None skipped): float32, contiguous,
    on xz's device, of shape ``state``, not needing a gradient."""
    _check_f32(fn, device, {k: (t, state) for k, t in named.items()})
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in named.values()):
        raise NotImplementedError(
            f"{fn} is not differentiable itself: differentiate through "
            f"cuda_lstm.lstm_seq_carry, whose autograd runs the backward and "
            f"adjoint kernels")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        msg = _lib().hfrep_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} (cudaError {err})")


def lstm_fwd_cuda(xz: torch.Tensor, rec: torch.Tensor,
                  activation: Optional[str] = "tanh", with_cs: bool = False,
                  carry: Optional[tuple] = None):
    """Launch ``csrc/lstm_fwd.cu`` in the layout :func:`fwd_layout` picks:
    xz (W, B, 4H), rec (H, 4H) → hs (W, B, H) float32, and with
    ``with_cs`` also cs (W, B, H) float32, on CUDA tensors only.
    ``carry`` = (h0, c0), float32 (B, H): h and c start there; without
    ``with_cs`` the result is then (hs, c_fin), the final c (B, H)."""
    act = act_code(activation)
    w, b, h = _check_operands("lstm_fwd_cuda", xz, rec)
    if rec.data_ptr() % 16:
        rec = rec.clone()              # the kernel stages rec with 16-byte loads
    h0, c0 = _carry_pair("lstm_fwd_cuda", "carry", carry)
    if carry is not None:
        _check_carry("lstm_fwd_cuda", xz.device, (b, h), {"h0": h0, "c0": c0})
    hs = torch.empty((w, b, h), dtype=torch.float32, device=xz.device)
    cs = torch.empty_like(hs) if with_cs else None
    c_fin = None
    if carry is not None and not with_cs:
        c_fin = torch.empty((b, h), dtype=torch.float32, device=xz.device)
    out = (hs, cs) if with_cs else (hs, c_fin) if c_fin is not None else hs
    if w == 0 or b == 0:
        if c_fin is not None:
            c_fin.copy_(c0)
        return out
    dev = xz.device.index if xz.device.index is not None else torch.cuda.current_device()
    layout, threads, rows = fwd_layout(
        h, xz.dtype, b, torch.cuda.get_device_properties(dev).multi_processor_count,
        _lib().hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz.device).cuda_stream
    bf16 = int(xz.dtype == torch.bfloat16)
    plan = (FWD_LAYOUTS[layout], threads, rows, dev, stream)
    if carry is None:
        err = _lib().hfrep_lstm_fwd(xz.data_ptr(), rec.data_ptr(), hs.data_ptr(),
                                    _ptr(cs), w, b, h, act, bf16, *plan)
    else:
        err = _lib().hfrep_lstm_fwd_carry(
            xz.data_ptr(), rec.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
            _ptr(cs), _ptr(c_fin), w, b, h, act, bf16, *plan)
    _raise_on(err, "lstm_fwd")
    _count_launch("lstm_fwd" + ("_cs" if with_cs else "") + ("_carry" if carry else ""))
    return out


def lstm_bwd_cuda(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                  cs: torch.Tensor, dhs: torch.Tensor,
                  dcs: Optional[torch.Tensor] = None,
                  activation: Optional[str] = "tanh",
                  with_carries: bool = False,
                  carry: Optional[tuple] = None,
                  dc_fin: Optional[torch.Tensor] = None) -> tuple:
    """Launch ``csrc/lstm_bwd.cu`` in the layout :func:`bwd_layout` picks:
    (dxz (W, B, 4H), drec (H, 4H)) and,
    with ``with_carries``, the per-step (dhT, dcT) (W, B, H); every output
    float32.  ``dcs`` is an optional direct cotangent on cs.  ``carry`` =
    (h0, c0) is the carry0 mode: step 0's previous state is (h0, c0), the
    dc carry starts at ``dc_fin`` (the final c's cotangent; None: zero),
    and (dh0, dc0) (B, H) are appended."""
    act = act_code(activation)
    w, b, h = _check_operands("lstm_bwd_cuda", xz, rec)
    seq = (w, b, h)
    _check_f32("lstm_bwd_cuda", xz.device,
               {"hs": (hs, seq), "cs": (cs, seq), "dhs": (dhs, seq), "dcs": (dcs, seq)})
    h0, c0 = _carry_pair("lstm_bwd_cuda", "carry", carry)
    _no_carry_extra("lstm_bwd_cuda", carry, "dc_fin", dc_fin)
    if carry is not None:
        _check_carry("lstm_bwd_cuda", xz.device, (b, h), {"h0": h0, "c0": c0, "dc_fin": dc_fin})
    f32 = dict(dtype=torch.float32, device=xz.device)
    dxz = torch.empty((w, b, 4 * h), **f32)
    drec = torch.empty((h, 4 * h), **f32)
    dhT = torch.empty(seq, **f32) if with_carries else None
    dcT = torch.empty(seq, **f32) if with_carries else None
    dh0 = torch.empty((b, h), **f32) if carry is not None else None
    dc0 = torch.empty((b, h), **f32) if carry is not None else None
    outs = ((dxz, drec) + ((dhT, dcT) if with_carries else ())
            + ((dh0, dc0) if carry is not None else ()))
    if w == 0 or b == 0:
        drec.zero_()
        if carry is not None:
            dh0.zero_()
            dc0.zero_()
            if dc_fin is not None:
                dc0.copy_(dc_fin)
        return outs
    dev = xz.device.index if xz.device.index is not None else torch.cuda.current_device()
    layout, threads, rows = bwd_layout(
        h, xz.dtype, b, torch.cuda.get_device_properties(dev).multi_processor_count,
        _lib().hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz.device).cuda_stream
    bf16 = int(xz.dtype == torch.bfloat16)
    plan = (w, b, h, act, bf16, rows, dev, stream, BWD_LAYOUTS[layout], threads)
    if carry is None:
        err = _lib("lstm_bwd").hfrep_lstm_bwd(
            xz.data_ptr(), rec.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
            _ptr(dcs), dxz.data_ptr(), _ptr(dhT), _ptr(dcT), drec.data_ptr(), *plan)
    else:
        err = _lib("lstm_bwd").hfrep_lstm_bwd_carry(
            xz.data_ptr(), rec.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
            _ptr(dcs), h0.data_ptr(), c0.data_ptr(), _ptr(dc_fin), dxz.data_ptr(),
            _ptr(dhT), _ptr(dcT), dh0.data_ptr(), dc0.data_ptr(), drec.data_ptr(), *plan)
    _raise_on(err, "lstm_bwd")
    _count_launch("lstm_bwd" if carry is None else "lstm_bwd_carry")
    return outs


def lstm_adj_cuda(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                  cs: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                  u: torch.Tensor, v: torch.Tensor,
                  activation: Optional[str] = "tanh",
                  carry: Optional[tuple] = None,
                  mu0: Optional[tuple] = None) -> tuple:
    """Launch ``csrc/lstm_adj.cu`` in the layout :func:`adj_layout` picks:
    given u = cot(dxz) (W, B, 4H) and
    v = cot(drec) (H, 4H), the cotangents (uxz, urec, uhs, ucs, udhs) of
    the backward's inputs xz, rec, hs, cs and dhs, all float32.  Carry
    mode: ``carry`` = (h0, c0) the backward's injected state and ``mu0`` =
    (muh0, muc0) the cotangents of its (dh0, dc0) (either None: zero);
    (u_dcfin, uh0, uc0), the cotangents of dc_fin, h0 and c0, are appended."""
    act = act_code(activation)
    w, b, h = _check_operands("lstm_adj_cuda", xz, rec)
    seq = (w, b, h)
    _check_f32("lstm_adj_cuda", xz.device,
               {"hs": (hs, seq), "cs": (cs, seq), "dhT": (dhT, seq), "dcT": (dcT, seq),
                "u": (u, (w, b, 4 * h)), "v": (v, (h, 4 * h))})
    h0, c0 = _carry_pair("lstm_adj_cuda", "carry", carry)
    muh0, muc0 = _carry_pair("lstm_adj_cuda", "mu0", mu0, nullable=True)
    _no_carry_extra("lstm_adj_cuda", carry, "mu0", mu0)
    if carry is not None:
        _check_carry("lstm_adj_cuda", xz.device, (b, h),
                     {"h0": h0, "c0": c0, "muh0": muh0, "muc0": muc0})
    f32 = dict(dtype=torch.float32, device=xz.device)
    uxz = torch.empty((w, b, 4 * h), **f32)
    urec = torch.empty((h, 4 * h), **f32)
    uhs, ucs, udhs = (torch.empty(seq, **f32) for _ in range(3))
    tail = tuple(torch.empty((b, h), **f32) for _ in range(3)) if carry is not None else ()
    outs = (uxz, urec, uhs, ucs, udhs) + tail
    if w == 0 or b == 0:
        urec.zero_()
        for t in tail:
            t.zero_()
        if tail and muc0 is not None:
            tail[0].copy_(muc0)
        return outs
    dev = xz.device.index if xz.device.index is not None else torch.cuda.current_device()
    layout, threads, rows = adj_layout(
        h, xz.dtype, b, torch.cuda.get_device_properties(dev).multi_processor_count,
        _lib().hfrep_max_smem_optin(dev))
    stream = torch.cuda.current_stream(xz.device).cuda_stream
    dzw = torch.empty((w, b, 4 * h), **f32)          # the backward's dz, for urec
    bf16 = int(xz.dtype == torch.bfloat16)
    plan = (w, b, h, act, bf16, rows, dev, stream, ADJ_LAYOUTS[layout], threads)
    if carry is None:
        err = _lib("lstm_adj").hfrep_lstm_adj(
            xz.data_ptr(), rec.data_ptr(), v.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhT.data_ptr(), dcT.data_ptr(), u.data_ptr(), uxz.data_ptr(), uhs.data_ptr(),
            ucs.data_ptr(), udhs.data_ptr(), urec.data_ptr(), dzw.data_ptr(), *plan)
    else:
        udcfin, uh0, uc0 = tail
        err = _lib("lstm_adj").hfrep_lstm_adj_carry(
            xz.data_ptr(), rec.data_ptr(), v.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dhT.data_ptr(), dcT.data_ptr(), u.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            _ptr(muh0), _ptr(muc0), uxz.data_ptr(), uhs.data_ptr(), ucs.data_ptr(),
            udhs.data_ptr(), urec.data_ptr(), dzw.data_ptr(), udcfin.data_ptr(),
            uh0.data_ptr(), uc0.data_ptr(), *plan)
    _raise_on(err, "lstm_adj")
    _count_launch("lstm_adj" if carry is None else "lstm_adj_carry")
    return outs


def weight_sums_cuda(sums, splits: int = 0) -> list:
    """Launch the weight sums alone (``csrc/weight_sum.cu``): each of the
    one to three ``sums`` is ``(terms, shift)``, its terms one or two
    ``(a, b, head)`` — a (R, M) or None (a column of ones), b (R, N), head
    (shift, M) or None (zeros) — float32 CUDA tensors, every sum of the
    same R, M, N and number of terms; returns each sum's C (M, N) float32,
    the function of :func:`weight_sum_plain`.  ``splits`` 0 takes the
    rule's cluster size (:func:`sum_plan`), else 1, 2, 4, 8 or 16.  The
    launch is counted in C (:func:`weight_sum_launches`).  The card tests,
    ``chip_smoke.py`` and ``tools/torch_weight_sum.py`` call it; the
    backward and adjoint entries launch the same kernels themselves."""
    if not 1 <= len(sums) <= WS_MAX_SUMS:
        raise ValueError(f"weight_sums_cuda takes 1 to {WS_MAX_SUMS} sums, got {len(sums)}")
    npair = len(sums[0][0])
    b0 = sums[0][0][0][1]
    r, n = b0.shape
    a0 = next((a for terms, _ in sums for a, _, _ in terms if a is not None), None)
    m = 1 if a0 is None else a0.shape[1]
    dev = b0.device
    a_p, b_p, h_p, shifts = [], [], [], []
    for terms, shift in sums:
        if len(terms) != npair or npair not in (1, 2):
            raise ValueError("weight_sums_cuda: every sum has the same one or two terms")
        for a, b, head in terms:
            _check_f32("weight_sums_cuda", dev, {"a": (a, (r, m)), "b": (b, (r, n)),
                                                 "head": (head, (shift, m))})
            if not b.is_cuda:
                raise ValueError(f"weight_sums_cuda runs on CUDA tensors; got b on {b.device}")
            a_p.append(_ptr(a))
            b_p.append(b.data_ptr())
            h_p.append(_ptr(head))
        shifts.append(shift)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty((m, n), **f32) for _ in sums]
    ptrs = lambda v: (_P * len(v))(*v)         # noqa: E731
    err = _lib("weight_sum").hfrep_weight_sum(
        ptrs(a_p), ptrs(b_p), ptrs(h_p), ptrs([o.data_ptr() for o in outs]),
        (_I * len(shifts))(*shifts), len(sums), npair, r, m, n, splits,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "weight_sum")
    return outs


def weight_sum_plain(terms, shift: int) -> torch.Tensor:
    """The weight sums' function as plain torch: C = sum over ``terms``
    ``(a, b, head)`` of a'^T b, a' being a moved down by ``shift`` rows
    with ``head`` (shift, M) on top (None: zeros); a None is a column of
    ones (M = 1), whose C is b's column sums.  (M, N) float32: drec and its
    siblings in the backward's and the adjoint's plain versions."""
    out = None
    for a, b, head in terms:
        r = b.shape[0]
        if a is None:
            c = b[shift:].sum(0, keepdim=True)
            if head is not None:
                c = c + head[:r].T @ b[:shift]
        else:
            top = head if head is not None else torch.zeros(
                (shift, a.shape[1]), dtype=a.dtype, device=a.device)
            c = torch.cat([top, a])[:r].T @ b
        out = c if out is None else out + c
    return out


# ------------------------------------------------------ the plain versions
def _rounder(rec: torch.Tensor):
    """float32 → float32 through rec's dtype: the cast the TPU kernels make
    before a dot with rec or recᵀ (the identity for float32)."""
    if rec.dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(rec.dtype).float()


def _shifted(seq: torch.Tensor, first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-step previous-state sequence: step 0 sees zeros, or the
    injected state ``first`` (B, H)."""
    head = torch.zeros_like(seq[:1]) if first is None else first[None].to(seq.dtype)
    return torch.cat([head, seq[:-1]], dim=0)



def _gates(z: torch.Tensor, h: int, act):
    return (sigmoid(z[:, :h]), sigmoid(z[:, h:2 * h]), act(z[:, 2 * h:3 * h]),
            sigmoid(z[:, 3 * h:]))


def lstm_seq_plain(xz: torch.Tensor, rec: torch.Tensor,
                   activation: Optional[str] = "tanh", with_cs: bool = False,
                   carry: Optional[tuple] = None):
    """The forward kernel's function as a plain step loop
    (``lstm_cell_step``): hs (W, B, H) float32, and with ``with_cs`` also
    cs.  h is rounded to the operand dtype before the dot; the dot (exact
    products of bf16 values, summed in float32), state and gate math are
    float32.  ``carry`` = (h0, c0): h and c start there, and without
    ``with_cs`` the result is (hs, c_fin).  Built from differentiable
    torch ops, so torch's own autograd can differentiate it (the tests'
    reference)."""
    act = _PLAIN_ACT[act_code(activation)]
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = _rounder(rec)
    if carry is None:
        h_t = torch.zeros((b, h), dtype=torch.float32, device=xz.device)
        c = torch.zeros_like(h_t)
    else:
        h_t, c = carry[0].float(), carry[1].float()
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
    if with_cs:
        return hs_t, (torch.stack(cs) if cs else empty.clone())
    return hs_t if carry is None else (hs_t, c)


def lstm_bwd_plain(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dhs: torch.Tensor,
                   dcs: Optional[torch.Tensor] = None,
                   activation: Optional[str] = "tanh",
                   with_carries: bool = False,
                   carry: Optional[tuple] = None,
                   dc_fin: Optional[torch.Tensor] = None) -> tuple:
    """The backward kernel's function as a plain reverse-time step loop
    (``_bwd_kernel`` / ``_lstm_bwd_scan``): (dxz, drec) [+ (dhT, dcT)]
    [+ (dh0, dc0) in the carry0 mode, ``carry`` = (h0, c0), with the dc
    carry starting at ``dc_fin``]."""
    _no_carry_extra("lstm_bwd_plain", carry, "dc_fin", dc_fin)
    code = act_code(activation)
    act, p = _PLAIN_ACT[code], _PRIME[code]
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = _rounder(rec)
    h0, c0 = (None, None) if carry is None else carry
    h_prev, c_prev = _shifted(hs, h0), _shifted(cs, c0)
    f32 = dict(dtype=torch.float32, device=xz.device)
    dxz = torch.empty((w, b, g), **f32)
    dhT = torch.empty((w, b, h), **f32)
    dcT = torch.empty((w, b, h), **f32)
    dh_c = torch.zeros((b, h), **f32)
    dc_c = torch.zeros((b, h), **f32) if dc_fin is None else dc_fin.float().clone()
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
    drec = weight_sum_plain([(hs.reshape(w * b, h), dxz.reshape(w * b, g),
                              None if h0 is None else h0.float())], b)
    outs = (dxz, drec, dhT, dcT) if with_carries else (dxz, drec)
    return outs if carry is None else outs + (dh_c, dc_c)


def _adj_step(code: int, z, c, c_prev, dh, dc, muc, dzbar) -> tuple:
    """One step of a layer's adjoint (``_adj_kernel``; ``adj_layer`` of the
    fused stack): the backward's step recomputed from the gates of ``z``
    and the carries dh = dhT_t, dc = dcT_t, then its VJP given the
    cotangent ``dzbar`` of dz and mu_c of the dc carry.  Returns (dz,
    zbar, dhTbar, dcTbar, cpbar, cbar): the backward's dz, the cotangent
    of z, of dhT_t and dcT_t, of c_{t-1} through the forget gate's dz, and
    of c_t."""
    act, p, pp = _PLAIN_ACT[code], _PRIME[code], _PRIME2[code]
    h = z.shape[-1] // 4
    i, f, gc, o = _gates(z, h, act)
    a_c = act(c)
    qi, qf, qo = i * (1.0 - i), f * (1.0 - f), o * (1.0 - o)
    do = dh * a_c
    dz = torch.cat([dc * gc * qi, dc * c_prev * qf, dc * i * p(gc), do * qo], dim=-1)
    dzbi, dzbf = dzbar[:, :h], dzbar[:, h:2 * h]
    dzbc, dzbo = dzbar[:, 2 * h:3 * h], dzbar[:, 3 * h:]
    dcTbar = muc * f
    fbar = muc * dc
    dcTbar = dcTbar + dzbi * gc * qi
    gbar = dzbi * dc * qi
    ibar = dzbi * dc * gc * (1.0 - 2.0 * i)
    dcTbar = dcTbar + dzbf * c_prev * qf
    cpbar = dzbf * dc * qf
    fbar = fbar + dzbf * dc * c_prev * (1.0 - 2.0 * f)
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
    return dz, zbar, dhTbar, dcTbar, cpbar, aCbar * p(a_c)


def lstm_adj_plain(xz: torch.Tensor, rec: torch.Tensor, hs: torch.Tensor,
                   cs: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                   u: torch.Tensor, v: torch.Tensor,
                   activation: Optional[str] = "tanh",
                   carry: Optional[tuple] = None,
                   mu0: Optional[tuple] = None) -> tuple:
    """The adjoint kernel's function as a plain forward-time step loop
    (``_adj_kernel``, with ``_adj_call``'s output shift):
    (uxz, urec, uhs, ucs, udhs) [+ (u_dcfin, uh0, uc0) in the carry mode,
    ``carry`` = (h0, c0), with the adjoint carries starting at ``mu0`` =
    (muh0, muc0), either None: zero]."""
    _no_carry_extra("lstm_adj_plain", carry, "mu0", mu0)
    code = act_code(activation)
    w, b, g = xz.shape
    h = g // 4
    rec32 = rec.float()
    rnd = _rounder(rec)
    h0, c0 = (None, None) if carry is None else carry
    h_prev, c_prev = _shifted(hs, h0), _shifted(cs, c0)
    f32 = dict(dtype=torch.float32, device=xz.device)
    uxz = torch.empty((w, b, g), **f32)
    uhp, ucp, uc, udhs = (torch.empty((w, b, h), **f32) for _ in range(4))
    urec = torch.zeros((h, g), **f32)
    muh0, muc0 = (None, None) if mu0 is None else mu0
    muh = torch.zeros((b, h), **f32) if muh0 is None else muh0.float()
    muc = torch.zeros((b, h), **f32) if muc0 is None else muc0.float()
    for t in range(w):
        hp_s, cp_s, dh, dc = h_prev[t], c_prev[t], dhT[t], dcT[t]
        z = xz[t].float() + rnd(hp_s) @ rec32
        dzbar = u[t] + rnd(muh) @ rec32 + hp_s @ v
        dz, zbar, dhTbar, dcTbar, cpbar, cbar = _adj_step(
            code, z, cs[t], cp_s, dh, dc, muc, dzbar)
        uxz[t] = zbar
        udhs[t] = dhTbar
        uhp[t] = dz @ v.T + rnd(zbar) @ rec32.T
        ucp[t] = cpbar
        uc[t] = cbar
        urec = urec + (muh.T @ dz + hp_s.T @ zbar)
        muh, muc = dhTbar, dcTbar
    # uhp_t is the cotangent of hs_{t-1}, ucp_t of cs_{t-1}, uc_t of cs_t
    zero = torch.zeros_like(uhp[:1])
    uhs = torch.cat([uhp[1:], zero], dim=0)
    ucs = uc + torch.cat([ucp[1:], zero], dim=0)
    if carry is None:
        return uxz, urec, uhs, ucs, udhs
    # step 0's previous state is the injected carry itself; the last
    # step's dcTbar is the cotangent of the dc carry the backward started at
    first = (uhp[0], ucp[0]) if w else (torch.zeros((b, h), **f32),) * 2
    return (uxz, urec, uhs, ucs, udhs, muc) + first


# ---------------------------------------------------------------- dispatch
def _device_rule(xz: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if xz.is_cuda:
        return True
    if xz.device.type == "cpu":
        return False
    raise ValueError(f"LSTM {what}: unsupported device {xz.device}")


def lstm_fwd(xz: torch.Tensor, rec: torch.Tensor,
             activation: Optional[str] = "tanh", with_cs: bool = False,
             carry: Optional[tuple] = None):
    """hs [, cs] (carry mode without cs: hs, c_fin): the forward kernel on
    a CUDA tensor, the plain version on a CPU tensor.  Not differentiable;
    see :func:`lstm_seq` and :func:`lstm_seq_carry`."""
    if _device_rule(xz, "forward"):
        return lstm_fwd_cuda(xz, rec, activation, with_cs, carry)
    return lstm_seq_plain(xz, rec, activation, with_cs, carry)


def lstm_bwd(xz, rec, hs, cs, dhs, dcs=None, activation="tanh",
             with_carries=False, carry=None, dc_fin=None) -> tuple:
    """The backward sweep: the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  Not differentiable; see :class:`LSTMBwdSeq`."""
    fn = lstm_bwd_cuda if _device_rule(xz, "backward") else lstm_bwd_plain
    return fn(xz, rec, hs, cs, dhs, dcs, activation, with_carries, carry, dc_fin)


def lstm_adj(xz, rec, hs, cs, dhT, dcT, u, v, activation="tanh", carry=None,
             mu0=None) -> tuple:
    """The adjoint sweep: on a CUDA tensor the kernel, in the layout
    :func:`adj_layout` picks (the register layout's pre-pass, sweep and
    post-pass at H <= 4 * FWD_KS, the wide layout above; no fallback), on a
    CPU tensor the plain version."""
    fn = lstm_adj_cuda if _device_rule(xz, "adjoint") else lstm_adj_plain
    return fn(xz, rec, hs, cs, dhT, dcT, u, v, activation, carry, mu0)


# ------------------------------------------------------ the dispatcher op
@torch.library.custom_op("hfrep::lstm_fwd", mutates_args=(), device_types="cpu",
                         schema="(Tensor xz, Tensor rec, str activation, bool with_cs)"
                                " -> Tensor[]")
def lstm_fwd_op(xz: torch.Tensor, rec: torch.Tensor, activation: str,
                with_cs: bool) -> list:
    """The carry-free forward behind PyTorch's dispatcher, ``hfrep::lstm_fwd``:
    ``[hs]``, or with ``with_cs`` ``[hs, cs]``, float32 (W, B, H).  On a
    CPU tensor the plain version; on a CUDA tensor :func:`lstm_fwd_cuda`,
    whose checks, layout rule, stream, ctypes pointers and launch count
    all run inside the op; under ``torch.export`` its fake implementation,
    which gives the shapes and touches no data, so an exported program
    holds one opaque ``hfrep.lstm_fwd`` node that launches the kernel (and
    counts the launch) each time the program runs.  The no-grad forward
    (:func:`lstm_seq` when nothing records) calls it; the autograd nodes
    call the wrapper directly."""
    out = lstm_seq_plain(xz, rec, activation, with_cs)
    return list(out) if with_cs else [out]


@lstm_fwd_op.register_kernel("cuda")
def _lstm_fwd_op_cuda(xz, rec, activation, with_cs):
    out = lstm_fwd_cuda(xz, rec, activation, with_cs)
    return list(out) if with_cs else [out]


@lstm_fwd_op.register_fake
def _lstm_fwd_op_fake(xz, rec, activation, with_cs):
    w, b, g = xz.shape
    hs = xz.new_empty((w, b, g // 4), dtype=torch.float32)
    return [hs, torch.empty_like(hs)] if with_cs else [hs]


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
    ``no_grad`` / ``inference_mode``, as serving and sampling call it —
    the primal forward through the dispatcher op :func:`lstm_fwd_op`,
    with no cs at all.  Kernel on a CUDA tensor, plain version on a CPU
    tensor."""
    if torch.is_grad_enabled() and (xz.requires_grad or rec.requires_grad):
        return LSTMFwdRes.apply(xz, rec, activation)[0]
    return lstm_fwd_op(xz, rec, activation, False)[0]


class LSTMFwdResCarry(torch.autograd.Function):
    """``lstm_fwd_res_carry`` and ``lstm_seq_carry``'s residual forward:
    (xz, rec, h0, c0) → (hs, cs, c_fin) through the forward kernel in its
    carry ``with_cs`` mode.

    c_fin (= cs[-1]) is an output of its own, not a slice of cs taken
    outside: its cotangent then arrives here as ``dc_fin``, which seeds the
    carry backward's dc carry (``_lstm_seq_carry_bwd``), where a slice's
    would arrive as a direct cs cotangent, which a recorded backward
    refuses.  As :class:`LSTMFwdRes`, the backward is the differentiable
    :class:`LSTMBwdSeqCarry` while autograd is recording and the raw
    carry0 backward kernel otherwise, with the direct cs cotangent (its
    ``dcs`` mode) that the adjoint sends at second order, and dc_fin."""

    @staticmethod
    def forward(ctx, xz, rec, h0, c0, activation):
        hs, cs = lstm_fwd(xz, rec, activation, with_cs=True, carry=(h0, c0))
        c_fin = cs[-1].clone() if cs.shape[0] else c0.clone()
        ctx.save_for_backward(xz, rec, h0, c0, hs, cs)
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return hs, cs, c_fin

    @staticmethod
    def backward(ctx, dhs, dcs, dc_fin):
        xz, rec, h0, c0, hs, cs = ctx.saved_tensors
        dhs = torch.zeros_like(hs) if dhs is None else _f32(dhs)
        dc_fin = torch.zeros_like(h0) if dc_fin is None else _f32(dc_fin)
        if torch.is_grad_enabled():
            if dcs is not None:
                raise NotImplementedError(
                    "LSTM: a recorded backward with a cell-state cotangent "
                    "(third order) is not supported")
            dxz, drec, dh0, dc0 = LSTMBwdSeqCarry.apply(xz, rec, hs, cs, dhs, dc_fin,
                                                        h0, c0, ctx.activation)
        else:
            dcs = None if dcs is None else _f32(dcs)
            dxz, drec, dh0, dc0 = lstm_bwd(xz, rec, hs, cs, dhs, dcs, ctx.activation,
                                           carry=(h0, c0), dc_fin=dc_fin)
        return _cast_like(dxz, xz), _cast_like(drec, rec), dh0, dc0, None


class LSTMBwdSeqCarry(torch.autograd.Function):
    """``lstm_bwd_seq_carry``: the first-order carry backward (dxz, drec,
    dh0, dc0) as a differentiable-once node.  Its forward runs the
    backward kernel in its carry0 mode with the per-step carries; its
    backward is the adjoint kernel in its carry mode, returning the
    cotangents of xz, rec, hs, cs, dhs, dc_fin, h0 and c0."""

    @staticmethod
    def forward(ctx, xz, rec, hs, cs, dhs, dc_fin, h0, c0, activation):
        dxz, drec, dhT, dcT, dh0, dc0 = lstm_bwd(
            xz, rec, hs, cs, dhs, None, activation, with_carries=True, carry=(h0, c0),
            dc_fin=dc_fin)
        ctx.save_for_backward(xz, rec, hs, cs, h0, c0, dhT, dcT)
        ctx.activation = activation
        ctx.set_materialize_grads(False)
        return dxz, drec, dh0, dc0

    @staticmethod
    def backward(ctx, u, v, muh0, muc0):
        if torch.is_grad_enabled():
            raise NotImplementedError("LSTM: third-order derivatives are not supported")
        xz, rec, hs, cs, h0, c0, dhT, dcT = ctx.saved_tensors
        u = torch.zeros(xz.shape, dtype=torch.float32, device=xz.device) if u is None else _f32(u)
        v = torch.zeros(rec.shape, dtype=torch.float32, device=xz.device) if v is None else _f32(v)
        mu0 = tuple(None if m is None else _f32(m) for m in (muh0, muc0))
        uxz, urec, uhs, ucs, udhs, udcfin, uh0, uc0 = lstm_adj(
            xz, rec, hs, cs, dhT, dcT, u, v, ctx.activation, carry=(h0, c0), mu0=mu0)
        return (_cast_like(uxz, xz), _cast_like(urec, rec), uhs, ucs, udhs, udcfin,
                uh0, uc0, None)


def _recording(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def lstm_seq_carry(xz: torch.Tensor, rec: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor, activation: Optional[str] = "tanh") -> tuple:
    """A chunk of the recurrence from the injected state (h0, c0), float32
    (B, H): (hs (W, B, H), c_fin (B, H)), both float32; the final hidden
    carry is hs[-1].  Twice differentiable in all four arguments, as
    :func:`lstm_seq`: under autograd the carry ``with_cs`` forward, the
    carry0 backward and the carry adjoint kernels; otherwise the carry
    primal forward kernel.  Kernel on a CUDA tensor, plain version on a
    CPU tensor."""
    if _recording(xz, rec, h0, c0):
        hs, _, c_fin = LSTMFwdResCarry.apply(xz, rec, h0, c0, activation)
        return hs, c_fin
    return lstm_fwd(xz, rec, activation, carry=(h0, c0))


def lstm_fwd_res_carry(xz: torch.Tensor, rec: torch.Tensor, h0: torch.Tensor,
                       c0: torch.Tensor, activation: Optional[str] = "tanh") -> tuple:
    """The residual-producing carry forward: (hs, cs) from (h0, c0),
    differentiable once (its backward is the carry0 backward kernel with
    a direct cs cotangent)."""
    if _recording(xz, rec, h0, c0):
        hs, cs, _ = LSTMFwdResCarry.apply(xz, rec, h0, c0, activation)
        return hs, cs
    return lstm_fwd(xz, rec, activation, with_cs=True, carry=(h0, c0))


def lstm_bwd_seq_carry(xz, rec, hs, cs, dhs, dc_fin, h0, c0,
                       activation: Optional[str] = "tanh") -> tuple:
    """The first-order carry backward (dxz, drec, dh0, dc0), differentiable
    once through the carry adjoint kernel; ``dc_fin`` None is zero."""
    if dc_fin is None:
        dc_fin = torch.zeros_like(h0)
    if _recording(xz, rec, hs, cs, dhs, dc_fin, h0, c0):
        return LSTMBwdSeqCarry.apply(xz, rec, hs, cs, dhs, dc_fin, h0, c0, activation)
    return lstm_bwd(xz, rec, hs, cs, dhs, None, activation, carry=(h0, c0), dc_fin=dc_fin)


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
