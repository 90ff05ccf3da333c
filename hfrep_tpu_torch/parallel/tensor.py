"""Tensor (hidden-unit) parallelism (``hfrep_tpu/parallel/tensor.py``).

The JAX package declares the layout as partition rules
(``GAN_PARTITION_RULES``: every LSTM layer's gate columns over ``tp``)
and lets GSPMD lower the recurrence to a per-step all_gather of the
hidden state.  Here the layout is the same rule table
(:data:`~hfrep_tpu_torch.parallel.rules.GAN_PARTITION_RULES`), read as
what each rank computes:

* **the layout** — rank ``k`` of the ``tp`` axis owns hidden units
  ``[k·Hl, (k+1)·Hl)``, ``Hl = H/tp``, and computes their columns in all
  four Keras gates (``g·H + k·Hl ... g·H + (k+1)·Hl`` for g in i, f, c, o:
  :func:`gate_columns`) of each layer's ``kernel``, ``recurrent_kernel``
  and ``bias``, taken by ``index_select`` from the whole parameter (whose
  backward puts exact zeros in the other ranks' columns).  JAX's
  ``P(None, "tp")`` cuts the 4H axis into contiguous blocks instead: a
  GSPMD declaration that computes the same numbers.  The cell update is
  then local; the one collective a step gathers h, (B, Hl) on each rank
  into (B, H).  The state stays whole and bit-equal on every rank (JAX
  shards params and slots; at H = 100 the state is a few MB), so
  checkpoints, resume and ``generate`` are the plain ones;
* **the collectives** — four autograd Functions in Megatron's conjugate
  pairs, each backward calling its partner's ``apply``, so the gradient
  penalty's second order runs through collectives too: :class:`_Copy`
  (F: identity forward, all_reduce backward) in front of each
  column-sliced product, the layer input once a layer and h each step;
  :class:`_Reduce` (R: all_reduce forward, identity backward);
  :class:`_Gather` (G: this rank's units padded with zeros to (B, H) and
  all_reduced, exact since a + 0 = a; gloo has all_reduce on CUDA
  tensors and no all_gather); :class:`_Slice` (S: this rank's units of a
  replicated tensor).  Every rank runs the same graph, and every backward
  that reaches one runs on the calling thread (``train/steps.py::_grad``,
  ``parallel/chain.py::_grad``), so the collectives come in one order on
  every rank of the axis;
* **the gradients** — a sliced leaf's gradient on a rank is its own
  columns' partial, a replicated leaf's (the Dense heads, the LayerNorms)
  is whole on every rank; the step's hook
  (:class:`~hfrep_tpu_torch.parallel.rules.DataShard`) keeps the latter
  on tp rank 0 alone and sums every leaf over the mesh in its one
  all_reduce an update, so the optimizer updates the same full state on
  every rank.

No hand kernel takes a rank's (H, 4H/tp) rec, so a tp rank runs its
recurrence step by step in torch ops: JAX's tp resolves
``lstm_backend='auto'`` to the XLA scan on such a mesh and refuses
``'pallas'`` (``hfrep_tpu/parallel/rules.py:393-412``), and so does this
launch (:func:`~hfrep_tpu_torch.parallel.rules.validate_tp`).  The
launch is the plain step (``train/steps.py``) with the hook and this
module's forwards as its ``apply_fns``: :func:`make_tp_train_step` /
:func:`make_tp_multi_step` on a ``('tp',)`` or ``('dp', 'tp')`` mesh
(``tp_train_step``, ``dp_tp_multi_step``, ...); the window axis with it
is :mod:`~hfrep_tpu_torch.parallel.dp_sp_tp`'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from hfrep_tpu_torch.ops.cuda_lstm import _PLAIN_ACT, _rounder, act_code
from hfrep_tpu_torch.ops.layers import sigmoid
from hfrep_tpu_torch.parallel.chain import Chain
from hfrep_tpu_torch.parallel.sequence import (Params, _named, critic_ops, generator_ops, net_ops,
                                               run_ops)


def _check_width(h: int, n_dev: int) -> int:
    if h % n_dev:
        raise ValueError(f"hidden width {h} not divisible by tp={n_dev} devices")
    return h // n_dev


def _tp_axis(mesh, axis_name: Optional[str]) -> str:
    if axis_name is None:
        if "tp" not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no 'tp' axis; pass axis_name "
                             "explicitly to shard hidden units over another name")
        return "tp"
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} not in mesh axes {mesh.axis_names}")
    return axis_name


def _param_specs(params: Params, mesh, axis: str) -> dict:
    """The rule table resolved over ``params`` on ``mesh``, its ``tp``
    renamed to ``axis``: ``{name: spec}``."""
    from hfrep_tpu_torch.parallel.rules import (GAN_PARTITION_RULES,
                                                match_partition_rules)

    rules = tuple((pat, tuple(axis if e == "tp" else e for e in spec))
                  for pat, spec in GAN_PARTITION_RULES)
    return match_partition_rules(rules, _named(params), mesh)


def gate_columns(hidden: int, n: int, k: int, device=None) -> torch.Tensor:
    """Rank ``k`` of ``n``'s columns of a (.., 4·hidden) gate axis: its
    units' block of each of the four gates, in gate order."""
    hl = _check_width(hidden, n)
    unit = torch.arange(k * hl, (k + 1) * hl, device=device)
    return torch.cat([g * hidden + unit for g in range(4)])


# ------------------------------------------------------------ collectives
class _Copy(torch.autograd.Function):
    """F: a replicated tensor into a column-sliced product; its cotangent,
    a partial on each rank, all_reduced (:class:`_Reduce`)."""

    @staticmethod
    def forward(ctx, ax: Chain, x):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _Reduce.apply(ctx.ax, g)


class _Reduce(torch.autograd.Function):
    """R: the ranks' partials summed; the backward is :class:`_Copy`."""

    @staticmethod
    def forward(ctx, ax: Chain, x):
        ctx.ax = ax
        return ax.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return None, _Copy.apply(ctx.ax, g)


class _Gather(torch.autograd.Function):
    """G: each rank's (B, Hl) units into the whole (B, H), zeros padded
    and all_reduced; the backward is :class:`_Slice`."""

    @staticmethod
    def forward(ctx, ax: Chain, h):
        ctx.ax = ax
        hl = h.shape[-1]
        out = h.new_zeros(h.shape[:-1] + (hl * ax.n,))
        out[..., ax.k * hl:(ax.k + 1) * hl] = h
        return ax.all_reduce_(out)

    @staticmethod
    def backward(ctx, g):
        return None, _Slice.apply(ctx.ax, g)


class _Slice(torch.autograd.Function):
    """S: this rank's units of a replicated (.., H); the backward is
    :class:`_Gather`."""

    @staticmethod
    def forward(ctx, ax: Chain, x):
        ctx.ax = ax
        hl = x.shape[-1] // ax.n
        return x.narrow(-1, ax.k * hl, hl).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return None, _Gather.apply(ctx.ax, g)


def _copy(ax: Chain, x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(ax, x) if ax.n > 1 else x


def _gather(ax: Chain, h: torch.Tensor) -> torch.Tensor:
    return _Gather.apply(ax, h) if ax.n > 1 else h


# --------------------------------------------------------------- forwards
def local_params(ax: Chain, params: dict) -> dict:
    """This rank's view of a name → tensor dict: each leaf the rule table
    slices, its gate columns (``index_select`` on the sliced axis); every
    other leaf as it is."""
    from hfrep_tpu_torch.parallel.rules import sliced_axis

    if ax.n == 1:
        return params
    out = {}
    for name, v in params.items():
        axis = sliced_axis(name)
        if axis is None:
            out[name] = v
        else:
            cols = gate_columns(v.shape[axis] // 4, ax.n, ax.k, v.device)
            out[name] = v.index_select(axis, cols)
    return out


def tp_lstm(ax: Chain, p: dict, x: torch.Tensor, activation: str,
            carry: Optional[tuple] = None, dtype: Optional[torch.dtype] = None) -> tuple:
    """One Keras LSTM layer on a rank's gate columns ``p`` (``kernel``
    (Fin, 4Hl), ``recurrent_kernel`` (H, 4Hl), ``bias`` (4Hl)) over the
    replicated ``x`` (B, W, Fin): ((B, W, H) replicated, in the compute
    dtype, (h (B, H), this rank's c (B, Hl)), float32), from ``carry`` =
    (h, c) or a zero carry.  The arithmetic of ``cuda_lstm.lstm_seq_plain``
    on a column slice, its precision policy included: the projection in
    the compute dtype (``dtype``, else ``x``'s), h rounded to it before the
    product with rec's values, the state and the gate math float32; a zero
    h's product is skipped (it adds exact zeros).  Every exchange is
    float32: the layer input's cotangent (its F) and h (its G)."""
    act = _PLAIN_ACT[act_code(activation)]
    dt = dtype or x.dtype
    b, w, f = x.shape
    hl = p["bias"].shape[0] // 4
    xz = (_copy(ax, x.float()).to(dt).reshape(b * w, f) @ p["kernel"].to(dt)
          + p["bias"].to(dt)).reshape(b, w, 4 * hl)
    rec = p["recurrent_kernel"].to(dt)
    rnd, rec = _rounder(rec), rec.float()
    h, c = carry if carry is not None else (None, xz.new_zeros((b, hl), dtype=torch.float32))
    hs = []
    for t in range(w):
        z = xz[:, t].float()
        if h is not None:
            z = z + rnd(_copy(ax, h)) @ rec
        gates = sigmoid(z)                       # one sigmoid over i, f, _, o
        c = gates[:, hl:2 * hl] * c + gates[:, :hl] * act(z[:, 2 * hl:3 * hl])
        h = _gather(ax, gates[:, 3 * hl:] * act(c))
        hs.append(h)
    return torch.stack(hs, dim=1).to(dt), (h, c)


def tp_lstm_op(ax: Chain):
    """:func:`tp_lstm` as ``sequence.run_ops``'s LSTM (its layer op, this
    rank's view of the layer's parameters, the input, the carry)."""

    def lstm(op, p: dict, x: torch.Tensor, carry) -> tuple:
        hs, fin = tp_lstm(ax, p, x, op.activation, carry, op.dtype)
        return hs, list(fin)

    return lstm


def tp_forward(ax: Chain, ops: tuple, p: dict, x: torch.Tensor) -> torch.Tensor:
    """A network's layers ``ops`` on a rank's view ``p``
    (:func:`local_params`) over the whole window, each LSTM on its gate
    columns: the output, replicated (a flattened head's scores in its
    compute dtype)."""
    y = run_ops(ops, p, x, 0, None, tp_lstm_op(ax))[1]
    return y.to(ops[-1].dtype or y.dtype) if ops[-1].kind == "flat" else y


# ---------------------------------------------------------- public surface
def _axis(params: dict, mesh, axis_name: Optional[str]) -> Chain:
    axis = _tp_axis(mesh, axis_name)
    for lay in ("lstm0", "lstm1"):
        _check_width(params[f"{lay}.recurrent_kernel"].shape[0], mesh.shape[axis])
    _param_specs(params, mesh, axis)            # every leaf has a rule
    return Chain(mesh, axis)


def tp_generate(g_params: Params, z: torch.Tensor, mesh, *, axis_name: Optional[str] = None,
                slope: float = 0.2, activation: str = "sigmoid", ln_eps: float = 1e-3,
                manual=None, check_vma=None, chunk=None) -> torch.Tensor:
    """MTSS generator forward with the LSTM gate columns over ``tp``: ``z``
    (B, W, F) the same on every rank → the whole output on every rank,
    the single-device forward's to float32 round-off.  JAX's retired
    manual-path knobs (``manual``, ``check_vma``, ``chunk``) are accepted
    and ignored; any other keyword is a TypeError."""
    del manual, check_vma, chunk
    p = _named(g_params)
    ax = _axis(p, mesh, axis_name)
    ops = generator_ops(p["lstm0.recurrent_kernel"].shape[0], slope, activation, ln_eps)
    return tp_forward(ax, ops, local_params(ax, p), z)


def tp_critic(d_params: Params, x: torch.Tensor, mesh, *, axis_name: Optional[str] = None,
              manual=None, check_vma=None, chunk=None) -> torch.Tensor:
    """Flagship critic forward with the gate columns over ``tp``: (B, W, F)
    → (B, 1) scores, replicated.  Retired knobs as :func:`tp_generate`."""
    del manual, check_vma, chunk
    p = _named(d_params)
    ax = _axis(p, mesh, axis_name)
    return tp_forward(ax, critic_ops(p["lstm0.recurrent_kernel"].shape[0]), local_params(ax, p),
                      x)


def validate_tp_pair(pair, n_tp: int) -> None:
    """The width-divisibility precondition the step builders share."""
    if pair.family != "mtss_wgan_gp":
        raise ValueError(f"tensor-parallel step supports the mtss_wgan_gp family, got "
                         f"{pair.family!r}")
    _check_width(pair.generator.lstm0.features, n_tp)
    _check_width(pair.discriminator.lstm0.features, n_tp)


def tp_apply_fns(pair, ax: Chain) -> tuple:
    """The step's ``apply_fns`` on a tp mesh: each rank's generator and
    critic on its gate columns of the modules' parameters, at the
    networks' precision policy (``sequence.net_ops``)."""
    ops_g, ops_d = net_ops(pair.generator), net_ops(pair.discriminator)

    def g_apply(module, z):
        return tp_forward(ax, ops_g, local_params(ax, _named(module)), z)

    def d_apply(module, x):
        return tp_forward(ax, ops_d, local_params(ax, _named(module)), x)

    return g_apply, d_apply


def _tp_step(pair, tcfg, dataset: torch.Tensor, mesh):
    """The plain step on a tp (or dp × tp) mesh: the hook and the
    gate-column forwards (on a mesh whose tp extent is 1, the plain
    forwards)."""
    from hfrep_tpu_torch.parallel.rules import data_constraint, validate_tp
    from hfrep_tpu_torch.train.steps import make_train_step

    spec = validate_tp(pair, tcfg, mesh)
    if spec.sp > 1:
        raise ValueError("sp with tp is the dp_sp_tp.py launch (make_dp_sp_tp_train_step); "
                         "make_tp_train_step shards dp and tp")
    fns = tp_apply_fns(pair, Chain(mesh, "tp")) if spec.tp > 1 else None
    return make_train_step(pair, tcfg, dataset, shard_data=data_constraint(mesh),
                           apply_fns=fns)


def make_tp_train_step(pair, tcfg, dataset: torch.Tensor, mesh, **attrs):
    """Hidden-unit-sharded MTSS-WGAN-GP training, float32 or bf16: ONE
    epoch on a ``('tp',)`` or ``('dp', 'tp')`` mesh, ``step(state, draws)`` with the global
    batch's draws (launched as ``tp_train_step`` / ``dp_tp_train_step``)."""
    from hfrep_tpu_torch.parallel.rules import instrument_mesh_launch

    return instrument_mesh_launch(_tp_step(pair, tcfg, dataset, mesh), tcfg, mesh,
                                  "train_step", **attrs)


def make_tp_multi_step(pair, tcfg, dataset: torch.Tensor, mesh, **attrs):
    """``tcfg.steps_per_call`` hidden-unit-sharded epochs a call, the
    trainer's block."""
    from hfrep_tpu_torch.parallel.rules import instrument_mesh_launch
    from hfrep_tpu_torch.train.steps import make_multi_step

    fn = make_multi_step(pair, tcfg, dataset, step=_tp_step(pair, tcfg, dataset, mesh))
    return instrument_mesh_launch(fn, tcfg, mesh, "multi_step", **attrs)


#: JAX's dp × tp names: the same builders, which shard both axes (JAX's
#: ``controlled_sampling`` has no counterpart: every rank follows the
#: single-device draws, the launch's one mode)
make_dp_tp_train_step = make_tp_train_step
make_dp_tp_multi_step = make_tp_multi_step
