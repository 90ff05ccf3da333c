"""Sequence (window-axis) parallelism (``hfrep_tpu/parallel/sequence.py``).

The JAX package constrains the window axis of the sampled batch over
``sp`` and lets GSPMD partition the per-timestep math.  Here the window
is cut into contiguous chunks, one a rank of the ``sp`` axis, and each
LSTM layer runs its chunk from the previous rank's final (h, c), handed
on along the axis (:mod:`~hfrep_tpu_torch.parallel.chain`); the backward
hands the carry cotangents back the other way, and the gradient
penalty's second order runs both ways.  A chunk goes through
:func:`~hfrep_tpu_torch.ops.cuda_lstm.lstm_seq_carry`, which under
autograd launches the carry ``with_cs`` forward, the carry0 backward and
the carry adjoint (``PERF.md`` §6 rows 1c, 2b, 3b).  The first rank
starts from a zero carry through the same carry kernels: the carry-free
adjoint has no output for a final cell state's cotangent, and the next
rank hands one back at second order (``cuda_lstm.LSTMFwdRes`` refuses it
in a recorded backward).  The carries stay float32 across the handoff;
the streams follow the networks' precision policy.  A flattened score
head is split by rows, each rank scoring its chunk, the partial scores
summed over the axis in float32; a per-step critic's chunks of scores are
gathered into the whole window's on every rank, so its loss is the
window's mean.  Dense layers act on each step alone: a Dense network's
chunk needs no carry and hands nothing on.

:func:`make_sp_train_step` / :func:`make_sp_multi_step` are the launch
on an ``('sp',)`` or ``('dp', 'sp')`` mesh: the plain step
(``train/steps.py``) with the mesh hook
(:func:`~hfrep_tpu_torch.parallel.rules.data_constraint`: this rank's
rows and window chunk, the gradients summed over sp and averaged over
dp, the penalty's squared norms summed over sp) and this module's
forwards as its ``apply_fns``, every other step semantic shared.  The
trainer picks them for a mesh with an sp axis longer than 1.

What else is here:

* the plain param-level forwards (:func:`generator_forward`,
  :func:`critic_forward`, :func:`_lstm_layer`, :func:`_sp_ln`,
  :func:`_sp_head_impl`, :func:`_local_chunk_scan`) — the flagship's
  arithmetic from a name → tensor dict of the port's parameter names
  (``lstm0.kernel``, ``norm0.scale``, ``out.kernel``, ...), shared with
  :mod:`~hfrep_tpu_torch.parallel.layer_pipeline`;
* every network's forward as its layers (:data:`NET_LAYERS`,
  :func:`net_ops`, :func:`run_ops`), which the window-chunk stages
  (:func:`net_stage`) and the tp forwards
  (:mod:`~hfrep_tpu_torch.parallel.tensor`) run with their own LSTM;
* :func:`sp_microbatch_plan` — JAX's analytic model of the retired
  microbatch schedule, ported as it is (advisory; no step has an M knob).

sp runs every GAN family at its precision policy, float32 or bf16 (JAX's
sp is GSPMD over the plain step and puts no family or dtype rule on it;
:func:`validate_sp_pair`).  JAX's forwards
and builders also take the knobs of its retired manual ``shard_map``
pipeline (``microbatches``, ``manual``, ``tp_axis``, ``remat``,
``check_vma``, ``chunk``) and ignore them; these take none of them.
The retired CLI knobs ``--sp-microbatches`` and ``--sp-remat`` are
accepted and ignored in ``experiments/cli.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Union

import torch
from torch import nn

from hfrep_tpu_torch.ops import cuda_lstm
from hfrep_tpu_torch.ops.layers import ACTIVATIONS, compute_dtype, layer_norm, leaky_relu
from hfrep_tpu_torch.parallel.chain import Chain, Stage, axis_sum, chain_apply

Params = Union[Mapping[str, torch.Tensor], nn.Module]


def _named(params: Params) -> dict:
    """A module's parameters by name, or the dict itself."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _sub(params: dict, prefix: str) -> dict:
    """One layer's parameters: ``lstm0.kernel`` → ``kernel``."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


# --------------------------------------------------- plain stack forwards
def _project(params: dict, x: torch.Tensor, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """The input projection for every timestep as one matmul in the
    compute dtype (``dtype``, else ``x``'s), time-major (W, B, 4H):
    ``keras_lstm``'s."""
    dt = dtype or x.dtype
    b, w, f = x.shape
    xz = (x.to(dt).reshape(b * w, f) @ params["kernel"].to(dt)
          + params["bias"].to(dt)).reshape(b, w, -1)
    return xz.transpose(0, 1).contiguous()


def _local_chunk_scan(xz_chunk: torch.Tensor, carry: tuple, recurrent: torch.Tensor,
                      activation: str) -> tuple:
    """One (W, B, 4H) pre-projected chunk from the carry (h0, c0):
    (hs (W, B, H), (h_fin, c_fin)), through the carry kernels."""
    hs, c_fin = cuda_lstm.lstm_seq_carry(xz_chunk, recurrent.contiguous(), carry[0],
                                         carry[1], activation)
    return hs, (hs[-1] if hs.shape[0] else carry[0], c_fin)


def _lstm_chunk(params: dict, x: torch.Tensor, carry: tuple, activation: str,
                dtype: Optional[torch.dtype] = None) -> tuple:
    """One Keras LSTM layer over a window chunk (B, Wc, Fin) from
    ``carry``: ((B, Wc, H) in the compute dtype, (h_fin, c_fin) float32).
    The streams (the projection, rec) are in the compute dtype (``dtype``,
    else ``x``'s), the carries float32, as ``keras_lstm``'s whole window
    keeps its state."""
    dt = dtype or x.dtype
    hs, fin = _local_chunk_scan(_project(params, x, dt), carry,
                                params["recurrent_kernel"].to(dt), activation)
    return hs.transpose(0, 1).to(dt), fin


def _lstm_layer(params: dict, x: torch.Tensor, activation: str,
                recurrent_activation: str = "sigmoid") -> torch.Tensor:
    """One Keras LSTM layer on (B, W, Fin) → (B, W, H) from a zero carry:
    :func:`~hfrep_tpu_torch.ops.cuda_lstm.keras_lstm`, the module's own
    route (the single-layer kernels)."""
    return cuda_lstm.keras_lstm(params["kernel"], params["recurrent_kernel"], params["bias"],
                                x, activation, recurrent_activation)


def _sp_ln(p: dict, v: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm through :func:`~hfrep_tpu_torch.ops.layers.layer_norm`,
    the arithmetic of the generator's ``KerasLayerNorm``."""
    return layer_norm(v, p["scale"], p["bias"], eps)


def _sp_head_impl(g_params: dict, v: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
    """LeakyReLU → LayerNorm → Dense, the generator's tail: per-timestep
    ops, the same on a whole window or a chunk."""
    v = _sp_ln(_sub(g_params, "norm1"), leaky_relu(v, slope), eps)
    return v @ g_params["out.kernel"] + g_params["out.bias"]


def generator_forward(g_params: Params, z: torch.Tensor, *, slope: float = 0.2,
                      activation: str = "sigmoid", ln_eps: float = 1e-3) -> torch.Tensor:
    """The MTSS generator (LSTM → LN → LSTM → LeakyReLU → LN → Dense)
    from its parameters: ``LSTMGenerator``'s forward to float32
    round-off."""
    p = _named(g_params)
    x = _sp_ln(_sub(p, "norm0"), _lstm_layer(_sub(p, "lstm0"), z, activation), ln_eps)
    return _sp_head_impl(p, _lstm_layer(_sub(p, "lstm1"), x, activation), slope, ln_eps)


def critic_forward(d_params: Params, x: torch.Tensor) -> torch.Tensor:
    """The flagship critic (LSTM → LSTM → Flatten → Dense(1)) from its
    parameters, the layers chained: (B, W, F) → (B, 1)."""
    p = _named(d_params)
    h = _lstm_layer(_sub(p, "lstm1"), _lstm_layer(_sub(p, "lstm0"), x, "tanh"), "tanh")
    return h.reshape(h.shape[0], -1) @ p["out.kernel"] + p["out.bias"]


# ------------------------------------------------------- a network's layers
@dataclasses.dataclass(frozen=True)
class Op:
    """One layer of a network's forward, as the window-chunk stages run
    it: ``lstm`` (a Keras LSTM of ``hidden`` units and ``activation``,
    from a carry), ``dense`` (a Keras Dense and its ``activation``),
    ``ln`` (a Keras LayerNorm of epsilon ``eps``), ``leaky`` (LeakyReLU of
    ``slope``) or ``flat`` (the flattened (W·H → 1) score head, a chunk's
    rows of it); ``name`` is the layer's parameter prefix and ``dtype``
    its compute dtype (``None``: the promoted type of its operands)."""

    kind: str
    name: str = ""
    activation: Optional[str] = None
    hidden: int = 0
    eps: float = 1e-3
    slope: float = 0.2
    dtype: Optional[torch.dtype] = None


#: each network's forward as its layers, by class (``models/generators.py``,
#: ``models/discriminators.py``); a leaky op takes the module's ``slope``
NET_LAYERS = {
    "DenseGenerator": ("dense0", "leaky", "norm0", "dense1", "leaky", "norm1", "out"),
    "LSTMGenerator": ("lstm0", "norm0", "lstm1", "leaky", "norm1", "out"),
    "DenseDiscriminator": ("dense0", "dense1", "out"),
    "DenseCritic": ("dense0", "leaky", "norm0", "dense1", "leaky", "norm1", "out"),
    "DenseFlatCritic": ("dense0", "dense1", "flat:out"),
    "LSTMDiscriminator": ("lstm0", "lstm1", "out"),
    "LSTMCritic": ("lstm0", "leaky", "norm0", "lstm1", "leaky", "norm1", "out"),
    "LSTMFlatCritic": ("lstm0", "lstm1", "flat:out"),
}


def net_ops(module: nn.Module) -> tuple:
    """``module``'s forward as :class:`Op` values, each layer's hyper-parameters
    and compute dtype read from the module (its parameters are the
    caller's).  A network with no entry in :data:`NET_LAYERS` raises."""
    from hfrep_tpu_torch.ops.layers import KerasDense, KerasLayerNorm
    from hfrep_tpu_torch.ops.lstm import KerasLSTM

    cls = type(module).__name__
    if cls not in NET_LAYERS:
        raise ValueError(f"no window-chunk form of {cls}: the window-sharded forwards run "
                         f"{sorted(NET_LAYERS)}")
    ops = []
    for entry in NET_LAYERS[cls]:
        if entry == "leaky":
            ops.append(Op("leaky", slope=module.slope))
            continue
        kind, _, name = entry.rpartition(":")
        layer = getattr(module, name)
        if isinstance(layer, KerasLSTM):
            ops.append(Op("lstm", name, layer.activation or "linear", layer.features,
                          dtype=layer.dtype))
        elif isinstance(layer, KerasLayerNorm):
            ops.append(Op("ln", name, eps=layer.epsilon, dtype=layer.dtype))
        elif isinstance(layer, KerasDense):
            ops.append(Op(kind or "dense", name, layer.activation, dtype=layer.dtype))
        else:
            raise ValueError(f"{cls}.{name}: no window-chunk form of {type(layer).__name__}")
    return tuple(ops)


def generator_ops(hidden: int, slope: float = 0.2, activation: str = "sigmoid",
                  ln_eps: float = 1e-3) -> tuple:
    """The MTSS generator's layers (LSTM → LN → LSTM → LeakyReLU → LN →
    Dense) from its hyper-parameters, each in its operands' dtype."""
    return (Op("lstm", "lstm0", activation, hidden), Op("ln", "norm0", eps=ln_eps),
            Op("lstm", "lstm1", activation, hidden), Op("leaky", slope=slope),
            Op("ln", "norm1", eps=ln_eps), Op("dense", "out"))


def critic_ops(hidden: int) -> tuple:
    """The flagship critic's layers (LSTM → LSTM → the flattened head)."""
    return Op("lstm", "lstm0", "tanh", hidden), Op("lstm", "lstm1", "tanh", hidden), \
        Op("flat", "out")


def _dense(op: Op, p: dict, x: torch.Tensor) -> torch.Tensor:
    """``KerasDense``'s arithmetic on explicit parameters."""
    dt = compute_dtype(op.dtype, x, p["kernel"])
    return ACTIVATIONS[op.activation](x.to(dt) @ p["kernel"].to(dt) + p["bias"].to(dt))


def _flat_head(op: Op, p: dict, h: torch.Tensor, k: int) -> torch.Tensor:
    """Chunk ``k``'s partial scores of the flattened head: its rows of
    the kernel, the bias added by the first chunk.  The products of the
    compute dtype's values are summed in float32, so the chunks' partials
    add up over the axis in float32 (a float32 score is the plain
    product's)."""
    dt = compute_dtype(op.dtype, h, p["kernel"])
    rows = h.shape[1] * h.shape[2]
    s = (h.reshape(h.shape[0], -1).to(dt).float()
         @ p["kernel"].narrow(0, k * rows, rows).to(dt).float())
    return s + p["bias"].to(dt).float() if k == 0 else s


def run_ops(ops: tuple, p: dict, x: torch.Tensor, k: int, b_in, lstm) -> tuple:
    """``ops`` on chunk ``k`` of the window, ``x`` (B, Wc, F): ``(finals,
    y)``, each LSTM's final (h, c) in layer order and the output.  An LSTM
    layer starts from its carry in ``b_in`` (two tensors a layer in
    order; ``None`` or empty: a zero carry) through ``lstm(op, params, x,
    carry) -> (hs, [h_fin, c_fin])``."""
    finals, i = [], 0
    for op in ops:
        sub = _sub(p, op.name)
        if op.kind == "lstm":
            carry = (b_in[i], b_in[i + 1]) if b_in else None
            i += 2
            x, fin = lstm(op, sub, x, carry)
            finals += fin
        elif op.kind == "dense":
            x = _dense(op, sub, x)
        elif op.kind == "ln":
            x = layer_norm(x, sub["scale"], sub["bias"], op.eps, op.dtype)
        elif op.kind == "leaky":
            x = leaky_relu(x, op.slope)
        else:
            x = _flat_head(op, sub, x, k)
    return finals, x


# ------------------------------------------------------ window-chunk stages
def _chunk_lstm(op: Op, p: dict, x: torch.Tensor, carry) -> tuple:
    """:func:`_lstm_chunk` from ``carry`` or, on the first rank, a zero
    carry (through the same carry kernels)."""
    if carry is None:
        z = torch.zeros((x.shape[0], op.hidden), dtype=torch.float32, device=x.device)
        carry = (z, z)
    hs, fin = _lstm_chunk(p, x, carry, op.activation, op.dtype)
    return hs, list(fin)


def _carry_shapes(ops: tuple):
    """The boundary a rank hands on: each LSTM's final (h, c), float32."""
    hidden = [op.hidden for op in ops if op.kind == "lstm"]
    return lambda rows: [(rows, h) for h in hidden for _ in range(2)]


def net_stage(ops: tuple, lstm=_chunk_lstm) -> Stage:
    """A network's layers ``ops`` on a window chunk: each LSTM from the
    previous rank's carry (a network with none hands nothing on); a
    flattened head's partial scores summed over the axis, any other
    output this rank's chunk."""

    def fn(k, x, b_in, p):
        return run_ops(ops, p, x, k, b_in, lstm)

    return Stage(fn, _carry_shapes(ops), combine="sum" if ops[-1].kind == "flat" else "local")


def lstm_stage(activation: str, hidden: int) -> Stage:
    """One LSTM layer on a window chunk from the previous rank's carry."""

    def fn(k, x, b_in, p):
        carry = ((b_in[0], b_in[1]) if b_in is not None else
                 (torch.zeros((x.shape[0], hidden), dtype=torch.float32, device=x.device),) * 2)
        h, fin = _lstm_chunk(p, x, carry, activation)
        return list(fin), h

    return Stage(fn, lambda rows: [(rows, hidden)] * 2)


class _WindowGather(torch.autograd.Function):
    """Each rank's (B, Wc, ...) window chunk into the whole (B, W, ...) on
    every rank of the chain: zero-padded and all_reduced in float32, exact
    (a + 0 = a, and a bf16 value round-trips through float32); the
    backward keeps this rank's chunk of the cotangent, which every rank
    holds whole (the loss over the gathered tensor is replicated)."""

    @staticmethod
    def forward(ctx, chain: Chain, y):
        ctx.chain, ctx.wc = chain, y.shape[1]
        out = torch.zeros((y.shape[0], y.shape[1] * chain.n) + tuple(y.shape[2:]),
                          dtype=torch.float32, device=y.device)
        out.narrow(1, chain.k * ctx.wc, ctx.wc).copy_(y)
        return chain.all_reduce_(out).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return None, g.narrow(1, ctx.chain.k * ctx.wc, ctx.wc)


def window_gather(chain: Chain, y: torch.Tensor) -> torch.Tensor:
    """:class:`_WindowGather` (``y`` itself on a one-rank chain)."""
    return _WindowGather.apply(chain, y) if chain.n > 1 else y


# ----------------------------------------------------- sp public surface
def _window_chain(mesh, axis_name: Optional[str]) -> Chain:
    if axis_name is None:
        axis_name = "sp" if "sp" in mesh.axis_names else mesh.axis_names[0]
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} not in mesh {mesh.axis_names}")
    return Chain(mesh, axis_name)


def _my_chunk(chain: Chain, x: torch.Tensor) -> torch.Tensor:
    w = x.shape[1]
    if w % chain.n:
        raise ValueError(f"window {w} not divisible by {chain.axis}={chain.n}")
    w //= chain.n
    return x.narrow(1, chain.k * w, w)


def sp_generate(g_params: Params, z: torch.Tensor, mesh, *, axis_name: Optional[str] = None,
                slope: float = 0.2, activation: str = "sigmoid",
                ln_eps: float = 1e-3) -> torch.Tensor:
    """Window-sharded generator synthesis: ``z`` (B, W, F), the same on
    every rank; returns this rank's chunk (B, W/sp, F) of the output
    (JAX returns the global array sharded (B, W@sp, F))."""
    chain = _window_chain(mesh, axis_name)
    p = _named(g_params)
    stage = net_stage(generator_ops(p["lstm0.recurrent_kernel"].shape[0], slope, activation,
                                    ln_eps))
    return chain_apply(chain, stage, _my_chunk(chain, z), p)


def sp_critic(d_params: Params, x: torch.Tensor, mesh, *,
              axis_name: Optional[str] = None) -> torch.Tensor:
    """Window-sharded critic scores: ``x`` (B, W, F), the same on every
    rank → (B, 1), replicated."""
    chain = _window_chain(mesh, axis_name)
    p = _named(d_params)
    return chain_apply(chain, net_stage(critic_ops(p["lstm0.recurrent_kernel"].shape[0])),
                       _my_chunk(chain, x), p)


def sp_lstm(kernel: torch.Tensor, recurrent: torch.Tensor, bias: torch.Tensor,
            x: torch.Tensor, mesh, *, axis_name: Optional[str] = None,
            activation: str = "tanh", recurrent_activation: str = "sigmoid") -> torch.Tensor:
    """One LSTM layer over ``x`` (B, W, F), the same on every rank: this
    rank's chunk (B, W/sp, H) of the output."""
    if recurrent_activation != "sigmoid":
        raise NotImplementedError(
            f"LSTM supports sigmoid gates only, got {recurrent_activation!r}")
    chain = _window_chain(mesh, axis_name)
    p = {"kernel": kernel, "recurrent_kernel": recurrent, "bias": bias}
    return chain_apply(chain, lstm_stage(activation, recurrent.shape[0]),
                       _my_chunk(chain, x), p)


def sp_lstm_sharded_input(params: Mapping[str, torch.Tensor], x: torch.Tensor, mesh,
                          **kw) -> torch.Tensor:
    """:func:`sp_lstm` from a ``KerasLSTM`` parameter dict."""
    return sp_lstm(params["kernel"], params["recurrent_kernel"], params["bias"], x, mesh, **kw)


def validate_sp_pair(pair) -> None:
    """The window-sharded step runs any family at its precision policy, as
    JAX's GSPMD sp does: both networks need a window-chunk form
    (:func:`net_ops`)."""
    net_ops(pair.generator)
    net_ops(pair.discriminator)


def sp_apply_fns(pair, chain: Chain) -> tuple:
    """The step's ``apply_fns`` on a window-sharded mesh: each rank's
    generator and critic on its window chunk of the draws.  A flattened
    critic's scores are the axis sum of the chunks' partials (cast to the
    head's compute dtype); a per-step critic's (B, Wc, 1) chunks are
    gathered into the whole window's (B, W, 1) on every rank, so its loss
    is the mean over the whole window, as on one device."""
    ops_g, ops_d = net_ops(pair.generator), net_ops(pair.discriminator)
    stage_g, stage_d = net_stage(ops_g), net_stage(ops_d)
    head = ops_d[-1]

    def g_apply(module, z):
        return chain_apply(chain, stage_g, z, _named(module))

    def d_apply(module, x):
        y = chain_apply(chain, stage_d, x, _named(module))
        if head.kind == "flat":
            return y.to(head.dtype or y.dtype)
        return window_gather(chain, y)

    return g_apply, d_apply


def _sp_step(pair, tcfg, dataset: torch.Tensor, mesh):
    """The plain step on a window-sharded mesh: the hook and the
    forwards over the mesh's sp axis."""
    from hfrep_tpu_torch.parallel.rules import data_constraint, validate_mesh
    from hfrep_tpu_torch.train.steps import make_train_step

    spec = validate_mesh(tcfg, mesh)
    if spec.tp > 1:
        raise ValueError("tp with sp is the dp_sp_tp.py launch (make_dp_sp_tp_train_step); "
                         "make_sp_train_step shards dp and sp")
    if dataset.shape[1] % spec.sp:
        raise ValueError(f"window {dataset.shape[1]} not divisible by sp={spec.sp}")
    validate_sp_pair(pair)
    chain = _window_chain(mesh, "sp")
    return make_train_step(pair, tcfg, dataset,
                           shard_data=data_constraint(mesh, lambda t: axis_sum(chain, t)),
                           apply_fns=sp_apply_fns(pair, chain))


def make_sp_train_step(pair, tcfg, dataset: torch.Tensor, mesh, **attrs):
    """Window-sharded MTSS-WGAN-GP training: ONE epoch on an ``('sp',)``
    or ``('dp', 'sp')`` mesh, ``step(state, draws)`` with the global
    batch's draws (launched as ``sp_train_step`` / ``dp_sp_train_step``)."""
    from hfrep_tpu_torch.parallel.rules import instrument_mesh_launch

    return instrument_mesh_launch(_sp_step(pair, tcfg, dataset, mesh), tcfg, mesh,
                                  "train_step", **attrs)


def make_sp_multi_step(pair, tcfg, dataset: torch.Tensor, mesh, **attrs):
    """``tcfg.steps_per_call`` window-sharded epochs a call, the
    trainer's block."""
    from hfrep_tpu_torch.parallel.rules import instrument_mesh_launch
    from hfrep_tpu_torch.train.steps import make_multi_step

    fn = make_multi_step(pair, tcfg, dataset, step=_sp_step(pair, tcfg, dataset, mesh))
    return instrument_mesh_launch(fn, tcfg, mesh, "multi_step", **attrs)


#: the 128-lane padding of the TPU kernels the retired schedule was
#: modelled on (``hfrep_tpu/ops/pallas_lstm.py``'s ``LANE``): the model's
#: own constant, not a fact of this port
_LANE = 128


def sp_microbatch_plan(batch: int, n_dev: int, window: int = 168, hidden: int = 100,
                       step_latency_s: float = 2e-6, mxu_flops: float = 1e14) -> dict:
    """JAX's analytic model of the retired sp pipeline's microbatch trade
    (its conclusions: latency-bound at the shipped shapes, the crossover
    at Bm* ≈ 1500 rows for Hp = 128), ported as it is: pure host
    arithmetic over its TPU-era constants."""
    hp = ((hidden + _LANE - 1) // _LANE) * _LANE
    plans = []
    for m in range(1, batch + 1):
        if batch % m:
            continue
        bm = batch // m
        t_step = max(step_latency_s, 8.0 * bm * hp * hp / mxu_flops)
        t_single = window * max(step_latency_s, 8.0 * batch * hp * hp / mxu_flops)
        rel = (m + n_dev - 1) * (window / n_dev) * t_step / t_single
        plans.append({"microbatches": m, "rows": bm, "supersteps": m + n_dev - 1,
                      "relative_time": rel})
    best = min(plans, key=lambda p: p["relative_time"])
    return {"plans": plans, "recommended": best["microbatches"]}
