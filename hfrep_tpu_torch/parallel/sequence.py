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
in a recorded backward).  The critic's flattened score head is split by
rows, each rank scoring its chunk, the partial scores summed over the
axis.

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
* :func:`sp_microbatch_plan` — JAX's analytic model of the retired
  microbatch schedule, ported as it is (advisory; no step has an M knob).

sp runs the flagship (``mtss_wgan_gp``) at float32, the family whose
forwards this module writes (:func:`validate_sp_pair`).  JAX's forwards
and builders also take the knobs of its retired manual ``shard_map``
pipeline (``microbatches``, ``manual``, ``tp_axis``, ``remat``,
``check_vma``, ``chunk``) and ignore them; these take none of them.
The retired CLI knobs ``--sp-microbatches`` and ``--sp-remat`` are
accepted and ignored in ``experiments/cli.py``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
from torch import nn

from hfrep_tpu_torch.ops import cuda_lstm
from hfrep_tpu_torch.ops.layers import layer_norm, leaky_relu
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
def _project(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The input projection for every timestep as one matmul, time-major
    (W, B, 4H): ``keras_lstm``'s."""
    b, w, f = x.shape
    xz = (x.reshape(b * w, f) @ params["kernel"] + params["bias"]).reshape(b, w, -1)
    return xz.transpose(0, 1).contiguous()


def _local_chunk_scan(xz_chunk: torch.Tensor, carry: tuple, recurrent: torch.Tensor,
                      activation: str) -> tuple:
    """One (W, B, 4H) pre-projected chunk from the carry (h0, c0):
    (hs (W, B, H), (h_fin, c_fin)), through the carry kernels."""
    hs, c_fin = cuda_lstm.lstm_seq_carry(xz_chunk, recurrent.contiguous(), carry[0],
                                         carry[1], activation)
    return hs, (hs[-1] if hs.shape[0] else carry[0], c_fin)


def _lstm_chunk(params: dict, x: torch.Tensor, carry: tuple, activation: str) -> tuple:
    """One Keras LSTM layer over a window chunk (B, Wc, Fin) from
    ``carry``: ((B, Wc, H), (h_fin, c_fin))."""
    hs, fin = _local_chunk_scan(_project(params, x), carry, params["recurrent_kernel"],
                                activation)
    return hs.transpose(0, 1), fin


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


# ------------------------------------------------------ window-chunk stages
def _carries(b_in, rows: int, hidden: int, device) -> tuple:
    """The two layers' initial (h, c): the previous rank's, or zeros."""
    if b_in is None:
        z = torch.zeros((rows, hidden), dtype=torch.float32, device=device)
        return (z, z), (z, z)
    return (b_in[0], b_in[1]), (b_in[2], b_in[3])


def _carry_shapes(hidden: int):
    return lambda rows: [(rows, hidden)] * 4


def generator_stage(hidden: int, slope: float = 0.2, activation: str = "sigmoid",
                    ln_eps: float = 1e-3) -> Stage:
    """The generator on a window chunk: both layers from the previous
    rank's carries, this rank's chunk of the output."""

    def fn(k, z, b_in, p):
        c0, c1 = _carries(b_in, z.shape[0], hidden, z.device)
        h, f0 = _lstm_chunk(_sub(p, "lstm0"), z, c0, activation)
        h, f1 = _lstm_chunk(_sub(p, "lstm1"), _sp_ln(_sub(p, "norm0"), h, ln_eps), c1,
                            activation)
        return [*f0, *f1], _sp_head_impl(p, h, slope, ln_eps)

    return Stage(fn, _carry_shapes(hidden))


def critic_stage(hidden: int) -> Stage:
    """The flagship critic on a window chunk: both layers from the
    previous rank's carries, the chunk's rows of the score head; the
    partial scores summed over the axis (the bias added once, by the
    first rank)."""

    def fn(k, x, b_in, p):
        c0, c1 = _carries(b_in, x.shape[0], hidden, x.device)
        h, f0 = _lstm_chunk(_sub(p, "lstm0"), x, c0, "tanh")
        h, f1 = _lstm_chunk(_sub(p, "lstm1"), h, c1, "tanh")
        rows = h.shape[1] * hidden
        s = h.reshape(h.shape[0], -1) @ p["out.kernel"].narrow(0, k * rows, rows)
        return [*f0, *f1], (s + p["out.bias"] if k == 0 else s)

    return Stage(fn, _carry_shapes(hidden), combine="sum")


def lstm_stage(activation: str, hidden: int) -> Stage:
    """One LSTM layer on a window chunk from the previous rank's carry."""

    def fn(k, x, b_in, p):
        carry = ((b_in[0], b_in[1]) if b_in is not None else
                 (torch.zeros((x.shape[0], hidden), dtype=torch.float32, device=x.device),) * 2)
        h, fin = _lstm_chunk(p, x, carry, activation)
        return list(fin), h

    return Stage(fn, lambda rows: [(rows, hidden)] * 2)


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
    stage = generator_stage(p["lstm0.recurrent_kernel"].shape[0], slope, activation, ln_eps)
    return chain_apply(chain, stage, _my_chunk(chain, z), p)


def sp_critic(d_params: Params, x: torch.Tensor, mesh, *,
              axis_name: Optional[str] = None) -> torch.Tensor:
    """Window-sharded critic scores: ``x`` (B, W, F), the same on every
    rank → (B, 1), replicated."""
    chain = _window_chain(mesh, axis_name)
    p = _named(d_params)
    return chain_apply(chain, critic_stage(p["lstm0.recurrent_kernel"].shape[0]),
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
    """The window-sharded step runs the flagship's forwards at float32."""
    if pair.family != "mtss_wgan_gp":
        raise ValueError(f"sequence-parallel step supports the mtss_wgan_gp family (the "
                         f"forwards this module writes), got {pair.family!r}")
    if pair.policy.compute_dtype != torch.float32:
        raise NotImplementedError("sequence-parallel step runs float32; configure "
                                  "dtype=float32")


def sp_apply_fns(pair, chain: Chain) -> tuple:
    """The step's ``apply_fns`` on a window-sharded mesh: each rank's
    generator and critic on its window chunk of the draws."""
    g = pair.generator
    stage_g = generator_stage(g.lstm0.features, g.slope, g.lstm0.activation,
                              g.norm0.epsilon)
    stage_d = critic_stage(pair.discriminator.lstm0.features)

    def g_apply(module, z):
        return chain_apply(chain, stage_g, z, _named(module))

    def d_apply(module, x):
        return chain_apply(chain, stage_d, x, _named(module))

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
