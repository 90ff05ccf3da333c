"""Layer (pipeline) parallelism over the two-LSTM stack
(``hfrep_tpu/parallel/layer_pipeline.py``).

A ``('pp',)`` mesh of exactly two ranks, the stack's depth: stage 0
owns the first LSTM (and the generator's first LayerNorm), stage 1 the
second LSTM and the head.  The batch splits into M microbatches and
stage k runs microbatch m at superstep k + m, so both stages compute at
once after a one-superstep fill; the whole (Bm, W, H) hidden sequence of
a microbatch crosses from stage 0 to stage 1 (the schedule of JAX's
``_pp_pipeline``, here a chain of two ranks,
:mod:`~hfrep_tpu_torch.parallel.chain`).  Stage 1's outputs are summed
over the axis (stage 0 contributes nothing), so every rank holds them;
the input is replicated and its cotangent summed back, so the gradient
penalty's ∇ₓc is whole on both ranks.

Each stage runs one layer, so the critic takes the chained
single-layer kernels (``lstm_fwd`` and its ``with_cs`` mode,
``lstm_bwd``, ``lstm_adj``), never the fused stack, which holds both
layers in one launch — JAX's ``_validate_pp_backend`` says the same of
its fused kernel, and has no counterpart here: the port's
``lstm_backend`` selects nothing (the kernel on a card, the plain
version on the CPU).  JAX's ``_stack_stage_params`` pads stage 0's
kernel rows to a common width so both devices trace one SPMD program;
here each rank runs its own layer at its own shapes, and needs none.

:func:`make_pp_train_step` is the plain step with ``apply_fns``
(``train/steps.py``), every other step semantic shared; each rank's
gradients are its stage's, summed over the axis.  As in JAX, nothing in
the trainer or the CLI dispatches to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from hfrep_tpu_torch.parallel.chain import Chain, Stage, chain_apply
from hfrep_tpu_torch.parallel.sequence import (Params, _lstm_layer, _named, _sp_head_impl,
                                               _sp_ln, _sub)

N_STAGES = 2          # the stack's depth — pp's one honest configuration


def _resolve_pp_axis(mesh, axis_name: Optional[str]) -> str:
    """The axis must be named ``'pp'`` unless the caller names one, and
    span exactly two ranks."""
    if axis_name is None:
        if "pp" not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no 'pp' axis; pass "
                             "axis_name explicitly to shard layers over another name")
        axis_name = "pp"
    if mesh.shape[axis_name] != N_STAGES:
        raise ValueError(f"layer pipeline needs exactly {N_STAGES} '{axis_name}' devices "
                         f"(the stack depth), got {mesh.shape[axis_name]}")
    return axis_name


def _microbatches(m: Optional[int], batch: int) -> int:
    m = N_STAGES if m is None else m
    if m < 1:
        raise ValueError(f"microbatches must be >= 1, got {m}")
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by microbatches {m}")
    return m


def _pp_pipeline(send_fn, head_fn, *, window: int, hidden: int, out_tail: tuple,
                 activation: str, microbatches: int) -> Stage:
    """The two-stage schedule as a chain :class:`~hfrep_tpu_torch.parallel.
    chain.Stage`: stage k runs LSTM k; stage 0 then ``send_fn`` on a
    microbatch and sends the (Bm, W, H) sequence; stage 1 ``head_fn`` into
    (Bm, *out_tail); the outputs summed over the axis."""

    def fn(k, x, b_in, p):
        h = _lstm_layer(_sub(p, f"lstm{k}"), x if k == 0 else b_in[0], activation)
        if k == 0:
            return [send_fn(p, h)], None
        return None, head_fn(p, h)

    return Stage(fn, lambda rows: [(rows, window, hidden)],
                 y_shape=lambda rows: (rows, *out_tail), combine="sum", shared_x=True,
                 microbatches=microbatches)


def generator_stage(window: int, features: int, hidden: int, slope: float = 0.2,
                    activation: str = "sigmoid", ln_eps: float = 1e-3,
                    microbatches: int = N_STAGES) -> Stage:
    """The MTSS generator depth-split: stage 0 = LSTM₀ + LayerNorm₀,
    stage 1 = LSTM₁ + (LeakyReLU → LayerNorm₁ → Dense), the sp path's
    helpers."""
    return _pp_pipeline(lambda p, v: _sp_ln(_sub(p, "norm0"), v, ln_eps),
                        lambda p, v: _sp_head_impl(p, v, slope, ln_eps),
                        window=window, hidden=hidden, out_tail=(window, features),
                        activation=activation, microbatches=microbatches)


def critic_stage(window: int, hidden: int, microbatches: int = N_STAGES) -> Stage:
    """The flagship critic depth-split: stage 0 = LSTM₀, stage 1 = LSTM₁ +
    the flattened (W·H → 1) score head."""

    def head(p, h):
        return h.reshape(h.shape[0], -1) @ p["out.kernel"] + p["out.bias"]

    return _pp_pipeline(lambda p, v: v, head, window=window, hidden=hidden, out_tail=(1,),
                        activation="tanh", microbatches=microbatches)


def pp_generate(g_params: Params, z: torch.Tensor, mesh, *, axis_name: Optional[str] = None,
                slope: float = 0.2, activation: str = "sigmoid", ln_eps: float = 1e-3,
                microbatches: Optional[int] = None) -> torch.Tensor:
    """The full MTSS generator with its two recurrences on the two
    stages: (B, W, F) → (B, W, F), on every rank."""
    chain = Chain(mesh, _resolve_pp_axis(mesh, axis_name))
    p = _named(g_params)
    b, w, f = z.shape
    stage = generator_stage(w, f, p["lstm0.recurrent_kernel"].shape[0], slope, activation,
                            ln_eps, _microbatches(microbatches, b))
    return chain_apply(chain, stage, z, p)


def pp_critic(d_params: Params, x: torch.Tensor, mesh, *, axis_name: Optional[str] = None,
              microbatches: Optional[int] = None) -> torch.Tensor:
    """The MTSS-WGAN-GP critic depth-split: (B, W, F) → (B, 1), on every
    rank."""
    chain = Chain(mesh, _resolve_pp_axis(mesh, axis_name))
    p = _named(d_params)
    stage = critic_stage(x.shape[1], p["lstm0.recurrent_kernel"].shape[0],
                         _microbatches(microbatches, x.shape[0]))
    return chain_apply(chain, stage, x, p)


def validate_pp_pair(pair) -> None:
    """The flagship family at float32, as JAX's."""
    if pair.family != "mtss_wgan_gp":
        raise ValueError(f"layer-pipeline step supports the mtss_wgan_gp family, got "
                         f"{pair.family!r}")
    if pair.policy.compute_dtype != torch.float32:
        raise NotImplementedError("layer-pipeline step runs f32; configure dtype=float32")


def pp_apply_fns(pair, chain: Chain, microbatches: int) -> tuple:
    """The step's ``apply_fns`` on the two-stage chain."""
    g, d = pair.generator, pair.discriminator
    w, f = d.out.kernel.shape[0] // d.lstm0.features, g.out.kernel.shape[1]
    stage_g = generator_stage(w, f, g.lstm0.features, g.slope, g.lstm0.activation,
                              g.norm0.epsilon, microbatches)
    stage_d = critic_stage(w, d.lstm0.features, microbatches)

    def g_apply(module, z):
        return chain_apply(chain, stage_g, z, _named(module))

    def d_apply(module, x):
        return chain_apply(chain, stage_d, x, _named(module))

    return g_apply, d_apply


def make_pp_train_step(pair, tcfg, dataset: torch.Tensor, mesh, *,
                       axis_name: Optional[str] = None, microbatches: Optional[int] = None):
    """Layer-pipelined MTSS-WGAN-GP training: one epoch (n_critic
    penalty critic updates + the generator update) with the stack
    depth-split over the ``pp`` axis: ``step(state, draws)`` with the
    global batch's draws, as the plain step.  Every pass splits into
    ``microbatches`` (default 2), which must divide every batch the step
    runs: the batch, and n_critic times it for the fakes."""
    from hfrep_tpu_torch.obs import instrument_launch
    from hfrep_tpu_torch.parallel.rules import DataShard
    from hfrep_tpu_torch.train.steps import make_train_step

    chain = Chain(mesh, _resolve_pp_axis(mesh, axis_name))
    validate_pp_pair(pair)
    m = _microbatches(microbatches, tcfg.batch_size)
    step = make_train_step(pair, tcfg, dataset, apply_fns=pp_apply_fns(pair, chain, m),
                           shard_data=DataShard(mesh, inner=(chain.axis,)))
    return instrument_launch(step, "pp_train_step", tcfg=tcfg, mesh=mesh, microbatches=m)
