"""The full 3-D dp × sp × tp composition (``hfrep_tpu/parallel/dp_sp_tp.py``):
the batch over ``dp``, the window over ``sp``, the hidden units over
``tp``, in one step.

It is :mod:`~hfrep_tpu_torch.parallel.sequence`'s chain of window chunks
with :mod:`~hfrep_tpu_torch.parallel.tensor`'s recurrence inside each
chunk: rank (s, t) of an sp × tp tile runs chunk s of every layer on its
gate columns t, from the carry the sp rank before it handed on — the
whole h (B, H) and its own units' c (B, Hl), sent between the ranks of
one tp coordinate.  A chunk's local graph then holds tp collectives,
which its tp sub-group runs in the same order on every rank (the same
code, the same chain schedule), while the chain's transfers run between
sp neighbours.  The hook sums each gradient over sp and tp (a replicated
leaf's kept on tp rank 0), averages it over dp, and completes the
penalty's squared norms over sp.

JAX's ``--sp-remat`` refuses this mesh (its tp-composed chunk scan is
not time-blocked), and so does ``experiments/cli.py``.
"""

from __future__ import annotations

import torch

from hfrep_tpu_torch.parallel.chain import Chain, Stage, axis_sum, chain_apply
from hfrep_tpu_torch.parallel.sequence import _named, _sp_head_impl, _sp_ln, _sub
from hfrep_tpu_torch.parallel.tensor import local_params, tp_lstm


def _carries(b_in) -> tuple:
    """The two layers' initial (h, c): the previous sp rank's, or none
    (a zero carry)."""
    if b_in is None:
        return None, None
    return (b_in[0], b_in[1]), (b_in[2], b_in[3])


def _carry_shapes(hidden: int, n_tp: int):
    return lambda rows: [(rows, hidden), (rows, hidden // n_tp)] * 2


def generator_stage(ax: Chain, hidden: int, slope: float = 0.2, activation: str = "sigmoid",
                    ln_eps: float = 1e-3) -> Stage:
    """The generator on a window chunk, each layer on this rank's gate
    columns from the previous sp rank's carries."""

    def fn(k, z, b_in, p):
        q = local_params(ax, p)
        c0, c1 = _carries(b_in)
        h, f0 = tp_lstm(ax, _sub(q, "lstm0"), z, activation, c0)
        h, f1 = tp_lstm(ax, _sub(q, "lstm1"), _sp_ln(_sub(q, "norm0"), h, ln_eps),
                        activation, c1)
        return [*f0, *f1], _sp_head_impl(q, h, slope, ln_eps)

    return Stage(fn, _carry_shapes(hidden, ax.n))


def critic_stage(ax: Chain, hidden: int) -> Stage:
    """The flagship critic on a window chunk: both layers on this rank's
    gate columns, the chunk's rows of the score head, the partial scores
    summed over sp (the bias added by the first sp rank)."""

    def fn(k, x, b_in, p):
        q = local_params(ax, p)
        c0, c1 = _carries(b_in)
        h, f0 = tp_lstm(ax, _sub(q, "lstm0"), x, "tanh", c0)
        h, f1 = tp_lstm(ax, _sub(q, "lstm1"), h, "tanh", c1)
        rows = h.shape[1] * hidden
        s = h.reshape(h.shape[0], -1) @ p["out.kernel"].narrow(0, k * rows, rows)
        return [*f0, *f1], (s + p["out.bias"] if k == 0 else s)

    return Stage(fn, _carry_shapes(hidden, ax.n), combine="sum")


def dp_sp_tp_apply_fns(pair, chain: Chain, ax: Chain) -> tuple:
    """The step's ``apply_fns`` on an sp × tp mesh: each rank's generator
    and critic on its window chunk and gate columns."""
    g = pair.generator
    stage_g = generator_stage(ax, g.lstm0.features, g.slope, g.lstm0.activation,
                              g.norm0.epsilon)
    stage_d = critic_stage(ax, pair.discriminator.lstm0.features)

    def g_apply(module, z):
        return chain_apply(chain, stage_g, z, _named(module))

    def d_apply(module, x):
        return chain_apply(chain, stage_d, x, _named(module))

    return g_apply, d_apply


def _dp_sp_tp_step(pair, tcfg, dataset: torch.Tensor, mesh):
    from hfrep_tpu_torch.parallel.rules import data_constraint, validate_tp
    from hfrep_tpu_torch.train.steps import make_train_step

    spec = validate_tp(pair, tcfg, mesh)
    if spec.sp == 1 or spec.tp == 1:
        raise ValueError(f"make_dp_sp_tp_train_step shards the window and the hidden units "
                         f"at once; mesh {mesh.shape} has an sp or tp extent of 1 (use "
                         "make_tp_train_step or make_sp_train_step)")
    if dataset.shape[1] % spec.sp:
        raise ValueError(f"window {dataset.shape[1]} not divisible by sp={spec.sp}")
    chain = Chain(mesh, "sp")
    return make_train_step(pair, tcfg, dataset,
                           shard_data=data_constraint(mesh, lambda t: axis_sum(chain, t)),
                           apply_fns=dp_sp_tp_apply_fns(pair, chain, Chain(mesh, "tp")))


def make_dp_sp_tp_train_step(pair, tcfg, dataset: torch.Tensor, mesh, **attrs):
    """ONE MTSS-WGAN-GP epoch on a ``('dp', 'sp', 'tp')`` mesh (or
    ``('sp', 'tp')``), ``step(state, draws)`` with the global batch's
    draws (launched as ``dp_sp_tp_train_step``)."""
    from hfrep_tpu_torch.parallel.rules import instrument_mesh_launch

    return instrument_mesh_launch(_dp_sp_tp_step(pair, tcfg, dataset, mesh), tcfg, mesh,
                                  "train_step", **attrs)


def make_dp_sp_tp_multi_step(pair, tcfg, dataset: torch.Tensor, mesh, **attrs):
    """``tcfg.steps_per_call`` such epochs a call, the trainer's block."""
    from hfrep_tpu_torch.parallel.rules import instrument_mesh_launch
    from hfrep_tpu_torch.train.steps import make_multi_step

    fn = make_multi_step(pair, tcfg, dataset, step=_dp_sp_tp_step(pair, tcfg, dataset, mesh))
    return instrument_mesh_launch(fn, tcfg, mesh, "multi_step", **attrs)
