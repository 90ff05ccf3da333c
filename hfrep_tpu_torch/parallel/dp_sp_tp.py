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
from hfrep_tpu_torch.parallel.sequence import _named, net_ops, run_ops
from hfrep_tpu_torch.parallel.tensor import local_params, tp_lstm_op


def _carry_shapes(ops: tuple, n_tp: int):
    """The boundary an sp rank hands on: each LSTM's whole h and this tp
    rank's units of its c."""
    hidden = [op.hidden for op in ops if op.kind == "lstm"]
    return lambda rows: [s for h in hidden for s in ((rows, h), (rows, h // n_tp))]


def tp_stage(ax: Chain, ops: tuple) -> Stage:
    """A network's layers ``ops`` on a window chunk, each LSTM on this
    rank's gate columns from the previous sp rank's carry (the first from
    a zero carry); a flattened head's partial scores summed over sp (the
    bias added by the first sp rank)."""
    lstm = tp_lstm_op(ax)

    def fn(k, x, b_in, p):
        return run_ops(ops, local_params(ax, p), x, k, b_in, lstm)

    return Stage(fn, _carry_shapes(ops, ax.n),
                 combine="sum" if ops[-1].kind == "flat" else "local")


def dp_sp_tp_apply_fns(pair, chain: Chain, ax: Chain) -> tuple:
    """The step's ``apply_fns`` on an sp × tp mesh: each rank's generator
    and critic on its window chunk and gate columns, at the networks'
    precision policy."""
    ops_g, ops_d = net_ops(pair.generator), net_ops(pair.discriminator)
    stage_g, stage_d = tp_stage(ax, ops_g), tp_stage(ax, ops_d)
    head = ops_d[-1]

    def g_apply(module, z):
        return chain_apply(chain, stage_g, z, _named(module))

    def d_apply(module, x):
        y = chain_apply(chain, stage_d, x, _named(module))
        return y.to(head.dtype or y.dtype)

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
    """ONE MTSS-WGAN-GP epoch, float32 or bf16, on a ``('dp', 'sp', 'tp')``
    mesh (or ``('sp', 'tp')``), ``step(state, draws)`` with the global batch's
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
