"""One mesh axis as a chain of ranks: the window axis (``sp``) and the
layer axis (``pp``) of the port.

The JAX package writes these axes as sharding constraints on the
single-device program (``hfrep_tpu/parallel/sequence.py``) and as a
masked SPMD schedule inside ``shard_map`` (``layer_pipeline.py``).
Torch has no partitioner that reaches inside a hand kernel and no
autograd through ``send``/``recv``, so here both axes are one explicit
design: rank ``k`` of the axis runs its stage of the model, receives
boundary tensors from rank ``k - 1`` and sends its own to rank ``k + 1``
(the final (h, c) of a window chunk under sp; the whole (Bm, W, H)
hidden sequence of a microbatch under pp).

Each call is ONE autograd node a rank (:class:`_ChainFn`), whose
backward and double backward are explicit lockstep schedules over local
graphs:

* forward: receive the boundary (a leaf of the local graph), run the
  stage, send its boundary on; combine the outputs (``"sum"``: an
  all_reduce over the axis, the result replicated; ``"local"``: each
  rank keeps its own);
* first order: receive the cotangent of the boundary sent (from
  ``k + 1``), differentiate the local graph, send the cotangent of the
  boundary received (to ``k - 1``);
* second order (the gradient penalty's ∂/∂θ ∇ₓc, through
  :class:`_ChainBwd`): forward along the chain the cotangents of the
  boundary cotangents, then backward along it the cotangents of the
  boundaries themselves.

Because every rank's outer program (the train step) is the same code,
every rank's autograd engine reaches these nodes in the same order, and
inside a node the transfers are written in one order for every rank: no
rank waits for a transfer the other has not reached.  Every wait ends at
the process group's finite timeout.

Conventions: a replicated tensor (identical on every rank of the axis)
has its full cotangent on every rank; a rank-local tensor its own; a
parameter's gradient is a rank-local partial, summed over the axis by
the step's reduction (:class:`~hfrep_tpu_torch.parallel.rules.DataShard`).
Third-order derivatives are not supported, as in the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def _grad(outputs, inputs, grad_outputs, **kw) -> list:
    """``torch.autograd.grad`` with the backward on the calling thread
    (the order of a multi-term sum is then the graph's own; see
    ``train/steps.py::_grad``); ``None`` for an input that needs no
    gradient or is unused, and for every input when no output needs
    one."""
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    out = [None] * len(inputs)
    if not live or not pairs:
        return out
    with torch.autograd.set_multithreading_enabled(False):
        got = torch.autograd.grad([o for o, _ in pairs], [inputs[i] for i in live],
                                  [g for _, g in pairs], allow_unused=True, **kw)
    for i, g in zip(live, got):
        out[i] = g
    return out


class Chain:
    """The ranks along ``axis`` of ``mesh`` that share this rank's other
    coordinates: its position ``k`` of ``n``, its neighbours' global
    ranks, and the axis's process group."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.n = int(mesh.shape[axis])
        coords = [int(c) for c in np.unravel_index(mesh.rank, mesh.axis_sizes)]
        i = mesh.axis_names.index(axis)
        self.k = coords[i]

        def at(k: int) -> int:
            c = list(coords)
            c[i] = k
            return int(np.ravel_multi_index(c, mesh.axis_sizes))

        self.prev = at(self.k - 1) if self.k > 0 else None
        self.next = at(self.k + 1) if self.k < self.n - 1 else None
        self.group = mesh.axis_group(axis) if self.n > 1 else None

    # --------------------------------------------------------- transfers
    def send(self, tensors: Sequence[Optional[torch.Tensor]], shapes, dst: int) -> None:
        """``tensors`` (``None``: zeros of its shape) to global rank
        ``dst``, as one float32 message (gloo: through a host copy); no
        message at all when there is nothing to send (a stage with no
        boundary)."""
        from hfrep_tpu_torch.parallel.rules import count_collective

        import torch.distributed as dist

        if not shapes:
            return
        dev = self.mesh.device
        flat = torch.cat([(torch.zeros(s, dtype=torch.float32, device=dev) if t is None
                           else t.detach().float()).reshape(-1)
                          for t, s in zip(tensors, shapes)])
        dist.send(self.mesh._wire(flat), dst)
        count_collective("send")

    def recv(self, shapes, src: int) -> List[torch.Tensor]:
        """The message :meth:`send` sent from global rank ``src``, split
        into tensors of ``shapes`` on this rank's device (none for no
        shapes)."""
        from hfrep_tpu_torch.parallel.rules import count_collective

        import torch.distributed as dist

        if not shapes:
            return []
        sizes = [int(np.prod(s)) for s in shapes]
        wire = torch.empty(sum(sizes), dtype=torch.float32, device=self.mesh.wire_device)
        dist.recv(wire, src)
        count_collective("recv")
        flat = wire.to(self.mesh.device)
        return [p.reshape(s).clone() for p, s in zip(flat.split(sizes), shapes)]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis, in place; every rank of the axis
        ends with the same bits."""
        if self.n == 1:
            return t
        from hfrep_tpu_torch.parallel.rules import count_collective

        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        count_collective("all_reduce")
        return t


class AxisSum(torch.autograd.Function):
    """A rank-local tensor summed over a chain's axis into a replicated
    one: the backward hands every rank the replicated cotangent as it is
    (each rank's summand has the sum's cotangent)."""

    @staticmethod
    def forward(ctx, chain: Chain, t: torch.Tensor):
        return chain.all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return None, g


def axis_sum(chain: Chain, t: torch.Tensor) -> torch.Tensor:
    return AxisSum.apply(chain, t) if chain.n > 1 else t


# ----------------------------------------------------------------- stages
@dataclasses.dataclass(frozen=True)
class Stage:
    """What one rank of a chain computes.

    ``fn(k, x, b_in, params) -> (b_out, y)``: rank ``k``'s stage on a
    microbatch ``x``, from the boundary ``b_in`` (``None`` at ``k = 0``),
    giving the boundary for rank ``k + 1`` (ignored on the last rank) and
    its output ``y`` (``None`` where the rank has none).  ``b_shapes(rows)``
    are the boundary's shapes for a microbatch of ``rows``; ``y_shape(rows)``
    the output's on a rank whose ``y`` is ``None``.  ``combine`` is
    ``"sum"`` (the outputs summed over the axis, replicated) or
    ``"local"``; ``shared_x``: the input is replicated over the axis (its
    cotangent is then summed over the axis, so every rank holds it whole);
    ``microbatches``: the batch is run as that many microbatches, stage
    ``k`` on microbatch ``m`` after stage ``k - 1`` sent it (the layer
    pipeline's schedule)."""

    fn: Callable
    b_shapes: Callable
    y_shape: Optional[Callable] = None
    combine: str = "local"
    shared_x: bool = False
    microbatches: int = 1


class _Run:
    """One call of a chain: its local graph and the schedules over it."""

    def __init__(self, chain: Chain, stage: Stage, names: Sequence[str]):
        self.chain, self.stage, self.names = chain, stage, list(names)

    # ----------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, params: dict, leaves: bool) -> torch.Tensor:
        """Run this rank's stage (microbatch by microbatch) between its
        neighbours' transfers and combine; with ``leaves`` the received
        boundaries become graph leaves and the local graph is kept."""
        ch, st = self.chain, self.stage
        m = st.microbatches
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} not divisible by microbatches={m}")
        self.b_in, self.b_out, ys = [], [], []
        for xm in x.split(x.shape[0] // m) if m > 1 else (x,):
            b_in = None
            if ch.prev is not None:
                b_in = ch.recv(st.b_shapes(xm.shape[0]), ch.prev)
                if leaves:
                    b_in = [t.requires_grad_(True) for t in b_in]
                self.b_in += b_in
            b_out, y = st.fn(ch.k, xm, b_in, params)
            if ch.next is not None:
                ch.send(b_out, [t.shape for t in b_out], ch.next)
                self.b_out += list(b_out)
            ys.append(y)
        self.y = None if ys[0] is None else (torch.cat(ys) if m > 1 else ys[0])
        self.rows = x.shape[0]
        if st.combine == "local":
            return self.y.detach()
        total = (torch.zeros(st.y_shape(self.rows), dtype=torch.float32, device=x.device)
                 if self.y is None else self.y.detach().clone())
        return ch.all_reduce_(total)

    def _inputs(self) -> list:
        return [self.xl] + [self.pl[n] for n in self.names] + self.b_in

    def _split(self, grads) -> tuple:
        n = len(self.names)
        return grads[0], list(grads[1:1 + n]), list(grads[1 + n:1 + n + len(self.b_in)])

    def _partials(self, dps: list) -> list:
        """A parameter's gradient on this rank: zeros where its stage does
        not use it (the partial the axis sum completes)."""
        return [torch.zeros_like(self.pl[n]) if d is None and self.pl[n].requires_grad else d
                for n, d in zip(self.names, dps)]

    def _sum_x(self, dx: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A shared input's cotangent, whole on every rank of the axis."""
        if not (self.stage.shared_x and self.xl.requires_grad):
            return dx
        dx = torch.zeros_like(self.xl) if dx is None else dx.detach().clone()
        return self.chain.all_reduce_(dx)

    def _outputs(self, dy, db_out) -> tuple:
        outs, cots = [], []
        if self.y is not None and dy is not None:
            outs.append(self.y)
            cots.append(dy.to(self.y.dtype))
        for t, c in zip(self.b_out, db_out):
            if t.requires_grad:
                outs.append(t)
                cots.append(c)
        return outs, cots

    # ------------------------------------------------------- first order
    def backward(self, dy: torch.Tensor) -> tuple:
        """(dx, dparams) of the local graph, the boundary cotangents
        handed back along the chain."""
        ch = self.chain
        db_out = ch.recv([t.shape for t in self.b_out], ch.next) if ch.next is not None else []
        outs, cots = self._outputs(dy, db_out)
        inputs = self._inputs()
        grads = _grad(outs, inputs, cots, retain_graph=True)
        dx, dps, db_in = self._split(grads)
        if ch.prev is not None:
            ch.send(db_in, [t.shape for t in self.b_in], ch.prev)
        return self._sum_x(dx), self._partials(dps)

    def first_order(self, dy: torch.Tensor) -> tuple:
        """:meth:`backward` with ``create_graph``: the cotangents' graph
        is kept, over leaves for ``dy`` and the boundary cotangents
        received, for :meth:`second_order`."""
        ch = self.chain
        with torch.enable_grad():
            self.dyl = dy.detach().requires_grad_(True)
            self.dbl = ([t.requires_grad_(True) for t in
                         ch.recv([t.shape for t in self.b_out], ch.next)]
                        if ch.next is not None else [])
            outs, cots = self._outputs(self.dyl, self.dbl)
            inputs = self._inputs()
            grads = _grad(outs, inputs, cots, retain_graph=True, create_graph=True)
        self.g1 = self._split(grads)
        dx, dps, db_in = self.g1
        if ch.prev is not None:
            ch.send(db_in, [t.shape for t in self.b_in], ch.prev)
        return self._sum_x(dx), dps

    # ------------------------------------------------------ second order
    def second_order(self, u_dx, u_dps, dy_needs: bool) -> tuple:
        """(u_dy, u_x, u_params): the VJP of :meth:`first_order`'s map.
        (a) forward along the chain: the cotangent of each boundary
        cotangent; (b) backward along it: the cotangent of each boundary,
        through the forward graph."""
        ch = self.chain
        dx, dps, db_in = self.g1
        shapes_in = [t.shape for t in self.b_in]
        u_dbin = ch.recv(shapes_in, ch.prev) if ch.prev is not None else []
        outs, cots = [], []
        for t, u in [(dx, u_dx)] + list(zip(dps, u_dps)) + list(zip(db_in, u_dbin)):
            if t is not None and u is not None and t.requires_grad:
                outs.append(t)
                cots.append(u)
        leaves = self._inputs() + [self.dyl] + self.dbl
        a = _grad(outs, leaves, cots, retain_graph=True)
        n_in = len(self._inputs())
        a_x, a_p, a_b = self._split(a[:n_in])
        a_dy, u_dbout = a[n_in], list(a[n_in + 1:])
        if ch.next is not None:
            ch.send(u_dbout, [t.shape for t in self.b_out], ch.next)
            u_bout = ch.recv([t.shape for t in self.b_out], ch.next)
            outs = [t for t in self.b_out if t.requires_grad]
            cots = [u for t, u in zip(self.b_out, u_bout) if t.requires_grad]
            c = _grad(outs, self._inputs(), cots, retain_graph=True)
            c_x, c_p, c_b = self._split(c)
            a_x, a_p, a_b = _add(a_x, c_x), [_add(p, q) for p, q in zip(a_p, c_p)], \
                [_add(p, q) for p, q in zip(a_b, c_b)]
        if ch.prev is not None:
            ch.send(a_b, shapes_in, ch.prev)
        if dy_needs and self.stage.combine == "sum":
            a_dy = ch.all_reduce_(torch.zeros_like(self.dyl) if a_dy is None else a_dy.clone())
        return a_dy, self._sum_x(a_x), self._partials(a_p)


def _add(a, b):
    return b if a is None else a if b is None else a + b


class _ChainFn(torch.autograd.Function):
    """A chain call as one autograd node a rank (module docstring)."""

    @staticmethod
    def forward(ctx, run: _Run, x, *vals):
        with torch.enable_grad():
            run.xl = x.detach().requires_grad_(x.requires_grad)
            run.pl = {n: v.detach().requires_grad_(v.requires_grad)
                      for n, v in zip(run.names, vals)}
            out = run.forward(run.xl, run.pl, leaves=True)
        ctx.run = run
        ctx.save_for_backward(x, *vals)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy):
        run = ctx.run
        if torch.is_grad_enabled():         # create_graph: a penalty's ∇ₓc
            x, *vals = ctx.saved_tensors
            return (None,) + tuple(_ChainBwd.apply(run, dy, x, *vals))
        dx, dps = run.backward(dy)
        return (None, dx) + tuple(dps)


class _ChainBwd(torch.autograd.Function):
    """:class:`_ChainFn`'s first order as a node of its own, so that the
    penalty's outer gradient can differentiate it (:meth:`_Run.second_order`)."""

    @staticmethod
    def forward(ctx, run: _Run, dy, x, *vals):
        dx, dps = run.first_order(dy)
        ctx.run = run
        ctx.set_materialize_grads(False)
        zero = lambda t: torch.zeros_like(t)   # noqa: E731
        return ((zero(x) if dx is None else dx.detach()),) + tuple(
            zero(v) if d is None else d.detach() for d, v in zip(dps, vals))

    @staticmethod
    def backward(ctx, u_dx, *u_dps):
        if torch.is_grad_enabled():
            raise NotImplementedError("chain: third-order derivatives are not supported")
        u_dy, u_x, u_ps = ctx.run.second_order(u_dx, list(u_dps), ctx.needs_input_grad[1])
        return (None, u_dy, u_x) + tuple(u_ps)


def chain_apply(chain: Chain, stage: Stage, x: torch.Tensor, params: dict) -> torch.Tensor:
    """Run ``stage`` along ``chain`` on this rank's ``x`` with ``params``
    (name → tensor): differentiable to second order in ``x`` and every
    parameter when autograd is recording, else a plain forward with the
    same transfers."""
    names = list(params)
    vals = [params[n] for n in names]
    run = _Run(chain, stage, names)
    if torch.is_grad_enabled() and (x.requires_grad or any(v.requires_grad for v in vals)):
        return _ChainFn.apply(run, x, *vals)
    with torch.no_grad():
        return run.forward(x, params, leaves=False)
