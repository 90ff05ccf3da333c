"""One mesh for the launch paths: partition rules over named leaves and
the data-parallel step (``hfrep_tpu/parallel/rules.py``).

* **one mesh** — :class:`MeshSpec` declares ``dp``/``sp``/``tp``/``pp``
  as axis sizes; :func:`build_mesh` turns it into the :class:`Mesh` one
  process sees: the axis names and sizes, this rank's position and
  device, and the process group its collectives run in.  A one-device
  mesh needs no process group and holds none; a larger one needs the
  default group that :func:`~hfrep_tpu_torch.parallel.mesh.
  initialize_distributed` made, of exactly its size, and runs its
  collectives there.  It is not wrapped in a ``DeviceMesh``: with a card
  present and a gloo default group (ranks sharing the card), a
  ``DeviceMesh`` makes a second gloo group of the same ranks without the
  group's finite timeout, and a 1-D dp mesh needs no sub-groups.
* **regex partition rules** — :func:`match_partition_rules` maps
  ``(pattern, PartitionSpec)`` rules over the '/'-joined names of a
  tree's leaves (the port's own names: ``generator/lstm0.kernel``,
  ``g_opt/nu/lstm0.recurrent_kernel``, ...); scalar leaves replicate,
  an unmatched leaf is a hard error naming it, and axis names the mesh
  lacks are stripped, so one rule set serves every mesh shape.
* **shard/gather fns** — :func:`make_shard_and_gather_fns` /
  :func:`shard_put`: this rank's block of each leaf under its spec, on
  its device (the divisibility error names the leaf), and the inverse,
  every rank's blocks gathered into full host arrays.
* **the dp launch** — :func:`make_gan_train_step` /
  :func:`make_gan_multi_step` build the single-device step with the dp
  hook :func:`data_constraint` returns.  Every rank draws the whole
  global batch from the same seeded generator (JAX's global-stream
  semantics, its only mode), keeps its contiguous ``B/dp`` rows, runs
  the unchanged step (hand kernels included) on them, and reduces every
  gradient and loss to the global mean before the optimizer touches it;
  the state stays replicated and bit-equal across ranks.  dp=N follows
  the single-device trajectory to float32 round-off; on a mesh with no
  axis longer than 1 the hook is ``None`` and the step is literally the
  single-device one: no collective, no extra launch.

JAX's ``_resolve_mesh_backend`` has no counterpart: it keeps GSPMD from
partitioning an opaque Pallas call, while here no partitioner looks
inside a kernel: each rank launches the hand kernels on its own rows.
The window, hidden-unit and layer axes (``sp``, ``tp``, ``pp``) need
their own designs (carry handoffs between ranks, a per-step all-gather
of h); the builders refuse them naming ROADMAP queue 1 item 9b, and run
no other program instead.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from hfrep_tpu_torch.core.device import DeviceLike

#: canonical axis order: ``dp`` shards batch / lane-grid rows, ``sp`` the
#: window, ``tp`` hidden units, ``pp`` the stack depth
AXES = ("dp", "sp", "tp", "pp")

#: the refusal every builder gives a mesh with an sp, tp or pp axis
ITEM_9B = ("the sp, tp and pp axes are ROADMAP queue 1 item 9b, not ported yet: "
           "this port launches dp meshes only")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, an axis
    name, a tuple of names, or ``None`` (not sharded); ``P()``
    replicates.  A one-name tuple is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: axis sizes.  ``MeshSpec(dp=2)`` is the 1-D
    data-parallel mesh; all sizes 1 is the single-device mesh, whose axes
    collapse to ``('dp',)`` so there is always one named axis."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1

    def __post_init__(self):
        for name in AXES:
            if getattr(self, name) < 1:
                raise ValueError(f"mesh axis sizes must be >= 1, got "
                                 f"{name}={getattr(self, name)}")

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp * self.pp

    @property
    def axis_names(self) -> Tuple[str, ...]:
        names = tuple(n for n in AXES if getattr(self, n) > 1)
        return names or ("dp",)

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, n) for n in self.axis_names)

    def describe(self) -> dict:
        """JSON-safe manifest section."""
        return {"axes": {n: int(s) for n, s in zip(self.axis_names, self.axis_sizes)},
                "devices": int(self.size), "unified": True}


#: collectives the dp hooks ran since the last reset: launches made to
#: compare a kernel with its plain version never touch them
_COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def collective_counts() -> dict:
    return dict(_COLLECTIVES)


def reset_collective_counts() -> None:
    for k in _COLLECTIVES:
        _COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A device mesh as one process sees it.

    ``axis_names``/``axis_sizes`` name the axes (any names: a seed mesh
    is ``('seed',)``); ``rank`` is this process's position in row-major
    order, ``device`` its device, ``group`` the process group of the
    mesh's collectives (``None`` on a one-device mesh), ``backend`` that
    group's backend."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    rank: int = 0
    group: Any = None
    backend: Optional[str] = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    @property
    def spans_processes(self) -> bool:
        return self.size > 1

    def coords(self) -> dict:
        """This rank's coordinate along each axis."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(self.rank, self.axis_sizes))))

    def _need_group(self, what: str) -> None:
        if self.group is None:
            raise RuntimeError(
                f"{what} on a {self.size}-device mesh {self.shape} needs a process "
                "group, and this mesh has none: build it with build_mesh after "
                "parallel.initialize_distributed")

    # ---------------------------------------------------------- collectives
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend carries it: gloo takes host tensors for
        every collective but all_reduce and broadcast, so this goes
        through host copies (bytes unchanged), NCCL device tensors; bool
        travels as uint8."""
        t = t.detach()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        t = t.cpu() if self.backend == "gloo" else t.to(self.device)
        return t.contiguous()

    def all_gather_cat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order, on
        ``t``'s device, bit for bit (gloo: through host copies)."""
        if self.size == 1:
            return t
        self._need_group("all_gather")
        import torch.distributed as dist

        wire = self._wire(t)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire, group=self.group)
        _COLLECTIVES["all_gather"] += 1
        out = torch.cat(parts, dim=dim)
        return out.to(t.device, torch.bool if t.dtype == torch.bool else out.dtype)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place with rank ``src``'s bytes."""
        if self.size == 1:
            return t
        self._need_group("broadcast")
        import torch.distributed as dist

        wire = self._wire(t)
        dist.broadcast(wire, src=src, group=self.group)
        _COLLECTIVES["broadcast"] += 1
        if wire is not t:
            with torch.no_grad():
                t.copy_(wire.to(t.device, t.dtype))
        return t

    def any(self, *flags: bool) -> Tuple[bool, ...]:
        """Each flag OR-ed over the ranks, in one collective."""
        if self.size == 1:
            return tuple(bool(f) for f in flags)
        self._need_group("a flag reduction")
        import torch.distributed as dist

        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device="cpu" if self.backend == "gloo" else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        _COLLECTIVES["all_reduce"] += 1
        return tuple(bool(v) for v in t.tolist())

    def barrier(self) -> None:
        if self.size == 1:
            return
        self._need_group("barrier")
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.group)


def rank_device(device: DeviceLike = None, rank: Optional[int] = None) -> torch.device:
    """A rank's device: the one asked for (``"cpu"`` included), else
    ``cuda:{local_rank % device_count}``, the local rank being ``rank``,
    else ``LOCAL_RANK``, else the process group's rank (one host); a rank
    that finds no card raises."""
    from hfrep_tpu_torch.core.device import resolve_device

    if device is not None:
        return resolve_device(device)
    resolve_device(None)                       # raises with no card
    import os

    import torch.distributed as dist

    if rank is not None:
        local = int(rank)
    elif "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        local = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(devices: Sequence[torch.device]) -> str:
    """The backend rule, a pure function of the ranks' devices: ``nccl``
    when each rank has a card of its own, ``gloo`` when ranks share a
    card or run on the CPU (NCCL refuses two ranks on one device)."""
    devs = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devs) or len({str(d) for d in devs}) < len(devs):
        return "gloo"
    return "nccl"


def make_named_mesh(axis_names: Sequence[str], axis_sizes: Sequence[int],
                    device: DeviceLike = None) -> Mesh:
    """A :class:`Mesh` over ``axis_names`` of ``axis_sizes``: one device
    and no process group when every size is 1, else the whole default
    process group (its size must be the mesh's)."""
    names, sizes = tuple(axis_names), tuple(int(s) for s in axis_sizes)
    n = int(np.prod(sizes))
    dev = rank_device(device)
    if n == 1:
        return Mesh(names, sizes, dev)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"a {n}-device mesh {dict(zip(names, sizes))} needs a process group of "
            f"{n} ranks and none is initialized: call "
            "hfrep_tpu_torch.parallel.initialize_distributed first (one process a rank)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} wants {n} ranks but the "
                         f"process group has {world}")
    return Mesh(names, sizes, dev, rank=dist.get_rank(), group=dist.group.WORLD,
                backend=dist.get_backend())


def build_mesh(spec: MeshSpec = MeshSpec(), device: DeviceLike = None) -> Mesh:
    """The :class:`Mesh` a declarative spec asks for, on this rank's
    device (:func:`rank_device`)."""
    return make_named_mesh(spec.axis_names, spec.axis_sizes, device)


def mesh_spec(mesh) -> MeshSpec:
    """The :class:`MeshSpec` a mesh realizes (unknown axis names refuse)."""
    if mesh is None:
        return MeshSpec()
    sizes = {}
    for name in mesh.axis_names:
        if name not in AXES:
            raise ValueError(f"mesh axis {name!r} not in {AXES}")
        sizes[name] = int(mesh.shape[name])
    return MeshSpec(**sizes)


# ------------------------------------------------------------ rule matching
def _children(tree) -> Optional[list]:
    """``[(key, child)]`` of a container in insertion order — dicts by
    key, lists and tuples by index, a module by ``named_parameters``, a
    dataclass by field — or ``None`` for a leaf."""
    from torch import nn

    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _tree_items(tree, path: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` in :func:`_children`'s order."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, v in kids:
        out += _tree_items(v, path + (k,))
    return out


def named_leaves(tree):
    """``[(name, leaf)]`` with '/'-joined names — the names the regex
    rules match (``generator/lstm0.kernel``, ``g_opt/nu/lstm1.bias``, a
    :class:`~hfrep_tpu_torch.train.states.GanState`'s ``step``)."""
    return [("/".join(p), leaf) for p, leaf in _tree_items(tree)]


def _rebuild(tree, leaves):
    """``tree``'s containers with ``leaves`` in :func:`named_leaves`'
    order (a module or dataclass becomes a dict of its leaves)."""
    it = iter(leaves)

    def walk(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        if isinstance(t, (list, tuple)):
            vals = [walk(v) for _, v in kids]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return {k: walk(v) for k, v in kids}

    return walk(tree)


def normalize_spec(spec: P, mesh) -> P:
    """Strip axis names the mesh does not carry (size-1 axes are not in
    ``mesh.axis_names``), so one rule set serves every mesh shape;
    ``mesh`` may be a :class:`Mesh` or a :class:`MeshSpec`."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    kept = [keep(e) for e in spec]
    while kept and kept[-1] is None:    # P(None, None) is not P(): trim
        kept.pop()
    return P(*kept)


def _is_scalar(leaf) -> bool:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return isinstance(leaf, (int, float, bool, np.number))
    return len(shape) == 0 or int(np.prod(shape)) <= 1


def match_partition_rules(rules, tree, mesh=None):
    """Tree of :class:`PartitionSpec` per ``rules`` over ``tree`` (same
    containers; a module or dataclass becomes a dict of its leaves).

    ``rules`` is a sequence of ``(regex, PartitionSpec)`` pairs matched
    (``re.search``) against each leaf's name, first match wins.  Scalar
    leaves always replicate.  A leaf no rule matches is a hard error
    naming it.  With ``mesh``, axis names it lacks are stripped."""
    specs = []
    for name, leaf in named_leaves(tree):
        if _is_scalar(leaf):
            specs.append(P())
            continue
        for pattern, ps in rules:
            if re.search(pattern, name) is not None:
                specs.append(normalize_spec(ps, mesh) if mesh is not None else ps)
                break
        else:
            raise ValueError(
                f"partition rule not found for param: {name!r} "
                f"(shape {tuple(getattr(leaf, 'shape', ()))}); every leaf must match "
                f"a rule — add one or extend the catch-all")
    return _rebuild(tree, specs)


def _is_spec(s) -> bool:
    return s is None or isinstance(s, PartitionSpec)


def broadcast_specs(tree, specs):
    """Align ``specs`` — one :class:`PartitionSpec` or a tree prefix of
    them — to ``tree``'s leaves: a flat list in :func:`named_leaves`'
    order (``None`` → replicated)."""
    if _is_spec(specs):
        return [specs if specs is not None else P()] * len(named_leaves(tree))
    kids = _children(tree)
    if kids is None:
        raise ValueError(f"spec tree {specs!r} is deeper than the tree it lays out")
    out = []
    for k, child in kids:
        sub = specs[k] if isinstance(specs, dict) else specs[int(k)]
        out += broadcast_specs(child, sub)
    return out


def _dim_blocks(spec: P, shape, mesh) -> list:
    """``[(dim, n blocks, this rank's block)]`` of a spec'd leaf."""
    coords, sizes = mesh.coords(), mesh.shape
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        n = int(np.prod([sizes[a] for a in axes]))
        idx = int(np.ravel_multi_index([coords[a] for a in axes],
                                       [sizes[a] for a in axes])) if axes else 0
        out.append((dim, n, idx))
    return out


def _check_divisible(name: str, leaf, spec: P, mesh) -> None:
    shape = tuple(getattr(leaf, "shape", ()))
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if n > 1 and shape[dim] % n:
            raise ValueError(
                f"cannot shard {name!r}: dimension {dim} (size {shape[dim]}) "
                f"is not divisible by the {'×'.join(axes)}={n} mesh extent")


def make_shard_and_gather_fns(mesh: Mesh, specs) -> Tuple[Callable, Callable]:
    """``(shard_fn, gather_fn)`` for host↔mesh movement.

    ``shard_fn(tree)`` gives every leaf's block for this rank under its
    spec, as a tensor on the mesh's device (divisibility checked leaf by
    leaf, the leaf named); ``gather_fn(tree)`` is the inverse: every
    rank's blocks joined into full host numpy arrays."""

    def shard_fn(tree):
        flat, flat_specs = named_leaves(tree), broadcast_specs(tree, specs)
        out = []
        for (name, leaf), spec in zip(flat, flat_specs):
            _check_divisible(name, leaf, spec, mesh)
            t = torch.as_tensor(leaf)
            for dim, n, idx in _dim_blocks(spec, t.shape, mesh):
                b = t.shape[dim] // n
                t = t.narrow(dim, idx * b, b)
            out.append(t.to(mesh.device))
        return _rebuild(tree, out)

    def gather_fn(tree):
        flat, flat_specs = named_leaves(tree), broadcast_specs(tree, specs)
        out = []
        for (_, leaf), spec in zip(flat, flat_specs):
            t = torch.as_tensor(leaf)
            for dim, n, _ in _dim_blocks(spec, t.shape, mesh):
                if n > 1:
                    if len(_dim_blocks(spec, t.shape, mesh)) > 1 or n != mesh.size:
                        raise NotImplementedError(
                            "gather of a leaf sharded over more than the whole 1-D mesh "
                            f"({spec}) waits for ROADMAP queue 1 item 9b")
                    t = mesh.all_gather_cat(t, dim)
            out.append(t.detach().cpu().numpy())
        return _rebuild(tree, out)

    return shard_fn, gather_fn


def shard_put(tree, mesh: Mesh, specs):
    """One-shot :func:`make_shard_and_gather_fns` shard."""
    shard_fn, _ = make_shard_and_gather_fns(mesh, specs)
    return shard_fn(tree)


# ------------------------------------------------------------- the dp hook
class DataShard:
    """The dp hook of a step (JAX's ``shard_data``): ``shard(x,
    batch_axis)`` is this rank's contiguous ``B/dp`` rows of a global-
    batch tensor, and :meth:`reduce` the global mean of a list of
    tensors, one all_reduce a call over one flat float32 buffer, in the
    list's order (every rank reduces the same list in the same order)."""

    def __init__(self, mesh: Mesh):
        mesh._need_group("the dp hook")
        self.mesh = mesh
        self.n = int(mesh.shape["dp"])
        self.rank = mesh.coords()["dp"]

    def __call__(self, x: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
        b = x.shape[batch_axis]
        if b % self.n:
            raise ValueError(f"global batch {b} not divisible by dp={self.n}")
        b //= self.n
        return x.narrow(batch_axis, self.rank * b, b)

    def reduce(self, tensors: Sequence[torch.Tensor]) -> list:
        import torch.distributed as dist

        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.mesh.group)
        flat.div_(self.n)
        _COLLECTIVES["all_reduce"] += 1
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[i:i + n].view(t.shape).to(t.dtype))
            i += n
        return out


def data_constraint(mesh: Optional[Mesh]) -> Optional[DataShard]:
    """The step's dp hook, or ``None`` — the literal single-device step,
    no collective — when the mesh has no dp extent to shard over."""
    if mesh is None:
        return None
    if int(mesh.shape.get("dp", 1)) <= 1:
        return None
    return DataShard(mesh)


# ------------------------------------------------------------- GAN rules
#: partition rules for the GAN train state over the port's names
#: (``generator/lstm0.kernel``, ``g_opt/nu/lstm1.bias``): ``tp`` would
#: shard every LSTM layer's gate columns; everything else replicates.  On
#: a mesh without ``tp`` the whole state replicates — the dp story.
GAN_PARTITION_RULES: Tuple[Tuple[str, P], ...] = (
    (r"lstm\d+\.(kernel|recurrent_kernel)$", P(None, "tp")),
    (r"lstm\d+\.bias$", P("tp")),
    (r".*", P()),
)

#: the lane-grid layout: every carry leaf leads with the grid's dataset
#: axis (``multi``) or lane axis (``lanes``), sharded over ``dp``
AE_LANE_SPEC = P("dp")
AE_LANE_RULES: Tuple[Tuple[str, P], ...] = ((r".*", AE_LANE_SPEC),)


def gan_state_specs(state, mesh):
    """Rule-resolved specs for a :class:`~hfrep_tpu_torch.train.states.GanState`."""
    return match_partition_rules(GAN_PARTITION_RULES, state, mesh)


def _validate_gan_mesh(pair, tcfg, dataset, mesh) -> MeshSpec:
    spec = mesh_spec(mesh)      # refuses unknown axis names
    if spec.sp > 1 or spec.tp > 1 or spec.pp > 1:
        raise ValueError(f"mesh {mesh.shape}: {ITEM_9B}")
    if spec.dp > 1 and tcfg.batch_size % spec.dp:
        raise ValueError(f"global batch {tcfg.batch_size} not divisible by dp={spec.dp}")
    return spec


def _launch_name(mesh, kind: str) -> str:
    """The JAX launch names: ``dp_multi_step``, ``dp_train_step``."""
    return f"{'_'.join(mesh.axis_names)}_{kind}"


def gan_launch_specs(pair, tcfg, dataset, mesh) -> P:
    """The state layout of a dp launch: replicated (one ``P()``)."""
    _validate_gan_mesh(pair, tcfg, dataset, mesh)
    return P()


def _gan_step(pair, tcfg, dataset, mesh, multi: bool):
    from hfrep_tpu_torch.train.steps import make_multi_step, make_train_step

    _validate_gan_mesh(pair, tcfg, dataset, mesh)
    step = make_train_step(pair, tcfg, dataset, shard_data=data_constraint(mesh))
    if multi:
        return make_multi_step(pair, tcfg, dataset, step=step)
    return step


def _gan_launch(tcfg, mesh, kind: str, fn, **attrs):
    from hfrep_tpu_torch.obs import instrument_launch

    return instrument_launch(fn, _launch_name(mesh, kind), tcfg=tcfg, mesh=mesh, **attrs)


def make_gan_train_step(pair, tcfg, dataset, mesh, *, instrument: bool = True, **attrs):
    """ONE epoch (n_critic critic updates + the generator update) across
    ``mesh``: ``step(state, draws)`` with the global batch's draws."""
    step = _gan_step(pair, tcfg, dataset, mesh, multi=False)
    return _gan_launch(tcfg, mesh, "train_step", step, **attrs) if instrument else step


def make_gan_multi_step(pair, tcfg, dataset, mesh, *, instrument: bool = True, **attrs):
    """``tcfg.steps_per_call`` epochs a call across ``mesh``, the
    trainer's block (``fn(state, draws=None, generator=None)``)."""
    fn = _gan_step(pair, tcfg, dataset, mesh, multi=True)
    return _gan_launch(tcfg, mesh, "multi_step", fn, **attrs) if instrument else fn


# ---------------------------------------------------------------- helpers
def lane_mesh(n_lanes: int, device: DeviceLike = None) -> Mesh:
    """A ``('dp',)`` mesh over every rank of the process group (the
    one-device mesh when there is none, or it has one rank).  A group of
    more than one rank whose size does not divide ``n_lanes`` is refused,
    naming the lane axis: JAX's lane mesh takes the largest divisor that
    fits its devices and leaves the rest idle, but a rank outside the
    mesh here would train the whole grid again and write the same
    snapshots as rank 0."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if n_lanes % world:
        raise ValueError(f"lane axis of size {n_lanes} not divisible by the {world} ranks "
                         "of the process group (a lane mesh spans every rank)")
    return build_mesh(MeshSpec(dp=world), device)
