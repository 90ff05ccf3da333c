"""One mesh for the launch paths and the GAN step's mesh hook
(``hfrep_tpu/parallel/rules.py``).

* **one mesh** — :class:`MeshSpec` declares ``dp``/``sp``/``tp``/``pp``
  as axis sizes; :func:`build_mesh` turns it into the :class:`Mesh` one
  process sees: the axis names and sizes, this rank's position and
  device, and the process group its collectives run in.  A one-device
  mesh needs no process group and holds none; a larger one needs the
  default group that :func:`~hfrep_tpu_torch.parallel.mesh.
  initialize_distributed` made, of exactly its size, and runs its
  collectives there (an axis of a mesh with two axes longer than 1 in a
  sub-group of its own, :meth:`Mesh.axis_group`).  It is not wrapped in
  a ``DeviceMesh``: with a card present and a gloo default group (ranks
  sharing the card), a ``DeviceMesh`` makes a second gloo group of the
  same ranks without the group's finite timeout.
* **the step hook** — :func:`data_constraint` returns it
  (:class:`DataShard`).  Every rank draws the whole global batch from
  the same seeded generator (JAX's global-stream semantics, its only
  mode) and keeps its block of it: its contiguous ``B/dp`` rows, and on
  an ``sp`` mesh its contiguous ``W/sp`` window chunk (a tp rank the
  same block as its tp peers).  Every gradient
  is reduced over the mesh before the optimizer touches it (a mean over
  ``dp``, a sum of the ranks' partials over an inner axis), every loss
  to its mean over ``dp``; the state stays replicated and bit-equal
  across ranks.  On a mesh with no axis longer than 1 the hook is
  ``None`` and the step is literally the single-device one: no
  collective, no extra launch.
* **the data-parallel launch** — :func:`make_gan_train_step` /
  :func:`make_gan_multi_step` build the single-device step with that
  hook on a ``dp`` mesh.  The window axis ``sp`` is
  :mod:`~hfrep_tpu_torch.parallel.sequence`'s launch (its forwards run
  the window chunks with carry handoffs between the ranks), the layer
  axis ``pp`` :mod:`~hfrep_tpu_torch.parallel.layer_pipeline`'s, the
  hidden-unit axis ``tp`` :mod:`~hfrep_tpu_torch.parallel.tensor`'s and
  sp with tp :mod:`~hfrep_tpu_torch.parallel.dp_sp_tp`'s; each builds the
  same step with the same hook and its own ``apply_fns``.
* **the compute layout** — :data:`GAN_PARTITION_RULES`, JAX's rule
  table (leaf name pattern → which axis of the leaf ``tp`` slices),
  resolved over the port's named leaves by :func:`match_partition_rules`
  (:func:`gan_state_specs` for a whole state, the optimizer slots
  included).  It says what a tp rank computes, not what it holds: every
  rank holds the whole state, replicated and bit-equal, and takes its
  gate columns of a sliced leaf at each call
  (:mod:`~hfrep_tpu_torch.parallel.tensor`); the hook keeps a replicated
  leaf's gradient on tp rank 0 alone, so the one all_reduce of an update
  sums every leaf exactly.

JAX's ``_resolve_mesh_backend`` keeps GSPMD from partitioning an opaque
Pallas call; here no partitioner looks inside a kernel.  Each dp, sp or
pp rank launches the hand kernels on its own block; a tp rank's rec is
(H, 4H/tp), which no kernel takes, so its recurrence runs step by step
in torch ops, as JAX's tp runs the XLA scan, and ``lstm_backend='pallas'``
is refused there with JAX's message (:func:`validate_tp`).
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
_COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "send": 0, "recv": 0}


def count_collective(kind: str) -> None:
    _COLLECTIVES[kind] += 1


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
    group's backend; ``axis_groups`` the sub-group of each axis on a mesh
    with more than one axis longer than 1 (:func:`make_named_mesh`)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device
    rank: int = 0
    group: Any = None
    backend: Optional[str] = None
    axis_groups: Optional[dict] = None

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

    def axis_group(self, axis: str):
        """The process group of the ranks that share this rank's
        coordinates on every other axis: the mesh's own group when no
        other axis is longer than 1."""
        self._need_group(f"a collective over {axis!r}")
        if self.axis_groups is None:
            return self.group
        return self.axis_groups[self.axis_names.index(axis)]

    @property
    def wire_device(self) -> torch.device:
        """Where the backend takes tensors for point-to-point transfers:
        the host under gloo, the card under NCCL."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

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
    rank = dist.get_rank()
    return Mesh(names, sizes, dev, rank=rank, group=dist.group.WORLD,
                backend=dist.get_backend(), axis_groups=_axis_groups(sizes, rank))


def _axis_groups(sizes: Tuple[int, ...], rank: int) -> Optional[dict]:
    """Every axis's sub-group holding ``rank`` when more than one axis is
    longer than 1 (else ``None``: each axis spans the whole group).
    Every rank creates every sub-group, in the same order, as
    ``new_group`` requires; each keeps its own."""
    if sum(s > 1 for s in sizes) < 2:
        return None
    import datetime

    import torch.distributed as dist

    from hfrep_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    mine = {}
    for i in range(len(sizes)):
        if sizes[i] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
            if rank in ranks:
                mine[i] = g
    return mine


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
    if isinstance(tree, (list, tuple)):
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


# ------------------------------------------------------ the compute layout
#: JAX's ``GAN_PARTITION_RULES`` over the port's leaf names: ``tp`` slices
#: every LSTM layer's gate columns (``kernel`` (F, 4H) and
#: ``recurrent_kernel`` (H, 4H) on their 4H axis, ``bias`` (4H,) on its
#: only one), everything else (Dense heads, LayerNorms) is replicated.  A
#: spec is JAX's ``PartitionSpec`` as a tuple: one entry a leading axis of
#: the leaf, the mesh axis that slices it or ``None``; ``()`` replicates.
#: The optimizer slots carry their parameter's name, so they match too.
GAN_PARTITION_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"lstm\d+\.(kernel|recurrent_kernel)$", (None, "tp")),
    (r"lstm\d+\.bias$", ("tp",)),
    (r".*", ()),
)


def normalize_spec(spec: tuple, mesh) -> tuple:
    """``spec`` without the axis names ``mesh`` lacks (an axis of size 1
    counts as absent), trailing ``None`` entries trimmed: one rule set
    serves every mesh."""
    names = {n for n, s in zip(mesh.axis_names, mesh.axis_sizes) if s > 1}
    kept = [e if e in names else None for e in spec]
    while kept and kept[-1] is None:
        kept.pop()
    return tuple(kept)


def match_partition_rules(rules, tree, mesh=None) -> dict:
    """``{name: spec}`` over :func:`named_leaves` of ``tree``, in their
    order: the first rule whose pattern ``re.search``-es the name wins; a
    scalar (no shape, or one element) is always replicated; a leaf no rule
    matches raises, naming its path.  With ``mesh``, each spec is
    :func:`normalize_spec`-ed to it."""
    specs = {}
    for name, leaf in named_leaves(tree):
        shape = getattr(leaf, "shape", None)
        if shape is None or len(shape) == 0 or int(np.prod(shape)) <= 1:
            specs[name] = ()
            continue
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                specs[name] = spec if mesh is None else normalize_spec(spec, mesh)
                break
        else:
            raise ValueError(f"partition rule not found for param: {name!r} (shape "
                             f"{tuple(shape)}); every leaf must match a rule — add one or "
                             "extend the catch-all")
    return specs


def gan_state_specs(state, mesh) -> dict:
    """The rule table resolved over a whole
    :class:`~hfrep_tpu_torch.train.states.GanState` on ``mesh``."""
    return match_partition_rules(GAN_PARTITION_RULES, state, mesh)


def sliced_axis(name: str) -> Optional[int]:
    """The axis of leaf ``name`` that ``tp`` slices by the rule table, or
    ``None`` for a replicated leaf."""
    for pattern, spec in GAN_PARTITION_RULES:
        if re.search(pattern, name) is not None:
            return spec.index("tp") if "tp" in spec else None
    return None


# ---------------------------------------------------------- the step hook
class DataShard:
    """The step's mesh hook (JAX's ``shard_data``).

    ``shard(x, batch_axis)`` is this rank's block of a global-batch
    tensor, by JAX's layout rule (``data_constraint``'s hint): its
    contiguous ``B/dp`` rows, and where ``x`` has a window axis after the
    batch axis and a feature axis after that, its contiguous ``W/sp``
    window chunk; :meth:`window` the chunk alone.  :meth:`reduce` is one
    all_reduce a call over one flat float32 buffer of a list of tensors,
    in the list's order (every rank reduces the same list in the same
    order): the first ``partials`` tensors are this rank's partial sums
    over the axes ``inner`` (a window chunk's gradient under sp, a
    stage's under pp), summed over them and averaged over dp; the rest
    (losses, accuracies) are equal across ``inner`` and averaged over dp.
    On a mesh with a ``tp`` axis ``names`` gives the partials' leaf names:
    a sliced leaf's partial is its own gate columns' (zeros elsewhere), a
    replicated leaf's is whole on every tp rank, so tp rank 0 alone keeps
    it (:func:`sliced_axis`).  ``sum_window`` completes a rank-local per-sample sum over the window
    (the penalty's squared norms of a window-sharded input gradient):
    ``None`` where every rank holds whole windows, else the window
    launch's differentiable sum over sp."""

    def __init__(self, mesh: Mesh, inner: Sequence[str] = (),
                 sum_window: Optional[Callable] = None):
        mesh._need_group("the step's mesh hook")
        shape, coords = mesh.shape, mesh.coords()
        self.mesh = mesh
        self.n, self.rank = int(shape.get("dp", 1)), coords.get("dp", 0)
        self.n_sp, self.sp_rank = int(shape.get("sp", 1)), coords.get("sp", 0)
        self.n_tp, self.tp_rank = int(shape.get("tp", 1)), coords.get("tp", 0)
        self.inner = int(np.prod([shape.get(a, 1) for a in inner]))
        self.sum_window = sum_window

    def __call__(self, x: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
        if self.n > 1:
            b = x.shape[batch_axis]
            if b % self.n:
                raise ValueError(f"global batch {b} not divisible by dp={self.n}")
            b //= self.n
            x = x.narrow(batch_axis, self.rank * b, b)
        if x.dim() > batch_axis + 2 and x.shape[batch_axis + 1] > 1:
            x = self.window(x, batch_axis + 1)
        return x

    def window(self, x: torch.Tensor, w_axis: int) -> torch.Tensor:
        if self.n_sp == 1:
            return x
        w = x.shape[w_axis]
        if w % self.n_sp:
            raise ValueError(f"window {w} not divisible by sp={self.n_sp}")
        w //= self.n_sp
        return x.narrow(w_axis, self.sp_rank * w, w)

    def reduce(self, tensors: Sequence[torch.Tensor], partials: int = 0,
               names: Optional[Sequence[str]] = None) -> list:
        import torch.distributed as dist

        parts = [t.detach().reshape(-1).float() for t in tensors]
        if self.n_tp > 1 and self.tp_rank:
            if names is None or len(names) != partials:
                raise ValueError("a tp mesh's reduction needs the partials' leaf names")
            # a replicated leaf's partial is swapped for zeros in this list, never
            # zeroed in place (``parts`` may be views of the caller's gradients)
            parts = [torch.zeros_like(t) if i < partials and sliced_axis(names[i]) is None
                     else t for i, t in enumerate(parts)]
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=self.mesh.group)
        if self.inner == 1:
            flat.div_(self.n)
        else:
            k = sum(t.numel() for t in tensors[:partials])
            flat[:k].div_(self.n)
            flat[k:].div_(self.n * self.inner)
        _COLLECTIVES["all_reduce"] += 1
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[i:i + n].view(t.shape).to(t.dtype))
            i += n
        return out


def data_constraint(mesh: Optional[Mesh],
                    sum_window: Optional[Callable] = None) -> Optional[DataShard]:
    """The step's mesh hook, or ``None`` — the literal single-device
    step, no collective — when the mesh has no dp, sp or tp extent to
    shard over.  ``sum_window`` is the hook's (:class:`DataShard`)."""
    if mesh is None:
        return None
    shape = mesh.shape
    if all(int(shape.get(a, 1)) <= 1 for a in ("dp", "sp", "tp")):
        return None
    inner = tuple(a for a in ("sp", "tp") if int(shape.get(a, 1)) > 1)
    return DataShard(mesh, inner=inner, sum_window=sum_window)


# ---------------------------------------------------------- the GAN launch
def validate_mesh(tcfg, mesh) -> MeshSpec:
    """The checks the dp, sp and tp launches share: known axis names, no
    pp axis (the layer pipeline's own schedule), the batch divisible by
    dp."""
    spec = mesh_spec(mesh)      # refuses unknown axis names
    if spec.pp > 1:
        raise ValueError("pp is the layer_pipeline.py axis (make_pp_train_step, its own "
                         "schedule); the mesh launch shards dp and sp, the tensor.py "
                         "launch tp")
    if spec.dp > 1 and tcfg.batch_size % spec.dp:
        raise ValueError(f"global batch {tcfg.batch_size} not divisible by dp={spec.dp}")
    return spec


def validate_tp(pair, tcfg, mesh) -> MeshSpec:
    """JAX's tp checks (``_validate_gan_mesh``, ``_resolve_mesh_backend``)
    with its messages: the ``mtss_wgan_gp`` family, hidden widths tp
    divides, no ``lstm_backend='pallas'``.  Like JAX's, they put no rule
    on the dtype or on health: a tp rank runs the single-device step's
    precision policy on its gate columns, and health reads the reduced
    gradients and the replicated state, the same on every rank.  A mesh
    whose tp extent is 1 passes."""
    spec = validate_mesh(tcfg, mesh)
    if spec.tp > 1:
        if pair.family != "mtss_wgan_gp":
            raise ValueError(f"tp (hidden-unit) sharding supports the mtss_wgan_gp family's "
                             f"LSTM stacks, got {pair.family!r}")
        for h in sorted({int(pair.generator.lstm0.features),
                         int(pair.discriminator.lstm0.features)}):
            if h % spec.tp:
                raise ValueError(f"hidden width {h} not divisible by tp={spec.tp} devices")
        if tcfg.lstm_backend == "pallas":
            raise ValueError("lstm_backend='pallas' cannot be GSPMD-partitioned over a "
                             f"{spec.size}-device mesh; use 'auto' (resolves to the xla scan "
                             "on multi-device meshes) or 'xla'")
    return spec


def _gan_step(pair, tcfg, dataset, mesh):
    from hfrep_tpu_torch.train.steps import make_train_step

    spec = validate_mesh(tcfg, mesh)
    if spec.sp > 1:
        raise ValueError("sp is the sequence.py axis (make_sp_train_step, the window-chunk "
                         "forwards); make_gan_train_step shards dp")
    if spec.tp > 1:
        raise ValueError("tp is the tensor.py axis (make_tp_train_step, the gate-column "
                         "forwards); make_gan_train_step shards dp")
    return make_train_step(pair, tcfg, dataset, shard_data=data_constraint(mesh))


def _launch_name(mesh, kind: str) -> str:
    """The JAX launch names: ``dp_multi_step``, ``sp_train_step``,
    ``dp_sp_multi_step``, ..."""
    return f"{'_'.join(mesh.axis_names)}_{kind}"


def instrument_mesh_launch(fn, tcfg, mesh, kind: str, **attrs):
    """``fn`` as a mesh launch under JAX's name for it."""
    from hfrep_tpu_torch.obs import instrument_launch

    return instrument_launch(fn, _launch_name(mesh, kind), tcfg=tcfg, mesh=mesh, **attrs)


def make_gan_train_step(pair, tcfg, dataset, mesh, **attrs):
    """ONE epoch (n_critic critic updates + the generator update) across
    ``mesh``: ``step(state, draws)`` with the global batch's draws;
    ``attrs`` go to the launch's telemetry."""
    return instrument_mesh_launch(_gan_step(pair, tcfg, dataset, mesh), tcfg, mesh,
                                  "train_step", **attrs)


def make_gan_multi_step(pair, tcfg, dataset, mesh, **attrs):
    """``tcfg.steps_per_call`` epochs a call across ``mesh``, the
    trainer's block (``fn(state, draws=None, generator=None)``)."""
    from hfrep_tpu_torch.train.steps import make_multi_step

    fn = make_multi_step(pair, tcfg, dataset, step=_gan_step(pair, tcfg, dataset, mesh))
    return instrument_mesh_launch(fn, tcfg, mesh, "multi_step", **attrs)


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
