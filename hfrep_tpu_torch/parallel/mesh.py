"""Device meshes and the process group (``hfrep_tpu/parallel/mesh.py``).

The scaling axis of this workload is data parallelism over the batch:
the models are ~200k parameters and a batch is (32, 48, 35) windows, so
the mesh is 1-D ``('dp',)``: one process a rank, each rank with its own
device, the gradients reduced across the process group.  Where JAX joins
a pod with ``jax.distributed.initialize`` and sees every device in
``jax.devices()``, each process here joins a ``torch.distributed``
process group over ``tcp://`` and builds the mesh as its rank sees it
(:class:`~hfrep_tpu_torch.parallel.rules.Mesh`).

The backend is a pure function of the ranks' devices
(:func:`~hfrep_tpu_torch.parallel.rules.choose_backend`): ``nccl`` when
each rank has a card of its own, ``gloo`` when ranks share a card or run
on the CPU.  Nothing falls back from one to the other.  Every group has
a finite timeout (:data:`DEFAULT_TIMEOUT_S`), so a dead peer fails the
run instead of hanging it.

:func:`make_mesh_2d` lays the group out as a dp × sp grid, dp
outermost; each axis longer than 1 of such a mesh runs its collectives
in a sub-group of its own.  Every layout the port launches (dp, sp, pp)
replicates the state, so :func:`replicate_to_global` is the one
promotion of host state to the mesh.
"""

from __future__ import annotations

import datetime
from typing import Optional

from hfrep_tpu_torch.config import MeshConfig
from hfrep_tpu_torch.core.device import DeviceLike
from hfrep_tpu_torch.parallel.rules import Mesh, choose_backend, make_named_mesh, rank_device

#: seconds a collective may wait for a peer before the run fails
DEFAULT_TIMEOUT_S = 300


def world_size() -> int:
    """Ranks in the default process group (1 when there is none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(cfg: Optional[MeshConfig] = None, device: DeviceLike = None) -> Mesh:
    """The 1-D mesh of ``cfg``: ``cfg.dp`` ranks (``-1``: every rank of
    the process group, one when there is none) over ``cfg.axis_name``."""
    cfg = cfg or MeshConfig()
    world = world_size()
    n = cfg.dp if cfg.dp > 0 else world
    if n > world:
        raise ValueError(f"requested {cfg.axis_name}={n} but the process group "
                         f"spans {world} rank(s)")
    return make_named_mesh((cfg.axis_name,), (n,), device)


def make_mesh_2d(dp: int, sp: int, device: DeviceLike = None) -> Mesh:
    """A composed ``('dp', 'sp')`` mesh of ``dp·sp`` ranks, dp
    outermost.  The process group must have exactly ``dp·sp`` ranks."""
    if dp < 1 or sp < 1:
        raise ValueError(f"dp×sp mesh dims must be >= 1, got {dp}×{sp}")
    world = world_size()
    if dp * sp > world:
        raise ValueError(f"requested dp×sp={dp}×{sp} but the process group spans "
                         f"{world} rank(s)")
    return make_named_mesh(("dp", "sp"), (dp, sp), device)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None) -> Optional[str]:
    """Join the process group before building a mesh; returns its backend.

    ``coordinator`` is ``host:port`` (rank 0 serves the store there), or
    ``file:///path`` (a file store every rank opens: no port to race for,
    for ranks of one host); every process runs the same command with its
    own ``process_id``.
    With no coordinator this is a no-op and returns ``None``, as in JAX.
    ``device`` is every rank's device rule (``None``: the card
    ``cuda:{rank % device_count}``; ``"cpu"``: the CPU)."""
    if coordinator is None:
        return None
    import torch
    import torch.distributed as dist

    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and --process-id")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    devices = [rank_device(device, r) for r in range(num_processes)]
    backend = choose_backend(devices)
    if devices[process_id].type == "cuda":
        torch.cuda.set_device(devices[process_id])
    init = coordinator if coordinator.startswith("file://") else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return backend


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def spans_processes(mesh: Optional[Mesh]) -> bool:
    """True when the mesh's collectives reach other processes."""
    return mesh is not None and mesh.spans_processes


def replicate_to_global(tree, mesh: Mesh, src: int = 0):
    """Make every rank hold rank ``src``'s bytes of ``tree``: each tensor
    (parameters, optimizer slots, a generator's state) is overwritten in
    place by a broadcast from ``src``, so ranks that built the same state
    from the same seed end bit-equal whatever their history.  Returns the
    tree; a one-device mesh returns it untouched."""
    import torch

    if not spans_processes(mesh):
        return tree
    from hfrep_tpu_torch.parallel.rules import named_leaves

    for _, leaf in named_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            mesh.broadcast_(leaf.data if isinstance(leaf, torch.nn.Parameter) else leaf, src)
    return tree

