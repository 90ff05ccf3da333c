"""Parallelism (``hfrep_tpu/parallel``): the mesh core and the
data-parallel launch.  The sp, tp and pp entry points (``sequence``,
``tensor``, ``layer_pipeline``, ``dp_sp``, ``dp_sp_tp``,
``make_mesh_2d/3d``, ``shard_to_global``) are ROADMAP queue 1 item 9b;
JAX's ``_compat`` re-exports a ``shard_map`` gate and has no
counterpart."""

from __future__ import annotations

from hfrep_tpu_torch.parallel.data_parallel import make_dp_multi_step  # noqa: F401
from hfrep_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    replicate_to_global,
    shutdown_distributed,
    spans_processes,
)
from hfrep_tpu_torch.parallel.rules import (  # noqa: F401
    AE_LANE_RULES,
    AE_LANE_SPEC,
    GAN_PARTITION_RULES,
    Mesh,
    MeshSpec,
    PartitionSpec,
    build_mesh,
    data_constraint,
    lane_mesh,
    make_gan_multi_step,
    make_gan_train_step,
    make_shard_and_gather_fns,
    match_partition_rules,
    mesh_spec,
    shard_put,
)
