"""Parallelism (``hfrep_tpu/parallel``): the mesh core, the data- and
window-parallel launch (``dp``, ``sp``, composed ``dp_sp``), the layer
pipeline (``pp``), the hidden-unit axis (``tp``, composed ``dp_tp``) and
the full ``dp_sp_tp``.  JAX's ``_compat`` re-exports a ``shard_map`` gate
and has no counterpart; JAX's ``make_dp_multi_step`` is
:func:`make_gan_multi_step` under another name; JAX's ``shard_to_global``
promotes a sharded state to global arrays, and every layout here keeps
the state whole and replicated on every rank (a tp rank slices its gate
columns at each call), so :func:`replicate_to_global` is the one
promotion."""

from __future__ import annotations

from hfrep_tpu_torch.parallel.dp_sp import (  # noqa: F401
    make_dp_sp_multi_step,
    make_dp_sp_train_step,
)
from hfrep_tpu_torch.parallel.dp_sp_tp import (  # noqa: F401
    make_dp_sp_tp_multi_step,
    make_dp_sp_tp_train_step,
)
from hfrep_tpu_torch.parallel.layer_pipeline import (  # noqa: F401
    make_pp_train_step,
    pp_critic,
    pp_generate,
)
from hfrep_tpu_torch.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    make_mesh_3d,
    replicate_to_global,
    shutdown_distributed,
    spans_processes,
)
from hfrep_tpu_torch.parallel.rules import (  # noqa: F401
    GAN_PARTITION_RULES,
    Mesh,
    MeshSpec,
    build_mesh,
    data_constraint,
    lane_mesh,
    make_gan_multi_step,
    make_gan_train_step,
    match_partition_rules,
    mesh_spec,
)
from hfrep_tpu_torch.parallel.sequence import (  # noqa: F401
    make_sp_multi_step,
    make_sp_train_step,
    sp_critic,
    sp_generate,
    sp_lstm,
    sp_microbatch_plan,
)
from hfrep_tpu_torch.parallel.tensor import (  # noqa: F401
    make_dp_tp_multi_step,
    make_dp_tp_train_step,
    make_tp_multi_step,
    make_tp_train_step,
    tp_critic,
    tp_generate,
)
