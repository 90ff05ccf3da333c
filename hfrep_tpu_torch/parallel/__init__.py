"""Parallelism (``hfrep_tpu/parallel``): the mesh core, the data- and
window-parallel launch (``dp``, ``sp``, composed ``dp_sp``) and the layer
pipeline (``pp``).  The hidden-unit axis (JAX's ``tensor`` and
``dp_sp_tp``) is ROADMAP queue 1 item 9c; JAX's ``_compat`` re-exports a
``shard_map`` gate and has no counterpart, and JAX's
``make_dp_multi_step`` is :func:`make_gan_multi_step` under another
name."""

from __future__ import annotations

from hfrep_tpu_torch.parallel.dp_sp import (  # noqa: F401
    make_dp_sp_multi_step,
    make_dp_sp_train_step,
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
    replicate_to_global,
    shutdown_distributed,
    spans_processes,
)
from hfrep_tpu_torch.parallel.rules import (  # noqa: F401
    Mesh,
    MeshSpec,
    build_mesh,
    data_constraint,
    lane_mesh,
    make_gan_multi_step,
    make_gan_train_step,
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
