"""Composed data × sequence parallelism (``hfrep_tpu/parallel/dp_sp.py``):
JAX's names for the launch on one ``('dp', 'sp')`` mesh, the batch over
``dp`` and the window over ``sp``.  They are
:mod:`~hfrep_tpu_torch.parallel.sequence`'s builders, which shard both
axes; JAX's ``controlled_sampling`` has no counterpart (every rank
follows the single-device draws, the launch's one mode)."""

from __future__ import annotations

from hfrep_tpu_torch.parallel.sequence import make_sp_multi_step, make_sp_train_step

make_dp_sp_train_step = make_sp_train_step
make_dp_sp_multi_step = make_sp_multi_step
