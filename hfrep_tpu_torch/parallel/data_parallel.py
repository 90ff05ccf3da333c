"""Data-parallel GAN training (``hfrep_tpu/parallel/data_parallel.py``):
the single-device block launched on a ``('dp',)`` mesh, each rank on its
rows of the global batch, the gradients reduced to the global mean
(:mod:`hfrep_tpu_torch.parallel.rules`).  JAX's ``controlled_sampling``
flag has no counterpart: the launch always follows the single-device
draws, JAX's only mode."""

from __future__ import annotations

from hfrep_tpu_torch.parallel.rules import Mesh, make_gan_multi_step


def make_dp_multi_step(pair, tcfg, dataset, mesh: Mesh):
    """``tcfg.steps_per_call`` data-parallel epochs a call."""
    return make_gan_multi_step(pair, tcfg, dataset, mesh)
