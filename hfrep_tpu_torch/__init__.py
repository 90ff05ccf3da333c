"""hfrep_tpu_torch — the PyTorch/CUDA port of ``hfrep_tpu``.

The JAX package beside this one is the reference; this package holds
its counterpart module by module (same layout: ``config``, ``core``,
``ops``, ``models``, ``train``, ``replication``, ``metrics``,
``scenario``, ``serve``, ``obs``, ``resilience``, ``orchestrate``,
``experiments``, ``utils``), imports ``torch`` and never
``jax``, and keeps its own copy of anything it needs from the JAX
package.  Every Pallas kernel on a ported path is a kernel written by
hand for Hopper under ``csrc/``, built with ``nvcc`` at first use
(:mod:`hfrep_tpu_torch.ops._build`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a machine with no card a call that did not ask for the CPU raises
(:func:`hfrep_tpu_torch.core.device.resolve_device`).

Importing this package builds nothing and loads no kernel.
"""

import os

# The CPU path's matmuls run in MKL, whose GEMM is not reproducible from
# run to run in its default mode: at two threads the first projection of
# a process's generator forward came out in a second bit pattern in 8 of
# 600 fresh processes under load (2 of 600 in plain AUTO, 0 of 600 in
# AUTO,STRICT; tools/torch_cpu_drift.py), and the pipeline's resume
# contract rests on items being pure functions of their coordinates.
# MKL's strict conditional numerical reproducibility in its AUTO branch
# (the fastest code path for the processor) gives the same bits in every
# run at a given thread count, the bits the default mode gives in most
# runs.  MKL reads the setting at its first call, so it is set here,
# before the port makes one; an explicit MKL_CBWR wins.
os.environ.setdefault("MKL_CBWR", "AUTO,STRICT")
