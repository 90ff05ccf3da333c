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
