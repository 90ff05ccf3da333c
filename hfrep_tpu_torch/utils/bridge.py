"""JAX parameter trees ↔ the port's modules.

The JAX package's params, turned into nested dicts of numpy arrays by
``jax.tree_util.tree_map(np.asarray, params)``, load into the port's
modules with :func:`from_flax` and come back out with :func:`to_flax`.
The port keeps the Keras layout in its parameters (``kernel`` is
(in, out)), so the bridge copies and never transposes.

Names: a module class's ``FLAX_NAMES`` maps a Flax submodule name
(``KerasLSTM_0``) to the attribute holding its counterpart (``lstm0``);
every generator and critic class carries one.
A conditional network (``models/conditional.py``) nests its body under
``body``, as Flax names the field.
Flax's inner wrappers (``LayerNorm_0`` inside ``KerasLayerNorm``,
``Dense_0`` inside ``KerasDense``) have no module of their own here:
their params live on the Keras-level module.
"""

from __future__ import annotations

import copy
from typing import Mapping

import numpy as np
import torch
from torch import nn

#: Flax submodules whose params the port holds one level up
_FLATTENED = ("LayerNorm_0", "Dense_0")


def _child(module: nn.Module, name: str) -> nn.Module:
    names = getattr(type(module), "FLAX_NAMES", {})
    if name not in names:
        raise KeyError(f"{type(module).__name__} has no counterpart of "
                       f"Flax submodule {name!r}")
    return getattr(module, names[name])


def from_flax(tree: Mapping, module: nn.Module) -> nn.Module:
    """Copy ``tree`` (nested dicts of arrays) into ``module``'s
    parameters in place; shapes must agree exactly.  Returns ``module``."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            target = module if key in _FLATTENED else _child(module, key)
            from_flax(value, target)
            continue
        param = getattr(module, key, None)
        if not isinstance(param, torch.Tensor):
            raise KeyError(f"{type(module).__name__} has no parameter {key!r}")
        src = torch.from_numpy(np.array(value))
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{type(module).__name__}.{key}: JAX shape "
                             f"{tuple(src.shape)} vs port {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(src.to(param.dtype))
    return module


def to_flax(module: nn.Module) -> dict:
    """The inverse of :func:`from_flax`: the module's parameters as the
    JAX package's nested dict of numpy arrays."""
    from hfrep_tpu_torch.ops.layers import KerasDense, KerasLayerNorm

    own = {k: p.detach().cpu().numpy() for k, p in module.named_parameters(recurse=False)}
    if isinstance(module, KerasLayerNorm):
        own = {"LayerNorm_0": own}
    elif isinstance(module, KerasDense):
        own = {"Dense_0": own}
    for flax_name, attr in getattr(type(module), "FLAX_NAMES", {}).items():
        own[flax_name] = to_flax(getattr(module, attr))
    return own


def gan_state_from_flax(g_tree: Mapping, d_tree: Mapping, pair):
    """A fresh training state (zero optimizer slots) whose networks are
    copies of ``pair``'s carrying the JAX param trees ``g_tree`` (the
    generator's) and ``d_tree`` (the critic's)."""
    from hfrep_tpu_torch.train.states import fresh_state

    gen = from_flax(g_tree, copy.deepcopy(pair.generator))
    disc = from_flax(d_tree, copy.deepcopy(pair.discriminator))
    return fresh_state(pair.loss, gen, disc)


def _slots_from_optax(opt_state, module: nn.Module, loss: str) -> dict:
    """The port's optimizer slots for ``module`` from an optax state as
    numpy: RMSprop's ``(ScaleByRmsState(nu), ...)`` or Adam's
    ``(ScaleByAdamState(count, mu, nu), ...)``."""
    from hfrep_tpu_torch.train.states import Adam, optimizer_class

    first = opt_state[0]

    def by_name(tree) -> dict:
        holder = from_flax(tree, copy.deepcopy(module))
        return {k: p.detach().clone() for k, p in holder.named_parameters()}

    if optimizer_class(loss) is Adam:
        return {"mu": by_name(first.mu), "nu": by_name(first.nu),
                "count": int(np.asarray(first.count))}
    return {"nu": by_name(first.nu)}


def gan_state_from_jax(state, pair):
    """A training state carrying a whole JAX ``GanState`` whose leaves
    are numpy arrays (``jax.tree_util.tree_map(np.asarray, state)``):
    the params into copies of ``pair``'s networks, the optax RMSprop
    ``nu`` or Adam ``mu``/``nu``/``count`` into the port's slots, and
    ``step``.  A conditional pair's state (``init_conditional_state``)
    carries across the same way, its trees nested under ``body``."""
    from hfrep_tpu_torch.train.states import GanState

    gen = from_flax(state.g_params, copy.deepcopy(pair.generator))
    disc = from_flax(state.d_params, copy.deepcopy(pair.discriminator))
    return GanState(generator=gen, discriminator=disc,
                    g_opt=_slots_from_optax(state.g_opt, gen, pair.loss),
                    d_opt=_slots_from_optax(state.d_opt, disc, pair.loss),
                    step=int(np.asarray(state.step)))
