"""Training state and optimizers (``hfrep_tpu/train/states.py``).

Optimizer hyperparameters mirror the reference with Keras's defaults made
explicit: ``Adam(2e-4, beta_1=0.5)`` with eps=1e-7 for the BCE families,
``RMSprop(5e-5)`` with rho=0.9/eps=1e-7 for the Wasserstein families —
each network with slots of its own.  Both are written out in optax's
form (``optax.adam``, ``optax.rmsprop``), which the JAX package runs:
``torch.optim.RMSprop`` puts eps outside the root and defaults to
alpha=0.99, so it would be another optimizer.

:class:`GanState` holds the two networks (their parameters are the
training state, updated in place), the optimizer slots and the epoch
count.  The JAX state is an immutable pytree; :meth:`GanState.to` makes
the copy a caller needs to run one epoch twice.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.models.registry import GanPair, build_gan

Params = Dict[str, torch.Tensor]


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


class RMSprop:
    """``optax.rmsprop(lr, decay, eps)``: ν ← (1−decay)·g² + decay·ν and
    p ← p + (−lr)·(rsqrt(ν + eps)·g); ν starts at zero."""

    def __init__(self, lr: float, decay: float = 0.9, eps: float = 1e-7):
        self.lr, self.decay, self.eps = lr, decay, eps

    @staticmethod
    def init(params: Params) -> dict:
        return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, slots: dict) -> None:
        for k, p in params.items():
            g = grads[k]
            nu = (1 - self.decay) * g ** 2 + self.decay * slots["nu"][k]
            slots["nu"][k] = nu
            p.add_(-self.lr * (torch.rsqrt(nu + self.eps) * g))


class Adam:
    """``optax.adam(lr, b1, b2, eps)``: μ ← (1−b1)·g + b1·μ,
    ν ← (1−b2)·g² + b2·ν, then the bias-corrected μ̂ / (√ν̂ + eps)
    scaled by −lr.  The corrections 1 − bᵗ are float32, as optax forms
    them."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    @staticmethod
    def init(params: Params) -> dict:
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, slots: dict) -> None:
        count = slots["count"] + 1
        slots["count"] = count
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        for k, p in params.items():
            g = grads[k]
            mu = (1 - self.b1) * g + self.b1 * slots["mu"][k]
            nu = (1 - self.b2) * g ** 2 + self.b2 * slots["nu"][k]
            slots["mu"][k], slots["nu"][k] = mu, nu
            mu_hat = mu / bc1.to(mu.device)
            nu_hat = nu / bc2.to(nu.device)
            p.add_(-self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)))


def optimizer_class(loss: str) -> type:
    """Adam for the BCE families, RMSprop for the Wasserstein ones."""
    return Adam if loss == "bce" else RMSprop


def make_optimizers(pair: GanPair, tcfg: TrainConfig) -> Tuple[object, object]:
    """(generator optimizer, critic optimizer) for the pair's loss kind."""
    if optimizer_class(pair.loss) is Adam:
        opt = lambda: Adam(tcfg.adam_lr, b1=tcfg.adam_b1, b2=0.999, eps=1e-7)  # noqa: E731
    else:
        opt = lambda: RMSprop(tcfg.rmsprop_lr, decay=0.9, eps=1e-7)  # noqa: E731
    return opt(), opt()


def params_of(module: nn.Module) -> Params:
    """A network's parameters by name: the keys of its optimizer slots."""
    return dict(module.named_parameters())


@dataclasses.dataclass
class GanState:
    """The networks (updated in place by a step), their optimizer slots
    and the number of generator updates taken."""

    generator: nn.Module
    discriminator: nn.Module
    g_opt: dict
    d_opt: dict
    step: int = 0

    def to(self, device: DeviceLike) -> "GanState":
        """A deep copy of the whole state on ``device``."""
        dev = resolve_device(device)
        move = lambda t: t.detach().to(dev).clone()  # noqa: E731
        return GanState(generator=copy.deepcopy(self.generator).to(dev),
                        discriminator=copy.deepcopy(self.discriminator).to(dev),
                        g_opt=_map(move, self.g_opt), d_opt=_map(move, self.d_opt),
                        step=self.step)


def fresh_state(loss: str, generator: nn.Module,
                discriminator: nn.Module) -> GanState:
    """A state over these networks with zero optimizer slots for ``loss``."""
    opt = optimizer_class(loss)
    return GanState(generator=generator, discriminator=discriminator,
                    g_opt=opt.init(params_of(generator)),
                    d_opt=opt.init(params_of(discriminator)), step=0)


def init_gan_state(seed: int, mcfg: ModelConfig,
                   device: DeviceLike = None) -> GanState:
    """Fresh Keras-default networks for ``mcfg`` on ``device`` (``None``:
    the card) — the generator first, then the critic, from one CPU
    ``torch.Generator`` seeded with ``seed``, so a seed gives the same
    weights on every device — and zero optimizer slots.  The JAX
    signature's ``tcfg`` only picks the optimizer there; the slots depend
    on the loss kind alone, which ``mcfg.family`` gives."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    pair = build_gan(mcfg, device=device, generator=gen)
    return fresh_state(pair.loss, pair.generator, pair.discriminator)


def init_conditional_state(seed: int, mcfg: ModelConfig, cond_dim: int,
                           device: DeviceLike = None) -> GanState:
    """:func:`init_gan_state` for a conditional pair: both networks take
    ``(input, cond)``, their first layers ``features + cond_dim`` wide
    (:func:`~hfrep_tpu_torch.models.conditional.build_conditional_gan`),
    from one CPU generator seeded with ``seed``, the generator first."""
    from hfrep_tpu_torch.models.conditional import build_conditional_gan

    gen = torch.Generator()
    gen.manual_seed(seed)
    pair = build_conditional_gan(mcfg, cond_dim, device=device, generator=gen)
    return fresh_state(pair.loss, pair.generator, pair.discriminator)
