"""tf.keras-exact Nadam over a lane grid (``hfrep_tpu/ops/optimizers.py``).

The reference's AE compiles with a bare ``Nadam()`` under 2022-era
tf.keras: lr=1e-3, beta_1=0.9, beta_2=0.999, epsilon=1e-7, and Dozat's
update with the momentum schedule ``u_t = beta1 * (1 - 0.5 * 0.96**t)``.
``torch.optim.NAdam`` is another rule (it scales the schedule's exponent
by ``momentum_decay=0.004``), so this is written out by hand.

The state is kept per lane: every tensor's leading ``lanes`` dims index
independent trainings, and ``count`` and ``m_schedule`` have exactly
those dims.  A lane marked ``frozen`` keeps its params and its whole
optimizer state, count and schedule included, as the JAX engine's
``jnp.where(stopped, old, new)`` does after a stopped lane's epoch.
Every update is in place.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class KerasNadamState(NamedTuple):
    count: torch.Tensor          # lanes, int32: completed steps
    m_schedule: torch.Tensor     # lanes, float32: prod_{i<=t} u_i
    mu: List[torch.Tensor]       # first moments, one per param
    nu: List[torch.Tensor]       # second moments


class KerasNadam:
    """tf.keras ``Nadam`` (optimizer_v2/nadam.py).  Per step t (1-based)::

        m_sched_t = m_sched_{t-1} * u_t
        g' = g / (1 - m_sched_t)
        m  = b1 m + (1-b1) g;    m' = m / (1 - m_sched_t * u_{t+1})
        v  = b2 v + (1-b2) g^2;  v' = v / (1 - b2**t)
        p += -lr * ((1-u_t) g' + u_{t+1} m') / (sqrt(v') + eps)

    ``0.96**t`` and ``b2**t`` are taken in float32, as JAX takes them."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: Sequence[torch.Tensor], lanes: Sequence[int]) -> KerasNadamState:
        dev = params[0].device
        return KerasNadamState(
            count=torch.zeros(tuple(lanes), dtype=torch.int32, device=dev),
            m_schedule=torch.ones(tuple(lanes), dtype=torch.float32, device=dev),
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             state: KerasNadamState, frozen: Optional[torch.Tensor] = None) -> None:
        """One update of every lane not ``frozen`` (a bool tensor of the
        lane dims), in place on ``params`` and ``state``."""
        b1, b2 = self.b1, self.b2
        nl = state.count.dim()
        t = state.count + 1
        tf_ = t.to(torch.float32)
        u_t = b1 * (1.0 - 0.5 * 0.96 ** tf_)
        u_t1 = b1 * (1.0 - 0.5 * 0.96 ** (tf_ + 1.0))
        m_sched_t = state.m_schedule * u_t
        m_sched_next = m_sched_t * u_t1
        v_corr = 1.0 - b2 ** tf_

        def lane(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
            return x.reshape(x.shape + (1,) * (like.dim() - nl))

        def keep(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
            return new if frozen is None else torch.where(lane(frozen, old), old, new)

        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m_new = b1 * m + (1.0 - b1) * g
            v_new = b2 * v + (1.0 - b2) * g * g
            g_prime = g / (1.0 - lane(m_sched_t, g))
            m_prime = m_new / (1.0 - lane(m_sched_next, g))
            v_prime = v_new / lane(v_corr, g)
            m_bar = (1.0 - lane(u_t, g)) * g_prime + lane(u_t1, g) * m_prime
            update = -self.lr * m_bar / (torch.sqrt(v_prime) + self.eps)
            p.copy_(keep(p, p + update))
            m.copy_(keep(m, m_new))
            v.copy_(keep(v, v_new))
        state.count.copy_(keep(state.count, t))
        state.m_schedule.copy_(keep(state.m_schedule, m_sched_t))


#: the JAX package's name
keras_nadam = KerasNadam
