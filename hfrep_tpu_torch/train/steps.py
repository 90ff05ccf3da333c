"""Alternating G/D train steps for the three loss families
(``hfrep_tpu/train/steps.py``).

One *epoch* is one call of the step: n_critic critic updates and one
generator update, with the step semantics of the JAX package one for one:

* **bce** (GAN / MTSS-GAN): two sequential discriminator Adam updates —
  real batch vs label 1, then a generated batch vs label 0 — then one
  generator update against label 1 on fresh noise.  Logits are per
  timestep (B, W, 1); the label broadcasts over W.
* **wgan_clip** (WGAN / MTSS-WGAN): n_critic iterations of two
  sequential critic updates (mean(−c(real)), then mean(c(fake))), each
  iteration ending in a clip of *every* critic tensor to ±clip,
  LayerNorm scales included.
* **wgan_gp** (WGAN-GP / MTSS-WGAN-GP): n_critic single RMSprop updates
  on mean(−c(real)) + mean(c(fake)) + gp_weight·mean((1−‖∇ₓ̂c(x̂)‖)²),
  x̂ = α·real + (1−α)·fake, α per sample.  Real and fake are scored in
  one 2B critic pass; the penalty is a separate B-wide pass whose
  second-order ∂/∂θ ∇ₓ̂c path runs the LSTM adjoint kernel.

As in the JAX step, the n_critic fake batches are one (n_critic·B)-row
generator pass with no gradient, and the generator update reuses the
last critic iteration's noise.

Draws are an explicit argument (:class:`Draws`): the real-batch indices,
the noises and α.  JAX's threefry and torch's generators never give the
same numbers, so a test hands one JAX epoch's draws to the port's step;
:func:`sample_draws` makes them on the device for ordinary runs.

:func:`make_conditional_step` is the scenario factory's regime-conditioned
epoch over the same :class:`Draws`.

Health (:mod:`hfrep_tpu_torch.obs.health`) is decided when a step is
built: off, the step runs exactly its plain code; on, it also returns
the five ``health_*`` metrics as device tensors — the generator's and
the critic's gradient norms (the critic's of the last critic
iteration), the update norm against a copy of the parameters taken at
the epoch's start (the optimizers update in place), the parameter norm
and the count of nonfinite parameters and losses — all from values the
step already holds, so the trajectory is bit-identical either way.

``shard_data`` is the mesh hook (:func:`hfrep_tpu_torch.parallel.rules.
data_constraint`, JAX's ``shard_data``): every rank gets the global
batch's draws, keeps its block of them (its rows over dp, its window
chunk over sp), and the hook's ``reduce`` turns every gradient, loss and
accuracy into the global one before the optimizer touches it; the
penalty's squared norms of a window-sharded input gradient are summed
over the window's ranks.  ``None`` (the default) is the literal single-
device step.  ``apply_fns = (g_apply, d_apply)`` overrides how the
generator and the critic are applied, ``g_apply(module, z)``, while
keeping every other step semantic (the draws, the critic loop, the
penalty, the updates): the window-sharded and layer-pipelined forwards
(:mod:`hfrep_tpu_torch.parallel.sequence`,
:mod:`hfrep_tpu_torch.parallel.layer_pipeline`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hfrep_tpu_torch.config import TrainConfig
from hfrep_tpu_torch.models.registry import GanPair
from hfrep_tpu_torch.obs import health as health_mod
from hfrep_tpu_torch.train.states import GanState, make_optimizers, params_of

Metrics = dict


@dataclasses.dataclass
class Draws:
    """One epoch's random inputs.

    Wasserstein families: ``idx`` (n_critic, B) real-batch indices,
    ``noises`` (n_critic, B, W, F), and for wgan_gp ``alphas``
    (n_critic, B, 1, 1).  bce: ``idx`` (B,) and ``noises`` (2, B, W, F) —
    the fake batch's noise, then the generator update's."""

    idx: torch.Tensor
    noises: torch.Tensor
    alphas: Optional[torch.Tensor] = None


def sample_draws(generator: torch.Generator, pair: GanPair, tcfg: TrainConfig,
                 dataset: torch.Tensor) -> Draws:
    """One epoch's draws from ``generator``, made on ``dataset``'s device
    (the generator must live there too)."""
    n, w, f = dataset.shape
    b = tcfg.batch_size
    kw = dict(generator=generator, device=dataset.device)
    if pair.loss == "bce":
        return Draws(idx=torch.randint(0, n, (b,), **kw),
                     noises=torch.randn((2, b, w, f), **kw))
    k = tcfg.n_critic
    return Draws(idx=torch.randint(0, n, (k, b), **kw),
                 noises=torch.randn((k, b, w, f), **kw),
                 alphas=(torch.rand((k, b, 1, 1), **kw)
                         if pair.loss == "wgan_gp" else None))


def _bce_logits(logits: torch.Tensor, label: float) -> torch.Tensor:
    """Binary cross-entropy from logits against a constant broadcast
    label (``optax.sigmoid_binary_cross_entropy``, averaged)."""
    labels = torch.full_like(logits, label)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def _grad(outputs, inputs, **kwargs):
    """``torch.autograd.grad`` with the backward on the calling thread.

    On a card the engine runs a backward on its device worker thread, so
    the nodes a ``create_graph`` backward records (the penalty's input
    gradient) take their sequence numbers from that thread's counter,
    while the forward's take the caller's.  The outer backward orders its
    ready nodes by those numbers, so where a gradient sums three or more
    terms its order, and its last bits, depended on how far each counter
    had run: a process's first training differed from its later ones in
    the last bits, and a resumed run from the straight one.  On the
    calling thread every node shares one counter, and the order is the
    graph's own."""
    with torch.autograd.set_multithreading_enabled(False):
        return torch.autograd.grad(outputs, inputs, **kwargs)


def gradient_penalty(critic: Callable, interp: torch.Tensor,
                     sq_sum: Optional[Callable] = None) -> torch.Tensor:
    """mean((1 − ‖∇ₓ̂ c(x̂)‖)²) over the batch of interpolates.

    The input gradient is taken with ``create_graph=True`` so the outer
    gradient reaches the critic's parameters through it (the LSTM's
    second order: :class:`~hfrep_tpu_torch.ops.cuda_lstm.LSTMBwdSeq` and
    the adjoint kernel).  The score sum, the gradient and the norm are
    float32 whatever the compute dtype; the +1e-12 sits inside the root.
    ``sq_sum`` completes each sample's squared norm where ``interp`` is
    this rank's window chunk (the mesh hook's ``sum_window``)."""
    x = interp.detach().requires_grad_(True)
    grads, = _grad(critic(x).float().sum(), x, create_graph=True)
    grads = grads.float()
    sq = (grads ** 2).sum(dim=tuple(range(1, grads.dim())))
    if sq_sum is not None:
        sq = sq_sum(sq)
    norms = torch.sqrt(sq + 1e-12)
    return ((1.0 - norms) ** 2).mean()


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.concatenate`` with its dtype promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=0)


class _Health:
    """The health block of one built step (``hfrep_tpu/train/steps.py``'s
    ``_health_metrics``): the updates report their gradients here, and
    :meth:`metrics` turns them into the five ``health_*`` tensors.  Every
    sum runs over the parameters in the JAX leaf order, each tree joined
    into one vector (:func:`~hfrep_tpu_torch.obs.health.flat`)."""

    def __init__(self, pair: GanPair):
        self.g_order = health_mod.jax_order(pair.generator)
        self.d_order = health_mod.jax_order(pair.discriminator)

    def _leaves(self, state: GanState) -> List[torch.Tensor]:
        g, d = params_of(state.generator), params_of(state.discriminator)
        # the JAX tree {"g": ..., "d": ...} flattens "d" first
        return [d[k] for k in self.d_order] + [g[k] for k in self.g_order]

    def begin(self, state: GanState) -> None:
        """The epoch's starting parameters, copied (the optimizers update
        in place)."""
        self.old = health_mod.flat(self._leaves(state))
        self.d_sq = self.g_sq = None

    def critic_iteration(self) -> None:
        """A new critic iteration: the last iteration's norm wins."""
        self.d_sq = None

    def critic_grads(self, grads: dict) -> None:
        sq = health_mod.tree_sq_norm([grads[k] for k in self.d_order])
        self.d_sq = sq if self.d_sq is None else self.d_sq + sq

    def generator_grads(self, grads: dict) -> None:
        self.g_sq = health_mod.tree_sq_norm([grads[k] for k in self.g_order])

    @torch.no_grad()
    def metrics(self, state: GanState, losses) -> Metrics:
        new = health_mod.flat(self._leaves(state))
        nonfinite = health_mod.tree_nonfinite(new)
        for v in losses:
            nonfinite = nonfinite + torch.sum(~torch.isfinite(v.float())).float()
        out = {"health_g_grad_norm": torch.sqrt(self.g_sq),
               "health_d_grad_norm": torch.sqrt(self.d_sq),
               "health_update_norm": torch.sqrt(health_mod.tree_update_sq_norm(self.old, new)),
               "health_param_norm": health_mod.tree_norm(new),
               "health_nonfinite": nonfinite}
        self.old = None
        return out


def _updates(pair: GanPair, tcfg: TrainConfig, health: Optional[_Health] = None,
             reduce: Optional[Callable] = None):
    """``(d_update, g_update)``: each takes ``(state, loss)``, applies one
    optimizer update of its network's parameters in place and returns the
    detached loss; ``g_update`` also counts the step.  With ``health``
    the updates hand it their gradients.  With ``reduce`` (the dp hook's)
    each update first reduces, in one call, its gradients in parameter
    order (an unused one as zeros, so every rank reduces the same list),
    its loss and ``extras`` (tensors the caller wants as global means,
    returned after the loss); the gradients are the rank's partials, named
    for the hook by their parameters."""
    g_tx, d_tx = make_optimizers(pair, tcfg)

    def _update(module: nn.Module, tx, slots: dict, loss: torch.Tensor, extras=()):
        params = params_of(module)
        grads = _grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        loss = loss.detach()
        if reduce is not None:
            out = reduce(list(grads.values()) + [loss] + list(extras), partials=len(grads),
                         names=list(grads))
            n = len(grads)
            grads, loss, extras = dict(zip(grads, out[:n])), out[n], tuple(out[n + 1:])
        tx.update(params, grads, slots)
        return grads, loss, extras

    def d_update(state: GanState, loss: torch.Tensor, extras=()):
        grads, loss, extras = _update(state.discriminator, d_tx, state.d_opt, loss, extras)
        if health is not None:
            health.critic_grads(grads)
        return (loss,) + extras if extras else loss

    def g_update(state: GanState, loss: torch.Tensor) -> torch.Tensor:
        grads, loss, _ = _update(state.generator, g_tx, state.g_opt, loss)
        if health is not None:
            health.generator_grads(grads)
        state.step += 1
        return loss

    return d_update, g_update


def _health(pair: GanPair) -> Optional[_Health]:
    """The build-time gate: a health block when health is on, else None."""
    return _Health(pair) if health_mod.active() is not None else None


def make_train_step(pair: GanPair, tcfg: TrainConfig, dataset: torch.Tensor,
                    shard_data: Optional[Callable] = None,
                    apply_fns: Optional[Tuple[Callable, Callable]] = None
                    ) -> Callable[[GanState, Draws], Tuple[GanState, Metrics]]:
    """Build ``step(state, draws) -> (state, metrics)`` for one epoch.

    The step updates ``state``'s networks and slots in place and returns
    it; metrics are 0-d float32 tensors on the device (no host sync).
    ``tcfg.fuse_gd`` changes nothing here: the JAX step uses it to emit
    an n_critic == 1 epoch as straight-line code instead of a size-1
    traced loop, and the port runs eagerly with no traced loop at all.
    With health on (decided here, at build time) the metrics also carry
    the five ``health_*`` values.  ``shard_data`` is the mesh hook and
    ``apply_fns`` the forwards' override (module docstring): the step
    takes the global batch's draws and runs on this rank's block of them.
    """
    health = _health(pair)
    d_update, g_update = _updates(pair, tcfg, health,
                                  None if shard_data is None else shard_data.reduce)
    acc = pair.policy.accum
    clip, gp_w = tcfg.clip_value, tcfg.gp_weight
    g_apply, d_apply = apply_fns or (lambda g, z: g(z), lambda d, x: d(x))
    sq_sum = None if shard_data is None else shard_data.sum_window

    def _real(idx: torch.Tensor) -> torch.Tensor:
        """The real windows of this rank's rows (its window chunk)."""
        real = dataset[idx]
        return real if shard_data is None else shard_data.window(real, 1)

    def _rows(draws: Draws) -> Draws:
        """This rank's block of the global batch's draws (every draw but
        bce's ``idx`` has a leading epoch or update axis)."""
        if shard_data is None:
            return draws
        axis = 0 if draws.idx.dim() == 1 else 1
        return Draws(idx=shard_data(draws.idx, axis), noises=shard_data(draws.noises, 1),
                     alphas=None if draws.alphas is None else shard_data(draws.alphas, 1))

    def _fakes(state: GanState, noises: torch.Tensor) -> torch.Tensor:
        """n_critic fake batches as ONE generator pass, no gradient."""
        n, b = noises.shape[0], noises.shape[1]
        with torch.no_grad():
            out = g_apply(state.generator, noises.reshape((n * b,) + noises.shape[2:]))
        return out.reshape(noises.shape[:2] + out.shape[1:])

    def _wasserstein_metrics(state: GanState, d_loss, g_loss) -> Metrics:
        metrics = {"d_loss": d_loss, "g_loss": g_loss}
        if health is not None:
            metrics.update(health.metrics(state, (d_loss, g_loss)))
        return metrics

    # ------------------------------------------------------------------ bce
    def bce_step(state: GanState, draws: Draws):
        if health is not None:
            health.begin(state)
        draws = _rows(draws)
        real = _real(draws.idx)
        g = state.generator
        with torch.no_grad():
            fake = g_apply(g, draws.noises[0])
        d = partial(d_apply, state.discriminator)
        logits = acc(d(real))
        acc_r = (logits > 0).float().mean()
        l_real, acc_r = d_update(state, _bce_logits(logits, 1.0), (acc_r,))
        logits = acc(d(fake))
        acc_f = (logits <= 0).float().mean()
        l_fake, acc_f = d_update(state, _bce_logits(logits, 0.0), (acc_f,))
        g_loss = g_update(state, _bce_logits(acc(d(g_apply(g, draws.noises[1]))), 1.0))
        metrics = {"d_loss": 0.5 * (l_real + l_fake),
                   "d_acc": 0.5 * (acc_r + acc_f), "g_loss": g_loss}
        if health is not None:
            metrics.update(health.metrics(state, (l_real, l_fake, g_loss)))
        return state, metrics

    # ------------------------------------------------------------ wgan_clip
    def wgan_step(state: GanState, draws: Draws):
        if health is not None:
            health.begin(state)
        draws = _rows(draws)
        fakes = _fakes(state, draws.noises)
        d = partial(d_apply, state.discriminator)
        d_loss = None
        for i in range(tcfg.n_critic):
            if health is not None:
                health.critic_iteration()
            real = _real(draws.idx[i])
            l_real = d_update(state, (-acc(d(real))).mean())
            l_fake = d_update(state, acc(d(fakes[i])).mean())
            with torch.no_grad():
                for p in state.discriminator.parameters():
                    p.clamp_(-clip, clip)
            d_loss = 0.5 * (l_real + l_fake)
        # the reference reuses the final critic-loop noise
        g_loss = g_update(state, (-acc(d(g_apply(state.generator, draws.noises[-1])))).mean())
        return state, _wasserstein_metrics(state, d_loss, g_loss)

    # -------------------------------------------------------------- wgan_gp
    def gp_critic_loss(d: Callable, real, fake, alpha) -> torch.Tensor:
        interp = alpha * real + (1.0 - alpha) * fake
        b = real.shape[0]
        scores = acc(d(_cat(real, fake)))       # one 2B pass for real ⊕ fake
        gp = gradient_penalty(d, interp, sq_sum)      # a separate B-wide pass
        w_loss = (-scores[:b]).mean() + scores[b:].mean()
        return w_loss + gp_w * gp

    def wgan_gp_step(state: GanState, draws: Draws):
        if health is not None:
            health.begin(state)
        draws = _rows(draws)
        fakes = _fakes(state, draws.noises)
        d = partial(d_apply, state.discriminator)
        d_loss = None
        for i in range(tcfg.n_critic):
            if health is not None:
                health.critic_iteration()
            real = _real(draws.idx[i])
            d_loss = d_update(state, gp_critic_loss(d, real, fakes[i], draws.alphas[i]))
        # the reference reuses the final critic-loop noise
        g_loss = g_update(state, (-acc(d(g_apply(state.generator, draws.noises[-1])))).mean())
        return state, _wasserstein_metrics(state, d_loss, g_loss)

    return {"bce": bce_step, "wgan_clip": wgan_step, "wgan_gp": wgan_gp_step}[pair.loss]


def make_conditional_step(pair: GanPair, tcfg: TrainConfig, dataset: torch.Tensor,
                          conditions) -> Callable[[GanState, Draws], Tuple[GanState, Metrics]]:
    """The conditional (cGAN) epoch of the scenario factory
    (``hfrep_tpu/train/steps.py:415-563``).

    ``pair`` is a :func:`~hfrep_tpu_torch.models.conditional.build_conditional_gan`
    pair whose members take ``(input, cond)``; ``conditions`` is the (N, C)
    condition matrix aligned row for row with ``dataset``.  Each real
    batch rides with its own conditions (one index gather serves both),
    and fakes are generated and scored under the same conditions, so the
    critic compares windows of one regime.  Per family the loss is the
    unconditional step's, over the same :class:`Draws`, with JAX's
    conditional differences: each critic iteration generates its own fake
    batch; the generator update takes the last iteration's indices (for
    its conditions) and noise; the penalty differentiates the critic with
    respect to x̂ only (the condition is a constant inside it); the bce
    metrics carry no ``d_acc``.  Health is gated as in
    :func:`make_train_step`.
    """
    health = _health(pair)
    d_update, g_update = _updates(pair, tcfg, health)
    acc = pair.policy.accum
    conditions = torch.as_tensor(conditions).to(dataset.device, torch.float32)
    if conditions.dim() != 2 or conditions.shape[0] != dataset.shape[0]:
        raise ValueError(
            f"conditions {tuple(conditions.shape)} do not align with dataset "
            f"{tuple(dataset.shape)}: one condition vector per training window")
    clip, gp_w = tcfg.clip_value, tcfg.gp_weight

    def _real(idx):
        return dataset[idx], conditions[idx]

    def bce_step(state: GanState, draws: Draws):
        if health is not None:
            health.begin(state)
        real, cond = _real(draws.idx)
        g, d = state.generator, state.discriminator
        with torch.no_grad():
            fake = g(draws.noises[0], cond)
        l_real = d_update(state, _bce_logits(acc(d(real, cond)), 1.0))
        l_fake = d_update(state, _bce_logits(acc(d(fake, cond)), 0.0))
        g_loss = g_update(state, _bce_logits(acc(d(g(draws.noises[1], cond), cond)), 1.0))
        metrics = {"d_loss": 0.5 * (l_real + l_fake), "g_loss": g_loss}
        if health is not None:
            metrics.update(health.metrics(state, (l_real, l_fake, g_loss)))
        return state, metrics

    def wasserstein_step(state: GanState, draws: Draws):
        if health is not None:
            health.begin(state)
        g, d = state.generator, state.discriminator
        d_loss = None
        for i in range(tcfg.n_critic):
            if health is not None:
                health.critic_iteration()
            real, cond = _real(draws.idx[i])
            with torch.no_grad():
                fake = g(draws.noises[i], cond)
            if pair.loss == "wgan_gp":
                alpha = draws.alphas[i]
                interp = alpha * real + (1.0 - alpha) * fake
                b = real.shape[0]
                scores = acc(d(_cat(real, fake), _cat(cond, cond)))
                gp = gradient_penalty(lambda x, c=cond: d(x, c), interp)
                d_loss = d_update(state, (-scores[:b]).mean() + scores[b:].mean() + gp_w * gp)
            else:
                l_real = d_update(state, (-acc(d(real, cond))).mean())
                l_fake = d_update(state, acc(d(fake, cond)).mean())
                with torch.no_grad():
                    for p in d.parameters():
                        p.clamp_(-clip, clip)
                d_loss = 0.5 * (l_real + l_fake)
        # the generator trains on the last critic iteration's draws
        cond_g = conditions[draws.idx[-1]]
        g_loss = g_update(state, (-acc(d(g(draws.noises[-1], cond_g), cond_g))).mean())
        metrics = {"d_loss": d_loss, "g_loss": g_loss}
        if health is not None:
            metrics.update(health.metrics(state, (d_loss, g_loss)))
        return state, metrics

    return bce_step if pair.loss == "bce" else wasserstein_step


def make_multi_step(pair: GanPair, tcfg: TrainConfig, dataset: torch.Tensor,
                    step: Optional[Callable] = None):
    """``tcfg.steps_per_call`` epochs per call, in a Python loop.

    Returns ``fn(state, draws=None, generator=None) -> (state, metrics)``:
    ``draws`` is a list of one :class:`Draws` per epoch, or ``None`` to
    sample each epoch's from ``generator`` (:func:`sample_draws`).
    Metrics are stacked, one entry per epoch, as the JAX scan stacks
    them.  ``step`` overrides the epoch step (e.g.
    :func:`make_conditional_step`'s) while keeping the loop.
    """
    if step is None:
        step = make_train_step(pair, tcfg, dataset)
    n = tcfg.steps_per_call

    def multi(state: GanState, draws: Optional[List[Draws]] = None,
              generator: Optional[torch.Generator] = None):
        if draws is not None and len(draws) != n:
            raise ValueError(f"want {n} epochs of draws, got {len(draws)}")
        if draws is None and generator is None:
            raise ValueError("pass the epochs' draws or a generator to sample them")
        metrics = []
        for i in range(n):
            d = draws[i] if draws is not None else sample_draws(generator, pair, tcfg, dataset)
            state, m = step(state, d)
            metrics.append(m)
        return state, {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    return multi
