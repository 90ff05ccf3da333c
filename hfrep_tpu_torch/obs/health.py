"""Training health: grad, update and param norms and nonfinite counts
(``hfrep_tpu/obs/health.py``).

WGAN-GP critic losses can go NaN while the host keeps dispatching; the
health block measures gradient and weight health inside the steps so a
divergence is seen at the next block boundary, not at evaluation:

* the step builders (:mod:`hfrep_tpu_torch.train.steps`,
  :mod:`hfrep_tpu_torch.replication.engine`) consult :func:`active` when
  the step is BUILT.  Off (the default): the step runs exactly the code
  it runs without this module, no extra tensor and no extra sync.  On:
  the steps also compute the global grad norm, update norm, param norm
  and a nonfinite element count as device tensors, from values the step
  already holds, so the training trajectory is bit-identical either way;
* the values reach the host only at the boundaries the drives already
  sync at (the trainer's block metrics, the AE engine's chunk stop flag)
  and surface as ``health/*`` gauges;
* :attr:`HealthConfig.abort_on_nonfinite` arms the tripwire: a nonfinite
  count seen at a boundary raises :class:`NumericFault` after dumping
  the offending state to an atomic forensic directory
  (``numeric_fault_<epoch>/``).

Activation: :func:`configure`, or the ``HFREP_HEALTH`` env var — ``1`` /
``on`` measures, ``abort`` also arms the tripwire (read once a process).

The sums run in float32 over the parameters in the JAX package's leaf
order (:func:`jax_order`: Flax's nested param dict flattened with its
keys sorted), each over the leaves joined into one vector, so that a
tree's norm is three launches however many leaves it has; the norms meet
the JAX package's at the gradient bars.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

ENV_HEALTH = "HFREP_HEALTH"

#: the gauge vocabulary this layer emits
GAUGES = (
    "health/g_grad_norm",
    "health/d_grad_norm",
    "health/update_norm",
    "health/param_norm",
    "health/nonfinite",
    "health/ae_grad_norm",
    "health/ae_param_norm",
    "health/ae_nonfinite",
)

#: metric-dict keys the GAN steps add when health is on (the trainer
#: maps ``health_<x>`` to the ``health/<x>`` gauge at block boundaries)
STEP_KEYS = ("health_g_grad_norm", "health_d_grad_norm",
             "health_update_norm", "health_param_norm", "health_nonfinite")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """The in-step health knobs."""

    #: measure grad/update/param norms and nonfinite counts in the steps
    enabled: bool = True
    #: a nonfinite count seen at a boundary raises :class:`NumericFault`
    #: (after the forensic dump) instead of training on
    abort_on_nonfinite: bool = False
    #: forensic dump location; None = the obs run dir when telemetry is
    #: on, else the drive's checkpoint/resume dir, else no dump
    dump_dir: Optional[str] = None


class NumericFault(RuntimeError):
    """Training produced nonfinite gradients or weights and the tripwire
    is armed.  Carries the boundary site, the epoch and the forensic dump
    path (when one was written)."""

    def __init__(self, site: str, epoch: Optional[int] = None,
                 nonfinite: Optional[float] = None,
                 dump: Optional[str] = None,
                 detail: Optional[str] = None):
        self.site, self.epoch, self.nonfinite, self.dump = (
            site, epoch, nonfinite, dump)
        msg = f"nonfinite values detected at {site} boundary"
        if epoch is not None:
            msg += f" (epoch {epoch})"
        if nonfinite:
            msg += f": {int(nonfinite)} nonfinite element(s)"
        if detail:
            msg += f" [{detail}]"
        if dump:
            msg += f"; forensic dump at {dump}"
        super().__init__(msg)


_active: Optional[HealthConfig] = None
_env_consumed = False


def configure(cfg: Optional[HealthConfig]) -> Optional[HealthConfig]:
    """Install (or clear, with None) the process-wide health config."""
    global _active, _env_consumed
    _active, _env_consumed = cfg, True
    return cfg


def active() -> Optional[HealthConfig]:
    """The installed config, else one parsed from ``HFREP_HEALTH`` (read
    once a process); None when health is off — the builders' one branch
    point."""
    global _active, _env_consumed
    if _active is None and not _env_consumed:
        spec = (os.environ.get(ENV_HEALTH) or "").strip().lower()
        if spec and spec not in ("0", "off", "false"):
            _active = HealthConfig(enabled=True, abort_on_nonfinite=(spec == "abort"))
        _env_consumed = True
    if _active is not None and not _active.enabled:
        return None
    return _active


# ------------------------------------------------------- the JAX leaf order
def _flax_paths(module: nn.Module, path: Tuple[str, ...] = (), name: str = ""
                ) -> List[Tuple[Tuple[str, ...], str]]:
    """``(flax path, parameter name)`` of every parameter of ``module``,
    by the naming :mod:`hfrep_tpu_torch.utils.bridge` maps."""
    from hfrep_tpu_torch.ops.layers import KerasDense, KerasLayerNorm

    wrap = (("LayerNorm_0",) if isinstance(module, KerasLayerNorm)
            else ("Dense_0",) if isinstance(module, KerasDense) else ())
    out = [(path + wrap + (k,), name + k)
           for k, _ in module.named_parameters(recurse=False)]
    for flax_name, attr in getattr(type(module), "FLAX_NAMES", {}).items():
        out += _flax_paths(getattr(module, attr), path + (flax_name,),
                           f"{name}{attr}.")
    return out


def jax_order(module: nn.Module) -> List[str]:
    """``module``'s parameter names (``named_parameters`` keys) in the
    order ``jax.tree_util.tree_leaves`` visits the JAX params."""
    return [name for _, name in sorted(_flax_paths(module))]


# ------------------------------------------------------- in-step helpers
def flat(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """The floating leaves joined into one float32 vector, in order (a
    new tensor: one launch, a copy)."""
    return torch.cat([t.detach().reshape(-1).float() for t in leaves if t.is_floating_point()])


def tree_sq_norm(leaves) -> torch.Tensor:
    """Σ‖leaf‖² in float32 (``leaves``: a leaf list or its :func:`flat`)."""
    v = leaves if isinstance(leaves, torch.Tensor) else flat(leaves)
    return torch.sum(torch.square(v))


def tree_norm(leaves) -> torch.Tensor:
    """Global L2 norm (float32)."""
    return torch.sqrt(tree_sq_norm(leaves))


def tree_nonfinite(leaves) -> torch.Tensor:
    """Count of nonfinite elements across the floating leaves, as float32."""
    v = leaves if isinstance(leaves, torch.Tensor) else flat(leaves)
    return torch.sum(~torch.isfinite(v)).float()


def tree_update_sq_norm(old, new) -> torch.Tensor:
    """Σ‖new − old‖² over two same-ordered leaf lists or their :func:`flat`."""
    o = old if isinstance(old, torch.Tensor) else flat(old)
    n = new if isinstance(new, torch.Tensor) else flat(new)
    return torch.sum(torch.square(n - o))


# -------------------------------------------------------------- forensics
def _flatten(tree, out: List) -> List:
    if isinstance(tree, torch.Tensor):
        out.append(tree.detach().cpu().numpy())
    elif isinstance(tree, dict):
        for k in tree:
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    return out


def dump_forensics(dump_dir, carry, detail: Optional[dict] = None,
                   name: str = "numeric_fault") -> Optional[str]:
    """Persist the offending state (nested dicts/lists of tensors) and a
    JSON detail document atomically under ``dump_dir/<name>``; returns
    the dump path, or None when nothing could be written.  Best effort:
    forensics must never mask the fault they describe."""
    if dump_dir is None:
        return None
    try:
        import json
        from pathlib import Path

        import numpy as np

        from hfrep_tpu_torch.utils import checkpoint as ckpt

        leaves = _flatten(carry, [])
        doc = json.dumps(detail or {}, default=str, indent=2)

        def writer(tmp: Path) -> None:
            np.savez(tmp / "carry.npz", **{f"leaf_{i}": v for i, v in enumerate(leaves)})
            (tmp / "detail.json").write_text(doc)

        path = Path(dump_dir) / name
        ckpt.write_atomic(path, writer, metadata={"kind": "numeric_fault_dump",
                                                  "n_leaves": len(leaves)})
        return str(path)
    except Exception:
        return None


def resolve_dump_dir(cfg: HealthConfig, fallback: Optional[str] = None) -> Optional[str]:
    """Where a forensic dump lands: the configured dir, else the active
    obs run dir, else ``fallback`` (the checkpoint/resume dir), else
    nowhere."""
    if cfg.dump_dir:
        return cfg.dump_dir
    try:
        from hfrep_tpu_torch.obs import get_obs
        obs = get_obs()
        if obs.enabled:
            return str(obs.run_dir)
    except Exception:
        pass
    return fallback


def tripwire(site: str, epoch: int, nonfinite: float, carry, detail: dict,
             fallback: Optional[str] = None, leader: bool = True) -> None:
    """A boundary's nonfinite count: nothing when it is 0; else a
    ``numeric_fault`` event, and under ``abort_on_nonfinite`` a forensic
    dump of ``carry`` (under the configured dir, the obs run dir or
    ``fallback``) and :class:`NumericFault`.  A rank that is not the
    ``leader`` of a multi-process drive, which sees the same count, only
    raises: the leader emits the event and writes the dump (``carry`` may
    then be ``None``)."""
    if not nonfinite > 0:
        return
    from hfrep_tpu_torch.obs import get_obs

    obs = get_obs()
    cfg = active()
    abort = bool(cfg and cfg.abort_on_nonfinite)
    if leader:
        obs.event("numeric_fault", site=site, epoch=epoch, nonfinite=nonfinite, abort=abort)
    if not abort:
        return
    dump = None
    if leader:
        dump = dump_forensics(resolve_dump_dir(cfg, fallback), carry,
                              detail={"site": site, "epoch": epoch, "nonfinite": nonfinite,
                                      **detail},
                              name=f"numeric_fault_{epoch}")
        obs.flush()
    raise NumericFault(site, epoch=epoch, nonfinite=nonfinite, dump=dump)


def gan_boundary(host: Dict[str, "object"], epoch: int, site: str, carry,
                 fallback: Optional[str] = None, leader: bool = True,
                 **gauge_attrs) -> None:
    """The GAN drives' boundary: a block's ``health_*`` metrics, already
    on the host, as the ``health/*`` gauges of its last epoch (the
    ``leader``'s alone), then the :func:`tripwire` on the block's summed
    nonfinite count."""
    import numpy as np

    from hfrep_tpu_torch.obs import get_obs

    obs = get_obs()
    last = {k: float(np.asarray(v).reshape(-1)[-1])
            for k, v in host.items() if k.startswith("health_")}
    if obs.enabled and leader:
        for k, v in last.items():
            obs.gauge(f"health/{k[len('health_'):]}").set(v, epoch=epoch, **gauge_attrs)
    nf = float(np.nansum(np.asarray(host["health_nonfinite"])))
    tripwire(site, epoch, nf, carry, {"last_metrics": last}, fallback, leader)
