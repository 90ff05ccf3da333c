"""Synthetic-universe scaling (``hfrep_tpu/scenario/universe.py``).

Universes of F funds × M months, from the deterministic fixture factor
model or from a trained conditional generator, driven through the
walk-forward grid so lane count, padding waste and throughput are
measured at sizes past the real 337 × 13 panel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from hfrep_tpu_torch.config import AEConfig
from hfrep_tpu_torch.core.device import DeviceLike
from hfrep_tpu_torch.scenario.walkforward import WalkForwardSpec, run_walkforward


@dataclasses.dataclass(frozen=True)
class UniverseSpec:
    """F funds × M months over ``n_factors`` synthetic factor columns."""

    funds: int
    months: int
    n_factors: int = 22
    seed: int = 0
    rank: int = 4


class Universe(NamedTuple):
    factors: np.ndarray       # (months, n_factors)
    hfd: np.ndarray           # (months, funds)
    rf: np.ndarray            # (months,)


def synthesize_universe(spec: UniverseSpec,
                        factor_sampler: Optional[Callable[[int, int], np.ndarray]] = None
                        ) -> Universe:
    """The fixture factor model's universe, or, given
    ``factor_sampler(months, n_factors)`` (e.g.
    :func:`generator_factor_sampler`), one on sampled factor paths; both
    share :func:`~hfrep_tpu_torch.utils.fixture_data.fund_cross_section`,
    whose stream is seeded apart from the factor values."""
    from hfrep_tpu_torch.utils.fixture_data import fund_cross_section, low_rank_returns

    if factor_sampler is not None:
        factors = np.asarray(factor_sampler(spec.months, spec.n_factors), np.float32)
        if factors.shape != (spec.months, spec.n_factors):
            raise ValueError(f"factor_sampler returned {factors.shape}, "
                             f"want {(spec.months, spec.n_factors)}")
    else:
        g_fac = np.random.default_rng((spec.seed, spec.months, spec.n_factors, 0))
        factors = low_rank_returns(g_fac, spec.months, spec.n_factors, spec.rank)
    hfd, rf = fund_cross_section(factors, spec.seed, spec.funds)
    return Universe(factors=factors, hfd=hfd, rf=rf)


def generator_factor_sampler(bundle, regime: int = 0, stream_seed: int = 0):
    """``factor_sampler`` over a conditional bundle: enough
    regime-conditioned windows to cover ``months`` rows, stitched, keyed
    by the bank's block derivation."""
    from hfrep_tpu_torch.scenario.conditional import _block_samples, _sample_fn

    def sampler(months: int, n_factors: int) -> np.ndarray:
        if n_factors != bundle.features:
            raise ValueError(f"bundle emits {bundle.features} factors, "
                             f"universe wants {n_factors}")
        n_windows = -(-months // bundle.window)
        cube = _block_samples(bundle, _sample_fn(bundle), stream_seed, regime, 0, n_windows)
        return cube.reshape(-1, bundle.features)[:months]

    return sampler


def drive_universe(spec: UniverseSpec, wf: WalkForwardSpec, cfg: AEConfig,
                   latent_dims: Sequence[int], out_dir, resume: bool = False,
                   factor_sampler=None, device: DeviceLike = None) -> dict:
    """Synthesize the universe and drive the walk-forward across it; the
    result's stats gain the universe's funds, months and factors."""
    uni = synthesize_universe(spec, factor_sampler)
    res = run_walkforward(uni.factors, uni.hfd, uni.rf, wf, cfg, latent_dims, out_dir,
                          resume=resume, device=device)
    res["stats"].update(funds=spec.funds, months=spec.months, n_factors=spec.n_factors)
    return res
