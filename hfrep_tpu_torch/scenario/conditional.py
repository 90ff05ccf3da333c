"""Conditional generation: the training drive and deterministic scenario
banks (``hfrep_tpu/scenario/conditional.py``).

A *scenario bank* is a directory of conditional sample blocks, each a
pure function of its ``(stream_seed, regime, seq)`` coordinate, so banks
replay bit for bit and resume by skipping blocks that verify.  Every
block publishes through the atomic writer of
:mod:`hfrep_tpu_torch.utils.checkpoint`, and ``bank.json`` records the
per-block digests (``checkpoint.aggregate_digest``) and one aggregate.

A block's noise comes from a CPU ``torch.Generator`` seeded with
:func:`block_key` of its coordinate and is then copied to the bundle's
device, so it does not depend on the device; the samples are the
generator's forward on it (``lstm_fwd`` on the card for the MTSS
families).  JAX's threefry draws are not torch's, so the port's digests
are not the JAX package's; on JAX's noise (the ``noise=`` seam of
:func:`_sample_fn`) the samples agree.

Layout under ``out_dir``::

    blocks/r<regime>_<seq>/samples.npy   atomic per-block artifacts
    bank.json                            manifest: digests + config

A SIGTERM drains at the next ``gan_block`` (training) or ``bank_block``
(a published block) boundary (:class:`~hfrep_tpu_torch.resilience.Preempted`):
a re-run keeps every block that verifies.  Not ported yet (ROADMAP): the
health tail of the training drive, a named no-op stub below.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import io
import json
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hfrep_tpu_torch import resilience
from hfrep_tpu_torch.config import ModelConfig, TrainConfig
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.core.precision import policy_from
from hfrep_tpu_torch.models.registry import GanPair, _family
from hfrep_tpu_torch.scenario import regimes as reg
from hfrep_tpu_torch.train.states import GanState, init_conditional_state
from hfrep_tpu_torch.train.steps import Draws, make_conditional_step, make_multi_step
from hfrep_tpu_torch.train.trainer import seed_mix
from hfrep_tpu_torch.utils import checkpoint as ckpt

BANK_MANIFEST = "bank.json"


# ------------------------------------------------- hooks of later layers
def _emit_conditional_health(metrics, epochs: int, state: GanState) -> None:
    """Stub of the drive's health tail (``health/*`` gauges and the
    nonfinite tripwire at site ``gan_block``)."""


def block_name(regime: int, seq: int) -> str:
    return f"r{int(regime)}_{int(seq):05d}"


def sliding_windows(panel: np.ndarray, window: int) -> np.ndarray:
    """(T, F) → (T-window+1, window, F) overlapping training windows."""
    x = np.asarray(panel, np.float32)
    if x.shape[0] < window:
        raise ValueError(f"{x.shape[0]} rows < window {window}")
    idx = np.arange(window)[None, :] + np.arange(x.shape[0] - window + 1)[:, None]
    return x[idx]


@dataclasses.dataclass(frozen=True)
class ConditionalBundle:
    """A trained (or initialised) conditional generator and what bank
    generation needs to know of it."""

    pair: GanPair
    generator: nn.Module         # (z, cond) -> (n, W, F), on ``device``
    window: int
    features: int
    n_regimes: int
    family: str
    train_epochs: int
    seed: int
    device: torch.device


def _pair_of(state: GanState, mcfg: ModelConfig) -> GanPair:
    return GanPair(generator=state.generator, discriminator=state.discriminator,
                   loss=_family(mcfg)[2], family=mcfg.family,
                   policy=policy_from(mcfg.dtype, mcfg.param_dtype))


def train_conditional(mcfg: ModelConfig, tcfg: TrainConfig, windows, conditions,
                      epochs: int, seed: int = 0, device: DeviceLike = None,
                      state: Optional[GanState] = None,
                      draw_source: Optional[Callable[[int], Draws]] = None
                      ) -> ConditionalBundle:
    """Train a regime-conditioned GAN on ``(windows, conditions)``.

    ``epochs == 0`` returns the initialised bundle.  The drive runs
    :func:`~hfrep_tpu_torch.train.steps.make_multi_step` over the
    conditional epoch step, ``tcfg.steps_per_call`` epochs a call with the
    last call clamped so exactly ``epochs`` train.  The state comes from
    :func:`~hfrep_tpu_torch.train.states.init_conditional_state` (seed
    ``seed``) unless ``state`` is given; each epoch's draws come from a
    device generator seeded with ``seed_mix(seed, 1)`` unless
    ``draw_source(epoch)`` gives them (the seam for JAX's draws)."""
    dev = resolve_device(device)
    cond = torch.as_tensor(np.asarray(conditions, np.float32))
    n_regimes = int(cond.shape[1])
    if state is None:
        state = init_conditional_state(seed, mcfg, n_regimes, device=dev)
    pair = _pair_of(state, mcfg)
    metrics = None
    if epochs > 0:
        ds = torch.as_tensor(np.asarray(windows, np.float32)).to(dev)
        step = make_conditional_step(pair, tcfg, ds, cond.to(dev))
        gen = None
        if draw_source is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed_mix(seed, 1))
        done = 0
        multis = {}                    # steps_per_call -> multi-step
        with resilience.graceful_drain():
            while done < epochs:
                # clamp the last call so the drive trains EXACTLY `epochs`
                # (an overshoot would change every bank digest downstream)
                spc = min(tcfg.steps_per_call, epochs - done)
                if spc not in multis:
                    multis[spc] = make_multi_step(
                        pair, dataclasses.replace(tcfg, steps_per_call=spc), ds, step=step)
                draws = (None if draw_source is None
                         else [draw_source(done + i) for i in range(spc)])
                state, metrics = multis[spc](state, draws=draws, generator=gen)
                done += spc
                if done < epochs:
                    resilience.boundary("gan_block")
    _emit_conditional_health(metrics, epochs, state)
    windows_shape = np.shape(windows)
    return ConditionalBundle(
        pair=pair, generator=state.generator, window=int(windows_shape[1]),
        features=int(windows_shape[2]), n_regimes=n_regimes, family=mcfg.family,
        train_epochs=int(epochs), seed=int(seed), device=dev)


@functools.lru_cache(maxsize=4)
def fixture_bundle(feats: int = 6, window: int = 12, n_regimes: int = 3,
                   epochs: int = 2, rows: int = 90, seed: int = 0,
                   family: str = "gan", device: DeviceLike = None) -> ConditionalBundle:
    """A small deterministic conditional bundle trained on the fixture
    panel, the stand-in for a production conditional checkpoint (cached
    per shape and device)."""
    from hfrep_tpu_torch.utils.fixture_data import scaled_panel

    panel = scaled_panel(rows, feats, seed=seed + 29).numpy()
    labels = reg.label_regimes(panel, window=min(window, 12), n_regimes=n_regimes)
    windows = sliding_windows(panel, window)
    conds = reg.window_conditions(labels, window, n_regimes)
    mcfg = ModelConfig(family=family, features=feats, window=window, hidden=16)
    tcfg = TrainConfig(batch_size=16, n_critic=1, seed=seed, steps_per_call=max(1, epochs))
    return train_conditional(mcfg, tcfg, windows, conds, epochs, seed=seed, device=device)


def block_key(stream_seed: int, regime: int, seq: int) -> int:
    """THE seed of a bank block's noise, shared by the writer and replay."""
    return seed_mix(int(stream_seed), int(regime), int(seq))


def _sample_fn(bundle: ConditionalBundle):
    """The conditional sampler ``fn(key, cond, n, noise=None) -> (n, W, F)``
    on the bundle's device: standard normal noise from a CPU generator
    seeded with ``key`` (:func:`block_key`), or ``noise`` (n, W, F) as
    given, copied to the device."""

    @torch.no_grad()
    def sample(key: int, cond, n: int, noise=None) -> torch.Tensor:
        if noise is None:
            g = torch.Generator()
            g.manual_seed(int(key))
            noise = torch.randn((n, bundle.window, bundle.features), generator=g)
        z = torch.as_tensor(noise, dtype=torch.float32).to(bundle.device)
        c = torch.as_tensor(cond, dtype=torch.float32).to(bundle.device)
        return bundle.generator(z, c.expand(n, c.shape[-1]))

    return sample


def _block_samples(bundle: ConditionalBundle, sample, stream_seed: int, regime: int,
                   seq: int, block_size: int, noise=None) -> np.ndarray:
    cond = torch.from_numpy(reg.one_hot([regime], bundle.n_regimes)[0])
    cube = sample(block_key(stream_seed, regime, seq), cond, int(block_size), noise=noise)
    return cube.cpu().numpy().astype(np.float32)


def _npy_digest(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, arr)
    return hashlib.sha256(buf.getvalue()).hexdigest()


def replay_block_digest(bundle: ConditionalBundle, stream_seed: int, regime: int,
                        seq: int, block_size: int) -> str:
    """Regenerate one block in memory and return the aggregate digest its
    on-disk artifact carries, without touching the bank."""
    arr = _block_samples(bundle, _sample_fn(bundle), stream_seed, regime, seq, block_size)
    return ckpt.aggregate_digest({"samples.npy": _npy_digest(arr)})


def _bank_fingerprint(bundle: ConditionalBundle, stream_seed: int, block_size: int) -> dict:
    """Everything that determines a block's bytes: the block key's inputs
    and the generator's identity.  Written into every block's metadata and
    compared before a verified block is reused."""
    return {"stream_seed": int(stream_seed), "block_size": int(block_size),
            "family": bundle.family, "window": int(bundle.window),
            "features": int(bundle.features), "n_regimes": int(bundle.n_regimes),
            "train_epochs": int(bundle.train_epochs), "seed": int(bundle.seed)}


def generate_bank(bundle: ConditionalBundle, out_dir, *,
                  regimes: Optional[Sequence[int]] = None, blocks: int = 4,
                  block_size: int = 16, stream_seed: int = 0) -> dict:
    """Write the stress scenario bank: ``blocks`` deterministic sample
    blocks per regime, each atomically published and digest-indexed in
    ``bank.json``.

    Resumable: a block that exists, verifies and carries this bank's
    fingerprint is kept; a rotted one is regenerated; a block of another
    seed or config refuses.  Returns the manifest with ``generated``, the
    blocks written by this call."""
    out = Path(out_dir)
    blocks_dir = out / "blocks"
    blocks_dir.mkdir(parents=True, exist_ok=True)
    regime_list = list(regimes) if regimes is not None else list(range(bundle.n_regimes))
    fp = _bank_fingerprint(bundle, stream_seed, block_size)
    sample = _sample_fn(bundle)
    digests: Dict[str, str] = {}
    generated = 0
    with resilience.graceful_drain():
        for regime in regime_list:
            if not 0 <= int(regime) < bundle.n_regimes:
                raise ValueError(f"regime {regime} outside [0, {bundle.n_regimes})")
            for seq in range(blocks):
                dst = blocks_dir / block_name(regime, seq)
                meta = None
                if (dst / ckpt.META_NAME).exists():
                    try:
                        meta = ckpt.verify(dst)
                    except ckpt.CheckpointCorrupt:
                        meta = None
                    if meta is not None and meta.get("bank") != fp:
                        raise ValueError(
                            f"{dst} holds a block from a DIFFERENT bank (stream seed / "
                            "block size / generator config differ) — remove the out dir "
                            "or use a fresh one")
                if meta is None:
                    arr = _block_samples(bundle, sample, stream_seed, regime, seq, block_size)
                    ckpt.write_atomic(dst, lambda tmp, a=arr: np.save(tmp / "samples.npy", a),
                                      metadata={"regime": int(regime), "seq": int(seq),
                                                "bank": fp},
                                      io_site="bank_save", fault_site="bank")
                    meta = ckpt.read_meta(dst)
                    generated += 1
                digests[block_name(regime, seq)] = meta["checksum"]["digest"]
                resilience.boundary("bank_block")
    manifest = {
        "stream_seed": int(stream_seed),
        "n_regimes": int(bundle.n_regimes),
        "regimes": [int(r) for r in regime_list],
        "blocks": int(blocks), "block_size": int(block_size),
        "family": bundle.family, "window": int(bundle.window),
        "features": int(bundle.features),
        "train_epochs": int(bundle.train_epochs), "seed": int(bundle.seed),
        "block_digests": digests,
        "aggregate_digest": ckpt.aggregate_digest(digests),
    }
    tmp = out / f".{BANK_MANIFEST}.tmp-{os.getpid()}"
    tmp.write_text(json.dumps(manifest, indent=2, sort_keys=True))
    os.replace(tmp, out / BANK_MANIFEST)
    manifest["generated"] = generated
    return manifest


def scenario_item_panel(stream_seed: int, source_idx: int, seq: int, *, regime: int,
                        n_regimes: int = 3, rows: int = 96, feats: int = 6,
                        window: int = 12, device: DeviceLike = None) -> np.ndarray:
    """One pipeline item: a conditional bank block of the fixture bundle
    flattened into a MinMax-scaled (rows, feats) panel, a pure function of
    ``(stream_seed, source, seq)`` with the regime folded into the block
    key."""
    bundle = fixture_bundle(feats=feats, window=window, n_regimes=n_regimes, device=device)
    n_windows = -(-int(rows) // window)          # ceil: enough rows
    cube = _block_samples(bundle, _sample_fn(bundle), stream_seed + 7919 * source_idx,
                          regime, seq, n_windows)
    x = cube.reshape(-1, feats)[:rows]
    lo, hi = x.min(axis=0), x.max(axis=0)
    scale = np.where(hi - lo == 0.0, 1.0, hi - lo)
    return ((x - lo) / scale).astype(np.float32)
