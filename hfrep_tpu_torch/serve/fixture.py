"""Fixture models for serving drills (``hfrep_tpu/serve/fixture.py``).

:func:`fixture_ae_model` trains the fixture replication head as the JAX
fixture does: the chunked early-exit drive
(:func:`~hfrep_tpu_torch.replication.engine.train_autoencoder_chunked`)
on the deterministic panel ``fixture_data.scaled_panel(rows, feats,
seed=seed + 17)``, once per process and shape.  :func:`init_ae_model`
builds an untrained head at an ``AEConfig``'s widths (Keras-default
init from an explicit seed: glorot-uniform kernels), for drills that
serve the paper's 22-factor panels.  The generator is a named preset's
at Keras-default init (``mtss_wgan_gp`` at (W, F) = (48, 35),
``mtss_wgan_gp_prod`` at (168, 36), H = 100), unless a trained one is
passed.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from hfrep_tpu_torch.config import AEConfig, get_preset
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.serve.aot import AEServeModel, GenServeModel
from hfrep_tpu_torch.serve.server import ReplicationServer, ServeConfig


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def init_ae_model(cfg: AEConfig = AEConfig(), seed: int = 0,
                  device: DeviceLike = None) -> AEServeModel:
    """An untrained replication head at ``cfg``'s widths, Keras-default init."""
    return AEServeModel.create(cfg, device=resolve_device(device),
                               generator=_generator(seed))


def train_fixture_head(feats: int = 16, rows: int = 96, latent: int = 8, epochs: int = 30,
                       seed: int = 0, device: DeviceLike = None, **draws):
    """Train the fixture head: ``(cfg, AEResult)``.  ``draws`` pass on to
    the engine (``init_params``, ``perm_source``: the seams for JAX's
    draws)."""
    from hfrep_tpu_torch.replication.engine import train_autoencoder_chunked
    from hfrep_tpu_torch.utils.fixture_data import scaled_panel

    dev = resolve_device(device)
    # seed + 17 is this fixture's panel stream
    scaled = scaled_panel(rows, feats, seed=seed + 17)
    cfg = AEConfig(n_factors=feats, latent_dim=min(latent, feats), epochs=epochs,
                   batch_size=32, patience=3, seed=seed, chunk_epochs=10)
    res, _ = train_autoencoder_chunked(seed, scaled, cfg, device=dev, **draws)
    return cfg, res


@functools.lru_cache(maxsize=4)
def fixture_ae_model(feats: int = 16, rows: int = 96, latent: int = 8, epochs: int = 30,
                     seed: int = 0, device: DeviceLike = None) -> AEServeModel:
    """The trained fixture replication head (cached per shape and device)."""
    dev = resolve_device(device)
    cfg, res = train_fixture_head(feats, rows, latent, epochs, seed, dev)
    params = {k: v.detach().cpu().numpy() for k, v in res.params.items()}
    return AEServeModel.create(cfg, params, device=dev)


def fixture_gen_model(preset: str = "mtss_wgan_gp", seed: int = 1,
                      device: DeviceLike = None) -> GenServeModel:
    """The generator of a named preset, Keras-default init."""
    return GenServeModel.create(get_preset(preset).model,
                                device=resolve_device(device),
                                generator=_generator(seed))


def fixture_server(cfg: ServeConfig, preset: Optional[str] = "mtss_wgan_gp",
                   seed: int = 0, device: DeviceLike = None,
                   gen_model: Optional[GenServeModel] = None,
                   ae_model: Optional[AEServeModel] = None) -> ReplicationServer:
    """A started server: the AE head ``ae_model`` when given, else the
    trained fixture head (16 factors); the generator ``gen_model``
    when given (a trained one), else the preset's at Keras-default init,
    or none when ``preset`` is None."""
    dev = resolve_device(device)
    gen = gen_model
    if gen is None and preset is not None:
        gen = fixture_gen_model(preset, seed=seed + 1, device=dev)
    ae = ae_model if ae_model is not None else fixture_ae_model(seed=seed, device=dev)
    return ReplicationServer(cfg, ae_model=ae, gen_model=gen).start()


def warm_server(server: ReplicationServer,
                panels: Sequence[np.ndarray]) -> int:
    """Build the full program grid AND push one real batch through each
    path, outside any measured window.  Returns the programs resident."""
    from concurrent.futures import wait

    n = server.warm()
    futs = [server.replicate(panels[i % len(panels)], timeout_ms=60000)
            for i in range(server.cfg.max_batch)]
    if server.gen_model is not None:
        futs += [server.sample(1, timeout_ms=60000)
                 for _ in range(server.cfg.max_batch)]
    wait(futs, timeout=120)
    return n
