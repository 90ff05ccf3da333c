"""Fixture models for serving drills (``hfrep_tpu/serve/fixture.py``).

The JAX fixture trains its AE head; training is not ported yet, so this
one builds the models with Keras-default initialisation from an explicit
seed: glorot-uniform kernels, orthogonal recurrent kernels and the unit
forget bias.  The AE head is at ``AEConfig()`` widths (22 factors,
latent 21); the generator is a named preset's (``mtss_wgan_gp`` at
(W, F) = (48, 35), ``mtss_wgan_gp_prod`` at (168, 36), H = 100).
"""

from __future__ import annotations

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


def fixture_ae_model(cfg: AEConfig = AEConfig(), seed: int = 0,
                     device: DeviceLike = None) -> AEServeModel:
    """The replication head at ``cfg``'s widths, Keras-default init."""
    return AEServeModel.create(cfg, device=resolve_device(device),
                               generator=_generator(seed))


def fixture_gen_model(preset: str = "mtss_wgan_gp", seed: int = 1,
                      device: DeviceLike = None) -> GenServeModel:
    """The generator of a named preset, Keras-default init."""
    return GenServeModel.create(get_preset(preset).model,
                                device=resolve_device(device),
                                generator=_generator(seed))


def fixture_server(cfg: ServeConfig, preset: Optional[str] = "mtss_wgan_gp",
                   seed: int = 0, device: DeviceLike = None,
                   gen_model: Optional[GenServeModel] = None) -> ReplicationServer:
    """A started server with the fixture AE head and a generator:
    ``gen_model`` when given (a trained one), else the preset's at
    Keras-default init, or none when ``preset`` is None."""
    dev = resolve_device(device)
    gen = gen_model
    if gen is None and preset is not None:
        gen = fixture_gen_model(preset, seed=seed + 1, device=dev)
    return ReplicationServer(cfg, ae_model=fixture_ae_model(seed=seed, device=dev),
                             gen_model=gen).start()


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
