"""GAN augmentation of the AE training set (``hfrep_tpu/experiments/augment.py``).

The reference flow (``autoencoder_v4.ipynb`` cells 42-50): sample the
trained generator on ``normal(0, 1, (10, 168, 36))`` noise (cell 43),
inverse-scale with the MinMax scaler of the full factor⋈hfd⋈rf panel
(cell 47), split the cube into factor, HF and rf rows
(``helper.py:133-153``, cell 48), and stack the synthetic rows above the
real training rows (cell 50).

A source's sampling draws come from a device ``torch.Generator`` seeded
from its label (:func:`source_sample_key`), so they differ from the JAX
package's threefry draws by design.  :func:`sample_keras_generator`
samples a reference Keras ``.h5`` artifact (it needs ``h5py``, imported
only there: the card's path never calls it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import torch

from hfrep_tpu_torch.core import scaler as mm
from hfrep_tpu_torch.core.data import Panel
from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.core.sampling import factor_hf_split
from hfrep_tpu_torch.train.trainer import seed_mix


def source_labels(paths: Sequence[str]) -> List[str]:
    """Stable per-source labels for a repeatable ``--gan-checkpoint`` flag:
    the artifact's basename stem, disambiguated on collision by a short
    digest of the full path, never by the flag's position."""
    stems = []
    for p in paths:
        base = os.path.basename(str(p).rstrip(os.sep))
        stems.append(os.path.splitext(base)[0] or base)
    labels = []
    for stem, p in zip(stems, paths):
        if stems.count(stem) > 1:
            labels.append(f"{stem}_{hashlib.sha256(str(p).encode()).hexdigest()[:6]}")
        else:
            labels.append(stem)
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate augmentation sources: {list(paths)}")
    return labels


def source_sample_key(label: str, base_seed: int = 7,
                      device: DeviceLike = None) -> torch.Generator:
    """The sampling generator of one source, on ``device``, seeded with
    ``seed_mix(base_seed, digest)`` of its label's sha256 (first four
    bytes mod 2**31): reordering the flags cannot change which draws
    sample which generator."""
    digest = int.from_bytes(hashlib.sha256(label.encode()).digest()[:4], "big") % (2 ** 31)
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed_mix(base_seed, digest))
    return g


@dataclasses.dataclass
class AugmentedData:
    """Flattened synthetic rows, ready to stack with real rows."""

    factors: torch.Tensor            # (N*W, 22)
    hf: torch.Tensor                 # (N*W, 13)
    rf: Optional[torch.Tensor]       # (N*W,) when the generator has an rf column
    raw_windows: torch.Tensor        # (N, W, F) inverse-scaled cube


def sample_generator(trainer, generator: Optional[torch.Generator] = None,
                     n_windows: int = 10, n_factors: int = 22, n_hf: int = 13,
                     noise: Optional[torch.Tensor] = None) -> AugmentedData:
    """Sample a trained :class:`~hfrep_tpu_torch.train.trainer.GanTrainer`
    (its own scaler, carried through checkpoints, undoes the scaling) and
    split the cube; ``noise`` (n, W, F) replaces the draw."""
    cube = trainer.generate(n_windows, generator=generator, noise=noise, unscale=True)
    return split_cube(cube, n_factors=n_factors, n_hf=n_hf)


def sample_keras_generator(path: str, generator: Optional[torch.Generator], panel: Panel,
                           n_windows: int = 10, n_factors: int = 22, n_hf: int = 13,
                           noise: Optional[torch.Tensor] = None,
                           device: DeviceLike = None) -> AugmentedData:
    """The notebook's cells 42-48 from a Keras ``.h5`` artifact: load the
    generator (:func:`~hfrep_tpu_torch.utils.keras_import.load_keras_generator`),
    sample ``normal(0, 1, (N, W, F))`` noise from ``generator`` on
    ``device`` (cell 43; ``noise`` replaces the draw), inverse-scale with
    the panel-refit MinMax scaler (cell 47) and split (cell 48).  Whether
    the cube carries an rf column is read from its own width: 36 → 22
    factors, 13 HF and rf; 35 → no rf."""
    from hfrep_tpu_torch.utils.keras_import import load_keras_generator

    dev = resolve_device(device)
    module, _, (window, features) = load_keras_generator(path, device=dev)
    if noise is None:
        noise = torch.randn((n_windows, window, features), generator=generator, device=dev)
    else:
        noise = torch.as_tensor(noise).to(dev, torch.float32)
    with torch.no_grad():
        cube_scaled = module(noise)
    include_rf = cube_scaled.shape[2] > n_factors + n_hf
    cube = inverse_scale_cube(cube_scaled, panel, include_rf=include_rf)
    return split_cube(cube, n_factors=n_factors, n_hf=n_hf)


def split_cube(cube: torch.Tensor, n_factors: int = 22, n_hf: int = 13) -> AugmentedData:
    """(N, W, F) inverse-scaled cube → flattened factor/HF/rf rows."""
    factors, rest = factor_hf_split(cube, n_factors)
    if cube.shape[2] > n_factors + n_hf:                       # an rf column
        hf, rf = rest[:, :n_hf], rest[:, n_hf]
    else:
        hf, rf = rest, None
    return AugmentedData(factors=factors, hf=hf, rf=rf, raw_windows=cube)


def augment_training_set(x_train, y_train, aug: AugmentedData
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic rows first, real rows after: the notebook's
    ``np.vstack([generated, real])`` (cell 50)."""
    dev = aug.factors.device
    x = torch.as_tensor(x_train, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y_train, dtype=torch.float32).to(dev)
    return torch.cat([aug.factors, x], dim=0), torch.cat([aug.hf, y], dim=0)


def augment_training_sets(x_train, y_train, augs) -> list:
    """The real training set and one augmented variant per sampled
    generator, the ``(x, y)`` list
    :func:`hfrep_tpu_torch.experiments.sweep.run_sweep_multi` pads into one
    grid; the row counts differ across the list."""
    real = (torch.as_tensor(x_train, dtype=torch.float32),
            torch.as_tensor(y_train, dtype=torch.float32))
    return [real] + [augment_training_set(x_train, y_train, a) for a in augs]


def inverse_scale_cube(cube_scaled: torch.Tensor, panel: Panel,
                       include_rf: bool = True) -> torch.Tensor:
    """The notebook's inverse scaler (cell 47: MinMax fit on factor⋈hfd⋈rf
    over the full sample) applied to a generated cube made outside a
    trainer."""
    params, _ = mm.fit_transform(panel.joined(include_rf=include_rf))
    flat = cube_scaled.reshape(-1, cube_scaled.shape[2]).to(params.data_min.device)
    return mm.inverse_transform(params, flat).reshape(cube_scaled.shape)
