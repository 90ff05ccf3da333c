"""Typed configuration: the port's own copy of ``hfrep_tpu/config.py``.

Frozen dataclasses and the named :data:`PRESETS`, field for field the
same as the reference's, so a preset name means the same model in both
packages.  The port keeps a copy instead of importing the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Windowed-panel dataset construction (``GAN/MTSS_WGAN_GP.py:97-101``)."""

    cleaned_dir: str = "cleaned_data"   # relative to the working directory
    n_sample: int = 1000
    window: int = 48
    include_rf: bool = False      # production artifact used 36 features (22+13+1)
    seed: int = 123


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """GAN architecture knobs shared by all six variants."""

    family: str = "gan"            # gan | wgan | wgan_gp | mtss_gan | mtss_wgan | mtss_wgan_gp
    hidden: int = 100              # Dense/LSTM width used everywhere in the reference
    leaky_slope: float = 0.2
    features: int = 35
    window: int = 48
    dtype: str = "float32"         # compute dtype; "bfloat16" runs matmuls and
                                   # activations in bf16 over float32 master
                                   # weights (core/precision.py)
    param_dtype: str = "float32"   # master weights; keep float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule (reference defaults cited per field)."""

    epochs: int = 5000             # GAN/MTSS_WGAN_GP.py:292
    batch_size: int = 32           # GAN/MTSS_WGAN_GP.py:292
    n_critic: int = 5              # GAN/MTSS_WGAN_GP.py:127
    adam_lr: float = 2e-4          # GAN/GAN.py:100  Adam(2e-4, beta1=0.5)
    adam_b1: float = 0.5
    rmsprop_lr: float = 5e-5       # GAN/WGAN.py:99
    clip_value: float = 0.01       # GAN/WGAN.py:98
    gp_weight: float = 10.0        # GAN/WGAN_GP.py:171 loss_weights=[1,1,10]
    seed: int = 123
    log_every: int = 50
    checkpoint_every: int = 1000
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 0
    steps_per_call: int = 50
    lstm_backend: str = "auto"
    sp_microbatches: Optional[int] = None
    fuse_gd: bool = True
    sp_remat: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the data-parallel trainer."""

    dp: int = -1
    axis_name: str = "dp"


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """Autoencoder replication engine (``Autoencoder_encapsulate.py``)."""

    n_factors: int = 22            # input dim (Autoencoder_encapsulate.py:24)
    latent_dim: int = 21
    epochs: int = 1000             # :86
    batch_size: int = 48           # :88
    val_split: float = 0.25        # :89
    patience: int = 5              # :72 EarlyStopping(patience=5)
    leaky_slope: float = 0.2       # :25,:29
    ols_window: int = 24           # :133
    lr: float = 1e-3               # tf.keras Nadam() default
    chunk_epochs: int = 50
    double_buffer: bool = True
    seed: int = 123
    dtype: str = "float32"         # compute dtype of the encoder/decoder matmuls
    beta_mode: str = "first"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = DataConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()
    ae: AEConfig = AEConfig()
    name: str = "default"


def _preset(family: str, name: str, **train_kw) -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(family=family),
        train=TrainConfig(**train_kw),
        name=name,
    )


#: The reference's named configurations.
PRESETS = {
    "gan_1k": _preset("gan", "gan_1k", epochs=1000),
    "wgan": _preset("wgan", "wgan"),
    "wgan_gp": _preset("wgan_gp", "wgan_gp"),
    "mtss_gan": _preset("mtss_gan", "mtss_gan"),
    "mtss_wgan": _preset("mtss_wgan", "mtss_wgan"),
    "mtss_wgan_gp": _preset("mtss_wgan_gp", "mtss_wgan_gp"),
    # production artifact configuration: window 168, 36 features
    "mtss_wgan_gp_prod": ExperimentConfig(
        data=DataConfig(window=168, include_rf=True),
        model=ModelConfig(family="mtss_wgan_gp", window=168, features=36),
        train=TrainConfig(),
        name="mtss_wgan_gp_prod",
    ),
    "ae_replication": ExperimentConfig(name="ae_replication"),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
