"""Export the port's trained generators as Keras ``.h5`` artifacts
(``hfrep_tpu/utils/keras_export.py``).

The reference consumes generator artifacts through Keras ``load_model``
(``autoencoder_v4.ipynb`` cell 42, saved at
``GAN/MTSS_WGAN_GP.py:285-287``); this is the outbound half of that
interop, :mod:`hfrep_tpu_torch.utils.keras_import` the inbound one.
Writing needs TensorFlow, imported inside :func:`export_keras_generator`
only: the card's machine has none.

Layer order mirrors :mod:`hfrep_tpu_torch.models.generators`:

* LSTM family: ``LSTM(H, act=sigmoid) → LayerNorm → LSTM(H, act=sigmoid)
  → LeakyReLU(0.2) → LayerNorm → Dense(F)``;
* Dense family: ``Dense(H, sigmoid) → LeakyReLU → LayerNorm ×2 → Dense(F)``.
"""

from __future__ import annotations

from torch import nn

from hfrep_tpu_torch.config import ModelConfig
from hfrep_tpu_torch.models.generators import LSTMGenerator
from hfrep_tpu_torch.models.registry import FAMILIES
from hfrep_tpu_torch.utils.bridge import to_flax


def _tf():
    try:
        import tensorflow as tf
        return tf
    except ImportError as e:
        raise ImportError("keras_export needs tensorflow to write .h5 artifacts; use "
                          "checkpoints (hfrep_tpu_torch.utils.checkpoint) without it") from e


def export_keras_generator(mcfg: ModelConfig, generator: nn.Module, path: str) -> str:
    """Write ``generator`` (the family's network, e.g. a trainer's
    ``state.generator``) as a Keras ``.h5`` at ``path``; returns
    ``path``.  It loads back through
    :func:`~hfrep_tpu_torch.utils.keras_import.load_keras_generator` and
    through ``tf.keras.models.load_model``."""
    tf = _tf()
    if mcfg.family not in FAMILIES:
        raise ValueError(f"unknown generator family {mcfg.family!r}; "
                         f"available: {sorted(FAMILIES)}")
    params = to_flax(generator)
    h, w, f = mcfg.hidden, mcfg.window, mcfg.features
    slope = mcfg.leaky_slope
    layers = tf.keras.layers

    def dense(name):
        return [params[name]["Dense_0"]["kernel"], params[name]["Dense_0"]["bias"]]

    def norm(name):
        return [params[name]["LayerNorm_0"]["scale"], params[name]["LayerNorm_0"]["bias"]]

    if FAMILIES[mcfg.family][0] is LSTMGenerator:
        model = tf.keras.Sequential([
            layers.Input((w, f)),
            layers.LSTM(h, activation="sigmoid", recurrent_activation="sigmoid",
                        return_sequences=True),
            layers.LayerNormalization(epsilon=1e-3),
            layers.LSTM(h, activation="sigmoid", recurrent_activation="sigmoid",
                        return_sequences=True),
            layers.LeakyReLU(negative_slope=slope),
            layers.LayerNormalization(epsilon=1e-3),
            layers.Dense(f),
        ])
        lstm = lambda name: [params[name][k] for k in ("kernel", "recurrent_kernel", "bias")]  # noqa: E731
        weighted = [(0, lstm("KerasLSTM_0")), (1, norm("KerasLayerNorm_0")),
                    (2, lstm("KerasLSTM_1")), (4, norm("KerasLayerNorm_1")),
                    (5, dense("KerasDense_0"))]
    else:
        model = tf.keras.Sequential([
            layers.Input((w, f)),
            layers.Dense(h, activation="sigmoid"),
            layers.LeakyReLU(negative_slope=slope),
            layers.LayerNormalization(epsilon=1e-3),
            layers.Dense(h, activation="sigmoid"),
            layers.LeakyReLU(negative_slope=slope),
            layers.LayerNormalization(epsilon=1e-3),
            layers.Dense(f),
        ])
        weighted = [(0, dense("KerasDense_0")), (2, norm("KerasLayerNorm_0")),
                    (3, dense("KerasDense_1")), (5, norm("KerasLayerNorm_1")),
                    (6, dense("KerasDense_2"))]
    for i, ws in weighted:
        model.layers[i].set_weights(ws)
    model.save(path)
    return path
