"""Import Keras ``.h5`` generator artifacts (``hfrep_tpu/utils/keras_import.py``).

The paper's headline GAN-augmentation experiment starts from a trained
generator saved by ``GAN/MTSS_WGAN_GP.py:285-287`` and loaded with Keras
``load_model`` at ``autoencoder_v4.ipynb`` cell 42.  This module parses
the h5's ``model_config`` JSON into a layer spec, builds the matching
network from the port's Keras-semantics layers
(:class:`~hfrep_tpu_torch.ops.lstm.KerasLSTM`,
:class:`~hfrep_tpu_torch.ops.layers.KerasDense`, …) and binds the stored
weights.  The LSTM layers run through :mod:`hfrep_tpu_torch.ops.lstm`:
the hand kernels on a CUDA tensor, the plain versions on a CPU one.

The model is built from the artifact's own config, not assumed from the
family name: the production artifact puts a ``LeakyReLU`` after both
LSTMs, where the committed script has one after the second only.

Reading an artifact needs ``h5py``, imported inside the functions that
read: the card's machine has none, and nothing on the card's path
imports this module.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hfrep_tpu_torch.core.device import DeviceLike, resolve_device
from hfrep_tpu_torch.ops.layers import ACTIVATIONS, KerasDense, KerasLayerNorm, leaky_relu
from hfrep_tpu_torch.ops.lstm import KerasLSTM

# A spec is a tuple:
#   ("lstm", units, activation, recurrent_activation)
#   ("dense", units, activation, use_bias)
#   ("layer_norm", epsilon)
#   ("leaky_relu", alpha)
#   ("flatten" | "activation" | "dropout", activation_or_None)
Spec = Tuple[Any, ...]

_WEIGHTED = {"lstm", "dense", "layer_norm"}


def _as_str(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)


def _checked_activation(name, cls: str):
    """Refuse an activation the port's layers do not implement while
    parsing, so the error names the artifact (:func:`parse_model_config`)."""
    if name not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r} on {cls} layer")
    return name


def _flatten_layers(layers: Sequence[dict], specs: List[Spec],
                    input_shape: List[Tuple[int, ...]]) -> None:
    for layer in layers:
        cls, cfg = layer["class_name"], layer["config"]
        if cls in ("Sequential", "Functional", "Model"):
            _flatten_layers(cfg["layers"], specs, input_shape)
        elif cls == "InputLayer":
            shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
            if shape is not None:
                input_shape.append(tuple(shape[1:]))
        elif cls == "LSTM":
            # fields the LSTM layer does not model fail loudly instead of
            # loading as a silently different function
            for field, default in (("return_sequences", True), ("go_backwards", False),
                                   ("stateful", False), ("use_bias", True)):
                if cfg.get(field, default) != default:
                    raise ValueError(f"unsupported LSTM config {field}={cfg[field]!r}")
            specs.append(("lstm", int(cfg["units"]),
                          _checked_activation(cfg.get("activation", "tanh"), cls),
                          _checked_activation(cfg.get("recurrent_activation", "sigmoid"),
                                              cls)))
        elif cls == "Dense":
            specs.append(("dense", int(cfg["units"]),
                          _checked_activation(cfg.get("activation"), cls),
                          bool(cfg.get("use_bias", True))))
        elif cls == "LayerNormalization":
            specs.append(("layer_norm", float(cfg.get("epsilon", 1e-3))))
        elif cls == "LeakyReLU":
            specs.append(("leaky_relu", float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))))
        elif cls in ("Flatten", "Activation", "Dropout"):
            act = cfg.get("activation")
            if cls == "Activation":
                _checked_activation(act, cls)
            specs.append((cls.lower(), act))
        else:
            raise ValueError(f"unsupported Keras layer in artifact: {cls}")


def parse_model_config(path: str) -> Tuple[Tuple[Spec, ...], Tuple[int, ...]]:
    """h5 ``model_config`` attr → (layer specs, per-sample input shape)."""
    import h5py

    with h5py.File(path, "r") as f:
        cfg = json.loads(_as_str(f.attrs["model_config"]))
    specs: List[Spec] = []
    input_shapes: List[Tuple[int, ...]] = []
    try:
        _flatten_layers([cfg] if "class_name" in cfg else cfg["config"]["layers"],
                        specs, input_shapes)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    if not input_shapes:
        raise ValueError(f"no InputLayer shape found in {path}")
    return tuple(specs), input_shapes[0]


class ImportedSequential(nn.Module):
    """A Sequential generator rebuilt on the port's layers.  The weighted
    layers sit in ``layers`` under ``layer_{i}``, ``i`` the spec's
    position (as the JAX module names its param tree); weightless layers
    (LeakyReLU) have no entry."""

    def __init__(self, specs: Sequence[Spec], input_shape: Sequence[int],
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.specs = tuple(specs)
        self.input_shape = tuple(input_shape)
        # the initial values are overwritten by the artifact's: a local
        # generator keeps the global RNG untouched
        kw = dict(device=dev, generator=torch.Generator().manual_seed(0))
        layers = {}
        width = int(self.input_shape[-1])
        for i, spec in enumerate(self.specs):
            kind, name = spec[0], f"layer_{i}"
            if kind == "lstm":
                layers[name] = KerasLSTM(width, spec[1], activation=spec[2],
                                         recurrent_activation=spec[3], **kw)
                width = spec[1]
            elif kind == "dense":
                layers[name] = KerasDense(width, spec[1], activation=spec[2],
                                          use_bias=spec[3] if len(spec) > 3 else True, **kw)
                width = spec[1]
            elif kind == "layer_norm":
                layers[name] = KerasLayerNorm(width, epsilon=spec[1], **kw)
            elif kind == "flatten":
                width = int(np.prod(self.input_shape[:-1])) * width
        self.layers = nn.ModuleDict(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, spec in enumerate(self.specs):
            kind = spec[0]
            if kind in _WEIGHTED:
                x = self.layers[f"layer_{i}"](x)
            elif kind == "leaky_relu":
                x = leaky_relu(x, spec[1])
            elif kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "activation":
                x = ACTIVATIONS[spec[1]](x)
            elif kind == "dropout":
                pass                                   # inference: identity
            else:  # pragma: no cover - parse_model_config refuses these
                raise ValueError(f"unsupported spec {spec}")
        return x


def _ordered_weight_groups(path: str) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """``model_weights`` as per-layer {basename: array} dicts in the save
    order of the ``weight_names`` attrs: consecutive entries sharing a
    dirname (``sequential_2/lstm_4/lstm_cell_4/kernel:0``) are one layer."""
    import h5py

    groups: List[Tuple[str, Dict[str, np.ndarray]]] = []
    with h5py.File(path, "r") as f:
        mw = f["model_weights"]
        for layer_name in mw.attrs["layer_names"]:
            g = mw[_as_str(layer_name)]
            for wn in g.attrs.get("weight_names", []):
                wn = _as_str(wn)
                dirname, base = wn.rsplit("/", 1)
                base = base.split(":")[0]
                if not groups or groups[-1][0] != dirname:
                    groups.append((dirname, {}))
                groups[-1][1][base] = np.array(g[wn])
    return groups


def load_keras_weights(path: str, specs: Sequence[Spec]) -> Dict[str, Any]:
    """h5 weights → the JAX package's param tree for the specs (numpy
    arrays, Keras layout: ``layer_{i}`` → ``kernel`` / ``Dense_0`` /
    ``LayerNorm_0``)."""
    groups = _ordered_weight_groups(path)
    weighted = [(i, s) for i, s in enumerate(specs) if s[0] in _WEIGHTED]
    if len(groups) != len(weighted):
        raise ValueError(f"{path}: {len(groups)} weighted layer groups in h5 vs "
                         f"{len(weighted)} weighted specs from model_config")
    params: Dict[str, Any] = {}
    for (i, spec), (dirname, w) in zip(weighted, groups):
        kind = spec[0]
        try:
            if kind == "lstm":
                params[f"layer_{i}"] = {k: w[k] for k in ("kernel", "recurrent_kernel", "bias")}
            elif kind == "dense":
                p = {"kernel": w["kernel"]}
                if "bias" in w:
                    p["bias"] = w["bias"]
                params[f"layer_{i}"] = {"Dense_0": p}
            elif kind == "layer_norm":
                params[f"layer_{i}"] = {"LayerNorm_0": {"scale": w["gamma"],
                                                        "bias": w["beta"]}}
        except KeyError as e:  # pragma: no cover - malformed artifact
            raise ValueError(f"{path}: layer group '{dirname}' missing weight {e} "
                             f"for spec {spec}") from e
    return params


def _bind(module: ImportedSequential, params: Dict[str, Any], path: str) -> None:
    """Copy the param tree into the module; every shape must agree."""
    want = {name: {k: tuple(p.shape) for k, p in layer.named_parameters()}
            for name, layer in module.layers.items()}
    flat = {}
    for name, tree in params.items():
        inner = tree.get("Dense_0") or tree.get("LayerNorm_0") or tree
        flat[name] = {k: np.asarray(v) for k, v in inner.items()}
    got = {name: {k: tuple(v.shape) for k, v in t.items()} for name, t in flat.items()}
    if got != want:
        raise ValueError(f"{path}: imported weight shapes do not match model_config "
                         f"architecture:\n  config: {want}\n  h5: {got}")
    with torch.no_grad():
        for name, layer in module.layers.items():
            for k, p in layer.named_parameters():
                p.copy_(torch.from_numpy(np.array(flat[name][k])).to(p.dtype))


def load_keras_generator(path: str, device: DeviceLike = None):
    """Load a generator artifact: ``(module, params, input_shape)``, the
    module carrying the weights on ``device`` (None: the card),
    ``params`` the JAX-layout tree they came from and ``input_shape`` the
    per-sample noise shape, e.g. ``(168, 36)`` for the production
    artifact (``autoencoder_v4.ipynb`` cell 43)."""
    specs, input_shape = parse_model_config(path)
    params = load_keras_weights(path, specs)
    module = ImportedSequential(specs, input_shape, device=device).eval()
    _bind(module, params, path)
    return module, params, tuple(input_shape)
