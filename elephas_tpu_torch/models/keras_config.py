"""Build the port's module from the JSON text of a Keras model
(``model.to_json()``, the ``keras_model_config`` param of the ML API),
without Keras.

Counterpart of ``keras.models.model_from_json`` as the reference's
``ElephasEstimator`` and ``ElephasTransformer`` call it
(``elephas_tpu/ml_model.py``). Scope: a ``Sequential`` of ``InputLayer``,
``Dense`` (``units``, ``activation``, ``use_bias``), ``Dropout``,
``Activation`` and ``Flatten``, under the float32 or ``mixed_bfloat16``
policy; the activations ``linear``, ``relu``, ``sigmoid``, ``softmax``
and ``tanh``. Any other class, layer setting or policy, and any
``custom_objects``, raises ``NotImplementedError`` naming its ROADMAP
item. Weights start from Keras's default initialisers
(:func:`~elephas_tpu_torch.models.layers.keras_init`) under ``seed``.

The module's weights cross to and from Keras by
:meth:`KerasSequential.get_weights` / :meth:`~KerasSequential.set_weights`
(Keras's ``get_weights()`` order: each Dense layer's kernel
``[in, out]``, then its bias) and by Keras path
(``<model>/<layer>/kernel``, :func:`elephas_tpu_torch.load_keras_weights`,
matched by layer order as for the zoo's Sequential models).
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.models.layers import Dense, Dropout, build_module, dense_paths
from elephas_tpu_torch.utils.weights import canonical_keras_names

_TODO = "{} is not ported yet (ROADMAP.md, Queue A item 2: the port reads a Sequential of " \
        "InputLayer, Dense, Dropout, Activation and Flatten)"

ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "tanh": torch.tanh,
}
# Dense settings that change the function or the loss; at these values
# they do not
_DENSE_NEUTRAL = {"kernel_regularizer": None, "bias_regularizer": None,
                  "activity_regularizer": None, "kernel_constraint": None,
                  "bias_constraint": None, "lora_rank": None, "quantization_config": None}


def _activation(name):
    if name not in ACTIVATIONS:
        raise NotImplementedError(_TODO.format(f"the activation {name!r}"))
    return ACTIVATIONS[name]


def _policy_name(dtype) -> str | None:
    """The policy name of a Keras ``dtype`` entry (a serialized
    ``DTypePolicy`` or a plain name)."""
    if isinstance(dtype, dict):
        return dtype.get("config", {}).get("name")
    return dtype


class Activation(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.name = name
        self.fn = _activation(name)

    def forward(self, x):
        return self.fn(x)


class KerasDense(Dense):
    """Keras's ``Dense`` with its activation."""

    def __init__(self, in_features, units, activation, use_bias):
        super().__init__(in_features, units, bias=use_bias)
        self.activation = _activation(activation)

    def forward(self, x):
        return self.activation(super().forward(x))


class KerasSequential(nn.Module):
    """The layers of a Keras ``Sequential``, in order; its ``Dense``
    layers keep their Keras names (``keras_names``)."""

    def __init__(self, name: str, layers: list[tuple[str, nn.Module]]):
        super().__init__()
        self.keras_sequential = name
        self.keras_names = [n for n, _ in layers]
        self.layers = nn.ModuleList([m for _, m in layers])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def _dense(self):
        return [(n, m) for n, m in zip(self.keras_names, self.layers) if isinstance(m, Dense)]

    def keras_paths(self) -> dict:
        """Keras paths as a fresh process names the layers (the JSON's
        names renumbered by kind, as :func:`~elephas_tpu_torch.utils.\
weights.canonical_keras_names` matches a Sequential's weights)."""
        paths = {}
        for n, m in self._dense():
            paths.update(dense_paths(f"{self.keras_sequential}/{n}", m))
        names = canonical_keras_names(self, paths)
        return {names[p]: v for p, v in paths.items()}

    def get_weights(self) -> list[np.ndarray]:
        """Keras's ``get_weights()``: each Dense layer's kernel ``[in, out]``
        and bias, as host float32 arrays."""
        out = []
        for _, m in self._dense():
            out.append(m.weight.detach().cpu().numpy().T.copy())
            if m.bias is not None:
                out.append(m.bias.detach().cpu().numpy().copy())
        return out

    def set_weights(self, weights) -> None:
        """The inverse of :meth:`get_weights`; raises ``ValueError`` on a
        count or shape that does not fit, copying nothing."""
        tensors = []
        for _, m in self._dense():
            tensors.append((m.weight, True))
            if m.bias is not None:
                tensors.append((m.bias, False))
        weights = [np.asarray(w) for w in weights]
        if len(weights) != len(tensors):
            raise ValueError(f"{len(weights)} weights for a model of {len(tensors)}")
        staged = []
        for (t, kernel), w in zip(tensors, weights):
            arr = w.T if kernel else w
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"a weight of shape {w.shape} does not fit {tuple(t.shape)}")
            staged.append((t, torch.tensor(np.ascontiguousarray(arr), dtype=t.dtype)))
        with torch.no_grad():
            for t, value in staged:
                t.copy_(value)


def _input_shape(config: dict, layers: list[dict]) -> tuple:
    if layers and layers[0].get("class_name") == "InputLayer":
        lc = layers[0]["config"]
        shape = lc.get("batch_shape") or lc.get("batch_input_shape")
    else:
        shape = config.get("build_input_shape")
    if not shape or any(s is None for s in shape[1:]):
        raise ValueError(f"the model's input shape is not fixed: {shape}")
    return tuple(int(s) for s in shape[1:])


def model_from_json(model_json: str, custom_objects: dict | None = None, seed: int = 0,
                    device=None) -> KerasSequential:
    """The module that ``model_json`` (``keras_model.to_json()``) describes,
    uncompiled, in eval mode on ``device`` (``cuda:0`` by default), its
    weights Keras's default initialisers from ``seed``."""
    if custom_objects:
        raise NotImplementedError(_TODO.format(f"custom_objects {sorted(custom_objects)}"))
    spec = json.loads(model_json) if isinstance(model_json, str) else model_json
    if spec.get("class_name") != "Sequential":
        raise NotImplementedError(_TODO.format(f"a {spec.get('class_name')!r} model"))
    config = spec["config"]
    layers = config.get("layers", [])
    policy = _policy_name(config.get("dtype"))
    shape = _input_shape(config, layers)
    built: list[tuple[str, object]] = []
    for i, layer in enumerate(layers):
        kind, lc = layer.get("class_name"), layer.get("config", {})
        if kind == "InputLayer":
            continue
        if _policy_name(lc.get("dtype", policy)) not in (policy, None):
            raise NotImplementedError(_TODO.format(
                f"layer {lc.get('name')!r} under its own dtype policy {lc.get('dtype')!r}"))
        name = lc.get("name", f"{kind.lower()}_{i}")
        if kind == "Dense":
            off = {k: lc[k] for k, v in _DENSE_NEUTRAL.items() if lc.get(k, v) != v}
            if off:
                raise NotImplementedError(_TODO.format(f"Dense {name!r} with {off}"))
            units, act, bias = int(lc["units"]), lc.get("activation"), lc.get("use_bias", True)
            built.append((name, ("dense", shape[-1], units, act, bias)))
            shape = shape[:-1] + (units,)
        elif kind == "Dropout":
            if lc.get("noise_shape") is not None:
                raise NotImplementedError(_TODO.format(f"Dropout {name!r} with a noise_shape"))
            built.append((name, ("dropout", float(lc["rate"]), lc.get("seed"), i)))
        elif kind == "Activation":
            built.append((name, ("activation", lc.get("activation"))))
        elif kind == "Flatten":
            built.append((name, ("flatten",)))
            shape = (math.prod(shape),)
        else:
            raise NotImplementedError(_TODO.format(f"the layer {kind!r}"))

    def make(entry):
        kind = entry[0]
        if kind == "dense":
            return KerasDense(*entry[1:])
        if kind == "dropout":
            _, rate, layer_seed, i = entry
            return Dropout(rate, seed + i if layer_seed is None else int(layer_seed))
        if kind == "activation":
            return Activation(entry[1])
        return nn.Flatten()

    return build_module(
        lambda: KerasSequential(config.get("name", "sequential"),
                                [(n, make(e)) for n, e in built]),
        seed, policy, device)
