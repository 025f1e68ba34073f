"""The reference's Keras weights in and out of the port's modules, by
Keras variable path.

Every model of the port lists its Keras paths (``keras_paths()``:
``{path: (tensor, permutation of the Keras axes)}``), BatchNorm's
non-trainable moving statistics included. Functional models (the
transformers, ResNet) have stable paths (``stem_bn/moving_variance``,
``blk0_attn/qkv/kernel``). A Keras ``Sequential`` model (``mnist_mlp``,
``cifar10_cnn``, ``imdb_lstm``: the module's ``keras_sequential`` names
it) names its layers from a counter global to the process
(``mnist_mlp/dense_3/kernel`` the second time one is built), so its
weights are matched by layer order, weight role and shape: the layers of
one kind are renumbered in the order of their counters
(:func:`canonical_keras_names`), as a fresh process would name them.

Every module lists its paths in Keras's ``model.weights`` order, so
:func:`get_weights` / :func:`set_weights` give and take the list that
Keras's ``model.get_weights()`` / ``set_weights()`` do: the order the
parameter server's wire carries between the two packages.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"(.*?)(?:_(\d+))?")


def _keras_paths(module) -> dict:
    """Keras variable path → (the port's tensor, the permutation of the
    Keras array's axes into it, or None)."""
    if not hasattr(module, "keras_paths"):
        raise ValueError(f"{type(module).__name__} has no Keras weight paths")
    return module.keras_paths()


def canonical_keras_names(module, paths) -> dict[str, str]:
    """For a Sequential ``module``: each of ``paths`` (Keras variable
    paths ``<model>/<layer>/.../<role>``) → its path as a fresh process
    would name it (the first ``dense`` layer ``dense``, the next
    ``dense_1``, ... in the order of their counters). Other modules' paths
    map to themselves."""
    name = getattr(module, "keras_sequential", None)
    if name is None:
        return {p: p for p in paths}
    ordinals: dict[str, set[int]] = {}
    parsed = {}
    for path in paths:
        parts = path.split("/")
        if len(parts) < 3 or parts[0] != name:
            parsed[path] = None
            continue
        kind, n = _LAYER.fullmatch(parts[1]).groups()
        ordinals.setdefault(kind, set()).add(int(n or 0))
        parsed[path] = (kind, int(n or 0), parts[2:])
    rank = {kind: {n: i for i, n in enumerate(sorted(ns))} for kind, ns in ordinals.items()}
    out = {}
    for path, p in parsed.items():
        if p is None:
            out[path] = path
            continue
        kind, n, rest = p
        i = rank[kind][n]
        out[path] = "/".join([name, kind if i == 0 else f"{kind}_{i}", *rest])
    return out


def load_keras_weights(module, weights: dict[str, np.ndarray]) -> None:
    """Copy a reference model's weights into ``module`` in place.

    ``weights`` is keyed by Keras variable path, as
    ``{v.path: np.asarray(v) for v in keras_model.weights}`` gives it
    (``tok_embed/embeddings``, ``blk0_attn/qkv/kernel``,
    ``s0_b0_bn1/moving_mean``, ``mnist_mlp/dense_3/kernel``, ...). Raises
    ``ValueError`` on a missing, unexpected or mis-shaped key; nothing is
    copied unless every key fits."""
    paths = _keras_paths(module)
    names = canonical_keras_names(module, weights)
    given = {names[p]: p for p in weights}
    missing = sorted(set(paths) - set(given))
    unexpected = sorted(given[p] for p in set(given) - set(paths))
    if missing or unexpected or len(given) != len(weights):
        raise ValueError(
            f"Keras weights do not match the module: missing {missing}, "
            f"unexpected {unexpected}"
        )
    staged = []
    for path, (tensor, perm) in paths.items():
        src = np.asarray(weights[given[path]])
        arr = src if perm is None else src.transpose(perm)
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(
                f"{given[path]}: Keras shape {src.shape} does not fit the "
                f"module's {tuple(tensor.shape)}"
                + ("" if perm is None else f" (axes {perm} of the Keras array)")
            )
        staged.append((tensor, torch.tensor(np.ascontiguousarray(arr))))
    with torch.no_grad():
        for tensor, value in staged:
            tensor.copy_(value)


def keras_weights(module) -> dict[str, np.ndarray]:
    """The inverse of :func:`load_keras_weights`: ``{Keras path: array}``
    of ``module``'s weights, in Keras's layouts, as host arrays that own
    their memory; a Sequential model's paths as a fresh process names
    them. The copies are complete when this returns, so later in-place
    updates of the module (an optimizer step, on the device or the CPU)
    cannot tear them."""
    out = {}
    for path, (tensor, perm) in _keras_paths(module).items():
        t = tensor.detach()
        if perm is not None:
            t = t.permute(*np.argsort(perm).tolist())
        # Keras's layout made where the tensor lies (a transpose is exact),
        # then one blocking copy into host memory of its own
        out[path] = t.to("cpu", memory_format=torch.contiguous_format, copy=True).numpy()
    return out


def weight_paths(module) -> list[str]:
    """``module``'s Keras paths in Keras's ``model.weights`` order."""
    return list(_keras_paths(module))


def get_weights(module) -> list[np.ndarray]:
    """Keras's ``model.get_weights()``: :func:`keras_weights`'s arrays in
    ``model.weights`` order (BatchNorm's moving statistics included)."""
    return list(keras_weights(module).values())


def set_weights(module, weights) -> None:
    """The inverse of :func:`get_weights`: copy a weight list in Keras's
    order into ``module`` (checked as :func:`load_keras_weights` checks)."""
    paths = weight_paths(module)
    weights = list(weights)
    if len(weights) != len(paths):
        raise ValueError(f"{len(weights)} weights for a model of {len(paths)}")
    load_keras_weights(module, dict(zip(paths, weights)))
