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
    of ``module``'s weights, in Keras's layouts (copies on the host);
    a Sequential model's paths as a fresh process names them."""
    out = {}
    for path, (tensor, perm) in _keras_paths(module).items():
        arr = tensor.detach().cpu().numpy()
        out[path] = np.ascontiguousarray(arr if perm is None else arr.transpose(np.argsort(perm)))
    return out
