"""The reference's Keras weights in and out of the port's modules, by
Keras variable path."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from elephas_tpu_torch.models.transformer import FusedLayerNorm, _Transformer


def _keras_paths(module: _Transformer) -> dict[str, tuple[torch.Tensor, bool]]:
    """Keras variable path → (the port's parameter, whether the Keras
    array is transposed into it). Keras Dense kernels are ``[in, out]``;
    ``nn.Linear`` weights are ``[out, in]``."""
    paths = {"tok_embed/embeddings": (module.tok_embed.weight, False)}

    def dense(prefix: str, lin: nn.Linear):
        paths[f"{prefix}/kernel"] = (lin.weight, True)
        if lin.bias is not None:
            paths[f"{prefix}/bias"] = (lin.bias, False)

    def norm(prefix: str, ln: FusedLayerNorm):
        paths[f"{prefix}/gamma"] = (ln.gamma, False)
        paths[f"{prefix}/beta"] = (ln.beta, False)

    for i, blk in enumerate(module.blocks):
        norm(f"blk{i}_ln1", blk.ln1)
        dense(f"blk{i}_attn/qkv", blk.attn.qkv)
        dense(f"blk{i}_attn/proj", blk.attn.proj)
        norm(f"blk{i}_ln2", blk.ln2)
        dense(f"blk{i}_mlp1", blk.mlp1)
        dense(f"blk{i}_mlp2", blk.mlp2)
    norm("final_ln", module.final_ln)
    for head in ("lm_head", "head"):
        if hasattr(module, head):
            dense(head, getattr(module, head))
    return paths


def load_keras_weights(module: _Transformer, weights: dict[str, np.ndarray]) -> None:
    """Copy a reference model's weights into ``module`` in place.

    ``weights`` is keyed by Keras variable path, as
    ``{v.path: np.asarray(v) for v in keras_model.weights}`` gives it
    (``tok_embed/embeddings``, ``blk0_attn/qkv/kernel``, ...). Raises
    ``ValueError`` on a missing, unexpected or mis-shaped key; nothing is
    copied unless every key fits."""
    paths = _keras_paths(module)
    missing = sorted(set(paths) - set(weights))
    unexpected = sorted(set(weights) - set(paths))
    if missing or unexpected:
        raise ValueError(
            f"Keras weights do not match the module: missing {missing}, "
            f"unexpected {unexpected}"
        )
    staged = []
    for path, (param, transpose) in paths.items():
        arr = np.asarray(weights[path])
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"{path}: Keras shape {np.asarray(weights[path]).shape} does "
                f"not fit the module's {tuple(param.shape)}"
                + (" (transposed)" if transpose else "")
            )
        staged.append((param, torch.tensor(arr)))
    with torch.no_grad():
        for param, value in staged:
            param.copy_(value)


def keras_weights(module: _Transformer) -> dict[str, np.ndarray]:
    """The inverse of :func:`load_keras_weights`: ``{Keras path: array}``
    of ``module``'s weights, Dense kernels transposed back to ``[in,
    out]`` (copies on the host)."""
    out = {}
    for path, (param, transpose) in _keras_paths(module).items():
        arr = param.detach().cpu().numpy()
        out[path] = np.ascontiguousarray(arr.T if transpose else arr)
    return out
