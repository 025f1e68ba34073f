"""Module <-> plain-dict serialization (counterpart of
``elephas_tpu/utils/serialization.py``: ``model_to_dict`` /
``dict_to_model``).

The reference's dict carries the Keras architecture JSON and the weights.
The port has no architecture format: a module of the zoo is rebuilt from
its builder's name and arguments, which every builder records on the
module it returns (``build_spec``, :func:`~elephas_tpu_torch.models.\
layers.zoo_builder`). The dict holds those, the compile spec (optimizer
class and hyperparameters, loss, metrics), the module's ``state_dict`` and
the optimizer's: strings, numbers, containers and tensors only, so that
``torch.load(weights_only=True)`` reads it and no pickled code runs.
"""

from __future__ import annotations

import functools

import torch

from elephas_tpu_torch import optimizers
from elephas_tpu_torch.device import resolve_device
from elephas_tpu_torch.models.layers import ZOO
from elephas_tpu_torch.training import LOSSES, compile_config, compile_model

_OPTIMIZERS = {"Adam": optimizers.Adam, "SGD": optimizers.SGD}


def model_to_dict(model) -> dict:
    """``{'builder', 'kwargs', 'compile', 'state_dict', 'optimizer'}`` of a
    compiled module of the zoo; raises ``ValueError`` for a module no
    builder of the zoo made."""
    spec = getattr(model, "build_spec", None)
    if spec is None:
        raise ValueError(
            f"cannot save a {type(model).__name__}: only modules built by a "
            f"builder of the zoo ({sorted(ZOO)}) can be rebuilt"
        )
    return {
        "builder": spec["builder"],
        "kwargs": dict(spec["kwargs"]),
        "compile": compile_config(model),
        "state_dict": model.state_dict(),
        "optimizer": model.training_spec.optimizer.state_dict(),
    }


def dict_to_model(dct: dict, device=None):
    """Rebuild the module of :func:`model_to_dict` on ``device`` (``cuda:0``
    by default): its builder with the same arguments, compiled as it was,
    with its weights, buffers and optimizer state."""
    model = ZOO[dct["builder"]](**dct["kwargs"], device=device)
    cfg = dct["compile"]
    loss = LOSSES[cfg["loss"]]
    if cfg["loss_kwargs"]:
        loss = functools.partial(loss, **cfg["loss_kwargs"])
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer = _OPTIMIZERS[cfg["optimizer"]](trainable, **cfg["hyperparameters"])
    compile_model(model, optimizer, loss, cfg["metrics"])
    model.load_state_dict(dct["state_dict"])
    optimizer.load_state_dict(dct["optimizer"])
    return model


def save_model(model, path: str) -> None:
    """:func:`model_to_dict` written with ``torch.save``."""
    torch.save(model_to_dict(model), path)


def load_model(path: str, device=None):
    """The module :func:`save_model` wrote, on ``device``."""
    dev = resolve_device(device)
    return dict_to_model(torch.load(path, map_location=dev, weights_only=True), dev)
