"""Training spec, losses and metrics: what the reference reads from a
compiled Keras model, narrowed to what its builders compile.

Counterpart of ``KerasIntrospection`` (``elephas_tpu/worker.py:119-337``).
Keras keeps the optimizer, loss and metrics on the model after
``model.compile``; here :func:`compile_model` records them on the module
as a :class:`TrainingSpec`, and :class:`elephas_tpu_torch.worker.Runner`
reads them from there.

The losses return per-sample values, unreduced, as the Keras loss
functions do; a training step takes their mean over every element (Keras's
``sum_over_batch_size``). The metrics return per-sample matches, which
:class:`MeanMetric` folds as Keras's ``Mean`` does.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

# keras.backend.epsilon(): the clip of probabilities before the log
EPSILON = 1e-7


def sparse_categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    """``y_true`` int ``[...]`` (or ``[..., 1]``), ``y_pred`` ``[..., C]``
    → values ``[...]``. From probabilities as Keras computes it:
    renormalise, clip to ``[ε, 1−ε]``, then log."""
    if y_true.ndim == y_pred.ndim and y_true.shape[-1] == 1:
        y_true = y_true[..., 0]
    if from_logits:
        log_prob = torch.log_softmax(y_pred, dim=-1)
    else:
        p = y_pred / y_pred.sum(dim=-1, keepdim=True)
        log_prob = torch.log(p.clamp(EPSILON, 1.0 - EPSILON))
    return -log_prob.gather(-1, y_true.long()[..., None])[..., 0]


def binary_crossentropy(y_true, y_pred):
    """Probabilities ``y_pred`` ``[..., K]`` and 0/1 ``y_true`` (``[...]``
    gains the trailing axis) → values ``[...]``, the mean over the last
    axis, with Keras's clip to ``[ε, 1−ε]``."""
    y_true = y_true.to(y_pred.dtype)
    if y_true.ndim == y_pred.ndim - 1:
        y_true = y_true[..., None]
    p = y_pred.clamp(EPSILON, 1.0 - EPSILON)
    bce = y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p)
    return (-bce).mean(dim=-1)


def sparse_categorical_accuracy(y_true, y_pred):
    """1.0 where ``argmax(y_pred)`` equals the label, else 0.0."""
    if y_true.ndim == y_pred.ndim and y_true.shape[-1] == 1:
        y_true = y_true[..., 0]
    return (y_pred.argmax(dim=-1) == y_true.long()).float()


def binary_accuracy(y_true, y_pred, threshold: float = 0.5):
    """1.0 where ``y_pred > threshold`` equals the 0/1 label, else 0.0."""
    if y_true.ndim == y_pred.ndim - 1:
        y_true = y_true[..., None]
    return ((y_pred > threshold).float() == y_true.float()).float()


LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
}


def _base(fn):
    return fn.func if isinstance(fn, functools.partial) else fn


def _resolve_metric(name: str, loss: Callable) -> Callable:
    """Keras's resolution of ``"accuracy"``: binary for a binary loss,
    sparse categorical for a sparse categorical one."""
    if name != "accuracy":
        raise ValueError(f"unsupported metric {name!r}: the port knows 'accuracy'")
    if _base(loss) is binary_crossentropy:
        return binary_accuracy
    if _base(loss) is sparse_categorical_crossentropy:
        return sparse_categorical_accuracy
    raise ValueError(f"no 'accuracy' for the loss {loss!r}")


@dataclass
class TrainingSpec:
    """What ``model.compile`` records: the optimizer over the module's
    parameters, the per-sample loss, and named per-sample metrics."""

    optimizer: torch.optim.Optimizer
    loss: Callable
    metrics: dict[str, Callable]


def compile_model(model: nn.Module, optimizer: torch.optim.Optimizer, loss,
                  metrics=()) -> nn.Module:
    """Record the training spec on ``model`` (as ``model.training_spec``)
    and return it. ``loss`` is a name from :data:`LOSSES` or a callable
    ``(y_true, y_pred) → per-sample values``; ``metrics`` holds names."""
    if isinstance(loss, str):
        if loss not in LOSSES:
            raise ValueError(f"unsupported loss {loss!r}: one of {sorted(LOSSES)}")
        loss = LOSSES[loss]
    model.training_spec = TrainingSpec(
        optimizer, loss, {name: _resolve_metric(name, loss) for name in metrics}
    )
    return model


class MeanMetric:
    """Keras's ``Mean`` over per-sample values: each sample's values are
    averaged over their non-batch axes, then ``total += Σ w·value`` and
    ``count += Σ w`` (``w`` = 1 without sample weights), both f32 on the
    values' device, so a step costs no host sync."""

    def __init__(self, device):
        self.total = torch.zeros((), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device)

    def update(self, values, sample_weight=None) -> None:
        values = values.float().reshape(values.shape[0], -1).mean(dim=1)
        if sample_weight is None:
            self.total += values.sum()
            self.count += values.shape[0]
        else:
            self.total += (values * sample_weight).sum()
            self.count += sample_weight.sum()

    def result(self) -> float:
        """``total / count`` in f32, 0 when nothing was counted."""
        if not self.count.item():
            return 0.0
        return (self.total / self.count).item()
