"""Training spec, losses and metrics: what the reference reads from a
compiled Keras model, narrowed to what its builders compile.

Counterpart of ``KerasIntrospection`` (``elephas_tpu/worker.py:119-337``).
Keras keeps the optimizer, loss and metrics on the model after
``model.compile``; here :func:`compile_model` records them on the module
as a :class:`TrainingSpec`, and :class:`elephas_tpu_torch.worker.Runner`
reads them from there.

The losses return per-sample values, unreduced, as the Keras loss
functions do; a training step takes their mean over every element (Keras's
``sum_over_batch_size``) and adds the auxiliary losses that layers add in
training mode (:func:`add_loss`, Keras's ``add_loss``: the Switch
load-balance loss), collected by :func:`auxiliary_losses` around the
forward. The metrics return per-sample matches, which
:class:`MeanMetric` folds as Keras's ``Mean`` does.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from elephas_tpu_torch.optimizers import hyperparameters

# keras.backend.epsilon(): the clip of probabilities before the log
EPSILON = 1e-7

# the auxiliary losses of the forward running on this thread (hyperparameter
# trials train in threads of their own)
_AUX = threading.local()


@contextlib.contextmanager
def auxiliary_losses():
    """Collect the auxiliary losses that the layers of the forwards run
    inside the block add (:func:`add_loss`), into the list it yields: the
    ``model.losses`` of Keras's training step."""
    outer = getattr(_AUX, "losses", None)
    _AUX.losses = losses = []
    try:
        yield losses
    finally:
        _AUX.losses = outer


def add_loss(value: torch.Tensor) -> None:
    """A layer's auxiliary loss of this forward, for the innermost
    :func:`auxiliary_losses` block around it (dropped outside one)."""
    losses = getattr(_AUX, "losses", None)
    if losses is not None:
        losses.append(value)


def training_loss(module: nn.Module, spec, x, y, weights=None):
    """A training step's forward and the loss it steps on, Keras's total:
    the task loss, as its mean over every value or, with row ``weights``,
    as the weighted mean of each row's mean (rows of zero weight count
    nowhere), plus the auxiliary losses the layers add. Returns ``(loss,
    y_pred)``."""
    with auxiliary_losses() as aux:
        y_pred = module(x)
    values = spec.loss(y, y_pred)
    if weights is None:
        loss = values.mean()
    else:
        rows = values.float().reshape(values.shape[0], -1).mean(dim=1)
        loss = (rows * weights).sum() / weights.sum().clamp_min(1.0)
    if aux:
        loss = loss + torch.stack(aux).sum()
    return loss, y_pred


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


def categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    """One-hot (or soft) ``y_true`` ``[..., C]`` and ``y_pred`` ``[..., C]``
    → values ``[...]``: ``−Σ y_true · log p``, with ``p`` renormalised and
    clipped to ``[ε, 1−ε]`` as in the sparse version."""
    if from_logits:
        log_prob = torch.log_softmax(y_pred, dim=-1)
    else:
        p = y_pred / y_pred.sum(dim=-1, keepdim=True)
        log_prob = torch.log(p.clamp(EPSILON, 1.0 - EPSILON))
    return -(y_true.to(log_prob.dtype) * log_prob).sum(dim=-1)


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


def categorical_accuracy(y_true, y_pred):
    """1.0 where ``argmax(y_pred)`` equals ``argmax(y_true)``, else 0.0."""
    return (y_pred.argmax(dim=-1) == y_true.argmax(dim=-1)).float()


def binary_accuracy(y_true, y_pred, threshold: float = 0.5):
    """1.0 where ``y_pred > threshold`` equals the 0/1 label, else 0.0."""
    if y_true.ndim == y_pred.ndim - 1:
        y_true = y_true[..., None]
    return ((y_pred > threshold).float() == y_true.float()).float()


def mean_squared_error(y_true, y_pred):
    """``mean((y_true − y_pred)²)`` over the last axis, as Keras's."""
    return (y_true.to(y_pred.dtype) - y_pred).square().mean(dim=-1)


LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mean_squared_error": mean_squared_error,
}


def classification_loss(sparse_labels: bool) -> str:
    """The zoo builders' loss: sparse categorical cross-entropy on integer
    labels, categorical on one-hot ones (``sparse_labels=False``)."""
    return "sparse_categorical_crossentropy" if sparse_labels else "categorical_crossentropy"


def _base(fn):
    return fn.func if isinstance(fn, functools.partial) else fn


def _resolve_metric(name: str, loss: Callable) -> Callable:
    """Keras's resolution of ``"accuracy"``: binary for a binary loss,
    sparse categorical for a sparse categorical one, categorical for a
    categorical one."""
    if name != "accuracy":
        raise ValueError(f"unsupported metric {name!r}: the port knows 'accuracy'")
    if _base(loss) is binary_crossentropy:
        return binary_accuracy
    if _base(loss) is sparse_categorical_crossentropy:
        return sparse_categorical_accuracy
    if _base(loss) is categorical_crossentropy:
        return categorical_accuracy
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


def compile_config(model: nn.Module) -> dict:
    """The module's training spec as plain values, for saving: the
    optimizer's class name and hyperparameters, the loss's name in
    :data:`LOSSES` and its keyword arguments, the metrics' names."""
    spec = model.training_spec
    base = _base(spec.loss)
    names = [name for name, fn in LOSSES.items() if fn is base]
    if not names:
        raise ValueError(f"cannot save the loss {spec.loss!r}: not one of {sorted(LOSSES)}")
    keywords = spec.loss.keywords if isinstance(spec.loss, functools.partial) else {}
    return {"optimizer": type(spec.optimizer).__name__,
            "hyperparameters": hyperparameters(spec.optimizer),
            "loss": names[0], "loss_kwargs": dict(keywords),
            "metrics": list(spec.metrics)}


class MeanMetric:
    """Keras's ``Mean`` over per-sample values: each sample's values are
    averaged over their non-batch axes, then ``total += Σ w·value`` and
    ``count += Σ w`` (``w`` = 1 without sample weights), both f32 on the
    values' device, so a step costs no host sync."""

    def __init__(self, device):
        self.total = torch.zeros((), dtype=torch.float32, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device)

    @staticmethod
    def contribution(values):
        """What :meth:`update` without sample weights adds: ``(Σ value, the
        number of samples)``."""
        values = values.float().reshape(values.shape[0], -1).mean(dim=1)
        return values.sum(), values.shape[0]

    def update(self, values, sample_weight=None) -> None:
        if sample_weight is None:
            total, count = self.contribution(values)
            self.total += total
            self.count += count
            return
        values = values.float().reshape(values.shape[0], -1).mean(dim=1)
        self.total += (values * sample_weight).sum()
        self.count += sample_weight.sum()

    def merge(self, other: "MeanMetric") -> None:
        """Add ``other``'s total and count (a block's contribution)."""
        self.total += other.total
        self.count += other.count

    def result(self) -> float:
        """``total / count`` in f32, 0 when nothing was counted."""
        if not self.count.item():
            return 0.0
        return (self.total / self.count).item()
