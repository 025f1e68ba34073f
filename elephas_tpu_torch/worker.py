"""Training, evaluation and prediction over W workers on one device —
the counterpart of ``elephas_tpu/worker.py``.

The reference runs a whole epoch for all W workers as one XLA program over
a ``('workers',)`` mesh, the state stacked ``[W, ...]``, with ``pmean``
collectives where the mode and frequency put them
(``MeshRunner._build_epoch_fn``, ``:456-519``). The port keeps W replica
modules on the one device the caller names: worker 0 is the master module
itself, and each other worker a copy of it (:func:`replicate`) with its
own optimizer over its own parameters, starting from the master's
optimizer state (the reference broadcasts one state to every worker,
``_device_state``). The workers step in turn inside one global step; the
collectives are means over the W replicas' tensors:

- ``synchronous`` with ``epoch`` or ``batch``: every step, the gradients
  and the float state (BatchNorm's moving statistics) are averaged before
  each worker's optimizer step (:func:`mean_gradients`), so the replicas
  stay bit-identical;
- ``asynchronous`` and ``hogwild`` (the same schedule, as in the
  reference): the weights and float state are averaged after every step
  with ``batch``, at the end of each epoch with ``epoch``
  (:func:`mean_weights`); optimizer state is never averaged;
- any mode with ``fit``: no collective inside the fit, one average of the
  weights and float state at its end.

Integer state is not averaged, and a dropout layer's generator is no
tensor of the module: each replica draws from its own copy of the
master's. The master keeps worker 0's weights, state and optimizer state,
as the reference writes worker 0 back (``_write_back``, ``:438-446``).
With one worker every collective is the identity, and the nine pairs
train identically.

Per worker step: forward in ``train()`` mode, the compiled loss (the mean
over every element), backward, the optimizer's step. Batches come in the
reference's order, wrap-padded (:func:`pad_to_batches`), with no
shuffling.
"""

from __future__ import annotations

import copy
import dataclasses
import logging

import numpy as np
import torch

from elephas_tpu_torch.optimizers import hyperparameters
from elephas_tpu_torch.training import MeanMetric

logger = logging.getLogger(__name__)

MODES = ("synchronous", "asynchronous", "hogwild")
FREQUENCIES = ("epoch", "batch", "fit")


def pad_to_batches(x: np.ndarray, num_batches: int, batch_size: int) -> np.ndarray:
    """Wrap-pad rows so ``x`` reshapes to ``[num_batches, batch_size, ...]``
    (wrap-around duplication, as the reference pads)."""
    n = len(x)
    total = num_batches * batch_size
    if n == 0:
        raise ValueError("cannot pad an empty partition")
    idx = np.arange(total) % n
    return x[idx].reshape((num_batches, batch_size) + x.shape[1:])


def stack_worker_batches(
    partitions: list[tuple[np.ndarray, np.ndarray]],
    batch_size: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Partition arrays → ``x[W, nb, B, ...]``, ``y[W, nb, B, ...]``, the
    per-worker true sample counts and the common batch count (the max over
    workers — shorter partitions wrap)."""
    counts = np.array([len(x) for x, _ in partitions])
    nb = max(1, int(np.ceil(counts.max() / batch_size)))
    xs = np.stack([pad_to_batches(x, nb, batch_size) for x, _ in partitions])
    ys = np.stack([pad_to_batches(y, nb, batch_size) for _, y in partitions])
    return xs, ys, counts, nb


def replicate(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of a compiled module for another worker, on the same device:
    its own parameters and buffers, and its own optimizer (the master's
    class and hyperparameters) over the copy's parameters, holding a copy
    of the master's optimizer state."""
    spec = model.training_spec
    # the spec is swapped below: do not copy the master's optimizer with it
    replica = copy.deepcopy(model, {id(spec): spec})
    position = {p: i for i, p in enumerate(model.parameters())}
    params = list(replica.parameters())
    opt = spec.optimizer
    groups = [dict(g, params=[params[position[p]] for p in g["params"]])
              for g in opt.param_groups]
    own = type(opt)(groups, **hyperparameters(opt))
    # load_state_dict keeps tensors that need no cast: copy, or the two
    # optimizers would step one m and v
    own.load_state_dict(copy.deepcopy(opt.state_dict()))
    replica.training_spec = dataclasses.replace(spec, optimizer=own)
    return replica


def _trainable(model) -> list[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


def _float_state(model) -> list[torch.Tensor]:
    """The float tensors of the module's state that are not trained: its
    persistent float buffers (BatchNorm's moving statistics)."""
    persistent = model.state_dict(keep_vars=True)
    return [b for name, b in model.named_buffers()
            if name in persistent and b.is_floating_point()]


@torch.no_grad()
def _mean_into(per_worker: list[list[torch.Tensor]]) -> None:
    """Copy each position's mean over the workers into every worker's
    tensor (``lax.pmean``)."""
    for tensors in zip(*per_worker):
        mean = torch.stack(tensors).mean(0)
        for t in tensors:
            t.copy_(mean)


@torch.no_grad()
def mean_gradients(replicas) -> None:
    """The synchronous collective: each trainable parameter's gradient
    becomes the mean over the workers (one tensor, shared by every
    replica), and the float state the mean of the replicas' (worker.py
    ``:481-482``)."""
    for params in zip(*map(_trainable, replicas)):
        mean = torch.stack([p.grad if p.grad is not None else torch.zeros_like(p)
                            for p in params]).mean(0)
        for p in params:
            p.grad = mean
    _mean_into([_float_state(r) for r in replicas])


def mean_weights(replicas) -> None:
    """The local-SGD collective: trainable parameters and float state
    become their means over the workers (worker.py ``:485-486``,
    ``:496-498``, and the ``fit`` frequency's average, ``:566-581``)."""
    _mean_into([_trainable(r) + _float_state(r) for r in replicas])


class Runner:
    """Runs a compiled module's training, evaluation and prediction on the
    module's device, over ``num_workers`` workers (counterpart of
    ``MeshRunner``).

    The module must carry a training spec
    (:func:`elephas_tpu_torch.training.compile_model`). Each call switches
    the module to ``train()`` or ``eval()`` as it needs and restores the
    mode it found. Evaluation and prediction run the master alone over
    every row: after a fit every replica equals it, or it holds worker 0's
    state, which the reference evaluates too."""

    def __init__(self, model: torch.nn.Module, mode: str, frequency: str,
                 num_workers: int = 1):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if frequency not in FREQUENCIES:
            raise ValueError(
                f"frequency must be one of {FREQUENCIES}, got {frequency!r}"
            )
        if getattr(model, "training_spec", None) is None:
            raise ValueError(
                "model must be compiled (optimizer/loss/metrics) before "
                "training: see elephas_tpu_torch.training.compile_model"
            )
        self.model = model
        self.mode = mode
        self.frequency = frequency
        self.num_workers = num_workers

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → device tensor; integers (tokens, labels) as int64,
        as the embedding and the label gather take them."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def run_epochs(
        self,
        partitions: list[tuple[np.ndarray, np.ndarray]],
        epochs: int,
        batch_size: int,
        verbose: int = 0,
        callbacks=(),
    ) -> dict:
        """Train ``epochs`` epochs, one partition a worker; returns a
        Keras-style history dict: each epoch's loss is the mean over the
        workers of each worker's mean step loss, and each compiled metric
        is accumulated over every worker's padded batches (wrap-padded rows
        count, as in the reference). After each epoch every
        ``callbacks(epoch, loss)`` runs, the master holding worker 0's
        state."""
        if len(partitions) != self.num_workers:
            raise ValueError(
                f"got {len(partitions)} partitions for {self.num_workers} workers"
            )
        xs, ys, _counts, nb = stack_worker_batches(partitions, batch_size)
        xb, yb = self._stage(xs), self._stage(ys)
        replicas = [self.model] + [replicate(self.model) for _ in range(self.num_workers - 1)]
        several = len(replicas) > 1
        synchronous = self.mode == "synchronous"
        metric_names = self.model.training_spec.metrics
        history: dict[str, list[float]] = {"loss": []}
        was_training = self.model.training
        for rep in replicas:
            rep.train()
        try:
            for epoch in range(epochs):
                metrics = {name: MeanMetric(self.device) for name in metric_names}
                losses = [[] for _ in replicas]
                for i in range(nb):
                    for w, rep in enumerate(replicas):
                        spec = rep.training_spec
                        y_pred = rep(xb[w, i])
                        loss = spec.loss(yb[w, i], y_pred).mean()
                        spec.optimizer.zero_grad(set_to_none=True)
                        loss.backward()
                        losses[w].append(loss.detach())
                        with torch.no_grad():
                            for name, fn in spec.metrics.items():
                                metrics[name].update(fn(yb[w, i], y_pred))
                    if several and synchronous and self.frequency != "fit":
                        mean_gradients(replicas)
                    for rep in replicas:
                        rep.training_spec.optimizer.step()
                    if several and not synchronous and self.frequency == "batch":
                        mean_weights(replicas)
                if several and not synchronous and self.frequency == "epoch":
                    mean_weights(replicas)
                epoch_loss = torch.stack([torch.stack(l).mean() for l in losses]).mean().item()
                history["loss"].append(epoch_loss)
                for name, metric in metrics.items():
                    history.setdefault(name, []).append(metric.result())
                if verbose:
                    logger.info("epoch %d/%d - loss: %.4f", epoch + 1, epochs, epoch_loss)
                for cb in callbacks:
                    cb(epoch, epoch_loss)
            if several and self.frequency == "fit":
                mean_weights(replicas)
        finally:
            self.model.train(was_training)
        return history

    def evaluate(
        self,
        partitions: list[tuple[np.ndarray, np.ndarray]],
        batch_size: int = 32,
    ) -> dict[str, float]:
        """``{'loss': ..., <metric>: ...}`` over the rows of the partitions
        as the reference shapes them for its workers (a worker left
        without rows evaluates a copy of the first row, as there), exactly:
        padding rows carry zero sample weight. Each sample's loss is first
        averaged over its non-batch axes (one value per row)."""
        parts = self._fit_partitions_to_mesh(partitions)
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([np.asarray(p[1]) for p in parts])
        n = len(x)
        nb = max(1, int(np.ceil(n / batch_size)))
        total = nb * batch_size
        idx = np.arange(total) % n
        xb = self._stage(x[idx].reshape((nb, batch_size) + x.shape[1:]))
        yb = self._stage(y[idx].reshape((nb, batch_size) + y.shape[1:]))
        wb = self._stage((np.arange(total) < n).astype(np.float32).reshape(nb, batch_size))
        spec = self.model.training_spec
        loss = MeanMetric(self.device)
        metrics = {name: MeanMetric(self.device) for name in spec.metrics}
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                for i in range(nb):
                    y_pred = self.model(xb[i])
                    loss.update(spec.loss(yb[i], y_pred), wb[i])
                    for name, fn in spec.metrics.items():
                        metrics[name].update(fn(yb[i], y_pred), wb[i])
        finally:
            self.model.train(was_training)
        return {"loss": loss.result(), **{k: m.result() for k, m in metrics.items()}}

    def predict(self, feature_partitions: list[np.ndarray], batch_size: int = 32) -> np.ndarray:
        """The module's outputs for every row, in input order, as a host
        float array."""
        parts = [p for p in feature_partitions if len(p)]
        if not parts:
            raise ValueError("predict: no input rows")
        x = np.concatenate(parts) if len(parts) > 1 else parts[0]
        n = len(x)
        nb = max(1, int(np.ceil(n / batch_size)))
        xb = self._stage(pad_to_batches(x, nb, batch_size))
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                preds = torch.cat([self.model(xb[i]) for i in range(nb)])
        finally:
            self.model.train(was_training)
        return preds[:n].cpu().numpy()

    def _fit_partitions_to_mesh(self, partitions):
        """Coalesce or split ``(x, y)`` partitions to exactly
        ``num_workers``, in order (``np.array_split``); a worker left
        without rows gets the first row."""
        if len(partitions) == self.num_workers:
            return partitions
        x = np.concatenate([p[0] for p in partitions])
        y = np.concatenate([np.asarray(p[1]) for p in partitions])
        xs = np.array_split(x, self.num_workers)
        offsets = np.cumsum([0] + [len(a) for a in xs])
        return [(a, y[offsets[i]:offsets[i + 1]]) if len(a) else (xs[0][:1], y[:1])
                for i, a in enumerate(xs)]
