"""Training, evaluation and prediction programs on one device — the
counterpart of ``elephas_tpu/worker.py``.

The reference runs a whole epoch for all W workers as one XLA program over
a ``('workers',)`` mesh, with ``pmean`` collectives where the mode and
frequency put them (``MeshRunner._build_epoch_fn``, ``:456-519``). The
port drives one device, so W is 1 and every one of those ``pmean``s is
the identity: each of the nine mode × frequency pairs runs the same
program, as the reference does on one device, and gives the same weights.
They are all accepted. More than one worker (``torch.distributed``) is a
later slice (ROADMAP.md, Queue A item 2).

Per step: forward in ``train()`` mode, the compiled loss (the mean over
every element), backward, the optimizer's step. Batches come in the
reference's order, wrap-padded (:func:`pad_to_batches`), with no
shuffling.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

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


class Runner:
    """Runs a compiled module's training, evaluation and prediction on the
    module's device (counterpart of ``MeshRunner`` with one worker).

    The module must carry a training spec
    (:func:`elephas_tpu_torch.training.compile_model`). Each call switches
    the module to ``train()`` or ``eval()`` as it needs and restores the
    mode it found."""

    num_workers = 1

    def __init__(self, model: torch.nn.Module, mode: str, frequency: str):
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
    ) -> dict:
        """Train ``epochs`` epochs; returns a Keras-style history dict: the
        per-epoch mean of the step losses, and each compiled metric
        accumulated over the epoch's padded batches (wrap-padded rows
        count, as in the reference)."""
        if len(partitions) != self.num_workers:
            raise ValueError(
                f"got {len(partitions)} partitions for {self.num_workers} workers"
            )
        xs, ys, _counts, nb = stack_worker_batches(partitions, batch_size)
        xb, yb = self._stage(xs[0]), self._stage(ys[0])
        spec = self.model.training_spec
        history: dict[str, list[float]] = {"loss": []}
        was_training = self.model.training
        self.model.train()
        try:
            for epoch in range(epochs):
                metrics = {name: MeanMetric(self.device) for name in spec.metrics}
                losses = []
                for i in range(nb):
                    y_pred = self.model(xb[i])
                    loss = spec.loss(yb[i], y_pred).mean()
                    spec.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                    spec.optimizer.step()
                    losses.append(loss.detach())
                    with torch.no_grad():
                        for name, fn in spec.metrics.items():
                            metrics[name].update(fn(yb[i], y_pred))
                epoch_loss = torch.stack(losses).mean().item()
                history["loss"].append(epoch_loss)
                for name, metric in metrics.items():
                    history.setdefault(name, []).append(metric.result())
                if verbose:
                    logger.info("epoch %d/%d - loss: %.4f", epoch + 1, epochs, epoch_loss)
        finally:
            self.model.train(was_training)
        return history

    def evaluate(
        self,
        partitions: list[tuple[np.ndarray, np.ndarray]],
        batch_size: int = 32,
    ) -> dict[str, float]:
        """``{'loss': ..., <metric>: ...}`` over the rows, exactly: padding
        rows carry zero sample weight. Each sample's loss is first
        averaged over its non-batch axes (one value per row)."""
        ((x, y),) = self._fit_partitions_to_mesh(partitions)
        n = len(x)
        nb = max(1, int(np.ceil(n / batch_size)))
        total = nb * batch_size
        idx = np.arange(total) % n
        xb = self._stage(x[idx].reshape((nb, batch_size) + x.shape[1:]))
        yb = self._stage(np.asarray(y)[idx].reshape((nb, batch_size) + np.shape(y)[1:]))
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
        """Coalesce ``(x, y)`` partitions to exactly ``num_workers`` (one),
        in order."""
        if len(partitions) == self.num_workers:
            return partitions
        x = np.concatenate([p[0] for p in partitions])
        y = np.concatenate([np.asarray(p[1]) for p in partitions])
        return [(x, y)]
