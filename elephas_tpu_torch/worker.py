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
shuffling. :meth:`Runner.run_epochs` stages a whole epoch on the device;
:meth:`Runner.run_epochs_stream` takes the same steps in blocks of a
:class:`~elephas_tpu_torch.data.streaming.ShardedStream`, which
:class:`BlockStager` moves onto the device while it trains.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
import math
import threading
import time

import numpy as np
import torch

from elephas_tpu_torch.data.streaming import prefetch_blocks
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


class BlockStager:
    """The device blocks of a stream's epochs, for the worker steps.
    Integer arrays (tokens, labels) cross in their own width (int32 tokens
    as int32) and become int64 on the device.

    On ``cuda`` the host makes one copy of each row and the card's copy
    overlaps its work on earlier blocks. The reader thread of
    :func:`~elephas_tpu_torch.data.streaming.prefetch_blocks` gathers each
    block straight into one of two reused pinned host buffers (a flat view
    of it for a short last block), after waiting on the event of the last
    copy out of that buffer, and at once copies it with
    ``non_blocking=True`` on a side stream into memory allocated on that
    stream (``record_stream`` keeps the caching allocator from handing it
    on while the compute stream reads it). The compute stream waits on the
    copy's event before the block's first step; nothing synchronizes the
    host with the card per block. A failed pin, copy or stream raises:
    there is no synchronous fallback. On the CPU the blocks go through as
    tensors, with no pinning and no streams.

    ``log``, when a list, receives one entry a block on ``cuda``:
    ``bytes`` copied, CUDA events ``start`` and ``end`` around the copy on
    the side stream (timed; read them after a synchronize), and
    ``gather_ms`` with the ``gather_thread`` that gathered it."""

    def __init__(self, device: torch.device, log: list | None = None):
        self.device = device
        self.log = log
        self.pinned_bytes = 0
        self._pinned: list[list[torch.Tensor]] | None = None
        self._copied: list[torch.cuda.Event | None] = [None, None]

    def blocks(self, stream, epochs: int = 1):
        """Yields ``(x [W, steps, B, ...], y, steps)`` on the device for
        ``epochs`` epochs of ``stream``, one after the other, from one
        reader thread."""
        if self.device.type != "cuda":
            host = itertools.chain.from_iterable(stream.blocks() for _ in range(epochs))
            for xs, ys, steps in prefetch_blocks(host):
                yield _as_input(torch.from_numpy(xs)), _as_input(torch.from_numpy(ys)), steps
            return
        if self._pinned is None:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._pinned = [self._pin(stream) for _ in range(2)]
        compute = torch.cuda.current_stream(self.device)
        gathered = prefetch_blocks(self._gather_and_copy(stream, epochs, compute))
        try:
            for dev, steps, copied in gathered:
                compute.wait_event(copied)
                yield _as_input(dev[0]), _as_input(dev[1]), steps
        finally:
            gathered.close()

    def _gather_and_copy(self, stream, epochs, compute):
        """In the reader thread: each block gathered into the next pinned
        buffer, then copied to the card on the side stream; yields the
        device arrays, the block's steps and the copy's event."""
        timed = self.log is not None
        ranges = itertools.chain.from_iterable(stream.step_ranges() for _ in range(epochs))
        for b, (lo, hi) in enumerate(ranges):
            slot = b % 2
            if self._copied[slot] is not None:
                self._copied[slot].synchronize()
            views = [_view(buf, (stream.num_workers, hi - lo) + shape)
                     for buf, shape in zip(self._pinned[slot], self._row_shapes)]
            t0 = time.perf_counter()
            stream.gather(lo, hi, out=[v.numpy() for v in views])
            gather_ms = (time.perf_counter() - t0) * 1e3
            with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
                start = torch.cuda.Event(enable_timing=True) if timed else None
                if timed:
                    start.record()
                dev = [torch.empty(v.shape, dtype=v.dtype, device=self.device) for v in views]
                for d, v in zip(dev, views):
                    d.copy_(v, non_blocking=True)
                    d.record_stream(compute)
                copied = torch.cuda.Event(enable_timing=timed)
                copied.record()
            self._copied[slot] = copied
            if timed:
                self.log.append({"bytes": sum(v.nbytes for v in views), "start": start,
                                 "end": copied, "gather_ms": gather_ms,
                                 "gather_thread": threading.current_thread().name})
            yield dev, hi - lo, copied

    def _pin(self, stream) -> list[torch.Tensor]:
        """Flat pinned buffers for a full block of x and of y."""
        rows = [np.asarray(src[0:1]) for src in (stream.x, stream.y)]
        self._row_shapes = [(stream.batch_size,) + r.shape[1:] for r in rows]
        block = stream.num_workers * stream.block_steps
        bufs = [torch.empty(block * math.prod(shape), pin_memory=True,
                            dtype=torch.from_numpy(r[:0]).dtype)
                for r, shape in zip(rows, self._row_shapes)]
        self.pinned_bytes += sum(b.nbytes for b in bufs)
        return bufs


def _view(buf: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The first elements of a flat buffer, shaped ``shape``."""
    return buf[:math.prod(shape)].view(shape)


def _as_input(t: torch.Tensor) -> torch.Tensor:
    """Integers (tokens, labels) as int64, as the embedding and the label
    gather take them."""
    return t if t.is_floating_point() else t.long()


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
        # BlockStager's log of the streamed fits (None: nothing logged),
        # and the pinned host bytes the last streamed fit held
        self.h2d_log: list | None = None
        self.pinned_bytes = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → device tensor; integers (tokens, labels) as int64,
        as the embedding and the label gather take them."""
        return _as_input(torch.from_numpy(np.ascontiguousarray(arr))).to(self.device)

    def run_epochs(
        self,
        partitions: list[tuple[np.ndarray, np.ndarray]],
        epochs: int,
        batch_size: int,
        verbose: int = 0,
        callbacks=(),
    ) -> dict:
        """Train ``epochs`` epochs, one partition a worker, the whole epoch
        staged on the device; returns a Keras-style history dict: each
        epoch's loss is the mean over the workers of each worker's mean
        step loss, and each compiled metric is accumulated over every
        worker's padded batches (wrap-padded rows count, as in the
        reference). After each epoch every ``callbacks(epoch, loss)``
        runs, the master holding worker 0's state."""
        if len(partitions) != self.num_workers:
            raise ValueError(
                f"got {len(partitions)} partitions for {self.num_workers} workers"
            )
        xs, ys, _counts, nb = stack_worker_batches(partitions, batch_size)
        staged = [(self._stage(xs), self._stage(ys), nb)]
        return self._train(itertools.repeat(staged, epochs), epochs, verbose, callbacks)

    def run_epochs_stream(self, stream, epochs: int, verbose: int = 0, callbacks=()) -> dict:
        """Train on a :class:`~elephas_tpu_torch.data.streaming.ShardedStream`:
        each epoch arrives in blocks of worker steps that never all live
        on the device at once (counterpart of
        ``MeshRunner.run_epochs_stream``, ``elephas_tpu/worker.py:588``).

        The blocks go through the same worker steps as :meth:`run_epochs`,
        so a stream of the staged rows trains bit-equal to the staged
        fit. Each block enters with zero metric state and its additive
        contribution accumulates (exact for the integer-valued counts);
        the epoch loss is the mean of every step's loss, which is the
        block losses weighted by their steps. :func:`~elephas_tpu_torch.\
data.streaming.prefetch_blocks` gathers the next blocks on the host in
        a reader thread; :class:`BlockStager` moves each to the device (on
        ``cuda`` gathered into pinned buffers, copied on a side stream).
        Losses and metric state stay on the device until the end of the
        epoch."""
        if self.frequency == "fit":
            raise ValueError(
                "frequency='fit' (train whole fit locally, average once) "
                "contradicts streaming; use 'epoch' or 'batch'"
            )
        if stream.num_workers != self.num_workers:
            raise ValueError(
                f"a stream over {stream.num_workers} workers for {self.num_workers}"
            )
        stager = BlockStager(self.device, self.h2d_log)
        # one reader for every epoch: the next epoch's first blocks cross
        # while this one ends
        blocks = stager.blocks(stream, epochs)
        try:
            return self._train((itertools.islice(blocks, stream.num_blocks)
                                for _ in range(epochs)), epochs, verbose, callbacks)
        finally:
            blocks.close()
            self.pinned_bytes = stager.pinned_bytes

    def _train(self, epoch_blocks, epochs, verbose, callbacks) -> dict:
        """The ``epochs`` epochs of ``epoch_blocks``: for each, an iterable
        of device blocks ``(x [W, steps, B, ...], y, steps)``."""
        replicas = [self.model] + [replicate(self.model) for _ in range(self.num_workers - 1)]
        several = len(replicas) > 1
        synchronous = self.mode == "synchronous"
        metric_names = self.model.training_spec.metrics
        history: dict[str, list[float]] = {"loss": []}
        was_training = self.model.training
        for rep in replicas:
            rep.train()
        try:
            for epoch, blocks in zip(range(epochs), epoch_blocks):
                metrics = {name: MeanMetric(self.device) for name in metric_names}
                losses = [[] for _ in replicas]
                for xb, yb, steps in blocks:
                    block = {name: MeanMetric(self.device) for name in metric_names}
                    for i in range(steps):
                        self._global_step(replicas, xb, yb, i, block, losses)
                    for name, metric in block.items():
                        metrics[name].merge(metric)
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

    def _global_step(self, replicas, xb, yb, i, metrics, losses) -> None:
        """Each worker's step ``i`` of the block, then the collective the
        mode and frequency put there."""
        synchronous = self.mode == "synchronous"
        several = len(replicas) > 1
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
