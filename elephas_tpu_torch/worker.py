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

In a process gang (:mod:`elephas_tpu_torch.parallel.distributed`) a
runner made with ``gang=True`` spans every rank's workers: rank r keeps
the replicas of its own workers ``[r·L, (r+1)·L)`` and stages only their
shards of the same global data (the SPMD contract: every rank holds the
same host arrays). The collectives gather every worker's tensors in global
worker order (:func:`elephas_tpu_torch.parallel.distributed.all_gather`)
and take the same ``torch.stack(...).mean(0)`` as one process does, so the
replicas stay bit-identical across ranks and the gang's fit is bit-equal
to the one-process fit over ``force_devices(P·L)`` workers; a sum
all-reduce would add in another order. The epoch's loss and the metrics'
sums are gathered the same way and reduced in the one-process order.

Per worker step: forward in ``train()`` mode, the compiled loss (the mean
over every element) plus the auxiliary losses the forward added (the
Switch load-balance loss; in the history's ``loss`` too, as in the
reference's total), backward, the optimizer's step. Batches come in the
reference's order, wrap-padded (:func:`pad_to_batches`), with no
shuffling. :meth:`Runner.run_epochs` stages a whole epoch on the device;
:meth:`Runner.run_epochs_stream` takes the same steps in blocks of a
:class:`~elephas_tpu_torch.data.streaming.ShardedStream`, which
:class:`BlockStager` moves onto the device while it trains.

The reference's executor-side workers are here too:
:class:`SparkWorker` (train one partition, yield its weights and history)
and :class:`AsynchronousSparkWorker` (pull, train on the device, push
the delta to a weight store of :mod:`elephas_tpu_torch.parameter` or of
the reference, under a supervised retry, optionally through
:class:`OverlappedSync`'s background window). They build their module
from Keras JSON and train it with :class:`Runner` on one worker.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import itertools
import logging
import math
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.data.streaming import prefetch_blocks
from elephas_tpu_torch.device import local_worker_indices, resolve_device
from elephas_tpu_torch.parallel import distributed
from elephas_tpu_torch.optimizers import hyperparameters
from elephas_tpu_torch.training import MeanMetric, training_loss
from elephas_tpu_torch.utils import sockets
from elephas_tpu_torch.utils.weights import get_weights, set_weights

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
    workers: list[int] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Partition arrays → ``x[W, nb, B, ...]``, ``y[W, nb, B, ...]``, the
    per-worker true sample counts and the common batch count (the max over
    workers — shorter partitions wrap). ``workers`` stacks only those
    workers' partitions (a rank's own), the batch count still the max over
    every partition."""
    counts = np.array([len(x) for x, _ in partitions])
    nb = max(1, int(np.ceil(counts.max() / batch_size)))
    own = partitions if workers is None else [partitions[w] for w in workers]
    xs = np.stack([pad_to_batches(x, nb, batch_size) for x, _ in own])
    ys = np.stack([pad_to_batches(y, nb, batch_size) for _, y in own])
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


class Replicas(list):
    """The local workers' modules of one runner (worker 0 first); ``gang``
    says whether the collectives over them span the process gang."""

    def __init__(self, modules, gang: bool = False):
        super().__init__(modules)
        self.gang = gang


def _gathered(per_worker: list[list[torch.Tensor]], gang: bool) -> list[list[torch.Tensor]]:
    """Every worker's tensors, in global worker order, from this process's
    workers' lists (``per_worker``, one list a local worker, the same
    positions in each): the lists themselves outside a gang; in a gang each
    rank's are gathered (one exact ``all_gather`` a dtype) and come back as
    views of the gathered buffer, shaped as the originals."""
    if not gang or distributed.process_count() == 1:
        return per_worker
    n_pos = len(per_worker[0])
    out = [[None] * n_pos for _ in range(distributed.process_count() * len(per_worker))]
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(per_worker[0]):
        by_dtype.setdefault(t.dtype, []).append(i)
    for positions in by_dtype.values():
        flat = torch.stack([torch.cat([ts[i].reshape(-1) for i in positions])
                            for ts in per_worker])
        rows = distributed.all_gather(flat)
        for w, row in enumerate(rows):
            lo = 0
            for i in positions:
                shape = per_worker[0][i].shape
                n = per_worker[0][i].numel()
                out[w][i] = row[lo:lo + n].view(shape)
                lo += n
    return out


@torch.no_grad()
def _mean_into(per_worker: list[list[torch.Tensor]], gang: bool = False) -> None:
    """Copy each position's mean over every worker into this process's
    workers' tensors (``lax.pmean``), taken on the first worker's device
    (a tensor-parallel replica's shard may lie on another)."""
    everyone = _gathered(per_worker, gang)
    for pos, tensors in enumerate(zip(*per_worker)):
        mean = torch.stack([w[pos].to(tensors[0].device) for w in everyone]).mean(0)
        for t in tensors:
            t.copy_(mean)


@torch.no_grad()
def mean_gradients(replicas) -> None:
    """The synchronous collective: each trainable parameter's gradient
    becomes the mean over the workers (one tensor, shared by every
    replica), and the float state the mean of the replicas' (worker.py
    ``:481-482``). ``replicas`` is a list of modules, or a
    :class:`Replicas` whose ``gang`` spans the process gang."""
    gang = getattr(replicas, "gang", False)
    local = [[p.grad if p.grad is not None else torch.zeros_like(p) for p in _trainable(r)]
             for r in replicas]
    everyone = _gathered(local, gang)
    for pos, params in enumerate(zip(*map(_trainable, replicas))):
        mean = torch.stack([w[pos] for w in everyone]).mean(0)
        for p in params:
            p.grad = mean
    _mean_into([_float_state(r) for r in replicas], gang)


def mean_weights(replicas) -> None:
    """The local-SGD collective: trainable parameters and float state
    become their means over the workers (worker.py ``:485-486``,
    ``:496-498``, and the ``fit`` frequency's average, ``:566-581``)."""
    _mean_into([_trainable(r) + _float_state(r) for r in replicas],
               getattr(replicas, "gang", False))


def _replay_metrics(block: dict, parts: dict) -> None:
    """Add every worker's metric contributions of a block (``parts``: a
    list a local worker of ``(sum, count)`` a step, gathered from every
    rank) into ``block``'s metrics in the one-process order: step by step,
    worker by worker."""
    for name, per_worker in parts.items():
        if not per_worker[0]:
            continue
        sums = distributed.all_gather(torch.stack([torch.stack([s for s, _ in steps])
                                                   for steps in per_worker]))
        counts = [c for _, c in per_worker[0]]
        metric = block[name]
        for i, count in enumerate(counts):
            for w in range(sums.shape[0]):
                metric.total += sums[w, i]
                metric.count += count


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
    ``gather_ms`` with the ``gather_thread`` that gathered it. ``workers``
    gathers only those workers' rows (a gang rank's own; None: all)."""

    def __init__(self, device: torch.device, log: list | None = None,
                 workers: list[int] | None = None):
        self.device = device
        self.log = log
        self.workers = workers
        self.pinned_bytes = 0
        self._pinned: list[list[torch.Tensor]] | None = None
        self._copied: list[torch.cuda.Event | None] = [None, None]

    def blocks(self, stream, epochs: int = 1):
        """Yields ``(x [W, steps, B, ...], y, steps)`` on the device for
        ``epochs`` epochs of ``stream``, one after the other, from one
        reader thread."""
        if self.device.type != "cuda":
            host = itertools.chain.from_iterable(stream.blocks(self.workers)
                                                 for _ in range(epochs))
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
            views = [_view(buf, (self._n_workers(stream), hi - lo) + shape)
                     for buf, shape in zip(self._pinned[slot], self._row_shapes)]
            t0 = time.perf_counter()
            stream.gather(lo, hi, out=[v.numpy() for v in views], worker_indices=self.workers)
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

    def _n_workers(self, stream) -> int:
        return stream.num_workers if self.workers is None else len(self.workers)

    def _pin(self, stream) -> list[torch.Tensor]:
        """Flat pinned buffers for a full block of x and of y."""
        rows = [np.asarray(src[0:1]) for src in (stream.x, stream.y)]
        self._row_shapes = [(stream.batch_size,) + r.shape[1:] for r in rows]
        block = self._n_workers(stream) * stream.block_steps
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


def check_stream(frequency: str, stream, workers: int, mismatch: str) -> None:
    """The refusals of a streamed fit: ``frequency='fit'``, and a stream
    over another count of row shards than ``workers`` (``mismatch``, a
    message formatted with ``got`` and ``want``)."""
    if frequency == "fit":
        raise ValueError(
            "frequency='fit' (train whole fit locally, average once) "
            "contradicts streaming; use 'epoch' or 'batch'"
        )
    if stream.num_workers != workers:
        raise ValueError(mismatch.format(got=stream.num_workers, want=workers))


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
                 num_workers: int = 1, gang: bool = False):
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
        # a gang runner's workers span the ranks: this one trains its own
        self.gang = bool(gang) and distributed.process_count() > 1
        self.local_workers = (local_worker_indices(num_workers) if self.gang
                              else list(range(num_workers)))
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
        xs, ys, _counts, nb = stack_worker_batches(
            partitions, batch_size, self.local_workers if self.gang else None)
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
        check_stream(self.frequency, stream, self.num_workers,
                     "a stream over {got} workers for {want}")
        stager = BlockStager(self.device, self.h2d_log,
                             self.local_workers if self.gang else None)
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
        replicas = Replicas([self.model] + [replicate(self.model)
                                            for _ in range(len(self.local_workers) - 1)],
                            gang=self.gang)
        several = self.num_workers > 1
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
                    # a gang rank keeps its workers' metric sums a step, then
                    # adds every worker's in the one-process order
                    parts = ({name: [[] for _ in replicas] for name in metric_names}
                             if self.gang else None)
                    for i in range(steps):
                        self._global_step(replicas, xb, yb, i, parts or block, losses)
                    if parts is not None:
                        _replay_metrics(block, parts)
                    for name, metric in block.items():
                        metrics[name].merge(metric)
                if several and not synchronous and self.frequency == "epoch":
                    mean_weights(replicas)
                per_worker = torch.stack([torch.stack(l).mean() for l in losses])
                if self.gang:
                    per_worker = distributed.all_gather(per_worker)
                epoch_loss = per_worker.mean().item()
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
        several = self.num_workers > 1
        for w, rep in enumerate(replicas):
            spec = rep.training_spec
            loss, y_pred = training_loss(rep, spec, xb[w, i], yb[w, i])
            spec.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            losses[w].append(loss.detach())
            with torch.no_grad():
                for name, fn in spec.metrics.items():
                    if isinstance(metrics[name], MeanMetric):
                        metrics[name].update(fn(yb[w, i], y_pred))
                    else:
                        metrics[name][w].append(MeanMetric.contribution(fn(yb[w, i], y_pred)))
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


# -- overlapped parameter sync --------------------------------------------


class OverlappedSync:
    """Background push(delta)/pull(weights) window for async/hogwild
    workers: one daemon thread owns the parameter client (a single
    connection — wire ops stay serialized), so a sync round overlaps the
    next period's compute instead of blocking it.

    Staleness bound: at most ``staleness`` rounds may be in flight;
    :meth:`submit` blocks until the oldest lands once the window is
    full. ``synchronous`` mode never routes through this class — it
    stays blocking and bit-exact.

    The thread touches only host numpy arrays and the client's socket: a
    delta is computed from host copies before it is submitted, so the
    thread launches no device work and reads no tensor that training
    updates in place.
    """

    def __init__(self, client, staleness: int = 1):
        self.client = client
        self.staleness = max(1, int(staleness))
        self._queue: queue.Queue = queue.Queue()
        self._pending: collections.deque[Future] = collections.deque()
        self.max_in_flight = 0  # high-water mark (tested staleness bound)
        # trace context is THREAD-local and the wire ops
        # below run on this daemon thread — capture the constructing
        # thread's scope so overlapped rounds stamp (and forward) the
        # same trace id the blocking path would
        self._trace_id = telemetry.current_trace()
        self._thread = threading.Thread(
            target=self._run, name="elephas-ps-sync", daemon=True
        )
        self._thread.start()

    def _run(self):
        with telemetry.trace_scope(self._trace_id):
            while True:
                item = self._queue.get()
                if item is None:
                    return
                delta, fut = item
                try:
                    if delta is not None:
                        self.client.update_parameters(delta)
                    fut.set_result(self.client.get_parameters())
                except BaseException as e:  # surfaced at submit/drain
                    fut.set_exception(e)

    def submit(self, delta) -> Future:
        """Queue one round (push ``delta``, then pull fresh weights)."""
        while len(self._pending) >= self.staleness:
            self._pending.popleft().result()  # staleness bound: block
        fut: Future = Future()
        self._queue.put((delta, fut))
        self._pending.append(fut)
        self.max_in_flight = max(self.max_in_flight, len(self._pending))
        return fut

    def freshest(self):
        """Newest completed pull (dropping older ones), or None if every
        in-flight round is still on the wire — the caller then continues
        from its local weights, Hogwild-style."""
        newest = None
        while self._pending and self._pending[0].done():
            newest = self._pending.popleft().result()
        return newest

    def drain(self):
        """Wait for every in-flight round; returns the last pull."""
        out = None
        while self._pending:
            out = self._pending.popleft().result()
        return out

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=30)


# -- executor-side worker classes (reference API parity) ----------------


class SparkWorker:
    """Per-partition synchronous worker (counterpart of
    ``elephas_tpu.worker.SparkWorker``, the reference's
    ``[U] elephas/worker.py::SparkWorker``).

    ``train(data_iterator)`` yields ``(trained_weights, history_dict)``.
    The module is built from the Keras JSON text (``model.to_json()``) by
    :func:`~elephas_tpu_torch.models.keras_config.model_from_json`, on
    ``device`` (``cuda:0`` unless the caller names another), and compiled
    with ``master_optimizer`` (a Keras name such as ``"adam"`` with Keras's
    defaults, or a serialized config), ``master_loss`` and
    ``master_metrics``. Weights cross as Keras's ``get_weights()`` list.
    Training is :class:`Runner`'s on one worker: batches in row order,
    the last one wrap-padded. Keras's ``fit`` shuffles each epoch with its
    own generator, which the port does not reproduce.
    """

    def __init__(
        self,
        json_model: str,
        parameters,
        train_config: dict | None = None,
        master_optimizer="rmsprop",
        master_loss="categorical_crossentropy",
        master_metrics=None,
        custom_objects: dict | None = None,
        device=None,
    ):
        self.json_model = json_model
        self.parameters = parameters
        self.train_config = dict(train_config or {})
        self.master_optimizer = master_optimizer
        self.master_loss = master_loss
        self.master_metrics = master_metrics
        self.custom_objects = custom_objects
        self.device = device

    def _build(self):
        from elephas_tpu_torch.models.keras_config import model_from_json
        from elephas_tpu_torch.optimizers import get as get_optimizer
        from elephas_tpu_torch.training import compile_model

        # the device resolves here, as the module is built: no GPU and
        # no explicit CPU raises
        model = model_from_json(self.json_model, custom_objects=self.custom_objects,
                                device=resolve_device(self.device))
        compile_model(model, get_optimizer(self.master_optimizer, model.parameters()),
                      self.master_loss, self.master_metrics or ())
        if self.parameters is not None:
            set_weights(model, self.parameters)
        return model

    @staticmethod
    def _stack(data_iterator):
        xs, ys = [], []
        for x, y in data_iterator:
            xs.append(np.asarray(x))
            ys.append(np.asarray(y))
        if not xs:
            return None, None
        return np.stack(xs), np.stack(ys)

    @staticmethod
    def _fit(model, x, y, epochs: int, batch_size: int, validation_split: float = 0.0) -> dict:
        """Keras's ``model.fit(x, y, epochs, batch_size, validation_split)``
        on one worker: the history of each epoch's loss and metrics, and
        ``val_*`` of the held-out tail."""
        runner = Runner(model, "synchronous", "epoch", 1)
        val_history: dict[str, list[float]] = {}
        callbacks = ()
        if validation_split and len(x) > 1:
            cut = len(x) - min(max(1, int(len(x) * validation_split)), len(x) - 1)
            val = [(x[cut:], y[cut:])]
            x, y = x[:cut], y[:cut]

            def evaluate(_epoch, _loss):
                for k, v in runner.evaluate(val, batch_size).items():
                    val_history.setdefault(f"val_{k}", []).append(v)

            callbacks = (evaluate,)
        history = runner.run_epochs([(x, y)], epochs, batch_size, callbacks=callbacks)
        history.update(val_history)
        return history

    def train(self, data_iterator):
        """Train on one partition's rows; yields (weights, history)."""
        x, y = self._stack(data_iterator)
        if x is None:
            return
        model = self._build()
        history = self._fit(
            model, x, y,
            epochs=self.train_config.get("epochs", 1),
            batch_size=self.train_config.get("batch_size", 32),
            validation_split=self.train_config.get("validation_split", 0.0),
        )
        yield get_weights(model), history


class AsynchronousSparkWorker(SparkWorker):
    """Per-partition async worker: pull → local train → push delta
    (counterpart of ``elephas_tpu.worker.AsynchronousSparkWorker``, the
    reference's ``[U] elephas/worker.py::AsynchronousSparkWorker``).

    Speaks the parameter-server protocol through a
    :mod:`elephas_tpu_torch.parameter` client, so it works against a
    weight store of either package on another host. ``frequency='epoch'``
    syncs once per epoch, ``'batch'`` once per mini-batch. The model
    trains on ``device``; every pull is copied into it and every push is
    the difference of two host copies (``after − before``, in numpy), so
    the wire and the codec see the bytes the reference sends.

    ``compression``/``topk`` select the binary codec's int8 quantization
    (with error-feedback residuals held by the client) and top-k delta
    sparsification; ``overlap=True`` routes sync rounds through
    :class:`OverlappedSync` so the wire rides under the next period's
    compute, trading a bounded ``staleness`` (in sync periods) for
    throughput — never applied to the synchronous worker.

    Fault tolerance: each sync period runs under a **supervised retry**
    — when a period's pull/push fails even after the client's own
    reconnect retries (a PS crash/restart, a severed wire), the worker
    backs off with capped exponential delays
    (:func:`~elephas_tpu_torch.utils.sockets.retry_call`), re-pulls fresh
    weights, and re-runs that period, up to ``ps_retries`` times before
    giving up. The worker registers under ``client_id`` and heartbeats
    the server once per sync period on the existing connection. On
    protocol-2 servers every push carries a sequence ID, making the
    period re-run's resends effectively-once (a re-run period's
    *recompute* trains that period's rows again: at-least-once training
    under crash recovery). With lossy compression a re-encoded retry
    folds the previous attempt's residual into the fresh delta.

    Sharded PS: ``master="host:p0,host:p1,..."`` — a comma-separated
    endpoint list — routes the same loop through a
    :class:`~elephas_tpu_torch.parameter.client.ShardedClient`
    (scatter/gather over per-shard servers, per-shard sequence IDs, one
    dead shard pausing only its slice). Workers may join and leave such
    a topology mid-run: registration is implicit (first heartbeat or
    sequenced update) and a departed worker's lease goes stale.
    """

    def __init__(
        self,
        json_model: str,
        parameters=None,
        train_config: dict | None = None,
        frequency: str = "epoch",
        parameter_server_mode: str = "http",
        master: str | None = None,
        port: int = 4000,
        master_optimizer="rmsprop",
        master_loss="categorical_crossentropy",
        master_metrics=None,
        custom_objects: dict | None = None,
        compression: str = "none",
        topk: float | None = None,
        pull_compression: str | None = None,
        overlap: bool = False,
        staleness: int = 1,
        ps_retries: int = 6,
        ps_retry_max_delay: float = 5.0,
        client_id: str | None = None,
        trace_id: str | None = None,
        device=None,
    ):
        super().__init__(
            json_model,
            parameters,
            train_config,
            master_optimizer,
            master_loss,
            master_metrics,
            custom_objects,
            device,
        )
        if frequency not in ("epoch", "batch"):
            raise ValueError(f"frequency must be 'epoch' or 'batch', got {frequency!r}")
        self.frequency = frequency
        self.parameter_server_mode = parameter_server_mode
        self.master = master
        self.port = port
        self.compression = compression
        self.topk = topk
        self.pull_compression = pull_compression
        self.overlap = bool(overlap)
        self.staleness = max(1, int(staleness))
        self.ps_retries = max(0, int(ps_retries))
        self.ps_retry_max_delay = float(ps_retry_max_delay)
        self.client_id = client_id
        # when set, train() runs under this trace id: its sync spans,
        # retries and PS round-trips stamp it, and the clients forward
        # it over the wire; None inherits the caller's scope
        self.trace_id = trace_id
        # the retry loop and sync cadence, on the same scrape as the
        # server's own counters
        reg = telemetry.registry()
        wid = telemetry.instance_label()
        self.telemetry_label = wid
        self._tracer = telemetry.tracer()
        self._m_sync_periods = reg.counter(
            "elephas_worker_sync_periods_total",
            "Completed pull-train-push sync periods",
            labels=("worker",),
        ).labels(worker=wid)
        self._m_retries = reg.counter(
            "elephas_worker_ps_retries_total",
            "Supervised re-runs of a sync period after a PS failure",
            labels=("worker",),
        ).labels(worker=wid)

    def release_telemetry(self) -> None:
        """Retire this worker's labeled series from the process
        registry. Explicit-only (see ``Registry.remove_series``):
        post-fit scrapes showing what the partitions did are a
        supported shape, so retirement is the host's call."""
        telemetry.remove_series(worker=self.telemetry_label)

    def _client(self, model=None):
        from elephas_tpu_torch.parameter.client import HttpClient, SocketClient

        if self.master and "," in str(self.master):
            # sharded topology: a comma-separated endpoint
            # list selects the scatter/gather client — the worker
            # derives the SAME deterministic shard map the server group
            # derived from the same weight template
            from elephas_tpu_torch.parameter.client import ShardedClient
            from elephas_tpu_torch.parameter.sharding import (
                ShardMap,
                shard_endpoints,
            )

            if self.parameter_server_mode not in ("http", "socket"):
                raise ValueError(
                    f"sharded endpoint lists need parameter_server_mode="
                    f"'http' or 'socket', got "
                    f"{self.parameter_server_mode!r}"
                )
            if model is None:
                raise ValueError(
                    "sharded endpoints need the built model to derive "
                    "the shard map from its weight template"
                )
            endpoints = shard_endpoints(self.master)
            return ShardedClient(
                endpoints,
                ShardMap.from_weights(get_weights(model), len(endpoints)),
                transport=self.parameter_server_mode,
                client_id=self.client_id,
                compression=self.compression, topk=self.topk,
                pull_compression=self.pull_compression,
                retries=max(3, self.ps_retries) if self.overlap else 3,
            )
        if self.parameter_server_mode == "native":
            if (
                self.compression != "none"
                or self.topk is not None
                or self.pull_compression not in (None, "none")
            ):
                raise ValueError(
                    "the native parameter server speaks raw float32 "
                    "frames — compression/topk need "
                    "parameter_server_mode='http' or 'socket'"
                )
            from elephas_tpu_torch.parameter.native import NativeClient, _Flattener

            host, _, p = (self.master or "127.0.0.1").partition(":")
            port = int(p) if p else self.port
            return NativeClient(host, port, _Flattener(get_weights(model)))
        cls = {"http": HttpClient, "socket": SocketClient}.get(
            self.parameter_server_mode
        )
        if cls is None:
            raise ValueError(
                f"parameter_server_mode must be 'http', 'socket' or "
                f"'native', got {self.parameter_server_mode!r}"
            )
        # overlap rounds ride a background thread where the supervised
        # period re-run below cannot reach them — give the client itself
        # the longer retry horizon there
        retries = max(3, self.ps_retries) if self.overlap else 3
        return cls(
            self.master, self.port,
            compression=self.compression, topk=self.topk,
            pull_compression=self.pull_compression,
            retries=retries, client_id=self.client_id,
        )

    def _periods(self, x, y, epochs: int, batch_size: int):
        """The sync-period stream: whole epochs or mini-batches."""
        for _ in range(epochs):
            if self.frequency == "epoch":
                yield x, y
            else:
                for start in range(0, len(x), batch_size):
                    yield x[start : start + batch_size], y[start : start + batch_size]

    def _fit_period(self, model, xp, yp, batch_size: int) -> None:
        """One epoch over the period's rows (Keras's ``fit``), or one step
        on the whole batch (``train_on_batch``)."""
        steps = batch_size if self.frequency == "epoch" else len(xp)
        Runner(model, "synchronous", "epoch", 1).run_epochs([(xp, yp)], 1, steps)

    def _heartbeat(self, client) -> None:
        """Best-effort lease refresh once per sync period (liveness is
        advisory; the period's own ops carry the hard failure path)."""
        beat = getattr(client, "heartbeat", None)
        if beat is None:
            return
        try:
            beat()
        except (ConnectionError, TimeoutError, OSError) as e:
            logger.debug("heartbeat failed (non-fatal): %r", e)

    def _supervised(self, fn):
        """One sync period under the supervision contract:
        capped-backoff re-runs survive a PS outage that outlasts the
        client's own reconnect retries; the final failure propagates
        so the driver's failure budget can count this worker. Each
        re-run counts in ``elephas_worker_ps_retries_total`` and lands
        as a trace event so outage windows line up with the
        chaos timeline."""

        def on_retry(attempt, exc):
            self._m_retries.inc()
            self._tracer.emit(
                "worker.retry", worker=self.telemetry_label,
                attempt=attempt, error=repr(exc),
            )

        return sockets.retry_call(
            fn,
            retries=self.ps_retries,
            base_delay=0.25,
            max_delay=self.ps_retry_max_delay,
            on_retry=on_retry,
        )

    def train(self, data_iterator):
        from elephas_tpu_torch.utils.functional_utils import subtract_params

        x, y = self._stack(data_iterator)
        if x is None:
            return
        # trace_scope(None) is a passthrough: without an explicit
        # trace_id this worker inherits whatever scope the caller set
        with telemetry.trace_scope(self.trace_id):
            yield from self._train_scoped(x, y, subtract_params)

    def _train_scoped(self, x, y, subtract_params):
        model = self._build()
        client = self._client(model)
        epochs = self.train_config.get("epochs", 1)
        batch_size = self.train_config.get("batch_size", 32)
        try:
            if self.overlap:
                self._train_overlapped(
                    model, client, x, y, epochs, batch_size
                )
            else:
                for xp, yp in self._periods(x, y, epochs, batch_size):

                    def sync_period(xp=xp, yp=yp):
                        # resume-from-last-PS-pull: every (re-)run of a
                        # period starts from fresh server weights, so a
                        # re-run after an outage trains on the
                        # post-recovery state, not a stale snapshot
                        self._heartbeat(client)
                        before = client.get_parameters()
                        set_weights(model, before)
                        self._fit_period(model, xp, yp, batch_size)
                        # server applies weights += delta, so the delta
                        # must be the descent step (after − before)
                        client.update_parameters(
                            subtract_params(get_weights(model), before)
                        )

                    with self._tracer.span(
                        "worker.sync_period",
                        worker=self.telemetry_label,
                    ):
                        self._supervised(sync_period)
                    self._m_sync_periods.inc()
                # confirmed delivery: every pipelined push is acked (or
                # sequence-deduplicated-resent) before this partition
                # reports done — without this, a connection dying on
                # the run's FINAL pushes would lose them silently
                flush = getattr(client, "flush", None)
                if flush is not None:
                    self._supervised(flush)
        finally:
            if hasattr(client, "close"):
                client.close()
        yield get_weights(model), {}

    def _train_overlapped(self, model, client, x, y, epochs, batch_size):
        """Double-buffered loop: period ``i``'s compute overlaps round
        ``i-1``'s push+pull; adopted weights are stale by at most
        ``staleness`` periods (else the worker continues from its own
        local weights, Hogwild-style)."""
        from elephas_tpu_torch.utils.functional_utils import subtract_params

        sync = OverlappedSync(client, self.staleness)
        try:
            before = client.get_parameters()  # initial pull: blocking
            set_weights(model, before)
            for xp, yp in self._periods(x, y, epochs, batch_size):
                self._fit_period(model, xp, yp, batch_size)
                after = get_weights(model)
                sync.submit(subtract_params(after, before))
                self._m_sync_periods.inc()
                fresh = sync.freshest()
                if fresh is not None:
                    before = fresh
                    set_weights(model, fresh)
                else:
                    # round still on the wire: continue from local
                    # weights (Hogwild-style), no extra copies
                    before = after
            final = sync.drain()  # every push acked before we report
            if final is not None:
                set_weights(model, final)
        finally:
            sync.close()
