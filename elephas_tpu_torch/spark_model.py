"""SparkModel — the Spark-shaped training façade of the port.

Counterpart of ``elephas_tpu/spark_model.py``: ``SparkModel(model, mode=,
frequency=, num_workers=, batch_size=, device=)`` with ``fit``,
``predict``, ``evaluate``, ``save`` and :func:`load_spark_model` over a
simple RDD or ``(x, y)`` arrays, on W workers
(:class:`elephas_tpu_torch.worker.Runner`), and ``generate`` and ``serve``
of a language model. ``model`` is a module compiled with
:func:`elephas_tpu_torch.training.compile_model`, as every builder of the
zoo returns it (``mnist_mlp``, ``cifar10_cnn``, ``imdb_lstm``,
``resnet``/``resnet50``, ``transformer_classifier``, ``transformer_lm``),
in float32 or, where the reference takes it, ``mixed_bfloat16``.

W workers share the one device the wrapper runs on: the reference's W is
the number of devices of its mesh, and the port's the slots of
:func:`elephas_tpu_torch.device.force_devices` (one a device unforced;
several physical GPUs in one process are refused). In a process gang
(``python -m elephas_tpu_torch.launch``, one rank a card) the workers span
every rank and the fit is SPMD: every rank runs the same script on the
same data, trains its own workers, and the replicas stay bit-identical
across ranks. Only the coordinator (rank 0) writes: the weight store,
``save``, ``history_log`` and the checkpoints, the others waiting at a
barrier after each snapshot; ``fit(resume=True)`` restores every rank from
the coordinator's snapshot. ``fit`` takes the reference's
``validation_split``, ``checkpoint_dir``/``checkpoint_every``/``resume``
(:mod:`elephas_tpu_torch.utils.checkpoint`), ``history_log`` and
``profile_dir`` (a ``torch.profiler`` Chrome trace), and streams what the
reference streams (:mod:`elephas_tpu_torch.data.streaming`): a memmap or
other lazy source, a lazy RDD, ``steps_per_epoch``, ``stream_block_steps``
or more than :attr:`SparkModel.STREAM_THRESHOLD_BYTES`. ``save`` writes
the module (:mod:`elephas_tpu_torch.utils.serialization`) and the
reference's ``<file>.elephas.json`` sidecar. :class:`SparkMLlibModel`
trains on an RDD of ``LabeledPoint``s.

``parameter_server_mode`` (``"http"``, ``"socket"`` or ``"native"``)
starts a live weight store for the fit (:mod:`elephas_tpu_torch.\
parameter`, on ``port``, sharded over ``ps_shards`` servers, journaled
under ``ps_journal_dir``): the master's weights, in Keras's
``get_weights()`` order, are published to it at every epoch boundary (in
the background with ``ps_overlap``) and once more at the end, and external
:class:`~elephas_tpu_torch.worker.AsynchronousSparkWorker` workers of
either package can pull from and push to it at :attr:`SparkModel.ps_endpoints`.
``fit(resume=True)`` adopts the journal's weights; under a
:class:`~elephas_tpu_torch.fault.FaultPlan` the fit survives up to
``failure_budget`` lost worker partitions (their rows reassigned to the
survivors with ``reassign_orphans``). The training itself does not go
through the store, as in the reference.

Every other keyword of the reference is accepted. At the value that leaves
the behaviour unchanged (the reference's default) it passes; any other
value raises ``NotImplementedError`` naming its ROADMAP.md item: model,
pipeline and sequence parallelism in training (item 5), and the serving
engine's decode meshes (item 5); the engine's sequence-parallel prefill
(``sp_prefill=`` a :class:`~elephas_tpu_torch.parallel.mesh.Mesh`) passes
through :meth:`SparkModel.serve`. :meth:`SparkModel.serve` with ``gateway_port`` puts the
HTTP/SSE gateway in front of the engine, and :meth:`SparkModel.scrape`
renders the port's telemetry registry. A ``mixed_bfloat16`` language
model is refused by :meth:`SparkModel.serve` and
``generate(kv_cache=True)``, as in the reference.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import queue
import threading
import time

import numpy as np
import torch
from torch import nn

from elephas_tpu_torch import telemetry
from elephas_tpu_torch.data import streaming
from elephas_tpu_torch.data.linalg import DenseVector
from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.device import gang, resolve_device, worker_count
from elephas_tpu_torch.models.transformer import _is_neutral
from elephas_tpu_torch.models.transformer import generate as _generate
from elephas_tpu_torch.parallel import distributed
from elephas_tpu_torch.serving import InferenceEngine
from elephas_tpu_torch.serving.policy import resolve_policy
from elephas_tpu_torch.utils import checkpoint as ckpt
from elephas_tpu_torch.utils import rdd_utils, serialization
from elephas_tpu_torch.utils.weights import get_weights, set_weights
from elephas_tpu_torch.worker import Runner

logger = logging.getLogger(__name__)

_TODO = "{} is not ported yet (ROADMAP.md, Queue A item {})"
# the reference's serve() binds its gateway here when given a port
_GATEWAY_HOST = "127.0.0.1"
# fit()'s trace ids: a process-monotonic run count (no pids, no wall
# time), as in the reference
_fit_trace_ids = itertools.count()


class _WeightPublisher:
    """Latest-wins background publication to the in-process weight store
    (the reference's ``_WeightPublisher``): the epoch loop hands off a
    snapshot and keeps training while ``set_weights`` runs on a daemon
    thread. The queue holds ONE snapshot: a slow store drops intermediate
    epochs rather than stalling training (the end-of-fit publish is
    always synchronous and final).

    A snapshot is a list of host numpy arrays that own their memory
    (:func:`~elephas_tpu_torch.utils.weights.get_weights`), finished on
    the fit thread before the handoff: the optimizer updates the module's
    tensors in place while this thread publishes, and the thread itself
    touches no tensor."""

    _STOP = object()

    def __init__(self, server):
        self._server = server
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(
            target=self._run, name="elephas-ps-publish", daemon=True
        )
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            try:
                self._server.set_weights(item)
            except Exception:  # publication is best-effort mid-fit
                logger.exception("background weight publication failed")

    def publish(self, weights) -> None:
        try:
            self._q.put_nowait(weights)
        except queue.Full:  # replace the stale queued snapshot
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(weights)
            except queue.Full:
                pass  # a concurrent publish won the slot; equally fresh

    def stop(self) -> None:
        self._q.put(self._STOP)  # behind any queued snapshot: drains first
        self._thread.join(timeout=30)


class SparkModel:
    """Data-parallel training of a compiled module on W workers of one
    device.

    ``device`` is ``cuda:0`` unless the caller names another (``"cpu"``
    runs the kernels' plain versions). ``num_workers`` is clamped to the
    workers :func:`~elephas_tpu_torch.device.num_available_workers`
    offers, as the reference clamps it to its devices. ``custom_objects``
    is kept for the reference's signature: the port resolves no class by
    name (checkpoints load into the live module, ``load_spark_model``
    rebuilds through the zoo's builders)."""

    # array datasets larger than this stream in blocks, as in the reference
    STREAM_THRESHOLD_BYTES = 1 << 30

    def __init__(
        self,
        model: nn.Module,
        mode: str = "synchronous",
        frequency: str = "epoch",
        parameter_server_mode: str | None = None,
        num_workers: int | None = None,
        custom_objects: dict | None = None,
        batch_size: int = 32,
        port: int = 4000,
        ps_overlap: bool | None = None,
        ps_journal_dir: str | None = None,
        ps_shards: int = 1,
        failure_budget: int = 0,
        reassign_orphans: bool = True,
        model_parallel: int = 1,
        pipeline_parallel: int = 1,
        pipeline_microbatches: int = 4,
        sequence_parallel: int = 1,
        sequence_attention: str = "ring",
        device=None,
        **kwargs,
    ):
        if not isinstance(model, nn.Module):
            raise ValueError(f"model must be a torch.nn.Module, got {type(model)}")
        if parameter_server_mode not in (None, "http", "socket", "native"):
            raise ValueError(
                f"parameter_server_mode must be 'http', 'socket', 'native' "
                f"or None, got {parameter_server_mode!r}"
            )
        if int(ps_shards) < 1:
            raise ValueError(f"ps_shards must be >= 1, got {ps_shards}")
        if sequence_attention not in ("ring", "ulysses"):
            raise ValueError(
                f"sequence_attention must be 'ring' or 'ulysses', got "
                f"{sequence_attention!r}"
            )
        # the reference's ps_overlap: None means "on unless synchronous"
        self.ps_overlap = mode != "synchronous" if ps_overlap is None else bool(ps_overlap)
        if int(ps_shards) > 1 and parameter_server_mode == "native":
            raise ValueError(
                "ps_shards > 1 needs parameter_server_mode='http' or "
                "'socket' — the native raw-f32 wire has no shard "
                "identity or sequence IDs"
            )
        # (name, value, the value that leaves the behaviour unchanged, item)
        unported = (
            ("model_parallel", model_parallel, 1, 5),
            ("pipeline_parallel", pipeline_parallel, 1, 5),
            ("pipeline_microbatches", pipeline_microbatches, 4, 5),
            ("sequence_parallel", sequence_parallel, 1, 5),
            ("sequence_attention", sequence_attention, "ring", 5),
        )
        for name, value, neutral, item in unported:
            if not _is_neutral(value, neutral):
                raise NotImplementedError(_TODO.format(f"{name}={value!r}", item))
        self.device = resolve_device(device)
        if gang() is not None and self.device != gang().device:
            raise ValueError(
                f"this rank of the gang runs on {gang().device}; a SparkModel on "
                f"{self.device} cannot join its collectives"
            )
        self.num_workers = worker_count(num_workers, self.device)
        # checks the compile spec, mode and frequency
        self._runner = Runner(model, mode, frequency, self.num_workers, gang=True)
        self._master_network = model.to(self.device)
        self.mode = mode
        self.frequency = frequency
        self.parameter_server_mode = parameter_server_mode
        self.custom_objects = custom_objects
        self.batch_size = batch_size
        self.port = port
        # journal the weight store (a crash-restartable PS, and the
        # sub-epoch resume source of fit(resume=True)), and tolerate up
        # to failure_budget lost worker partitions before aborting a fit
        self.ps_journal_dir = ps_journal_dir
        self.ps_shards = int(ps_shards)
        self.failure_budget = max(0, int(failure_budget))
        # within the budget a lost partition's rows go to the survivors
        # (False drops them)
        self.reassign_orphans = bool(reassign_orphans)
        self._parameter_server = None
        self._publisher = None
        self.model_parallel = int(model_parallel)
        self.pipeline_parallel = int(pipeline_parallel)
        self.pipeline_microbatches = int(pipeline_microbatches)
        self.sequence_parallel = int(sequence_parallel)
        self.sequence_attention = str(sequence_attention)
        self.kwargs = kwargs
        self.training_histories: list[dict] = []

    @property
    def master_network(self) -> nn.Module:
        return self._master_network

    def get_config(self) -> dict:
        """The reference's distribution config, key for key (the sidecar
        that ``save`` writes)."""
        return {
            "mode": self.mode,
            "frequency": self.frequency,
            "parameter_server_mode": self.parameter_server_mode,
            "num_workers": self.num_workers,
            "batch_size": self.batch_size,
            "port": self.port,
            "ps_overlap": self.ps_overlap,
            "ps_journal_dir": self.ps_journal_dir,
            "ps_shards": self.ps_shards,
            "failure_budget": self.failure_budget,
            "reassign_orphans": self.reassign_orphans,
            "model_parallel": self.model_parallel,
            "pipeline_parallel": self.pipeline_parallel,
            "pipeline_microbatches": self.pipeline_microbatches,
            "sequence_parallel": self.sequence_parallel,
            "sequence_attention": self.sequence_attention,
        }

    # -- parameter server -----------------------------------------------

    def start_server(self, restore_journal: bool = True) -> None:
        """Start the weight store that ``parameter_server_mode`` names
        (nothing without one), seeded with the master's weights in Keras's
        ``get_weights()`` order: an :class:`~elephas_tpu_torch.parameter.\
HttpServer`, a :class:`~elephas_tpu_torch.parameter.SocketServer` or
        a :class:`~elephas_tpu_torch.parameter.native.\
NativeParameterServer` on ``port`` (0: an ephemeral one), or with
        ``ps_shards > 1`` a :class:`~elephas_tpu_torch.parameter.\
ShardedServerGroup` on consecutive ports. With ``ps_journal_dir`` the
        store journals (each shard under ``shard-<i>/``) and, with
        ``restore_journal``, replays an existing journal first."""
        if self.parameter_server_mode is None:
            return
        if not distributed.is_coordinator():
            # one weight store a gang, on rank 0 (the reference's store
            # lives on the driver); the other ranks publish nothing
            return
        from elephas_tpu_torch.parameter.server import HttpServer, SocketServer

        cls = {"http": HttpServer, "socket": SocketServer}.get(self.parameter_server_mode)
        if cls is None:
            # mode already validated in __init__; only 'native' remains
            from elephas_tpu_torch.parameter.native import NativeParameterServer

            cls = NativeParameterServer
        kwargs = {}
        if self.ps_journal_dir:
            # a fresh (non-resume) fit passes restore_journal=False:
            # starting over must not continue from an earlier run's
            # journal (it is overwritten as this run snapshots)
            kwargs["restore_journal"] = restore_journal
            if self.ps_shards <= 1:
                kwargs["journal_dir"] = self.ps_journal_dir
        weights = get_weights(self._master_network)
        if self.ps_shards > 1:
            from elephas_tpu_torch.parameter.sharding import ShardedServerGroup

            ports = ([0] * self.ps_shards if not self.port
                     else [self.port + i for i in range(self.ps_shards)])
            self._parameter_server = ShardedServerGroup(
                cls, weights, self.ps_shards, mode=self.mode, ports=ports,
                journal_dir=self.ps_journal_dir, **kwargs,
            )
        else:
            self._parameter_server = cls(weights, mode=self.mode, port=self.port, **kwargs)
        self._parameter_server.start()
        if self.ps_overlap and self.mode != "synchronous":
            self._publisher = _WeightPublisher(self._parameter_server)

    @property
    def ps_endpoints(self) -> str | None:
        """The running weight store's endpoint list: one ``host:port``, or
        with ``ps_shards > 1`` a comma-separated shard list in shard order,
        the string an :class:`~elephas_tpu_torch.worker.\
AsynchronousSparkWorker` takes as ``master=``. None until
        :meth:`start_server` ran."""
        server = self._parameter_server
        if server is None:
            return None
        if hasattr(server, "endpoints"):
            return server.endpoints
        return f"127.0.0.1:{server.port}"

    def stop_server(self) -> None:
        self._stop_publisher()
        if self._parameter_server is not None:
            self._parameter_server.stop()
            self._parameter_server = None

    def _stop_publisher(self) -> None:
        if self._publisher is not None:
            self._publisher.stop()
            self._publisher = None

    def _publish_weights(self, final: bool = False) -> None:
        """Publish the master's weights to the store: in the background
        (latest wins) mid-fit with ``ps_overlap``, else synchronously. The
        host copy is taken here, on the fit thread."""
        if self._parameter_server is None:
            return
        telemetry.registry().counter(
            "elephas_ps_weight_publications_total",
            "Master-weight snapshots published to the external store",
        ).inc()
        weights = get_weights(self._master_network)
        if self._publisher is not None and not final:
            self._publisher.publish(weights)
            return
        if final:
            # drain the background publisher so the synchronous final
            # publish cannot be overwritten by a stale queued snapshot
            self._stop_publisher()
        self._parameter_server.set_weights(weights)

    def fit(
        self,
        rdd,
        epochs: int = 10,
        batch_size: int | None = None,
        verbose: int = 0,
        validation_split: float = 0.0,
        profile_dir: str | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
        resume: bool = False,
        steps_per_epoch: int | None = None,
        stream_block_steps: int | None = None,
        history_log: str | None = None,
        **kwargs,
    ) -> dict:
        """Train on a simple RDD of ``(x_row, y_row)`` pairs, or on an
        ``(x, y)`` pair of array-likes (``np.ndarray``, ``np.memmap``, an
        h5py-like dataset), ``batch_size`` rows a worker step. Returns the
        Keras-style history dict (``loss`` and each compiled metric per
        epoch, ``val_*`` with ``validation_split``), also appended to
        ``training_histories``.

        As in the reference: an RDD whose partition count is not the
        worker count is repartitioned round-robin, arrays are split into
        contiguous parts; ``validation_split`` holds out that fraction of
        the rows at the tail, evaluated after every epoch (once, on the
        averaged model, with ``frequency="fit"``);
        ``checkpoint_dir`` snapshots every ``checkpoint_every`` epochs and
        at the end, and ``resume=True`` restarts from the newest snapshot
        and trains the epochs left; ``history_log`` appends one JSON line
        an epoch and a final one with the whole history; ``profile_dir``
        receives a ``torch.profiler`` Chrome trace of the epochs.

        The fit streams (:meth:`~elephas_tpu_torch.worker.Runner.\
run_epochs_stream`) instead of staging whole epochs on the device when
        ``stream_block_steps`` or ``steps_per_epoch`` is given, when x or
        y is a lazy source, when the arrays hold more than
        :attr:`STREAM_THRESHOLD_BYTES`, or for a lazy RDD (except with
        ``frequency="fit"``, which reads it in one ranged read a partition
        and stages it). Blocks hold ``stream_block_steps`` (else 16)
        worker steps; workers own contiguous ceil-split row ranges. A
        streamed ``validation_split`` keeps the training rows lazy and
        evaluates the tail in blocks of ``block steps × batch × workers``
        rows, as a row-weighted mean (exact: every metric of the port is a
        mean). ``frequency="fit"`` cannot stream
        and raises ``ValueError``."""
        batch_size = batch_size or self.batch_size
        options = dict(profile_dir=profile_dir, checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every, resume=resume,
                       history_log=history_log)
        if not isinstance(rdd, Rdd):
            x, y = rdd
            return self._fit_arrays(x, y, epochs, batch_size, verbose, validation_split,
                                    steps_per_epoch, stream_block_steps, options)
        if rdd.is_lazy() and self.frequency != "fit":
            # row ranges of backing stores: stream them
            x, y = streaming.lazy_rdd_sources(rdd)
            return self._fit_arrays(x, y, epochs, batch_size, verbose, validation_split,
                                    steps_per_epoch, stream_block_steps, options)
        if not rdd.is_lazy() and rdd.getNumPartitions() != self.num_workers:
            # a lazy RDD is not repartitioned row by row: its ranged reads
            # are re-split to the workers by the runner
            rdd = rdd.repartition(self.num_workers)
        return self._fit_partitions(rdd_utils.partition_arrays(rdd), epochs, batch_size, verbose,
                                    validation_split, **options)

    def _fit_arrays(self, x, y, epochs, batch_size, verbose, validation_split, steps_per_epoch,
                    stream_block_steps, options) -> dict:
        # each member on its own: a memmap x with a list y still streams x
        if not streaming.is_lazy_source(x) and type(x) is not np.ndarray:
            x = np.asarray(x)
        if not streaming.is_lazy_source(y) and type(y) is not np.ndarray:
            y = np.asarray(y)
        should_stream = (stream_block_steps is not None or steps_per_epoch is not None
                         or streaming.is_lazy_source(x) or streaming.is_lazy_source(y)
                         or streaming.estimate_nbytes(x, y) > self.STREAM_THRESHOLD_BYTES)
        if not should_stream:
            # fewer rows than workers leaves empty splits: the runner fills
            partitions = [(a, b) for a, b in zip(np.array_split(x, self.num_workers),
                                                 np.array_split(y, self.num_workers)) if len(a)]
            return self._fit_partitions(partitions, epochs, batch_size, verbose,
                                        validation_split, **options)
        n = len(x)
        block_steps = stream_block_steps or 16
        val_spec, num_rows = None, None
        if validation_split and validation_split > 0.0:
            # the training rows stay a lazy view (num_rows), the tail is
            # evaluated in blocks: neither span is read whole
            n_val = min(max(1, int(n * validation_split)), n - 1)
            num_rows = n - n_val
            val_spec = (x, y, n, n_val, max(batch_size, block_steps * batch_size)
                        * max(1, self.num_workers))
        stream = streaming.ShardedStream(x, y, batch_size, self.num_workers,
                                         block_steps=block_steps,
                                         steps_per_epoch=steps_per_epoch, num_rows=num_rows)
        return self._fit_partitions(None, epochs, batch_size, verbose, 0.0, stream=stream,
                                    val_spec=val_spec, **options)

    def _fit_partitions(self, partitions, epochs, batch_size, verbose, validation_split,
                        profile_dir, checkpoint_dir, checkpoint_every, resume,
                        history_log, stream=None, val_spec=None) -> dict:
        """The fit over staged ``partitions``, or over ``stream`` with the
        streamed validation of ``val_spec`` (``(x, y, n, n_val, block)``:
        the last ``n_val`` of ``n`` rows, evaluated ``block`` rows at a
        time)."""
        runner = self._runner
        start_epoch = 0
        if checkpoint_dir and resume:
            meta = ckpt.restore_checkpoint(self._master_network, checkpoint_dir)
            if meta is not None:
                start_epoch = int(meta["epoch"])
                logger.info("resuming from %s at epoch %d", checkpoint_dir, start_epoch)
        if resume and self.ps_journal_dir:
            # the PS journal may hold sub-epoch updates newer than the
            # epoch checkpoint: adopt them as the master state; the
            # server below replays the same journal
            journaled = self._load_ps_journal_weights()
            if journaled is not None:
                set_weights(self._master_network, journaled)
                logger.info("resume: adopted journaled parameter-server state from %s",
                            self.ps_journal_dir)
        if start_epoch >= epochs:
            history = {"loss": []}
            self.training_histories.append(history)
            return history
        epochs -= start_epoch
        if partitions is not None:
            # drop (or reassign) the partitions of workers that died,
            # within the failure budget
            partitions = self._survive_partitions(partitions)

        val_partitions = None
        if validation_split and validation_split > 0.0:
            # the global tail, cut across the ordered partitions
            lens = [len(p[0]) for p in partitions]
            n_total = sum(lens)
            cut = n_total - min(max(1, int(n_total * validation_split)), n_total - 1)
            train_parts, val_partitions, lo = [], [], 0
            for (px, py), n in zip(partitions, lens):
                k = min(max(cut - lo, 0), n)
                if k:
                    train_parts.append((px[:k], py[:k]))
                if k < n:
                    val_partitions.append((px[k:], py[k:]))
                lo += n
            partitions = train_parts
        if partitions is not None:
            partitions = runner._fit_partitions_to_mesh(partitions)
        val_evaluate = None
        if val_partitions is not None:
            def val_evaluate():
                return runner.evaluate(val_partitions, batch_size)
        elif val_spec is not None:
            val_evaluate = _block_evaluate(runner, val_spec, batch_size)

        self.start_server(restore_journal=bool(resume))
        try:
            return self._run_fit(runner, partitions, epochs, batch_size, verbose, start_epoch,
                                 profile_dir, checkpoint_dir, checkpoint_every, history_log,
                                 stream, val_evaluate)
        finally:
            self.stop_server()

    def _run_fit(self, runner, partitions, epochs, batch_size, verbose, start_epoch,
                 profile_dir, checkpoint_dir, checkpoint_every, history_log, stream,
                 val_evaluate) -> dict:
        """The epochs of a fit, with the weight store (if any) running:
        epoch boundaries land on the trace as ``fit.epoch`` events and are
        published to the store, all under one trace id that the PS
        clients forward over the wire; the final publish is synchronous
        and not caught."""
        callbacks = [lambda epoch, loss: telemetry.emit("fit.epoch", epoch=int(epoch),
                                                        loss=float(loss))]
        if self._parameter_server is not None:
            callbacks.append(lambda *_: self._publish_weights())
        if checkpoint_dir:
            def save_ckpt(epoch, _loss):
                done = start_epoch + epoch + 1
                if done % checkpoint_every == 0:
                    ckpt.save_checkpoint(self._master_network, checkpoint_dir, done)

            callbacks.append(save_ckpt)
        if history_log and distributed.is_coordinator():
            t_start = time.time()

            def log_epoch(epoch, loss):
                with open(history_log, "a") as f:
                    f.write(json.dumps({"epoch": start_epoch + epoch + 1, "loss": float(loss),
                                        "elapsed_s": round(time.time() - t_start, 3)}) + "\n")

            callbacks.append(log_epoch)
        val_history: dict[str, list[float]] = {}
        if val_evaluate is not None and self.frequency != "fit":
            # per epoch, like keras.fit's val_* history
            def eval_cb(_epoch, _loss):
                for k, v in val_evaluate().items():
                    val_history.setdefault(f"val_{k}", []).append(v)

            callbacks.append(eval_cb)

        with self._profile(profile_dir), \
                telemetry.trace_scope(f"fit-r{next(_fit_trace_ids)}e{start_epoch}"):
            if stream is not None:
                history = runner.run_epochs_stream(stream, epochs, verbose, callbacks)
            else:
                history = runner.run_epochs(partitions, epochs, batch_size, verbose, callbacks)
        if val_evaluate is not None and self.frequency == "fit":
            # 'fit' averages the workers once, after the epochs: validate
            # the averaged model once, not worker 0's replica per epoch
            for k, v in val_evaluate().items():
                val_history[f"val_{k}"] = [v]
        if checkpoint_dir:
            # terminal snapshot, whatever the checkpoint_every cadence
            ckpt.save_checkpoint(self._master_network, checkpoint_dir,
                                 start_epoch + epochs, history)
        history.update(val_history)
        if history_log and distributed.is_coordinator():
            with open(history_log, "a") as f:
                f.write(json.dumps({"final": True, "history": history}) + "\n")
        self._publish_weights(final=True)
        self.training_histories.append(history)
        return history

    def _load_ps_journal_weights(self):
        """The journaled PS weights for ``fit(resume=True)``, or None. With
        ``ps_shards > 1`` each shard journaled its slice: they are gathered
        through the shard map the servers used; a topology journaled only
        in part is refused as a resume source (with a warning) rather than
        mixing journal slices with the older checkpoint."""
        from elephas_tpu_torch.parameter import journal as ps_journal

        if self.ps_shards <= 1:
            state = ps_journal.load_journal(self.ps_journal_dir)
            return None if state is None else state[0]
        from elephas_tpu_torch.parameter.sharding import ShardMap, shard_journal_dir

        smap = ShardMap.from_weights(get_weights(self._master_network), self.ps_shards)
        slices: list = [None] * self.ps_shards
        missing = []
        for i in range(self.ps_shards):
            state = ps_journal.load_journal(shard_journal_dir(self.ps_journal_dir, i))
            if state is None:
                missing.append(i)
            else:
                slices[i] = state[0]
        if missing:
            if len(missing) < self.ps_shards:
                logger.warning(
                    "resume: shard journal(s) %s missing under %s (%d of %d exist) — "
                    "refusing a mixed journal/checkpoint weight state; resuming from "
                    "the checkpoint alone", missing, self.ps_journal_dir,
                    self.ps_shards - len(missing), self.ps_shards)
            return None
        return smap.gather(slices)

    def _survive_partitions(self, partitions):
        """Worker-loss supervision: a partition whose executor died
        (:func:`~elephas_tpu_torch.fault.plan.check_partition` raises
        under an active fault plan) is dropped, or with
        ``reassign_orphans`` its rows go to the survivors, until more than
        ``failure_budget`` workers are lost, which raises
        :class:`~elephas_tpu_torch.fault.plan.FaultBudgetExceeded`."""
        from elephas_tpu_torch.fault.plan import (
            FaultBudgetExceeded,
            WorkerFault,
            active_plan,
            check_partition,
        )

        if active_plan() is None:
            return partitions
        survivors, orphans, lost = [], [], []
        for i, part in enumerate(partitions):
            try:
                check_partition(i)
            except WorkerFault as e:
                logger.warning("worker partition %d lost: %s", i, e)
                lost.append(i)
                orphans.append(part)
                continue
            survivors.append(part)
        if not lost:
            return partitions
        if len(lost) > self.failure_budget or not survivors:
            raise FaultBudgetExceeded(
                f"lost {len(lost)} worker partition(s) {lost} of "
                f"{len(partitions)}, exceeding failure_budget="
                f"{self.failure_budget} (survivors: {len(survivors)}) — "
                f"raise the budget to continue degraded, or repair the "
                f"failing workers"
            )
        if self.reassign_orphans:
            survivors = self._reassign_orphans(survivors, orphans)
            logger.warning(
                "reassigned %d orphaned partition(s) %s across %d survivors "
                "(failure_budget=%d) — full dataset, fewer workers",
                len(lost), lost, len(survivors), self.failure_budget)
            return survivors
        logger.warning("continuing with %d/%d worker partitions (failure_budget=%d)",
                       len(survivors), len(partitions), self.failure_budget)
        return survivors

    @staticmethod
    def _reassign_orphans(survivors, orphans):
        """Concatenate each orphaned partition onto a survivor
        (round-robin). ``y`` may nest row-aligned arrays in lists, tuples
        and dicts (several outputs): they are joined leaf by leaf."""
        from elephas_tpu_torch.utils.functional_utils import tree_map

        merged = list(survivors)
        for j, (ox, oy) in enumerate(orphans):
            t = j % len(merged)
            sx, sy = merged[t]
            merged[t] = (
                np.concatenate([np.asarray(sx), np.asarray(ox)]),
                tree_map(lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]), sy, oy),
            )
        return merged

    def _profile(self, profile_dir):
        """A ``torch.profiler`` trace of the host and, on a GPU, the device,
        written into ``profile_dir`` as a Chrome trace when it ends
        (counterpart of ``jax.profiler.trace``); nothing without one."""
        if not profile_dir:
            return contextlib.nullcontext()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        return torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir),
        )

    def predict(self, data, batch_size: int | None = None) -> np.ndarray:
        """Forward pass over an Rdd of feature rows or an array; returns the
        stacked predictions in input order."""
        batch_size = batch_size or self.batch_size
        if isinstance(data, Rdd):
            parts = [np.stack([np.asarray(el) for el in p]) for p in data.partitions() if p]
        else:
            parts = [np.asarray(data)]
        return self._runner.predict(parts, batch_size)

    def evaluate(self, x_test, y_test=None, batch_size: int | None = None, **kwargs):
        """Evaluate on ``(x, y)`` arrays or a simple RDD. Returns ``[loss,
        *metrics]`` in compile order, like ``keras.Model.evaluate`` (the
        loss alone when nothing else is compiled)."""
        batch_size = batch_size or self.batch_size
        if isinstance(x_test, Rdd):
            partitions = rdd_utils.partition_arrays(x_test)
        else:
            partitions = [(np.asarray(x_test), np.asarray(y_test))]
        results = self._runner.evaluate(partitions, batch_size)
        ordered = list(results.values())
        return ordered if len(ordered) > 1 else ordered[0]

    def save(self, file_name: str) -> None:
        """Save the master module (:func:`~elephas_tpu_torch.utils.\
serialization.save_model`: its builder and arguments, compile spec,
        weights and optimizer state) to ``file_name``, and the distribution
        config (:meth:`get_config`) to ``<file_name>.elephas.json``, as the
        reference does. In a gang only the coordinator writes."""

        def write():
            serialization.save_model(self._master_network, file_name)
            with open(file_name + ".elephas.json", "w") as f:
                json.dump(self.get_config(), f)

        ckpt.coordinator_writes("save", write)

    def generate(self, prompt, steps: int, temperature: float = 0.0,
                 top_k: int | None = None, top_p: float | None = None, seed: int = 0,
                 kv_cache: bool = False):
        """Autoregressive generation from the master network on this
        wrapper's one device: :func:`~elephas_tpu_torch.generate` with the
        same arguments (the reference decodes over the wrapper's mesh; one
        device is the port's only mesh). Returns ``[B, P + steps]`` int32
        tokens."""
        return _generate(self._master_network, prompt, steps, temperature=temperature,
                         top_k=top_k, top_p=top_p, seed=seed, kv_cache=kv_cache)

    def serve(self, num_slots: int = 8, policy=None, tenants=None,
              gateway_port: int | None = None, gateway_host: str = _GATEWAY_HOST,
              **engine_options):
        """A continuous-batching :class:`~elephas_tpu_torch.serving.\
InferenceEngine` over the wrapped model, on this wrapper's device.
        ``engine_options`` go to the engine (``top_k``, ``top_p``,
        ``seed``, ``buckets``, ``steps_per_sync``, ``attention``, the paged
        arena's ``paged``, ``block_size``, ``num_blocks``, ``preemption`` and
        ``kv_dtype``, speculative decoding's ``speculative``, ``spec_k`` and
        ``spec_drafter``, and the reference's other engine keywords,
        ``flight_recorder`` among them, whose unported values raise there).
        ``policy`` / ``tenants`` install an admission policy through
        :func:`~elephas_tpu_torch.serving.policy.resolve_policy`:
        ``"fair"`` (or only ``tenants={"name": weight}``) for fair share,
        deadlines and admission control, ``"fifo"``, or a
        :class:`~elephas_tpu_torch.serving.policy.Policy`. Submit with
        ``engine.submit(prompt, max_new_tokens, temperature=, eos_id=,
        tenant=, ttft_deadline_ms=)``, drive with ``engine.step()`` /
        ``stream()`` / ``run()``.

        ``gateway_port`` (0: an ephemeral port) also starts a
        :class:`~elephas_tpu_torch.serving.gateway.Gateway` on
        ``gateway_host`` in front of the engine, as ``engine.gateway``: it
        serves ``POST /v1/generate`` (SSE or JSON), ``/metrics``,
        ``/stats``, ``/healthz``, ``/debug/engine``, the per-request trace,
        cancel and export routes, ``/v1/migrate`` and ``/v1/score``. The
        engine is a context manager: leaving the ``with`` block (or
        ``engine.close()``) stops the gateway and releases the port."""
        engine = InferenceEngine(self._master_network, num_slots=num_slots,
                                 policy=resolve_policy(policy, tenants), device=self.device,
                                 **engine_options)
        if gateway_port is not None:
            from elephas_tpu_torch.serving.gateway import Gateway

            gw = Gateway(engine, host=gateway_host, port=int(gateway_port))
            try:
                engine.gateway = gw.start()
            except Exception:
                # the caller never receives the engine: retire both its and
                # the half-built gateway's series before re-raising
                gw.release_telemetry()
                engine.release_telemetry()
                raise
        return engine

    def scrape(self) -> str:
        """The port's telemetry registry (the serving engines' series and
        their gateways') as Prometheus exposition text."""
        return telemetry.scrape_text()


def _block_evaluate(runner, val_spec, batch_size):
    """Evaluate the held-out tail of a streamed fit ``block`` rows at a
    time, as the row-weighted mean of the blocks' results (the
    reference's ``_make_val_evaluate``, ``elephas_tpu/spark_model.py:993``).
    Exact for the loss and every metric of the port, which are all
    row-weighted means, so the reference's warning for a metric that is
    not one has nothing to warn of."""
    x, y, n, n_val, block = val_spec

    def evaluate_blocks():
        totals: dict[str, float] = {}
        for lo in range(n - n_val, n, block):
            hi = min(n, lo + block)
            res = runner.evaluate([(np.asarray(x[lo:hi]), np.asarray(y[lo:hi]))], batch_size)
            for k, v in res.items():
                totals[k] = totals.get(k, 0.0) + float(v) * (hi - lo)
        return {k: v / n_val for k, v in totals.items()}

    return evaluate_blocks


class SparkMLlibModel(SparkModel):
    """SparkModel over MLlib-style ``LabeledPoint`` RDDs (counterpart of
    ``elephas_tpu/spark_model.py:1409``)."""

    def train(self, labeled_points: Rdd, epochs: int = 10, batch_size: int = 32,
              categorical: bool = False, nb_classes: int | None = None, **kwargs) -> dict:
        rdd = rdd_utils.lp_to_simple_rdd(labeled_points, categorical, nb_classes)
        return self.fit(rdd, epochs=epochs, batch_size=batch_size, **kwargs)

    def predict(self, data, batch_size: int | None = None) -> np.ndarray:
        """Predictions for an Rdd of ``DenseVector``s or arrays, a
        ``DenseVector`` (one row) or an array."""
        if isinstance(data, Rdd):
            data = data.map(lambda el: el.toArray() if isinstance(el, DenseVector) else el)
        elif isinstance(data, DenseVector):
            data = data.toArray()[None]
        return super().predict(data, batch_size)


def load_spark_model(file_name: str, device=None) -> SparkModel:
    """Reload a wrapper saved by :meth:`SparkModel.save`, on ``device``
    (``cuda:0`` by default), with the sidecar's config."""
    model = serialization.load_model(file_name, device)
    config = {}
    sidecar = file_name + ".elephas.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            config = json.load(f)
    return SparkModel(
        model,
        mode=config.get("mode", "synchronous"),
        frequency=config.get("frequency", "epoch"),
        parameter_server_mode=config.get("parameter_server_mode"),
        num_workers=config.get("num_workers"),
        batch_size=config.get("batch_size", 32),
        port=config.get("port", 4000),
        ps_overlap=config.get("ps_overlap"),
        ps_journal_dir=config.get("ps_journal_dir"),
        ps_shards=config.get("ps_shards", 1),
        failure_budget=config.get("failure_budget", 0),
        reassign_orphans=config.get("reassign_orphans", True),
        model_parallel=config.get("model_parallel", 1),
        pipeline_parallel=config.get("pipeline_parallel", 1),
        pipeline_microbatches=config.get("pipeline_microbatches", 4),
        sequence_parallel=config.get("sequence_parallel", 1),
        sequence_attention=config.get("sequence_attention", "ring"),
        device=device,
    )
