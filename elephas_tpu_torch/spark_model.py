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
several physical GPUs are refused). ``fit`` takes the reference's
``validation_split``, ``checkpoint_dir``/``checkpoint_every``/``resume``
(:mod:`elephas_tpu_torch.utils.checkpoint`), ``history_log`` and
``profile_dir`` (a ``torch.profiler`` Chrome trace), and streams what the
reference streams (:mod:`elephas_tpu_torch.data.streaming`): a memmap or
other lazy source, a lazy RDD, ``steps_per_epoch``, ``stream_block_steps``
or more than :attr:`SparkModel.STREAM_THRESHOLD_BYTES`. ``save`` writes
the module (:mod:`elephas_tpu_torch.utils.serialization`) and the
reference's ``<file>.elephas.json`` sidecar. :class:`SparkMLlibModel`
trains on an RDD of ``LabeledPoint``s.

Every keyword of the reference is accepted. At the value that leaves the
behaviour unchanged (the reference's default) it passes; any other value
raises ``NotImplementedError`` naming its ROADMAP.md item: the parameter
server and fault tolerance (item 4), model, pipeline and sequence
parallelism (item 5), and the serving engine's options beyond the fixed
arena (:meth:`SparkModel.serve`, item 3). A ``mixed_bfloat16`` language
model is refused by :meth:`SparkModel.serve` and
``generate(kv_cache=True)``, as in the reference.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch
from torch import nn

from elephas_tpu_torch.data import streaming
from elephas_tpu_torch.data.linalg import DenseVector
from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.device import resolve_device, worker_count
from elephas_tpu_torch.models.transformer import _is_neutral
from elephas_tpu_torch.models.transformer import generate as _generate
from elephas_tpu_torch.serving import InferenceEngine
from elephas_tpu_torch.utils import checkpoint as ckpt
from elephas_tpu_torch.utils import rdd_utils, serialization
from elephas_tpu_torch.worker import Runner

logger = logging.getLogger(__name__)

_TODO = "{} is not ported yet (ROADMAP.md, Queue A item {})"
_SERVING_TODO = (
    "serve({}) is not ported yet (ROADMAP.md, Queue A item 3: the "
    "gateway and SLO tenants)"
)
# the reference's serve() binds its gateway here when given a port
_GATEWAY_HOST = "127.0.0.1"


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
        # (name, value, the value that leaves the behaviour unchanged, item)
        unported = (
            ("parameter_server_mode", parameter_server_mode, None, 4),
            ("port", port, 4000, 4),
            ("ps_overlap", self.ps_overlap, mode != "synchronous", 4),
            ("ps_journal_dir", ps_journal_dir, None, 4), ("ps_shards", ps_shards, 1, 4),
            ("failure_budget", failure_budget, 0, 4),
            ("reassign_orphans", reassign_orphans, True, 4),
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
        self.num_workers = worker_count(num_workers, self.device)
        # checks the compile spec, mode and frequency
        self._runner = Runner(model, mode, frequency, self.num_workers)
        self._master_network = model.to(self.device)
        self.mode = mode
        self.frequency = frequency
        self.parameter_server_mode = parameter_server_mode
        self.custom_objects = custom_objects
        self.batch_size = batch_size
        self.port = port
        self.ps_journal_dir = ps_journal_dir
        self.ps_shards = int(ps_shards)
        self.failure_budget = int(failure_budget)
        self.reassign_orphans = bool(reassign_orphans)
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
        if start_epoch >= epochs:
            history = {"loss": []}
            self.training_histories.append(history)
            return history
        epochs -= start_epoch

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

        callbacks = []
        if checkpoint_dir:
            def save_ckpt(epoch, _loss):
                done = start_epoch + epoch + 1
                if done % checkpoint_every == 0:
                    ckpt.save_checkpoint(self._master_network, checkpoint_dir, done)

            callbacks.append(save_ckpt)
        if history_log:
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

        with self._profile(profile_dir):
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
        if history_log:
            with open(history_log, "a") as f:
                f.write(json.dumps({"final": True, "history": history}) + "\n")
        self.training_histories.append(history)
        return history

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
        reference does."""
        serialization.save_model(self._master_network, file_name)
        with open(file_name + ".elephas.json", "w") as f:
            json.dump(self.get_config(), f)

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

    def serve(self, num_slots: int = 8, tenants=None, gateway_port: int | None = None,
              gateway_host: str = _GATEWAY_HOST, **engine_options):
        """A continuous-batching :class:`~elephas_tpu_torch.serving.\
InferenceEngine` over the wrapped model, on this wrapper's device.
        ``engine_options`` go to the engine (``top_k``, ``top_p``,
        ``seed``, ``buckets``, ``steps_per_sync``, ``attention`` and the
        reference's other engine keywords, ``flight_recorder`` among them,
        whose unported values raise there). ``tenants``, ``gateway_port`` and a
        ``gateway_host`` other than the reference's default raise. Submit
        with ``engine.submit(prompt, max_new_tokens, temperature=,
        eos_id=)``, drive with ``engine.step()`` / ``stream()`` /
        ``run()``."""
        for name, value in (("tenants", tenants), ("gateway_port", gateway_port)):
            if value is not None:
                raise NotImplementedError(_SERVING_TODO.format(f"{name}={value!r}"))
        if gateway_host != _GATEWAY_HOST:
            raise NotImplementedError(_SERVING_TODO.format(f"gateway_host={gateway_host!r}"))
        return InferenceEngine(self._master_network, num_slots=num_slots,
                               device=self.device, **engine_options)


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
