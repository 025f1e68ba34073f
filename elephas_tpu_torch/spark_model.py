"""SparkModel — the Spark-shaped training façade of the port.

Counterpart of ``elephas_tpu/spark_model.py``: ``SparkModel(model, mode=,
frequency=, num_workers=, batch_size=, device=)`` with ``fit``,
``predict`` and ``evaluate`` over a simple RDD or ``(x, y)`` arrays, on one
device (:class:`elephas_tpu_torch.worker.Runner`). ``model`` is a module
compiled with :func:`elephas_tpu_torch.training.compile_model`, as
:func:`~elephas_tpu_torch.transformer_lm` and
:func:`~elephas_tpu_torch.transformer_classifier` return it.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: more than one worker, the parameter server, model,
pipeline and sequence parallelism, streaming inputs, ``validation_split``,
checkpoints and ``resume``, ``save``/``load_spark_model``, and the serving
engine. ``mixed_bfloat16`` is refused by the model builders.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.device import resolve_device, worker_count
from elephas_tpu_torch.utils import rdd_utils
from elephas_tpu_torch.worker import Runner

_TRAINING_TODO = (
    "{} is not ported yet (ROADMAP.md, Queue A item 2: what the training "
    "slice left out)"
)
_SERVING_TODO = (
    "the serving engine is not ported yet (ROADMAP.md, Queue A item 1: "
    "cached decode and the InferenceEngine)"
)


class SparkModel:
    """Data-parallel training of a compiled module, on one device.

    ``device`` is ``cuda:0`` unless the caller names another (``"cpu"``
    runs the kernels' plain versions). With one worker, every mode and
    frequency trains identically (see :mod:`elephas_tpu_torch.worker`)."""

    def __init__(
        self,
        model: nn.Module,
        mode: str = "synchronous",
        frequency: str = "epoch",
        parameter_server_mode: str | None = None,
        num_workers: int | None = None,
        batch_size: int = 32,
        model_parallel: int = 1,
        pipeline_parallel: int = 1,
        sequence_parallel: int = 1,
        device=None,
    ):
        if not isinstance(model, nn.Module):
            raise ValueError(f"model must be a torch.nn.Module, got {type(model)}")
        # checks the compile spec, mode and frequency
        self._runner = Runner(model, mode, frequency)
        if parameter_server_mode not in (None, "http", "socket", "native"):
            raise ValueError(
                f"parameter_server_mode must be 'http', 'socket', 'native' "
                f"or None, got {parameter_server_mode!r}"
            )
        if parameter_server_mode is not None:
            raise NotImplementedError(
                _TRAINING_TODO.format(f"parameter_server_mode={parameter_server_mode!r}")
            )
        for name, n in (("model_parallel", model_parallel),
                        ("pipeline_parallel", pipeline_parallel),
                        ("sequence_parallel", sequence_parallel)):
            if n > 1:
                raise NotImplementedError(_TRAINING_TODO.format(f"{name}={n}"))
        self.device = resolve_device(device)
        self.num_workers = worker_count(num_workers, self.device)
        if self.num_workers > 1:
            raise NotImplementedError(_TRAINING_TODO.format(
                f"training on {self.num_workers} workers (torch.distributed)"
            ))
        self._master_network = model.to(self.device)
        self.mode = mode
        self.frequency = frequency
        self.batch_size = batch_size
        self.training_histories: list[dict] = []

    @property
    def master_network(self) -> nn.Module:
        return self._master_network

    def fit(
        self,
        rdd,
        epochs: int = 10,
        batch_size: int | None = None,
        verbose: int = 0,
        validation_split: float = 0.0,
        checkpoint_dir: str | None = None,
        resume: bool = False,
        steps_per_epoch: int | None = None,
        stream_block_steps: int | None = None,
    ) -> dict:
        """Train on a simple RDD of ``(x_row, y_row)`` pairs, or on an
        ``(x, y)`` pair of arrays. Returns the Keras-style history dict
        (``loss`` and each compiled metric per epoch), also appended to
        ``training_histories``."""
        if validation_split:
            raise NotImplementedError(_TRAINING_TODO.format("validation_split"))
        if checkpoint_dir or resume:
            raise NotImplementedError(_TRAINING_TODO.format("checkpoint_dir/resume"))
        if steps_per_epoch is not None or stream_block_steps is not None:
            raise NotImplementedError(_TRAINING_TODO.format("streaming inputs"))
        batch_size = batch_size or self.batch_size
        if isinstance(rdd, Rdd):
            # with one worker the reference's round-robin repartition keeps
            # the rows in order: the runner's concatenation is the same
            partitions = rdd_utils.partition_arrays(rdd)
        else:
            partitions = [tuple(np.asarray(a) for a in rdd)]
        partitions = self._runner._fit_partitions_to_mesh(partitions)
        history = self._runner.run_epochs(partitions, epochs, batch_size, verbose)
        self.training_histories.append(history)
        return history

    def predict(self, data, batch_size: int | None = None) -> np.ndarray:
        """Forward pass over an Rdd of feature rows or an array; returns the
        stacked predictions in input order."""
        batch_size = batch_size or self.batch_size
        if isinstance(data, Rdd):
            parts = [np.stack([np.asarray(el) for el in p]) for p in data.partitions() if p]
        else:
            parts = [np.asarray(data)]
        return self._runner.predict(parts, batch_size)

    def evaluate(self, x_test, y_test=None, batch_size: int | None = None):
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

    def save(self, file_name: str, overwrite: bool = False) -> None:
        raise NotImplementedError(_TRAINING_TODO.format("save/load_spark_model"))

    def serve(self, *args, **kwargs):
        raise NotImplementedError(_SERVING_TODO)


def load_spark_model(file_name: str, **kwargs) -> SparkModel:
    raise NotImplementedError(_TRAINING_TODO.format("save/load_spark_model"))
