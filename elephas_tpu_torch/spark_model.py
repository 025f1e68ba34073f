"""SparkModel — the Spark-shaped training façade of the port.

Counterpart of ``elephas_tpu/spark_model.py``: ``SparkModel(model, mode=,
frequency=, num_workers=, batch_size=, device=)`` with ``fit``,
``predict`` and ``evaluate`` over a simple RDD or ``(x, y)`` arrays, on one
device (:class:`elephas_tpu_torch.worker.Runner`), and ``generate`` and
``serve`` of a language model. ``model`` is a module compiled with
:func:`elephas_tpu_torch.training.compile_model`, as every builder of the
zoo returns it (``mnist_mlp``, ``cifar10_cnn``, ``imdb_lstm``,
``resnet``/``resnet50``, ``transformer_classifier``, ``transformer_lm``),
in float32 or, where the reference takes it, ``mixed_bfloat16``.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: more than one worker, the parameter server, model,
pipeline and sequence parallelism (item 5), streaming inputs,
``validation_split``, checkpoints and ``resume``,
``save``/``load_spark_model``, and the serving engine's options beyond
the fixed arena (:meth:`SparkModel.serve`). A ``mixed_bfloat16`` language
model is refused by :meth:`SparkModel.serve` and ``generate(kv_cache=True)``,
as in the reference.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.device import resolve_device, worker_count
from elephas_tpu_torch.models.transformer import generate as _generate
from elephas_tpu_torch.serving import InferenceEngine
from elephas_tpu_torch.utils import rdd_utils
from elephas_tpu_torch.worker import Runner

_TRAINING_TODO = (
    "{} is not ported yet (ROADMAP.md, Queue A item 2: what the training "
    "slice left out)"
)
_SCALE_OUT_TODO = (
    "{} is not ported yet (ROADMAP.md, Queue A item 5: model, pipeline and "
    "sequence parallelism)"
)
_SERVING_TODO = (
    "serve({}) is not ported yet (ROADMAP.md, Queue A item 3: the "
    "gateway and SLO tenants)"
)
# the reference's serve() binds its gateway here when given a port
_GATEWAY_HOST = "127.0.0.1"


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
                raise NotImplementedError(_SCALE_OUT_TODO.format(f"{name}={n}"))
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


def load_spark_model(file_name: str, **kwargs) -> SparkModel:
    raise NotImplementedError(_TRAINING_TODO.format("save/load_spark_model"))
