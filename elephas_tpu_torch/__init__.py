"""elephas_tpu_torch — the PyTorch/CUDA port of elephas_tpu for NVIDIA Hopper.

The JAX package ``elephas_tpu`` stays the reference; this package is its
counterpart beside it, slice by slice (ROADMAP.md). It imports torch and
numpy, never jax, keras or ``elephas_tpu``.

What runs: the reference's model zoo (:func:`mnist_mlp`,
:func:`cifar10_cnn`, :func:`imdb_lstm`, :func:`resnet`, :func:`resnet50`,
:func:`transformer_classifier`, :func:`transformer_lm`, and the Switch
mixture-of-experts :func:`switch_transformer_classifier` and
:func:`switch_transformer_lm` over :class:`MoeFFN`) builds, trains,
evaluates and predicts through :class:`SparkModel` in float32 and, where
the reference takes it (the transformers and ResNet), ``mixed_bfloat16``:
on W workers in every mode and frequency of the reference, on one
device (:func:`elephas_tpu_torch.device.force_devices` offers the worker
slots) or across a gang of processes, one rank a card
(``python -m elephas_tpu_torch.launch``,
:mod:`elephas_tpu_torch.parallel.distributed`), with validation,
checkpoints and resume, and
:meth:`SparkModel.save` / :func:`load_spark_model`. The transformers run the flash-attention forward
(``csrc/flash_fwd.cu``) and the LayerNorm forward and backward
(``csrc/layer_norm.cu``, behind :class:`FusedLayerNorm`) as CUDA kernels
written for sm_90a, on their bf16 routes under ``mixed_bfloat16``; the
flash backward is plain PyTorch. :func:`transformer_lm` and
:func:`switch_transformer_lm` serve through :func:`generate` and the continuous-batching :class:`InferenceEngine` on
the fixed or paged KV arena, with decode attention as a CUDA kernel
(``csrc/span_decode.cu``), speculative decoding through the span-chunk
kernel (``csrc/span_chunk.cu``), SLO admission policies, and long prompts
prefilled sequence-parallel over a :class:`~elephas_tpu_torch.parallel.mesh.Mesh` (ring or Ulysses attention, :mod:`elephas_tpu_torch.ops.ring_attention`,
:mod:`elephas_tpu_torch.ops.ulysses`, over the flash forward); the engine
records the reference's telemetry (:mod:`elephas_tpu_torch.telemetry`) and
serves over HTTP/SSE through :class:`~elephas_tpu_torch.serving.Gateway`
(``SparkModel.serve(gateway_port=...)``), its requests migrating between
engines as wire-v3 records (:mod:`elephas_tpu_torch.fleet.migration`).
Weights cross from and to the reference by Keras path
(:func:`load_keras_weights`, :func:`keras_weights`).

Inputs the reference streams (a memmap or other lazy source, a lazy RDD,
``steps_per_epoch``, ``stream_block_steps``, arrays over
``SparkModel.STREAM_THRESHOLD_BYTES``) stream into the card in blocks
(:mod:`elephas_tpu_torch.data.streaming`): a reader thread gathers the
next blocks, which cross from pinned host buffers on a side CUDA stream
while the card trains on the current one. The Spark ML surface runs on
the same ``SparkModel``: :class:`ElephasEstimator` and
:class:`ElephasTransformer` in a :class:`~elephas_tpu_torch.ml.Pipeline`
over the DataFrame stand-in (:mod:`elephas_tpu_torch.data.dataframe`),
the model read from its Keras JSON (:mod:`elephas_tpu_torch.models.\
keras_config`), and :class:`SparkMLlibModel` over ``LabeledPoint`` RDDs. :class:`HyperParamModel`
searches hyperparameters over the worker slots (in a gang, its rounds
gathered from every rank), its trials trained by the same runner.

Entry points run on ``cuda`` by default; only an explicit
``device="cpu"`` selects the CPU, where the kernels' plain PyTorch
versions run.
"""

__version__ = "0.6.0"

from elephas_tpu_torch.hyperparam import HyperParamModel  # noqa: F401
from elephas_tpu_torch.models import (  # noqa: F401
    FusedLayerNorm,
    MoeFFN,
    cifar10_cnn,
    generate,
    imdb_lstm,
    mnist_mlp,
    resnet,
    resnet50,
    switch_transformer_classifier,
    switch_transformer_lm,
    transformer_classifier,
    transformer_lm,
)
from elephas_tpu_torch.ml_model import (  # noqa: F401
    ElephasEstimator,
    ElephasTransformer,
    load_ml_estimator,
    load_ml_transformer,
)
from elephas_tpu_torch.parallel.tensor import ShardedTrainer  # noqa: F401
from elephas_tpu_torch.serving import InferenceEngine, RequestCancelled  # noqa: F401
from elephas_tpu_torch.spark_model import (  # noqa: F401
    SparkMLlibModel,
    SparkModel,
    load_spark_model,
)
from elephas_tpu_torch.utils.rdd_utils import to_simple_rdd  # noqa: F401
from elephas_tpu_torch.utils.weights import keras_weights, load_keras_weights  # noqa: F401

__all__ = [
    "ElephasEstimator",
    "ElephasTransformer",
    "FusedLayerNorm",
    "HyperParamModel",
    "InferenceEngine",
    "MoeFFN",
    "RequestCancelled",
    "ShardedTrainer",
    "SparkMLlibModel",
    "SparkModel",
    "cifar10_cnn",
    "generate",
    "imdb_lstm",
    "keras_weights",
    "load_keras_weights",
    "load_ml_estimator",
    "load_ml_transformer",
    "load_spark_model",
    "mnist_mlp",
    "resnet",
    "resnet50",
    "switch_transformer_classifier",
    "switch_transformer_lm",
    "to_simple_rdd",
    "transformer_classifier",
    "transformer_lm",
    "__version__",
]
