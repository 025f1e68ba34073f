"""elephas_tpu_torch — the PyTorch/CUDA port of elephas_tpu for NVIDIA Hopper.

The JAX package ``elephas_tpu`` stays the reference; this package is its
counterpart beside it, slice by slice (ROADMAP.md). It imports torch and
numpy, never jax, keras or ``elephas_tpu``.

The first slice serves :func:`transformer_lm` through :func:`generate`,
with the flash-attention forward as a CUDA kernel written for sm_90a
(``csrc/flash_fwd.cu``). The second trains through :class:`SparkModel`
(one device), with the LayerNorm forward and backward as CUDA kernels
(``csrc/layer_norm.cu``, behind :class:`FusedLayerNorm`), the flash
backward in plain PyTorch, and Keras's Adam. Entry points run on ``cuda``
by default; only an explicit ``device="cpu"`` selects the CPU, where the
kernels' plain PyTorch versions run.
"""

__version__ = "0.2.0"

from elephas_tpu_torch.models.transformer import (  # noqa: F401
    FusedLayerNorm,
    generate,
    transformer_classifier,
    transformer_lm,
)
from elephas_tpu_torch.spark_model import SparkModel, load_spark_model  # noqa: F401
from elephas_tpu_torch.utils.rdd_utils import to_simple_rdd  # noqa: F401
from elephas_tpu_torch.utils.weights import keras_weights, load_keras_weights  # noqa: F401

__all__ = [
    "FusedLayerNorm",
    "SparkModel",
    "generate",
    "keras_weights",
    "load_keras_weights",
    "load_spark_model",
    "to_simple_rdd",
    "transformer_classifier",
    "transformer_lm",
]
