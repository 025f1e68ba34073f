"""elephas_tpu_torch — the PyTorch/CUDA port of elephas_tpu for NVIDIA Hopper.

The JAX package ``elephas_tpu`` stays the reference; this package is its
counterpart beside it, slice by slice (ROADMAP.md). It imports torch and
numpy, never jax, keras or ``elephas_tpu``.

The first slice serves :func:`transformer_lm` through :func:`generate`,
with the flash-attention forward as a CUDA kernel written for sm_90a
(``csrc/flash_fwd.cu``). Entry points run on ``cuda`` by default; only an
explicit ``device="cpu"`` selects the CPU, where the kernels' plain
PyTorch versions run.
"""

__version__ = "0.1.0"

from elephas_tpu_torch.models.transformer import (  # noqa: F401
    generate,
    transformer_classifier,
    transformer_lm,
)
from elephas_tpu_torch.utils.weights import load_keras_weights  # noqa: F401

__all__ = [
    "generate",
    "load_keras_weights",
    "transformer_classifier",
    "transformer_lm",
]
