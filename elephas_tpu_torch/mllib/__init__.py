"""MLlib compatibility layer (counterpart of ``elephas_tpu/mllib/``)."""

from elephas_tpu_torch.mllib.adapter import (  # noqa: F401
    from_matrix,
    from_vector,
    to_matrix,
    to_vector,
)
