"""Spark-ML-style pipeline layer (counterpart of ``elephas_tpu/ml/``)."""

from elephas_tpu_torch.ml.adapter import (  # noqa: F401
    df_to_simple_rdd,
    from_data_frame,
    to_data_frame,
)
from elephas_tpu_torch.ml.pipeline import Pipeline, PipelineModel  # noqa: F401
