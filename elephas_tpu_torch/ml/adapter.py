"""DataFrame <-> simple RDD (copy of ``elephas_tpu/ml/adapter.py``):
``df_to_simple_rdd`` (a features column and a label column → an RDD of
``(x, y)`` numpy pairs, one-hot with ``categorical``),
``to_data_frame`` and ``from_data_frame``."""

from __future__ import annotations

import numpy as np

from elephas_tpu_torch.data.context import SparkContext
from elephas_tpu_torch.data.dataframe import DataFrame, vectorize_column
from elephas_tpu_torch.data.linalg import DenseVector
from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.utils.rdd_utils import encode_labels, to_simple_rdd


def df_to_simple_rdd(df: DataFrame, categorical: bool = False, nb_classes: int | None = None,
                     features_col: str = "features", label_col: str = "label",
                     num_partitions: int | None = None) -> Rdd:
    """DataFrame → a simple RDD of ``(features_row, label_row)`` pairs."""
    features, labels = from_data_frame(df, categorical, nb_classes, features_col, label_col)
    return to_simple_rdd(SparkContext(), features, labels, num_partitions=num_partitions)


def to_data_frame(sc, features, labels, categorical: bool = False) -> DataFrame:
    """numpy arrays → DataFrame(features: DenseVector, label: float)."""
    label_values = [
        float(np.argmax(y)) if categorical else float(np.ravel(y)[0] if np.ndim(y) else y)
        for y in np.asarray(labels)
    ]
    return DataFrame({"features": [DenseVector(np.ravel(x)) for x in np.asarray(features)],
                      "label": label_values})


def from_data_frame(df: DataFrame, categorical: bool = False, nb_classes: int | None = None,
                    features_col: str = "features", label_col: str = "label"):
    """DataFrame → ``(features, labels)`` numpy arrays."""
    features = vectorize_column(df.column_values(features_col))
    raw = df.column_values(label_col)
    labels = encode_labels(raw, nb_classes) if categorical else np.asarray(raw, dtype=np.float32)
    return features, labels
