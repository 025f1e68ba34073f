"""MLlib-style linalg types: ``DenseVector``, ``DenseMatrix``,
``Vectors``, ``LabeledPoint`` (copy of ``elephas_tpu/data/linalg.py``):
numpy-backed stand-ins for ``pyspark.mllib``'s, with the constructor and
attribute surface the adapters use."""

from __future__ import annotations

import numpy as np


class DenseVector:
    def __init__(self, values):
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)

    def toArray(self) -> np.ndarray:
        return self.values

    def __len__(self) -> int:
        return len(self.values)

    def __eq__(self, other) -> bool:
        return isinstance(other, DenseVector) and np.array_equal(self.values, other.values)

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


class DenseMatrix:
    """Column-major dense matrix (MLlib's layout)."""

    def __init__(self, numRows: int, numCols: int, values):
        self.numRows = int(numRows)
        self.numCols = int(numCols)
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)
        if self.values.size != self.numRows * self.numCols:
            raise ValueError("values size does not match numRows*numCols")

    def toArray(self) -> np.ndarray:
        return self.values.reshape((self.numCols, self.numRows)).T

    def __eq__(self, other) -> bool:
        return (isinstance(other, DenseMatrix) and self.numRows == other.numRows
                and self.numCols == other.numCols and np.array_equal(self.values, other.values))

    def __repr__(self) -> str:
        return f"DenseMatrix({self.numRows}, {self.numCols})"


class Vectors:
    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and np.ndim(values[0]) >= 1:
            return DenseVector(values[0])
        return DenseVector(values)


class LabeledPoint:
    def __init__(self, label, features):
        self.label = float(label)
        self.features = features if isinstance(features, DenseVector) else DenseVector(features)

    def __repr__(self) -> str:
        return f"LabeledPoint({self.label}, {self.features})"
