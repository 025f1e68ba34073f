"""numpy <-> MLlib linalg conversions (copy of
``elephas_tpu/mllib/adapter.py``): ``to_matrix``, ``from_matrix``,
``to_vector``, ``from_vector`` against
:mod:`elephas_tpu_torch.data.linalg`."""

from __future__ import annotations

import numpy as np

from elephas_tpu_torch.data.linalg import DenseMatrix, DenseVector


def to_matrix(np_array: np.ndarray) -> DenseMatrix:
    if np_array.ndim != 2:
        raise ValueError(f"to_matrix expects a 2-D array, got ndim={np_array.ndim}")
    rows, cols = np_array.shape
    # DenseMatrix stores column-major
    return DenseMatrix(rows, cols, np_array.T.reshape(-1))


def from_matrix(matrix: DenseMatrix) -> np.ndarray:
    return matrix.toArray()


def to_vector(np_array: np.ndarray) -> DenseVector:
    if np_array.ndim != 1:
        raise ValueError(f"to_vector expects a 1-D array, got ndim={np_array.ndim}")
    return DenseVector(np_array)


def from_vector(vector: DenseVector) -> np.ndarray:
    return vector.toArray()
