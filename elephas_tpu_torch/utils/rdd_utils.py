"""RDD construction helpers (copy of ``elephas_tpu/utils/rdd_utils.py``,
cut to :func:`to_simple_rdd` and :func:`partition_arrays`).

A "simple RDD" is an RDD of ``(features_row, label_row)`` numpy pairs.
"""

from __future__ import annotations

import numpy as np

from elephas_tpu_torch.data.rdd import Rdd


def to_simple_rdd(sc, features, labels, num_partitions: int | None = None) -> Rdd:
    """Zip feature and label arrays into an RDD of ``(x_row, y_row)``
    pairs. Every source is read into host memory (the reference's lazy
    row-range partitions for memmap/h5py sources are not ported)."""
    if len(features) != len(labels):
        raise ValueError(
            f"features ({len(features)}) and labels ({len(labels)}) lengths differ"
        )
    pairs = list(zip(np.asarray(features), np.asarray(labels)))
    return sc.parallelize(pairs, numSlices=num_partitions)


def partition_arrays(rdd: Rdd) -> list[tuple[np.ndarray, np.ndarray]]:
    """Stack each partition of a simple RDD into ``(x[P,...], y[P,...])``.

    Empty partitions are dropped: a zero-row partition carries no
    information."""
    out = []
    for part in rdd.partitions():
        if not part:
            continue
        xs = np.stack([np.asarray(x) for x, _ in part])
        ys = np.stack([np.asarray(y) for _, y in part])
        out.append((xs, ys))
    if not out:
        raise ValueError("RDD has no data")
    return out
