"""RDD construction helpers (copy of ``elephas_tpu/utils/rdd_utils.py``):
:func:`to_simple_rdd`, :func:`partition_arrays`, the label encoders and
the ``LabeledPoint`` conversions.

A "simple RDD" is an RDD of ``(features_row, label_row)`` numpy pairs. A
lazy source (a memmap, an h5py dataset) makes an Rdd of
:class:`~elephas_tpu_torch.data.rdd.LazyRows` partitions, which
``SparkModel.fit`` streams.
"""

from __future__ import annotations

import numpy as np

from elephas_tpu_torch.data.linalg import LabeledPoint
from elephas_tpu_torch.data.rdd import LazyRows, Rdd
from elephas_tpu_torch.data.streaming import is_lazy_source


def encode_label(label, nb_classes: int) -> np.ndarray:
    """One-hot encode a scalar label into ``nb_classes`` floats."""
    encoded = np.zeros(nb_classes, dtype=np.float32)
    encoded[int(label)] = 1.0
    return encoded


def encode_labels(raw, nb_classes: int | None = None) -> np.ndarray:
    """One-hot a sequence of scalar labels (``nb_classes`` is max + 1 when
    omitted)."""
    if nb_classes is None:
        nb_classes = int(max(raw)) + 1
    return np.stack([encode_label(label, nb_classes) for label in raw])


def to_simple_rdd(sc, features, labels, num_partitions: int | None = None) -> Rdd:
    """Zip feature and label arrays into an RDD of ``(x_row, y_row)``
    pairs. A lazy source gives contiguous :class:`LazyRows` partitions
    (the other member as an ndarray), read only when used."""
    if len(features) != len(labels):
        raise ValueError(
            f"features ({len(features)}) and labels ({len(labels)}) lengths differ"
        )
    if is_lazy_source(features) or is_lazy_source(labels):
        # the streaming gather indexes the eager member with numpy arrays
        if not is_lazy_source(features):
            features = np.asarray(features)
        if not is_lazy_source(labels):
            labels = np.asarray(labels)
        n = len(features)
        parts = max(1, num_partitions or min(sc.defaultParallelism, n))
        base, rem = divmod(n, parts)
        out, start = [], 0
        for i in range(parts):
            size = base + (1 if i < rem else 0)
            out.append(LazyRows(features, labels, start, start + size))
            start += size
        return Rdd(out)
    pairs = list(zip(np.asarray(features), np.asarray(labels)))
    return sc.parallelize(pairs, numSlices=num_partitions)


def to_labeled_point(sc, features, labels, categorical: bool = False) -> Rdd:
    """An RDD of :class:`LabeledPoint` from numpy arrays."""
    points = [LabeledPoint(int(np.argmax(y)) if categorical else y, np.ravel(x))
              for x, y in zip(np.asarray(features), np.asarray(labels))]
    return sc.parallelize(points)


def from_labeled_point(rdd: Rdd, categorical: bool = False, nb_classes: int | None = None):
    """An RDD of LabeledPoints back into ``(features, labels)`` arrays."""
    points = rdd.collect()
    features = np.stack([p.features.toArray() for p in points]).astype(np.float32)
    if categorical:
        labels = encode_labels([p.label for p in points], nb_classes)
    else:
        labels = np.array([p.label for p in points], dtype=np.float32)
    return features, labels


def lp_to_simple_rdd(lp_rdd: Rdd, categorical: bool = False,
                     nb_classes: int | None = None) -> Rdd:
    """RDD[LabeledPoint] → a simple RDD of ``(x_row, y_row)`` pairs."""
    if categorical and nb_classes is None:
        nb_classes = int(max(p.label for p in lp_rdd.collect())) + 1

    def convert(p: LabeledPoint):
        x = p.features.toArray().astype(np.float32)
        y = encode_label(p.label, nb_classes) if categorical else np.float32(p.label)
        return (x, y)

    return lp_rdd.map(convert)


def partition_arrays(rdd: Rdd) -> list[tuple[np.ndarray, np.ndarray]]:
    """Stack each partition of a simple RDD into ``(x[P,...], y[P,...])``;
    a :class:`LazyRows` partition with one ranged read of each source.

    Empty partitions are dropped: a zero-row partition carries no
    information."""
    out = []
    for part in rdd.partitions():
        if not part:
            continue
        if isinstance(part, LazyRows):
            xs = np.asarray(part.x[part.lo:part.hi])
            ys = np.asarray(part.y[part.lo:part.hi])
        else:
            xs = np.stack([np.asarray(x) for x, _ in part])
            ys = np.stack([np.asarray(y) for _, y in part])
        out.append((xs, ys))
    if not out:
        raise ValueError("RDD has no data")
    return out
