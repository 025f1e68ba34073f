"""Rdd — a host-local, partitioned dataset with the Spark RDD surface
(copy of ``elephas_tpu/data/rdd.py``).

A partition is a list of elements held on the host; ``SparkModel`` stacks
partitions into arrays and places them on its device. Transformations are
eager, with one exception: a :class:`LazyRows` partition is a contiguous
row range of sliceable ``(x, y)`` sources (a memmap, an h5py dataset),
which ``SparkModel.fit`` streams block by block
(:mod:`elephas_tpu_torch.data.streaming`); an eager transformation
(``map``, ``collect``, ``repartition``) reads it row by row.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator

import numpy as np


class LazyRows:
    """A partition holding rows ``[lo, hi)`` of row-aligned ``(x, y)``
    sources, read only when iterated."""

    __slots__ = ("x", "y", "lo", "hi")

    def __init__(self, x, y, lo: int, hi: int):
        if not 0 <= lo <= hi:
            raise ValueError(f"bad row range [{lo}, {hi})")
        self.x, self.y, self.lo, self.hi = x, y, lo, hi

    def __len__(self) -> int:
        return self.hi - self.lo

    def __iter__(self):
        for i in range(self.lo, self.hi):
            yield (np.asarray(self.x[i]), np.asarray(self.y[i]))

    def __bool__(self) -> bool:
        return len(self) > 0


class Rdd:
    def __init__(self, partitions: list):
        self._partitions = [p if isinstance(p, LazyRows) else list(p) for p in partitions]

    def is_lazy(self) -> bool:
        """True when every partition is a lazy row range."""
        return bool(self._partitions) and all(isinstance(p, LazyRows) for p in self._partitions)

    def getNumPartitions(self) -> int:
        return len(self._partitions)

    def repartition(self, num_partitions: int) -> "Rdd":
        """Round-robin redistribute elements into ``num_partitions``."""
        if num_partitions <= 0:
            raise ValueError("num_partitions must be positive")
        parts: list[list[Any]] = [[] for _ in range(num_partitions)]
        for i, el in enumerate(self._iter_all()):
            parts[i % num_partitions].append(el)
        return Rdd(parts)

    coalesce = repartition

    def partitions(self) -> list:
        """Direct partition access (not in Spark's API; used internally)."""
        return self._partitions

    def map(self, f: Callable[[Any], Any]) -> "Rdd":
        return Rdd([[f(el) for el in p] for p in self._partitions])

    def filter(self, f: Callable[[Any], bool]) -> "Rdd":
        return Rdd([[el for el in p if f(el)] for p in self._partitions])

    def mapPartitions(self, f: Callable[[Iterator[Any]], Iterable[Any]]) -> "Rdd":
        return Rdd([list(f(iter(p))) for p in self._partitions])

    def zip(self, other: "Rdd") -> "Rdd":
        if self.getNumPartitions() != other.getNumPartitions():
            raise ValueError("zip: partition counts differ")
        return Rdd([list(zip(a, b, strict=True))
                    for a, b in zip(self._partitions, other._partitions)])

    def collect(self) -> list[Any]:
        return list(self._iter_all())

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def first(self) -> Any:
        for el in self._iter_all():
            return el
        raise ValueError("first() on empty RDD")

    def take(self, n: int) -> list[Any]:
        return list(itertools.islice(self._iter_all(), n))

    # persistence is a no-op: the data is already on the host
    def cache(self) -> "Rdd":
        return self

    persist = cache

    def unpersist(self) -> "Rdd":
        return self

    def _iter_all(self) -> Iterator[Any]:
        return itertools.chain.from_iterable(self._partitions)
