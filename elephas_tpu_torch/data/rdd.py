"""Rdd — a host-local, partitioned dataset with the Spark RDD surface
(copy of ``elephas_tpu/data/rdd.py``, cut to what ``SparkModel`` and its
callers read: ``map``, ``repartition``/``coalesce``, ``collect``,
``count``; the lazy row-range partitions of the streaming path are not
ported).

A partition is a list of elements held on the host; ``SparkModel`` stacks
partitions into arrays and places them on its device.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator


class Rdd:
    def __init__(self, partitions: list):
        self._partitions = [list(p) for p in partitions]

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

    def partitions(self) -> list[list[Any]]:
        """Direct partition access (not in Spark's API; used internally)."""
        return self._partitions

    def map(self, f: Callable[[Any], Any]) -> "Rdd":
        return Rdd([[f(el) for el in p] for p in self._partitions])

    def collect(self) -> list[Any]:
        return list(self._iter_all())

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def _iter_all(self) -> Iterator[Any]:
        return itertools.chain.from_iterable(self._partitions)
