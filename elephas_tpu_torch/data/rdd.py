"""Rdd — a host-local, partitioned dataset with the Spark RDD surface
(copy of ``elephas_tpu/data/rdd.py``, cut to what ``SparkModel`` reads;
the lazy row-range partitions, transformations and actions are not
ported).

A partition is a list of elements held on the host; ``SparkModel`` stacks
partitions into arrays and places them on its device.
"""

from __future__ import annotations

from typing import Any


class Rdd:
    def __init__(self, partitions: list):
        self._partitions = [list(p) for p in partitions]

    def getNumPartitions(self) -> int:
        return len(self._partitions)

    def partitions(self) -> list[list[Any]]:
        """Direct partition access (not in Spark's API; used internally)."""
        return self._partitions
