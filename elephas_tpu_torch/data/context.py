"""SparkContext stand-in (copy of ``elephas_tpu/data/context.py``).

The context only creates partitioned host datasets
(:class:`~elephas_tpu_torch.data.rdd.Rdd`); placing them on the device is
the runner's job.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.device import num_available_workers


class SparkContext:
    """Local stand-in for ``pyspark.SparkContext``.

    ``master='local[N]'`` sets the default parallelism N; ``local[*]``
    uses the port's worker slots (at least one): the CUDA devices, or
    what :func:`~elephas_tpu_torch.device.force_devices` offers."""

    def __init__(self, master: str = "local[*]", appName: str = "elephas_tpu_torch"):
        self.master = master
        self.appName = appName
        self._default_parallelism = self._parse_master(master)

    @staticmethod
    def _parse_master(master: str) -> int:
        m = re.fullmatch(r"local\[(\*|\d+)\]", master)
        if m is None:
            if master == "local":
                return 1
            raise ValueError(
                f"unsupported master {master!r}; this shim is local-only"
            )
        if m.group(1) == "*":
            return max(1, num_available_workers("cuda"))
        return max(1, int(m.group(1)))

    @property
    def defaultParallelism(self) -> int:
        return self._default_parallelism

    def parallelize(self, data: Iterable[Any], numSlices: int | None = None) -> Rdd:
        elements = list(data)
        n = numSlices or min(self._default_parallelism, max(1, len(elements)))
        n = max(1, n)
        # contiguous split (Spark semantics), sizes differing by at most 1
        base, rem = divmod(len(elements), n)
        parts, start = [], 0
        for i in range(n):
            size = base + (1 if i < rem else 0)
            parts.append(elements[start : start + size])
            start += size
        return Rdd(parts)
