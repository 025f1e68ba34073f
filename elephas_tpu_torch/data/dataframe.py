"""``Row``, ``DataFrame`` and ``SparkSession``: the ``pyspark.sql``
stand-ins the ML layer reads (copy of ``elephas_tpu/data/dataframe.py``).

A column store of equal-length Python lists with ``select``,
``withColumn``, ``drop``, ``withColumnRenamed``, ``randomSplit``
(numpy's ``default_rng(seed)`` permutation, the reference's split),
``collect`` (Rows), ``take``, ``first``, ``rdd`` and ``count``. No
training math happens here: the ML layer turns columns into arrays
(:func:`vectorize_column`) for ``SparkModel``.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from elephas_tpu_torch.data.linalg import DenseVector
from elephas_tpu_torch.data.rdd import Rdd


class Row:
    """A record addressable by attribute, key and position."""

    def __init__(self, **fields):
        self.__dict__["_fields"] = dict(fields)

    def __getattr__(self, name):
        try:
            return self._fields[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, key):
        if isinstance(key, int):
            return list(self._fields.values())[key]
        return self._fields[key]

    def asDict(self) -> dict:
        return dict(self._fields)

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self._fields.items())
        return f"Row({inner})"

    def __eq__(self, other):
        # fields hold numpy arrays (features columns): compare each
        if not isinstance(other, Row):
            return NotImplemented
        a, b = self._fields, other._fields
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    def __hash__(self):
        def canon(v):
            if isinstance(v, np.ndarray):
                return (v.shape, v.tobytes())
            if isinstance(v, (list, tuple)):
                return tuple(canon(el) for el in v)
            return v

        return hash(tuple((k, canon(v)) for k, v in self._fields.items()))


class DataFrame:
    """Column store of equal-length Python lists."""

    def __init__(self, data: dict[str, list[Any]]):
        lengths = {len(v) for v in data.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in data.items()} }")
        self._data = {k: list(v) for k, v in data.items()}

    @property
    def columns(self) -> list[str]:
        return list(self._data)

    def count(self) -> int:
        return len(next(iter(self._data.values()), []))

    def select(self, *cols: str) -> "DataFrame":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        missing = [c for c in cols if c not in self._data]
        if missing:
            raise KeyError(f"no such column(s): {missing}; have {self.columns}")
        return DataFrame({c: self._data[c] for c in cols})

    def withColumn(self, name: str, values: Iterable[Any]) -> "DataFrame":
        values = list(values)
        if self._data and len(values) != self.count():
            raise ValueError(f"withColumn {name!r}: {len(values)} values for {self.count()} rows")
        return DataFrame({**self._data, name: values})

    def drop(self, *cols: str) -> "DataFrame":
        return DataFrame({k: v for k, v in self._data.items() if k not in cols})

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        return DataFrame({(new if k == old else k): v for k, v in self._data.items()})

    def randomSplit(self, weights: list[float], seed: int = 0) -> list["DataFrame"]:
        n = self.count()
        perm = np.random.default_rng(seed).permutation(n)
        total = sum(weights)
        bounds = np.cumsum([int(round(w / total * n)) for w in weights])[:-1]
        return [DataFrame({k: [v[i] for i in idx] for k, v in self._data.items()})
                for idx in np.split(perm, bounds)]

    def collect(self) -> list[Row]:
        return self.take(self.count())

    def take(self, n: int) -> list[Row]:
        cols = self.columns
        return [Row(**{c: self._data[c][i] for c in cols}) for i in range(min(n, self.count()))]

    def first(self) -> Row:
        rows = self.take(1)
        if not rows:
            raise ValueError("first() on empty DataFrame")
        return rows[0]

    @property
    def rdd(self) -> Rdd:
        return Rdd([self.collect()])

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def column_values(self, name: str) -> list[Any]:
        return self._data[name]


class SparkSession:
    """Builds DataFrames from rows or columns."""

    def __init__(self, spark_context=None):
        from elephas_tpu_torch.data.context import SparkContext

        self.sparkContext = spark_context or SparkContext()

    class _Builder:
        def getOrCreate(self) -> "SparkSession":
            return SparkSession()

        def appName(self, _name: str) -> "SparkSession._Builder":
            return self

        def master(self, _master: str) -> "SparkSession._Builder":
            return self

    builder = _Builder()

    def createDataFrame(self, data, schema: list[str] | None = None) -> DataFrame:
        """From a dict of columns, a list (or Rdd) of Rows, or of tuples
        with ``schema`` naming the columns."""
        if isinstance(data, dict):
            return DataFrame(data)
        if isinstance(data, Rdd):
            data = data.collect()
        data = list(data)
        if not data:
            raise ValueError("cannot create DataFrame from empty data")
        if isinstance(data[0], Row):
            return DataFrame({c: [r[c] for r in data] for c in data[0].asDict()})
        if schema is None:
            raise ValueError("schema (column names) required for tuple rows")
        return DataFrame({name: [row[i] for row in data] for i, name in enumerate(schema)})


def vectorize_column(values: list[Any]) -> np.ndarray:
    """A features column (DenseVectors, arrays or scalars) → a 2-D float32
    array."""
    rows = [v.toArray() if isinstance(v, DenseVector)
            else np.ravel(np.asarray(v, dtype=np.float32)) for v in values]
    return np.stack(rows).astype(np.float32)
