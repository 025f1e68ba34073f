"""Host-side data layer of the port: the Spark stand-ins that
:func:`elephas_tpu_torch.utils.rdd_utils.to_simple_rdd`,
:class:`elephas_tpu_torch.SparkModel` and the ML layer read (copies of
``elephas_tpu/data/``): ``SparkContext`` and its ``Broadcast``, ``Rdd`` with its
lazy row-range partitions (``LazyRows``), which ``SparkModel.fit``
streams (:mod:`elephas_tpu_torch.data.streaming`), the MLlib linalg types
and the DataFrame (:mod:`elephas_tpu_torch.data.dataframe`).
"""

from elephas_tpu_torch.data.context import Broadcast, SparkContext  # noqa: F401
from elephas_tpu_torch.data.linalg import (  # noqa: F401
    DenseMatrix,
    DenseVector,
    LabeledPoint,
    Vectors,
)
from elephas_tpu_torch.data.rdd import LazyRows, Rdd  # noqa: F401
