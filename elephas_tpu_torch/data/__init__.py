"""Host-side data layer of the port: the Spark stand-ins that
:func:`elephas_tpu_torch.utils.rdd_utils.to_simple_rdd` and
:class:`elephas_tpu_torch.SparkModel` read.

Copies of ``elephas_tpu/data/{context,rdd}.py``, cut to what the training
slice needs: ``SparkContext.parallelize`` and an eager ``Rdd``. Lazy
row-range partitions (the streaming path) are not ported.
"""

from elephas_tpu_torch.data.context import SparkContext  # noqa: F401
from elephas_tpu_torch.data.rdd import Rdd  # noqa: F401
