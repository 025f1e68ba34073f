"""Parallelism layer of the port: the process gang and the device mesh.

Counterpart of ``elephas_tpu/parallel``: :mod:`.distributed` joins the
processes of a gang over ``torch.distributed`` (one rank a card, NCCL on
the cards, gloo on the CPU), and :mod:`.mesh` names an ordered list of
devices by axes, which the sequence-parallel attention of
:mod:`elephas_tpu_torch.ops.ring_attention` and
:mod:`elephas_tpu_torch.ops.ulysses` runs over. The data-parallel workers
themselves are placed by :mod:`elephas_tpu_torch.device`.
"""

from elephas_tpu_torch.device import num_available_workers  # noqa: F401
from elephas_tpu_torch.parallel.mesh import Mesh  # noqa: F401
