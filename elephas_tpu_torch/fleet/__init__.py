"""The fleet layer of the port (counterpart of ``elephas_tpu/fleet``).

Only the live-migration wire (:mod:`elephas_tpu_torch.fleet.migration`)
is here so far: the gateway's export and migrate routes speak it. The
router and placement modules come with ROADMAP.md, Queue A item 4b (the
parameter server they publish through is :mod:`elephas_tpu_torch.parameter`).
"""

from elephas_tpu_torch.fleet.migration import (  # noqa: F401
    MAGIC,
    VERSION,
    decode_record,
    encode_record,
)

__all__ = ["MAGIC", "VERSION", "decode_record", "encode_record"]
