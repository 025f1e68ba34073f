"""Serving fleet of the port (counterpart of ``elephas_tpu/fleet``):
replicated engines behind a prefix- and load-aware router, with
cross-replica live migration.

- :mod:`elephas_tpu_torch.fleet.placement` — deterministic two-stage
  placement as a PURE function: prefix affinity first (route to the
  replica whose cache already holds the prompt's longest warm prefix,
  above a ``min_affinity_tokens`` floor), load balance the rest by
  blocks-free/queue-depth, round-robin as the counted degraded floor
  when the fleet view goes stale. Same snapshot + same prompt ⇒ same
  replica, on every call, every process and in both packages.
- :mod:`elephas_tpu_torch.fleet.migration` — the cross-replica live-
  migration wire: a request's preemption offload record (K/V block rows
  at the arena's stored dtype, cursor, last token) plus its identity,
  knobs and weight generation, framed as binary + JSON header (no
  pickle). A request preempted on replica A resumes bit-exact at
  temperature 0 on replica B.
- :mod:`elephas_tpu_torch.fleet.router` — :class:`~elephas_tpu_torch.\
fleet.router.Router`: N replicas (each its own driver thread, lock and
  arena) behind one placement brain and an optional asyncio HTTP/1.1 +
  SSE front door. ``drain()`` empties a replica by live-migrating its
  work (zero dropped, zero doubled tokens); ``kill_replica()`` + re-drive
  is the chaos story; the ``replica_down`` watchdog rule fires and clears
  off the router's replica-up gauge; ``set_canary`` splits traffic for a
  canary deployment (:mod:`elephas_tpu_torch.deploy`).
"""

from elephas_tpu_torch.fleet.migration import (  # noqa: F401
    MAGIC,
    VERSION,
    decode_record,
    encode_record,
)
from elephas_tpu_torch.fleet.placement import (  # noqa: F401
    PlacementDecision,
    place,
)
from elephas_tpu_torch.fleet.router import (  # noqa: F401
    Replica,
    Router,
    RouterRequest,
)

__all__ = [
    "PlacementDecision",
    "place",
    "MAGIC",
    "VERSION",
    "encode_record",
    "decode_record",
    "Replica",
    "Router",
    "RouterRequest",
]
