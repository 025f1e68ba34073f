"""Parameter server & client: the port's own copy of
``elephas_tpu.parameter`` (the upstream ``[U] elephas/parameter/``).
Numpy and the stdlib only: the wire bytes, the journal files and the
protocol are the reference's, byte for byte, so clients, servers and
journals of the two packages mix freely.

In upstream elephas these carry the entire asynchronous training protocol:
workers pull weights and push deltas over Flask HTTP or raw TCP, full
model bytes pickled per round-trip — the main scalability cliff of the
design (SURVEY.md §3.2).

In the port, as in the reference's TPU rebuild, the training hot path
stays on the device (:class:`~elephas_tpu_torch.worker.Runner`); these
classes serve (a) API parity, (b) a coordinator-hosted weight store over DCN
for external pollers / cross-job consumers, and (c) faithful unit-testable
semantics of the async/hogwild locking difference.

A binary codec replaces the pickled wire format
(:mod:`elephas_tpu_torch.parameter.codec` — dtype-preserving frames, optional
int8 quantization with error-feedback residuals, optional top-k delta
sparsification) negotiated per connection, with pickle kept as the
legacy fallback.

The servers are journaled and restartable and the apply path
idempotent via client-assigned sequence IDs
(:mod:`elephas_tpu_torch.parameter.journal`; protocol version 2 adds the
sequenced-update, heartbeat, and status ops), turning the clients'
at-least-once retries into effectively-once delivery.

Sharding splits the key space: :mod:`elephas_tpu_torch.parameter.sharding`
maps weight tensors deterministically onto N PS endpoints
(:class:`ShardMap`, :class:`ShardedServerGroup` with per-shard
journals), and :class:`ShardedClient` scatter/gathers pushes and pulls
across them with per-shard sequence IDs and partial-failure isolation
— one dead shard pauses only its slice.
"""

from elephas_tpu_torch.parameter.server import (  # noqa: F401
    BaseParameterServer,
    HttpServer,
    SocketServer,
)
from elephas_tpu_torch.parameter.client import (  # noqa: F401
    BaseParameterClient,
    HttpClient,
    ShardedClient,
    SocketClient,
)
from elephas_tpu_torch.parameter.sharding import (  # noqa: F401
    ShardMap,
    ShardedServerGroup,
    shard_endpoints,
    shard_journal_dir,
)
from elephas_tpu_torch.parameter.codec import (  # noqa: F401
    ErrorFeedback,
    WireCodec,
)
from elephas_tpu_torch.parameter.journal import (  # noqa: F401
    clean_orphaned_tmp,
    load_journal,
    save_journal,
)
