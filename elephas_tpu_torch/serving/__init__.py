"""Continuous-batching inference serving on the port (counterpart of
``elephas_tpu/serving``, single device):

- :mod:`elephas_tpu_torch.serving.kv_cache` — the slot arena of per-layer
  K/V caches with per-slot write cursors, and its prefill, chunk, verify,
  decode and prefix-copy passes;
- :mod:`elephas_tpu_torch.serving.paged_kv` — the paged arena: a block pool
  with per-slot block tables, its chunk, verify and decode passes, and the
  block gather / scatter of preemption;
- :mod:`elephas_tpu_torch.serving.blocks` — the refcounted block allocator;
- :mod:`elephas_tpu_torch.serving.kv_quant` — the int8 / int4 block codec;
- :mod:`elephas_tpu_torch.serving.scheduler` — iteration-level admission
  of queued requests into free slots (and blocks), preemption, immediate
  reclamation on EOS/max-tokens, bucketed prompt padding;
- :mod:`elephas_tpu_torch.serving.prefix_cache` — the deterministic radix
  indexes over cached prompt prefixes: donor slots (fixed arena) or shared
  full blocks (paged);
- :mod:`elephas_tpu_torch.serving.speculative` — speculative decoding's
  drafters (n-gram lookup, a draft model) and the acceptance throttle;
- :mod:`elephas_tpu_torch.serving.policy` — the SLO admission policies
  (FIFO, tenant fair share with deadlines, aging and admission control);
- :mod:`elephas_tpu_torch.serving.engine` — :class:`InferenceEngine`, the
  host-side serving loop (also ``SparkModel.serve()``), with its telemetry
  (:mod:`elephas_tpu_torch.telemetry`: ``scrape``, ``explain``,
  ``debug_snapshot``) and migration records (``export_request`` /
  ``import_request``);
- :mod:`elephas_tpu_torch.serving.gateway` — :class:`Gateway`, the HTTP/SSE
  front door over one engine.
"""

from elephas_tpu_torch.serving.blocks import BlockAllocator  # noqa: F401
from elephas_tpu_torch.serving.engine import InferenceEngine, RequestCancelled  # noqa: F401
from elephas_tpu_torch.serving.gateway import Gateway  # noqa: F401
from elephas_tpu_torch.serving.kv_cache import SlotKVCache  # noqa: F401
from elephas_tpu_torch.serving.paged_kv import (  # noqa: F401
    PagedKVPool,
    blocks_for,
    table_buckets,
)
from elephas_tpu_torch.serving.policy import (  # noqa: F401
    DEFAULT_TENANT,
    AdmissionRejected,
    FairSharePolicy,
    FifoPolicy,
    Policy,
    resolve_policy,
)
from elephas_tpu_torch.serving.prefix_cache import (  # noqa: F401
    BlockEntry,
    CacheEntry,
    PagedPrefixIndex,
    PrefixCache,
)
from elephas_tpu_torch.serving.scheduler import (  # noqa: F401
    Admission,
    Preemption,
    Request,
    Scheduler,
    bucket_for,
    default_buckets,
)
from elephas_tpu_torch.serving.speculative import (  # noqa: F401
    AcceptanceThrottle,
    DraftModelDrafter,
    Drafter,
    NgramDrafter,
)

__all__ = ["DEFAULT_TENANT", "AcceptanceThrottle", "Admission", "AdmissionRejected",
           "BlockAllocator", "BlockEntry", "CacheEntry", "DraftModelDrafter", "Drafter",
           "FairSharePolicy", "FifoPolicy", "Gateway", "InferenceEngine", "NgramDrafter", "PagedKVPool",
           "PagedPrefixIndex", "Policy", "Preemption", "PrefixCache", "Request",
           "RequestCancelled", "Scheduler", "SlotKVCache", "blocks_for", "bucket_for",
           "default_buckets", "resolve_policy", "table_buckets"]
