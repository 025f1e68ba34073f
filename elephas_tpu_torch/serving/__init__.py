"""Continuous-batching inference serving on the port (counterpart of
``elephas_tpu/serving``, fixed-arena slice):

- :mod:`elephas_tpu_torch.serving.kv_cache` — the slot arena of per-layer
  K/V caches with per-slot write cursors, and its prefill, chunk, verify,
  decode and prefix-copy passes;
- :mod:`elephas_tpu_torch.serving.scheduler` — iteration-level admission
  of queued requests into free slots, immediate reclamation on
  EOS/max-tokens, bucketed prompt padding;
- :mod:`elephas_tpu_torch.serving.prefix_cache` — the deterministic radix
  index over cached prompt prefixes: finished requests' prompt K/V stays
  resident as donor slots, evicted LRU;
- :mod:`elephas_tpu_torch.serving.engine` — :class:`InferenceEngine`, the
  host-side serving loop (also ``SparkModel.serve()``).
"""

from elephas_tpu_torch.serving.engine import InferenceEngine, RequestCancelled  # noqa: F401
from elephas_tpu_torch.serving.kv_cache import SlotKVCache  # noqa: F401
from elephas_tpu_torch.serving.prefix_cache import CacheEntry, PrefixCache  # noqa: F401
from elephas_tpu_torch.serving.scheduler import (  # noqa: F401
    Admission,
    Request,
    Scheduler,
    bucket_for,
    default_buckets,
)

__all__ = ["Admission", "CacheEntry", "InferenceEngine", "PrefixCache", "Request",
           "RequestCancelled", "Scheduler", "SlotKVCache", "bucket_for", "default_buckets"]
