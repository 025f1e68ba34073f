"""Continuous-batching inference serving on the port (counterpart of
``elephas_tpu/serving``, fixed-arena slice):

- :mod:`elephas_tpu_torch.serving.kv_cache` — the slot arena of per-layer
  K/V caches with per-slot write cursors, and its prefill and decode
  passes;
- :mod:`elephas_tpu_torch.serving.scheduler` — iteration-level admission
  of queued requests into free slots, immediate reclamation on
  EOS/max-tokens, bucketed prompt padding;
- :mod:`elephas_tpu_torch.serving.engine` — :class:`InferenceEngine`, the
  host-side serving loop (also ``SparkModel.serve()``).
"""

from elephas_tpu_torch.serving.engine import InferenceEngine, RequestCancelled  # noqa: F401

__all__ = ["InferenceEngine", "RequestCancelled"]
