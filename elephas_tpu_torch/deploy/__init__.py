"""Continuous weight deployment: train-while-serving (counterpart of
``elephas_tpu/deploy``).

The repo's two mature halves — asynchronous training pushing deltas
into a (sharded, journaled) parameter server, and a paged-KV serving
fleet behind a router — meet here. Three pieces close the loop:

- :mod:`elephas_tpu_torch.deploy.versions` —
  :class:`~elephas_tpu_torch.deploy.versions.VersionLedger`: a monotonic
  weight-generation ledger over the PS store. ``publish(weights)``
  mints generation N+1, stamps it into every shard via
  ``set_weights(weight_version=...)``, and snapshots it into the
  per-shard journals — so a restarted shard resumes KNOWING its
  generation, and ``rollback`` can re-serve an earlier generation's
  content (as a NEW generation: the ledger only moves forward).
- :mod:`elephas_tpu_torch.deploy.subscriber` —
  :class:`~elephas_tpu_torch.deploy.subscriber.WeightSubscriber`: the
  serving-side staleness-bounded puller. Polls the PS ``status``
  surface for a CONSISTENT version cut (every shard reporting the
  same generation), pulls over the existing PS wire (the PS codec,
  int8 pull compression and all), and applies through the engine's
  ``refresh_weights(version=N)`` — which already flushes the prefix
  cache, quarantines straddling prefills, and cascades to draft
  models. Apply is idempotent by version compare: a generation is
  applied at most once, so a mid-deployment shard kill can never
  double-apply.
- :mod:`elephas_tpu_torch.deploy.rollout` —
  :class:`~elephas_tpu_torch.deploy.rollout.CanaryController`: canary
  deployment through the fleet Router. A configurable traffic share
  lands on replicas serving generation N+1 (the router's
  deterministic canary split); the ``slo_burn`` watchdog rule watches
  the FleetScraper view; a clean evaluation window promotes the
  generation fleet-wide, a burn auto-rolls-back to generation N's
  content from the ledger. Windows are EVALUATION counts, never wall
  clock (the standing control-path contract).

Weight generations are stamped end-to-end: PS ``status()`` and
journals, engine ``stats()``/``debug_snapshot()``/flight-recorder
traces, the ``elephas_serving_weight_version`` gauge every scrape and
fleet view carries, the migration wire header (``weight_ver``, v3 —
mismatched non-zero generations refuse loudly) and ``/healthz``.
"""

from elephas_tpu_torch.deploy.rollout import CanaryController  # noqa: F401
from elephas_tpu_torch.deploy.subscriber import WeightSubscriber  # noqa: F401
from elephas_tpu_torch.deploy.versions import VersionLedger  # noqa: F401

__all__ = [
    "VersionLedger",
    "WeightSubscriber",
    "CanaryController",
]
