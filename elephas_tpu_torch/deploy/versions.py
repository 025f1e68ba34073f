"""Monotonic weight-generation ledger over the PS store (counterpart of
``elephas_tpu/deploy/versions.py``: the same generations, status and
journal bytes on the port's stores).

A "deployment" needs a name for *which* weights a replica serves;
raw weight lists have none. The :class:`VersionLedger` mints one — a
monotonically increasing integer generation — per publication, and
stamps it into the store so every downstream surface (PS ``status``,
the journal, the serving engines' ``stats()``/scrapes/traces, the
migration wire) can tell generations apart.

Two invariants carry the whole subsystem:

1. **Monotonic, even through rollback.** ``rollback(to_version)``
   re-publishes generation ``to_version``'s *content* under a NEW
   generation number. A ledger that moved backwards would break the
   subscriber's idempotence rule ("apply iff remote > applied") and
   reopen the double-apply window the rule exists to close.
2. **The journal knows its generation.** Every publication snapshots
   each shard's journal with ``weight_version`` in the meta, so a
   shard killed mid-deployment restores straight into the generation
   it last served — the chaos-convergence story rides on this.

The ledger is a host-side supervisor object (it lives wherever the
training driver or rollout controller lives), duck-typed over either
one :class:`~elephas_tpu_torch.parameter.server.BaseParameterServer` or a
:class:`~elephas_tpu_torch.parameter.sharding.ShardedServerGroup` — both
expose ``set_weights(weights, weight_version=)``, ``get_parameters``,
``status`` and (per shard) ``write_journal``.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict

import numpy as np

from elephas_tpu_torch import telemetry

__all__ = ["VersionLedger"]

logger = logging.getLogger(__name__)


def _store_servers(store) -> list:
    """The store's per-shard servers (``[store]`` for a single PS) —
    the unit journaling and status both run at."""
    servers = getattr(store, "servers", None)
    return list(servers) if servers is not None else [store]


def _store_versions(store) -> list[int]:
    """Every shard's self-reported generation, in shard order."""
    status = store.status()
    if isinstance(status, dict):
        status = [status]
    return [int(st.get("weight_version", 0)) for st in status]


class VersionLedger:
    """Mint, publish, and roll back weight generations on a PS store.

    ``keep_generations`` bounds the host-memory history of published
    weight lists (rollback targets); publishing beyond the bound drops
    the oldest. On construction the ledger RESUMES from the store's
    maximum self-reported generation — a supervisor restarted over a
    journal-restored store must keep minting above what the fleet has
    already seen, never re-issue a used number.
    """

    def __init__(self, store, keep_generations: int = 4):
        if keep_generations < 1:
            raise ValueError(
                f"keep_generations must be >= 1, got {keep_generations}"
            )
        self.store = store
        self.keep_generations = int(keep_generations)
        self._lock = threading.Lock()
        # resume above anything any shard has served (shards can
        # disagree transiently after a torn deployment — the NEXT
        # publication re-converges them, so take the max)
        versions = _store_versions(store)
        self._version = max(versions, default=0)
        if len(set(versions)) > 1:
            logger.warning(
                "ledger resumed over a store with MIXED generations "
                "%s — the next publication re-converges all shards",
                versions,
            )
        # rollback targets: generation -> full weight list. Seed with
        # the store's current content so the pre-publication
        # generation stays reachable.
        self._history: OrderedDict[int, list[np.ndarray]] = OrderedDict()
        self._history[self._version] = [
            np.asarray(w) for w in store.get_parameters()
        ]

        # telemetry captured at construction (standing null contract);
        # counters are report-only — minting runs on self._version,
        # plain host state under the lock
        reg = telemetry.registry()
        self._tracer = telemetry.tracer()
        label = telemetry.instance_label()
        self.telemetry_label = label
        self._m_publications = reg.counter(
            "elephas_deploy_publications_total",
            "Weight generations published through the ledger",
            labels=("deploy",),
        ).labels(deploy=label)
        self._m_rollbacks = reg.counter(
            "elephas_deploy_rollbacks_total",
            "Generations re-published from an earlier generation's "
            "content (ledger rollback — the number still moves "
            "forward)",
            labels=("deploy",),
        ).labels(deploy=label)
        self._g_version = reg.gauge(
            "elephas_deploy_ledger_version",
            "Latest generation the ledger has minted",
            labels=("deploy",),
        ).labels(deploy=label)
        self._g_version.set(self._version)

    @property
    def version(self) -> int:
        """Latest minted generation (0 = nothing published yet)."""
        return self._version

    def known_versions(self) -> list[int]:
        """Generations whose content is still held for rollback."""
        with self._lock:
            return sorted(self._history)

    def weights_of(self, version: int) -> list[np.ndarray]:
        """The full weight list published as ``version`` (copies)."""
        with self._lock:
            if version not in self._history:
                raise KeyError(
                    f"generation {version} is not in the ledger's "
                    f"history (have {sorted(self._history)}; "
                    f"keep_generations={self.keep_generations})"
                )
            return [w.copy() for w in self._history[version]]

    # -- publication ---------------------------------------------------

    def _publish_locked(self, weights: list[np.ndarray]) -> int:
        """Mint + scatter + journal one generation. Caller holds
        ``self._lock``."""
        version = self._version + 1
        self.store.set_weights(weights, weight_version=version)
        # journal NOW, not at the store's update cadence: the whole
        # point of stamping is that a shard killed right after this
        # line restores into generation `version`, not N-1
        for server in _store_servers(self.store):
            server.write_journal()
        self._version = version
        self._history[version] = weights
        while len(self._history) > self.keep_generations:
            self._history.popitem(last=False)
        return version

    def publish(self, weights) -> int:
        """Publish ``weights`` as the next generation: stamp every
        shard, snapshot every journal, record the content for
        rollback. Returns the minted generation."""
        weights = [np.asarray(w) for w in weights]
        with self._lock:
            version = self._publish_locked(weights)
        self._m_publications.inc()
        self._g_version.set(version)
        self._tracer.emit(
            "deploy.publish", deploy=self.telemetry_label,
            weight_version=version,
        )
        logger.info("published weight generation %d", version)
        return version

    def rollback(self, to_version: int) -> int:
        """Re-publish generation ``to_version``'s content as a NEW
        generation (monotonic — see the module docstring). Returns the
        new generation number."""
        with self._lock:
            if to_version not in self._history:
                raise KeyError(
                    f"cannot roll back to generation {to_version}: "
                    f"not in the ledger's history "
                    f"(have {sorted(self._history)})"
                )
            weights = [w.copy() for w in self._history[to_version]]
            version = self._publish_locked(weights)
        self._m_rollbacks.inc()
        self._g_version.set(version)
        self._tracer.emit(
            "deploy.rollback", deploy=self.telemetry_label,
            weight_version=version, content_of=to_version,
        )
        logger.warning(
            "rolled back: generation %d re-serves generation %d's "
            "content", version, to_version,
        )
        return version

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        """Ledger + store view: the minted generation, each shard's
        self-reported one, and whether the store has converged."""
        shard_versions = _store_versions(self.store)
        return {
            "version": self._version,
            "shard_versions": shard_versions,
            "converged": len(set(shard_versions)) == 1,
            "history": sorted(self._history),
        }

    def release_telemetry(self) -> None:
        """Retire this ledger's labeled series (explicit-only, the
        standing retirement contract)."""
        telemetry.remove_series(deploy=self.telemetry_label)
