"""Sharded parameter-server topology.

The single PS is the scale ceiling and the single point of failure for
asynchronous training: every worker syncs the full weight list through
one process, and one kill stalls all of them (classic PS designs shard
the key space and replicate for availability — Li et al., OSDI'14;
Project Adam, OSDI'14). This module holds the *pure* topology pieces:

- :class:`ShardMap` — a **deterministic** assignment of weight tensors
  to ``num_shards`` parameter-server endpoints, computed from nothing
  but the tensors' (dtype, shape) template. Client and servers each
  derive the map independently from the same template and MUST agree;
  :meth:`ShardMap.signature` is the cheap cross-check (the sharded
  client refuses a server whose ``status`` reports a different shard
  identity — see the validation satellite).
- :func:`shard_journal_dir` — per-shard journal placement
  (``journal_dir/shard-<i>/``), so a killed shard recovers by
  replaying only its own slice.
- :class:`ShardedServerGroup` — N ordinary (journaled, restartable)
  servers, each holding only its slice of the weight list, plus
  whole-list ``set_weights``/``get_parameters`` for the driver.

Assignment algorithm (the determinism contract, documented in
``docs/API.md``): tensors are taken **largest-bytes-first** (ties by
ascending tensor index) and each is placed on the currently
least-loaded shard (ties by ascending shard index) — greedy balanced
bin-packing, a pure function of the template and ``num_shards``. Every
shard is guaranteed at least one tensor when ``num_shards <=
len(weights)``; more shards than tensors is refused loudly (an empty
shard would serve an empty weight list and mask mis-wiring).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = [
    "ShardMap",
    "ShardedServerGroup",
    "shard_endpoints",
    "shard_journal_dir",
]


def shard_journal_dir(journal_dir: str, shard_id: int) -> str:
    """Shard ``shard_id``'s journal directory under ``journal_dir`` —
    each shard journals (and recovers) independently, so a kill costs
    one slice's replay, not the whole model's."""
    return os.path.join(journal_dir, f"shard-{int(shard_id)}")


def shard_endpoints(master: str) -> list[str]:
    """Split a comma-separated ``host:port[,host:port...]`` endpoint
    list, validating loudly (the validation satellite): empty entries
    and duplicate endpoints are configuration bugs that would silently
    cross-wire shards, not conditions to limp through."""
    endpoints = [e.strip() for e in str(master).split(",")]
    if not endpoints or any(not e for e in endpoints):
        raise ValueError(
            f"sharded endpoint list {master!r} contains an empty entry"
        )
    seen = set()
    for e in endpoints:
        if e in seen:
            raise ValueError(
                f"duplicate endpoint {e!r} in sharded endpoint list "
                f"{master!r} — two shard slots on one server would "
                f"cross-wire the shard map"
            )
        seen.add(e)
    return endpoints


class ShardMap:
    """Deterministic tensor→shard assignment for one weight template.

    Built from ``[(dtype_name, shape), ...]`` (or directly from a
    weight list via :meth:`from_weights`); see the module docstring for
    the assignment algorithm. The map is the single source of truth
    for scatter (split a full list into per-shard slices) and gather
    (reassemble per-shard slices into the full list).
    """

    def __init__(self, template: list[tuple[str, tuple]], num_shards: int):
        num_shards = int(num_shards)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if not template:
            raise ValueError("cannot shard an empty weight list")
        if num_shards > len(template):
            raise ValueError(
                f"num_shards={num_shards} exceeds the {len(template)} "
                f"weight tensors — an empty shard would serve an empty "
                f"weight list and mask mis-wiring; use fewer shards"
            )
        self.template = [
            (str(dt), tuple(int(d) for d in shape)) for dt, shape in template
        ]
        self.num_shards = num_shards

        def nbytes(entry):
            dt, shape = entry
            return int(np.dtype(dt).itemsize) * int(np.prod(shape, dtype=np.int64))

        # largest-bytes-first, ties by index; place on the least-loaded
        # shard, ties by shard index — pure function of the template
        order = sorted(
            range(len(self.template)),
            key=lambda i: (-nbytes(self.template[i]), i),
        )
        loads = [0] * num_shards
        assign = [0] * len(self.template)
        for i in order:
            s = min(range(num_shards), key=lambda j: (loads[j], j))
            assign[i] = s
            loads[s] += nbytes(self.template[i])
        self._assign = assign
        self.shard_bytes = loads
        # per-shard tensor indices in ASCENDING template order — the
        # slice order every scatter/gather and every shard server uses
        self._indices = [
            [i for i, s in enumerate(assign) if s == shard]
            for shard in range(num_shards)
        ]

    @classmethod
    def from_weights(cls, weights, num_shards: int) -> "ShardMap":
        return cls(
            [(np.asarray(w).dtype.name, np.shape(w)) for w in weights],
            num_shards,
        )

    def shard_of(self, tensor_index: int) -> int:
        return self._assign[tensor_index]

    def indices_of(self, shard: int) -> list[int]:
        """Template indices owned by ``shard``, ascending."""
        return list(self._indices[shard])

    def signature(self) -> str:
        """Short stable digest of (template, num_shards, assignment) —
        two parties that agree on the signature agree on every slice
        boundary."""
        h = hashlib.sha256()
        h.update(str(self.num_shards).encode())
        for (dt, shape), s in zip(self.template, self._assign):
            h.update(f"{dt}:{shape}:{s};".encode())
        return h.hexdigest()[:16]

    # -- scatter / gather ---------------------------------------------

    def scatter(self, full: list) -> list[list]:
        """Split a full weight/delta list into per-shard slices."""
        if len(full) != len(self.template):
            raise ValueError(
                f"shard map covers {len(self.template)} tensors, got a "
                f"list of {len(full)}"
            )
        return [[full[i] for i in idx] for idx in self._indices]

    def gather(self, slices: list[list]) -> list:
        """Reassemble per-shard slices into the full list."""
        if len(slices) != self.num_shards:
            raise ValueError(
                f"expected {self.num_shards} shard slices, got {len(slices)}"
            )
        full = [None] * len(self.template)
        for shard, (idx, part) in enumerate(zip(self._indices, slices)):
            if len(part) != len(idx):
                raise ValueError(
                    f"shard {shard} returned {len(part)} tensors, the "
                    f"shard map assigns it {len(idx)} — topology mismatch "
                    f"(server restarted with a different model or shard "
                    f"count?)"
                )
            for i, t in zip(idx, part):
                full[i] = t
        return full


class ShardedServerGroup:
    """N per-shard parameter servers behind one façade.

    Each shard is an ordinary (journaled, restartable) server from
    :mod:`elephas_tpu_torch.parameter.server`, constructed over ONLY its
    slice of the weight list, with its own journal directory
    (``journal_dir/shard-<i>/``) and its shard identity stamped for
    the status/validation surface. The group is what
    ``SparkModel(ps_shards=N)`` hosts; workers reach it through a
    :class:`~elephas_tpu_torch.parameter.client.ShardedClient` over
    ``endpoints``.
    """

    def __init__(
        self,
        server_cls,
        weights,
        num_shards: int,
        mode: str = "asynchronous",
        ports=None,
        journal_dir: str | None = None,
        host: str = "127.0.0.1",
        **ft_kwargs,
    ):
        self.shard_map = ShardMap.from_weights(weights, num_shards)
        self.host = host
        if ports is None:
            ports = [0] * num_shards
        if len(ports) != num_shards:
            raise ValueError(
                f"got {len(ports)} ports for {num_shards} shards"
            )
        slices = self.shard_map.scatter(
            [np.asarray(w) for w in weights]
        )
        self.servers = []
        for i, (part, port) in enumerate(zip(slices, ports)):
            kwargs = dict(ft_kwargs)
            if journal_dir:
                kwargs["journal_dir"] = shard_journal_dir(journal_dir, i)
            self.servers.append(
                server_cls(
                    part, mode=mode, port=port,
                    shard_id=i, num_shards=num_shards,
                    shard_signature=self.shard_map.signature(),
                    **kwargs,
                )
            )

    @property
    def num_shards(self) -> int:
        return self.shard_map.num_shards

    @property
    def ports(self) -> list[int]:
        return [s.port for s in self.servers]

    @property
    def endpoints(self) -> str:
        """Comma-separated endpoint list in shard order — the wire
        address a :class:`ShardedClient` (or a worker's ``master=``)
        takes."""
        return ",".join(f"{self.host}:{p}" for p in self.ports)

    def start(self) -> None:
        for s in self.servers:
            s.start()

    def stop(self, flush_journal: bool = True) -> None:
        for s in self.servers:
            s.stop(flush_journal=flush_journal)

    def set_weights(self, weights, weight_version: int | None = None) -> None:
        for server, part in zip(
            self.servers, self.shard_map.scatter(list(weights))
        ):
            server.set_weights(part, weight_version=weight_version)

    def get_parameters(self) -> list[np.ndarray]:
        return self.shard_map.gather(
            [s.get_parameters() for s in self.servers]
        )

    def status(self) -> list[dict]:
        return [s.status() for s in self.servers]

    def scrape_all(self) -> dict[int, str]:
        """Per-shard Prometheus exposition text keyed by shard id
       : each shard's OWN ``server=``-labeled
        series via :meth:`~elephas_tpu_torch.parameter.server.\
BaseParameterServer.scrape` — the ready-made target map for a
        :class:`~elephas_tpu_torch.telemetry.aggregate.FleetScraper`
        (``{f"shard-{i}": group.servers[i].scrape for i in ...}``)
        and the quick operator answer to "which shard is behind"."""
        return {i: s.scrape() for i, s in enumerate(self.servers)}

    @property
    def updates_applied(self) -> int:
        return sum(s.updates_applied for s in self.servers)

    @property
    def updates_duplicate(self) -> int:
        return sum(s.updates_duplicate for s in self.servers)
