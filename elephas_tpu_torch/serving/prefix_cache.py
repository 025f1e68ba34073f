"""Host-side radix index over cached prompt prefixes (copy of the
fixed-arena half of ``elephas_tpu/serving/prefix_cache.py``).

Once a prompt has been prefilled into a KV slot, its first ``p`` arena rows
are reusable: causal attention makes the K/V of position ``i`` a function
of tokens ``0..i`` only, so any later prompt sharing those tokens can copy
the rows instead of recomputing them. This module finds such donors.

- **Determinism.** No wall clock: recency is a logical clock bumped per
  cache operation, ties break on slot id, so the same submission order
  gives the same schedule.
- **Slots are the unit of residence.** An entry maps one slot to the token
  sequence whose K/V occupies its first ``length`` rows. Each trie node
  holds the slots whose cached sequence passes through it; a lookup walks
  the prompt until the path dies and takes the deepest node with a slot.
- **Pins guard the admission wave.** A donor chosen for one admission is
  pinned so a later admission of the same wave cannot evict (and
  overwrite) it before the engine's copy has read it.
- **LRU eviction under slot pressure.** Donor slots (entries whose request
  finished) are reclaimable: with no free slot the scheduler evicts the
  least recently used unpinned, unleased entry.

The counters are plain integers, read by ``stats()``; each is mirrored
into the port's telemetry registry (the reference's ``elephas_prefix_*``
series, labeled ``cache=<instance>``), report-only: null mode leaves the
counts exact and the series at 0. ``release_telemetry()`` retires the
series.

The paged arena's index (:class:`PagedPrefixIndex`, entries
:class:`BlockEntry`) holds block ids instead of slots: a hit splices the
entry's full blocks into the new request's table by refcount, with no copy.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from elephas_tpu_torch import telemetry


def _cache_series(shared: bool = False) -> tuple[str, dict]:
    """This cache's instance label and its registry counters: hits,
    misses, reused tokens, evictions and (paged) shared blocks."""
    reg = telemetry.registry()
    cid = telemetry.instance_label()

    def c(name, help_):
        return reg.counter(name, help_, labels=("cache",)).labels(cache=cid)

    series = {
        "hits": c("elephas_prefix_cache_hits_total",
                  "Admissions served a donor copy from the prefix cache"),
        "misses": c("elephas_prefix_cache_misses_total",
                    "Admissions that landed cold (no usable cached prefix)"),
        "reused_tokens": c("elephas_prefix_cache_reused_tokens_total",
                           "Prompt tokens served by donor copy instead of prefill"),
        "evictions": c("elephas_prefix_cache_evictions_total",
                       "Donor entries evicted under slot pressure (LRU)"),
    }
    if shared:
        series["shared_blocks"] = c(
            "elephas_prefix_blocks_shared_total",
            "Pool blocks spliced copy-free into admitted requests' "
            "block tables via prefix-index refcount sharing",
        )
    return cid, series


@dataclass
class _Node:
    children: dict = field(default_factory=dict)  # token -> _Node
    slots: set = field(default_factory=set)  # slots covering this node


@dataclass
class CacheEntry:
    """One resident prefix: ``slot``'s first ``length`` arena rows hold the
    K/V of ``tokens``. ``leased`` while the prefilling request still
    occupies the slot; ``pins`` counts admission-wave references that
    block eviction."""

    slot: int
    tokens: tuple
    length: int
    last_use: int
    leased: bool = True
    pins: int = 0


class PrefixCache:
    """Radix index of cached prompt prefixes over KV slots. All methods are
    O(len(tokens)) host work; the scheduler owns one instance when
    ``prefix_cache=True`` and drives it in submission order."""

    def __init__(self):
        self._root = _Node()
        self._entries: dict[int, CacheEntry] = {}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.reused_tokens = 0
        self.evictions = 0
        self.telemetry_label, self._m = _cache_series()

    def release_telemetry(self) -> None:
        """Retire this cache's labeled series from the registry (the
        owning scheduler's and engine's ``release_telemetry`` cascade
        here); the plain counts keep reading."""
        telemetry.remove_series(cache=self.telemetry_label)

    # -- registration ---------------------------------------------------

    def insert(self, slot: int, tokens) -> None:
        """Register ``slot`` as holding the K/V of ``tokens`` (when a
        request's prefill completes). Replaces any previous entry."""
        if slot in self._entries:
            self.remove(slot)
        tokens = tuple(int(t) for t in tokens)
        self._clock += 1
        self._entries[slot] = CacheEntry(
            slot=slot, tokens=tokens, length=len(tokens), last_use=self._clock,
        )
        node = self._root
        for t in tokens:
            node = node.children.setdefault(t, _Node())
            node.slots.add(slot)

    def release(self, slot: int) -> bool:
        """The occupying request finished: the entry survives as an
        evictable donor. Returns True when the slot is retained (the
        scheduler then keeps it off the free list)."""
        entry = self._entries.get(slot)
        if entry is None:
            return False
        entry.leased = False
        return True

    def remove(self, slot: int) -> None:
        """Drop the slot's entry (it is re-leased or evicted: its rows are
        about to be overwritten) and prune the emptied trie nodes."""
        entry = self._entries.pop(slot, None)
        if entry is None:
            return
        node, path = self._root, []
        for t in entry.tokens:
            child = node.children.get(t)
            if child is None:
                break
            path.append((node, t, child))
            child.slots.discard(slot)
            node = child
        for parent, t, child in reversed(path):
            if not child.slots and not child.children:
                del parent.children[t]

    # -- lookup / pinning ----------------------------------------------

    def match(self, prompt, max_reuse: int | None = None):
        """Longest cached prefix of ``prompt`` strictly shorter than the
        prompt (one suffix token must remain: its logits give the first
        sample). Pure: no counter, recency or pin moves, since admission
        probes a blocked queue head every step. Returns ``(slot,
        reuse_len)`` or ``(None, 0)``; among the deepest node's slots the
        most recently used wins, then the lowest slot id."""
        cap = len(prompt) - 1
        if max_reuse is not None:
            cap = min(cap, int(max_reuse))
        node, depth = self._root, 0
        best_depth, best_node = 0, None
        for t in prompt:
            if depth >= cap:
                break
            node = node.children.get(int(t))
            if node is None or not node.slots:
                break
            depth += 1
            best_depth, best_node = depth, node
        if best_node is None:
            return None, 0
        slot = max(best_node.slots, key=lambda s: (self._entries[s].last_use, -s))
        return slot, best_depth

    def match_len(self, prompt) -> int:
        """How many leading tokens of ``prompt`` an admission would reuse:
        ``match(prompt)[1]``, as pure."""
        return self.match(prompt)[1]

    def pin(self, slot: int) -> None:
        """Block eviction of the entry while a wave holds it."""
        self._entries[slot].pins += 1

    def unpin(self, slot: int) -> None:
        entry = self._entries.get(slot)
        if entry is not None and entry.pins > 0:
            entry.pins -= 1

    def commit_hit(self, slot: int, reuse_len: int) -> None:
        """An admission reuses ``slot``'s rows: bump its recency and the
        hit counters."""
        entry = self._entries.get(slot)
        if entry is not None:
            self._clock += 1
            entry.last_use = self._clock
        self.hits += 1
        self.reused_tokens += int(reuse_len)
        self._m["hits"].inc()
        self._m["reused_tokens"].inc(int(reuse_len))

    def record_miss(self) -> None:
        """An admission landed with no reuse."""
        self.misses += 1
        self._m["misses"].inc()

    def flush(self) -> list[int]:
        """Drop every entry and return the slots that were resident as
        unleased donors (the caller puts them back on its free list)."""
        donors = self.donor_slots
        for slot in list(self._entries):
            self.remove(slot)
        return donors

    # -- eviction -------------------------------------------------------

    def evict_lru(self) -> int | None:
        """Evict the least recently used unleased, unpinned entry and
        return its (now free) slot, or None; ties break on slot id."""
        victims = [e for e in self._entries.values() if not e.leased and e.pins == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda e: (e.last_use, e.slot))
        self.remove(victim.slot)
        self.evictions += 1
        self._m["evictions"].inc()
        return victim.slot

    # -- introspection --------------------------------------------------

    @property
    def donor_slots(self) -> list[int]:
        """Slots resident as unleased donors, sorted."""
        return sorted(s for s, e in self._entries.items() if not e.leased)

    def entry(self, slot: int) -> CacheEntry | None:
        return self._entries.get(slot)

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "donors": len(self.donor_slots),
            "hits": self.hits,
            "misses": self.misses,
            "reused_tokens": self.reused_tokens,
            "evictions": self.evictions,
        }


@dataclass
class BlockEntry:
    """One indexed full-block prompt prefix (paged arena): ``blocks[i]``
    holds the K/V of ``tokens[i·bs : (i+1)·bs]``. The entry owns one
    allocator reference per block, independent of the request that
    prefilled them."""

    eid: int
    tokens: tuple
    blocks: tuple
    last_use: int


class PagedPrefixIndex:
    """Radix index over FULL-BLOCK prompt prefixes for the paged arena
    (copy of the reference's ``PagedPrefixIndex``):

    - a hit splices the shared blocks into the new table with one more
      reference each: no device copy, and the donor holds no slot;
    - sharing is at full-block granularity (a partial block also holds the
      writer's later tokens): the trailing ``len(prompt) % block_size``
      tokens of a hit prefill with the suffix;
    - eviction under pool pressure (:meth:`evict_for`) drops least recently
      used entries whose blocks would actually free (refcount 1); an entry
      shared with live tables frees nothing and is skipped.

    Logical-clock recency, entry-id tie-breaks, a pure :meth:`match` (the
    hit commits only when the admission lands), as :class:`PrefixCache`."""

    def __init__(self, allocator):
        self._alloc = allocator
        self._root = _Node()  # node.slots holds entry ids here
        self._entries: dict[int, BlockEntry] = {}
        self._by_tokens: dict[tuple, BlockEntry] = {}
        self._clock = 0
        self._ids = itertools.count()
        self.hits = 0
        self.misses = 0
        self.reused_tokens = 0
        self.evictions = 0
        self.shared_blocks = 0
        self.telemetry_label, self._m = _cache_series(shared=True)

    def release_telemetry(self) -> None:
        telemetry.remove_series(cache=self.telemetry_label)

    # -- registration ---------------------------------------------------

    def insert(self, tokens, blocks) -> None:
        """Index the full-block prefix of ``tokens`` whose K/V lives in
        ``blocks`` (the owner's leading table blocks), taking one reference
        per indexed block. An exact duplicate bumps recency instead."""
        bs = self._alloc.block_size
        n_full = len(tokens) // bs
        if n_full < 1:
            return
        key = tuple(int(t) for t in tokens[: n_full * bs])
        self._clock += 1
        prev = self._by_tokens.get(key)
        if prev is not None:
            prev.last_use = self._clock
            return
        held = tuple(int(b) for b in blocks[:n_full])
        if len(held) != n_full:
            raise ValueError(
                f"insert(): {n_full} full prompt blocks indexed but "
                f"only {len(held)} block ids supplied"
            )
        self._alloc.ref(held)
        entry = BlockEntry(eid=next(self._ids), tokens=key, blocks=held,
                           last_use=self._clock)
        self._entries[entry.eid] = entry
        self._by_tokens[key] = entry
        node = self._root
        for t in key:
            node = node.children.setdefault(t, _Node())
            node.slots.add(entry.eid)

    def _remove(self, entry: BlockEntry) -> list[int]:
        """Drop the entry, prune its trie path, release its block references.
        Returns the block ids that freed."""
        del self._entries[entry.eid]
        del self._by_tokens[entry.tokens]
        node, path = self._root, []
        for t in entry.tokens:
            child = node.children.get(t)
            if child is None:
                break
            path.append((node, t, child))
            child.slots.discard(entry.eid)
            node = child
        for parent, t, child in reversed(path):
            if not child.slots and not child.children:
                del parent.children[t]
        return self._alloc.deref(entry.blocks)

    # -- lookup / splice ------------------------------------------------

    def match(self, prompt):
        """Longest indexed FULL-BLOCK prefix of ``prompt`` strictly shorter
        than it (one suffix token must remain to prefill). Pure. Returns
        ``(eid, reuse_tokens)`` (a multiple of the block size) or ``(None,
        0)``."""
        bs = self._alloc.block_size
        cap = len(prompt) - 1
        node, depth = self._root, 0
        best_node, best_depth = None, 0
        for t in prompt:
            if depth >= cap:
                break
            node = node.children.get(int(t))
            if node is None or not node.slots:
                break
            depth += 1
            if depth % bs == 0:
                best_node, best_depth = node, depth
        if best_node is None:
            return None, 0
        eid = max(best_node.slots, key=lambda e: (self._entries[e].last_use, -e))
        return eid, best_depth

    def match_len(self, prompt) -> int:
        """Reusable full-block prefix length for ``prompt``: ``match(prompt)[1]``."""
        return self.match(prompt)[1]

    def commit_hit(self, eid: int, reuse_len: int) -> list[int]:
        """The admission lands: reference the entry's first ``reuse_len / bs``
        blocks for the new table and return their ids in prompt order."""
        entry = self._entries[eid]
        self._clock += 1
        entry.last_use = self._clock
        n = int(reuse_len) // self._alloc.block_size
        shared = list(entry.blocks[:n])
        self._alloc.ref(shared)
        self.hits += 1
        self.reused_tokens += int(reuse_len)
        self.shared_blocks += n
        self._m["hits"].inc()
        self._m["reused_tokens"].inc(int(reuse_len))
        self._m["shared_blocks"].inc(n)
        return shared

    def record_miss(self) -> None:
        self.misses += 1
        self._m["misses"].inc()

    # -- eviction / flush -----------------------------------------------

    def evict_for(self, n_blocks: int) -> int:
        """Release least recently used entries until at least ``n_blocks``
        blocks freed or nothing more can free; entries none of whose blocks
        would free are skipped. Returns the blocks freed."""
        freed = 0
        while freed < n_blocks:
            victims = sorted(self._entries.values(), key=lambda e: (e.last_use, e.eid))
            pick = next((e for e in victims
                         if any(self._alloc.ref_count(b) == 1 for b in e.blocks)), None)
            if pick is None:
                break
            freed += len(self._remove(pick))
            self.evictions += 1
            self._m["evictions"].inc()
        return freed

    def flush(self) -> None:
        """Drop every entry and release its block references."""
        for eid in list(self._entries):
            entry = self._entries.get(eid)
            if entry is not None:
                self._remove(entry)

    # -- introspection --------------------------------------------------

    def entry(self, eid: int) -> BlockEntry | None:
        return self._entries.get(eid)

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "indexed_blocks": sum(len(e.blocks) for e in self._entries.values()),
            "hits": self.hits,
            "misses": self.misses,
            "reused_tokens": self.reused_tokens,
            "evictions": self.evictions,
            "shared_blocks": self.shared_blocks,
        }
