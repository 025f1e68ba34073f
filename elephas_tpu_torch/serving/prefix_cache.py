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

The counters are plain integers (the reference keeps them in its telemetry
registry, which the port does not have yet: ROADMAP.md, Queue A item 3).
The paged index (``BlockEntry``, ``PagedPrefixIndex``) comes with the paged
arena (item 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field


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

    def record_miss(self) -> None:
        """An admission landed with no reuse."""
        self.misses += 1

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
