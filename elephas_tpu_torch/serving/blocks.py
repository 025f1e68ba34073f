"""Refcounted block allocator for the paged KV arena.

Copy of ``elephas_tpu/serving/blocks.py`` (host-side bookkeeping, no
tensors). The allocator owns which pool blocks are leased and by how many
holders:

- an active request's block table holds one reference per block;
- a prefix-index entry (:class:`~elephas_tpu_torch.serving.prefix_cache.\
PagedPrefixIndex`) holds one reference per indexed full-prompt block;
- a prefix hit splices the entry's blocks into the new table with one more
  reference each: copy-free sharing, safe because a sharer only writes at
  positions at or after its shared full-block boundary.

A block returns to the free list only when its last reference drops. The
free list stays sorted ascending and allocation takes the lowest ids first,
so the same submissions lease the same block ids in the same order. The
optional ``free_gauge`` (the engine's ``elephas_serving_blocks_free``
series in the port's registry) is set after every change of the free list:
a report-only mirror, nothing reads it back.
"""

from __future__ import annotations


class BlockAllocator:
    """Deterministic refcounted free list over ``num_blocks`` pool blocks of
    ``block_size`` positions each."""

    def __init__(self, num_blocks: int, block_size: int, free_gauge=None):
        if int(num_blocks) < 1:
            raise ValueError(f"num_blocks={num_blocks} < 1")
        if int(block_size) < 1:
            raise ValueError(f"block_size={block_size} < 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: list[int] = list(range(self.num_blocks))
        self._refs: dict[int, int] = {}
        self._gauge = free_gauge
        self._set_gauge()

    def _set_gauge(self) -> None:
        if self._gauge is not None:
            self._gauge.set(len(self._free))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def leased_count(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Lease ``n`` fresh blocks (one reference each), lowest ids first,
        or None when the free list is short (never a partial grant)."""
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        blocks, self._free = self._free[:n], self._free[n:]
        for b in blocks:
            self._refs[b] = 1
        self._set_gauge()
        return blocks

    def ref(self, blocks) -> None:
        """Take one more reference on each (already leased) block."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(f"ref() on unleased block {b}")
            self._refs[b] += 1

    def deref(self, blocks) -> list[int]:
        """Drop one reference per block; blocks reaching zero return to the
        free list. Returns the freed ids (sorted)."""
        freed = []
        for b in blocks:
            refs = self._refs.get(b)
            if refs is None:
                raise ValueError(f"deref() on unleased block {b}")
            if refs == 1:
                del self._refs[b]
                freed.append(b)
            else:
                self._refs[b] = refs - 1
        if freed:
            freed.sort()
            self._free = sorted(self._free + freed)
            self._set_gauge()
        return freed

    def ref_count(self, block: int) -> int:
        return self._refs.get(int(block), 0)
