"""Paged KV arena: a block pool of K/V and attention through block tables.

Counterpart of ``elephas_tpu/serving/paged_kv.py``, single device. The fixed
slot arena (:mod:`~elephas_tpu_torch.serving.kv_cache`) prices every slot at
the model's worst-case length. The paged arena keeps one **block pool**
``[num_blocks, block_size, H, Dh]`` per layer and a **block table** per
slot that maps position ``p`` to pool row ``(table[p // block_size], p %
block_size)``. A request reserves ``ceil((prompt + max_new_tokens) /
block_size)`` blocks, its own worst case, and full prompt-prefix blocks can
be shared by refcount.

Where the port departs from the reference, and why:

- **In place.** The pool is updated in place, as :class:`~elephas_tpu_torch.\
serving.kv_cache.SlotKVCache` is, not threaded through functionally.
- **The sink block.** The reference drops a write to the sentinel id
  ``num_blocks`` (``mode="drop"``) and clips a gather of it to the last
  block. An in-place index write cannot drop, a clamped index would alias a
  real row, and two lanes writing one row in one call land in no fixed
  order. So the pool holds one extra block at index ``num_blocks`` that no
  request leases: inactive lanes, padded chunk tails and cursors past their
  table write there, and a sentinel table entry reads there (only masked
  lanes ever see those rows). :meth:`PagedKVPool.nbytes` still reports the
  reference's figure, without the sink.
- **Quantize on write** (``kv_dtype`` ``"int8"`` / ``"int4"``): codes and
  scales come from :func:`~elephas_tpu_torch.serving.kv_quant.quantize_rows`
  in plain PyTorch, as the reference computes them in XLA outside any
  kernel; the kernels dequantize as a tile lands.

Table rows pad with the sentinel id ``num_blocks``. :func:`gather_blocks` /
:func:`scatter_blocks` are the device half of preempt and resume.
"""

from __future__ import annotations

import torch

from elephas_tpu_torch.serving.kv_quant import check_kv_dtype, packed_head_dim, \
    pool_bytes_per_pos

__all__ = [
    "PagedKVPool",
    "blocks_for",
    "table_buckets",
    "table_bucket_for",
    "paged_token_decode_step",
    "paged_chunk_forward",
    "paged_verify_forward",
    "gather_blocks",
    "scatter_blocks",
]


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions (ceil division)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(block_size))


def table_buckets(max_blocks: int) -> tuple[int, ...]:
    """Power-of-two block-table length ladder ``[1, 2, 4, ..]`` capped at
    (and always including) ``max_blocks``."""
    if max_blocks <= 0:
        raise ValueError(
            f"max_blocks must be positive, got {max_blocks}"
        )
    buckets, b = [], 1
    while b < max_blocks:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_blocks))
    return tuple(buckets)


def table_bucket_for(n_blocks: int, buckets) -> int:
    """Smallest table bucket holding ``n_blocks`` blocks."""
    for b in buckets:
        if b >= n_blocks:
            return int(b)
    raise ValueError(
        f"block table of {n_blocks} blocks exceeds the largest table "
        f"bucket {max(buckets)}"
    )


class PagedKVPool:
    """The paged block pool of one model: ``caches`` is ``{layer_name: (k,
    v)}``, each ``[num_blocks + 1, block_size, H, Dh]`` float32, for
    ``kv_dtype="fp"``, or ``{layer_name: (kq, vq, k_scale, v_scale)}`` when
    quantized: int8 codes ``[num_blocks + 1, block_size, H, Dhp]`` (``Dhp``
    the packed head dim) beside float32 scales ``[num_blocks + 1,
    block_size, H]``. Block ``num_blocks`` is the sink (see the module).
    Zeroed at construction, updated in place.

    ``attention_layers`` is ``[(name, FlashMHA)]`` in block order."""

    def __init__(self, attention_layers, num_blocks: int, block_size: int, device,
                 kv_dtype: str = "fp"):
        self.specs = [(name, int(l.num_heads), int(l.head_dim))
                      for name, l in attention_layers]
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.kv_dtype = check_kv_dtype(kv_dtype)
        n = self.num_blocks + 1
        bs = self.block_size
        self.caches = {}
        for name, h, d in self.specs:
            if self.kv_dtype == "fp":
                self.caches[name] = tuple(
                    torch.zeros(n, bs, h, d, dtype=torch.float32, device=device)
                    for _ in range(2))
            else:
                dp = packed_head_dim(d, self.kv_dtype)
                self.caches[name] = (
                    torch.zeros(n, bs, h, dp, dtype=torch.int8, device=device),
                    torch.zeros(n, bs, h, dp, dtype=torch.int8, device=device),
                    torch.zeros(n, bs, h, dtype=torch.float32, device=device),
                    torch.zeros(n, bs, h, dtype=torch.float32, device=device),
                )

    @property
    def sink(self) -> int:
        """The sentinel block id: the sink block's index."""
        return self.num_blocks

    def nbytes(self) -> int:
        """Size of the pool's ``num_blocks`` blocks at their stored dtype (the
        reference's figure: the sink block is not counted)."""
        return self.num_blocks * self.block_size * pool_bytes_per_pos(self.specs, self.kv_dtype)

    def layers(self):
        """Each attention layer's pool entry, in block order."""
        return [self.caches[name] for name, _h, _d in self.specs]


def _table_blocks(tables, blk_idx, sink):
    """Block ids at table column ``blk_idx`` (any shape ``[B, ...]``); a
    column past the table maps to the sink, not to a real block."""
    t = tables.shape[1]
    flat = blk_idx.reshape(blk_idx.shape[0], -1)
    ids = tables.long().gather(1, flat.clamp(0, t - 1))
    ids = torch.where(flat < t, ids, sink)
    return ids.reshape(blk_idx.shape)


def paged_token_decode_step(model, tok, positions, pool: PagedKVPool, tables, active,
                            attention: str = "flash"):
    """One decode step over the whole slot population, paged: slot ``b``
    consumes ``tok[b]`` (``[B]`` int64) at ``positions[b]`` (``[B]`` int32),
    writes that position's K/V (codes and scales when quantized) into pool
    row ``(tables[b, p // bs], p % bs)`` where ``active`` (``[B]`` bool)
    holds, and attends over its table's span (positions ``<= positions[b]``
    of ``T · block_size``). An inactive lane, or a cursor past its table
    (a finished slot still running out its window), writes to the sink.
    ``attention="flash"`` runs the paged span-decode kernel (its plain
    version on the CPU), ``"naive"`` gathers and dequantizes the span and
    runs the dense masked softmax, the parity oracle. Returns ``[B,
    vocab]`` logits."""
    bs = pool.block_size
    pos = positions.long()
    blk = _table_blocks(tables, pos // bs, pool.sink)
    blk = torch.where(active, blk, pool.sink)
    off = pos % bs
    x = model.tok_embed(tok)
    if model.positions is not None:
        x = x + model.positions[pos]
    for block, entry in zip(model.blocks, pool.layers()):
        x = x + block.attn.paged_decode(block.ln1(x), positions, entry, tables, blk, off,
                                        attention, pool.kv_dtype)
        x = block.mlp(x)
    return model.lm_head(model.final_ln(x))


def paged_chunk_forward(model, tokens_chunk, pool: PagedKVPool, tables, offsets, chunk_lens,
                        active=None, attention: str = "flash"):
    """Prefill a bounded chunk of each row's prompt into its block-table rows:
    row ``b`` of ``tokens_chunk`` (``[n, C]`` int64) holds positions
    ``offsets[b] .. offsets[b] + C - 1`` of the request whose table is
    ``tables[b]`` (``[n, T]`` int32). ``chunk_lens`` masks a partial chunk's
    padded tail, ``active`` (``None`` = all) the rows not prefilling; their
    writes go to the sink. The chunk's K/V lands in the pool first, then its
    queries attend over the table span (shared prefix blocks, earlier
    chunks, the chunk's own causal part). Returns ``[n, C, vocab]``
    logits."""
    c = tokens_chunk.shape[1]
    dev = tokens_chunk.device
    bs = pool.block_size
    pos_mat = (offsets.to(torch.int32)[:, None]
               + torch.arange(c, dtype=torch.int32, device=dev)[None, :]).contiguous()
    valid = torch.arange(c, device=dev)[None, :] < chunk_lens[:, None]
    if active is not None:
        valid = valid & active[:, None]
    pos = pos_mat.long()
    blk = torch.where(valid, _table_blocks(tables, pos // bs, pool.sink), pool.sink)
    off = pos % bs
    x = model.tok_embed(tokens_chunk)
    if model.positions is not None:
        # a padded tail may run past the table: its rows are never read
        x = x + model.positions[pos.clamp(max=model.maxlen - 1)]
    for block, entry in zip(model.blocks, pool.layers()):
        x = x + block.attn.paged_chunk(block.ln1(x), pos_mat, entry, tables, blk, off,
                                       attention, pool.kv_dtype)
        x = block.mlp(x)
    return model.lm_head(model.final_ln(x))


def paged_verify_forward(model, tokens_window, pool: PagedKVPool, tables, offsets, n_fed,
                         active=None, attention: str = "flash"):
    """The speculative verify pass over the paged arena: row ``b`` feeds
    ``n_fed[b]`` tokens at positions ``offsets[b] ..`` and gets a logits row
    a window position. It is :func:`paged_chunk_forward` with generated
    tokens; rejected positions lie inside blocks the request reserved, and a
    later feed rewrites them before any query can see them."""
    return paged_chunk_forward(model, tokens_window, pool, tables, offsets, n_fed, active,
                               attention)


def gather_blocks(pool: PagedKVPool, ids):
    """Read pool blocks ``ids`` (``[n]`` int64) of every layer: ``{name:
    leaves}`` with each leaf ``[n, block_size, ...]`` at its stored dtype
    (fp rows, or codes and scales). The pool is not changed."""
    return {name: tuple(z[ids] for z in leaves) for name, leaves in pool.caches.items()}


def scatter_blocks(pool: PagedKVPool, ids, rows) -> None:
    """Write ``rows`` (as :func:`gather_blocks` returns them) back into pool
    blocks ``ids``, in place: restored rows are bitwise the offloaded
    ones."""
    for name, leaves in pool.caches.items():
        for z, r in zip(leaves, rows[name]):
            z[ids] = r.to(z.device, non_blocking=True)
