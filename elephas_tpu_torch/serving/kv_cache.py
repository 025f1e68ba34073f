"""Slot-based KV cache arena and the two passes that fill and read it.

Counterpart of ``elephas_tpu/serving/kv_cache.py`` on the fixed arena,
without a mesh. The arena is a ``[num_slots, max_len, heads, head_dim]``
pair of float32 K/V buffers per attention layer. Slots outlive requests:
a slot's **write cursor** (the per-slot position vector of the decode
step) marks how many tokens of its occupant are cached, and reclaiming a
slot is free: the next occupant's prefill overwrites from position 0, and
stale rows beyond the new prompt are never visible, because decode
attends only to positions ``<= cursor`` and rewrites each before the
cursor reaches it.

The reference replays the Keras graph with its arrays threaded
functionally through ``jit``; here both passes walk the port's own
modules (:meth:`FlashMHA.prefill`, :meth:`FlashMHA.decode`) and update
the arena **in place**:

- :func:`prefill_forward` — a bucket of prompts for the admitted slots in
  one full-sequence forward, writing positions ``0..S-1`` of each slot's
  rows;
- :func:`token_decode_step` — one token for EVERY slot at its own
  position (fixed shapes: all ``num_slots`` rows each step, writes masked
  by ``active``), the step a CUDA graph of the decode window will hold.

``chunked_prefill_forward``, ``verify_forward`` and ``prefix_copy`` are
later slices (ROADMAP.md, Queue A item 1).
"""

from __future__ import annotations

import torch


class SlotKVCache:
    """The slot arena of one model: ``caches`` is ``{layer_name: (k, v)}``,
    each ``[num_slots, max_len, H, Dh]`` float32 on ``device``, zeroed at
    construction and updated in place by :func:`prefill_forward` and
    :func:`token_decode_step`.

    ``attention_layers`` is ``[(name, FlashMHA)]`` in block order, as
    :func:`~elephas_tpu_torch.models.transformer.validate_token_decode_model`
    returns it."""

    def __init__(self, attention_layers, num_slots: int, max_len: int, device):
        self.specs = [(name, int(l.num_heads), int(l.head_dim)) for name, l in attention_layers]
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.caches = {
            name: tuple(
                torch.zeros(self.num_slots, self.max_len, h, d, dtype=torch.float32,
                            device=device)
                for _ in range(2)
            )
            for name, h, d in self.specs
        }

    def nbytes(self) -> int:
        """Size of the full (f32) arena."""
        per_pos = sum(h * d for _, h, d in self.specs) * 2 * 4
        return self.num_slots * self.max_len * per_pos

    def layers(self):
        """``(k, v)`` of each attention layer, in block order."""
        return [self.caches[name] for name, _h, _d in self.specs]


def token_decode_step(model, tok, positions, cache: SlotKVCache, active=None,
                      attention: str = "flash", span: int | None = None):
    """One decode step for the WHOLE arena: slot ``i`` consumes token
    ``tok[i]`` (``[num_slots]`` int64) at position ``positions[i]``
    (``[num_slots]`` int32, its write cursor), writes that position's K/V
    into its arena rows where ``active`` (``[num_slots]`` bool, ``None`` =
    all) holds, attends over positions ``<= positions[i]`` of
    ``cache[:, :span]`` and yields its next-token logits
    ``[num_slots, vocab]``.

    ``attention="flash"`` runs the span-decode kernel (its plain version on
    the CPU); ``"naive"`` the dense masked softmax, the parity oracle.
    Every active slot's position must lie inside ``span`` (``None`` =
    ``max_len``); an inactive lane's stale cursor past it computes a value
    nobody reads."""
    x = model.tok_embed(tok)
    if model.positions is not None:
        x = x + model.positions[positions.long()]
    for block, (ck, cv) in zip(model.blocks, cache.layers()):
        x = x + block.attn.decode(block.ln1(x), positions, ck, cv, active, attention, span)
        x = block.mlp(x)
    return model.lm_head(model.final_ln(x))


def prefill_forward(model, tokens_rows, cache: SlotKVCache, slots, attention: str = "flash"):
    """Full-sequence forward of a wave of bucket-padded prompts into their
    slots: ``tokens_rows`` ``[n, S]`` int64 (``S`` the prompt bucket) for
    the arena slots ``slots`` (``[n]`` int64). Positions ``0..S-1`` of each
    slot's rows are written; positions past a real prompt hold padding
    whose K/V decode rewrites before its cursor makes them visible.

    The reference runs all ``num_slots`` rows and masks the write; this
    computes only the admitted rows. Returns ``[n, S, vocab]`` logits."""
    s = tokens_rows.shape[1]
    x = model.tok_embed(tokens_rows)
    if model.positions is not None:
        x = x + model.positions[:s]
    for block, (ck, cv) in zip(model.blocks, cache.layers()):
        x = x + block.attn.prefill(block.ln1(x), ck, cv, slots, attention)
        x = block.mlp(x)
    return model.lm_head(model.final_ln(x))
