"""Sequence-parallel long-prompt prefill for the serving engine.

Counterpart of ``elephas_tpu/serving/sp_prefill.py``. One device's chunk
prefill bounds how long a prompt the engine ingests in a reasonable TTFT:
the O(T²) attention runs on one device however the chunks are scheduled.
Here the prompt's sequence axis shards over an SP mesh axis
(:class:`~elephas_tpu_torch.parallel.mesh.Mesh`) and attention runs as a
ring (:mod:`elephas_tpu_torch.ops.ring_attention`: the K/V shards rotate,
the queries stay) or as Ulysses (:mod:`elephas_tpu_torch.ops.ulysses`:
two all-to-alls around full-sequence attention a head group), both over
the port's flash forward; every other op is token-local and runs on the
whole sequence.

The engine uses one function from here, :func:`sp_prefill_forward`: a
whole (power-of-two padded) prompt's forward that returns the logits and
each attention layer's K/V rows. The engine lands those rows in the paged
block pool (as a preemption resume does) and decode goes on unmeshed on
the landed blocks: the mesh serves the prefill only.

Numerics: ring and Ulysses are exact attention evaluated blockwise (lse
merges), so the logits match the single-device prefill to float
tolerance and temperature-0 first tokens exactly; the landed K/V rows are
projections of the same hidden states, so decode over them is token-exact
at temperature 0.
"""

from __future__ import annotations

from elephas_tpu_torch.models.transformer import _apply_rope
from elephas_tpu_torch.ops.ring_attention import ring_attention_sharded
from elephas_tpu_torch.ops.ulysses import ulysses_attention_sharded

__all__ = ["sp_pad_len", "sp_prefill_forward"]


def sp_pad_len(prompt_len: int, sp: int, maxlen: int) -> int | None:
    """Padded sequence length for an SP prefill of ``prompt_len`` tokens
    over ``sp`` shards: the smallest power of two covering the prompt that
    also tiles over the shards and keeps each local shard flash-tileable
    (a power-of-two local length is at most 128 or a multiple of 128, the
    kernel's block rule). ``None`` when no such length fits ``maxlen``:
    the caller falls back to the single-device path, loudly."""
    s = 1
    while s < max(int(prompt_len), int(sp)):
        s *= 2
    return s if s <= maxlen else None


def _sp_attention(attn, x, mesh, seq_axis: str, mechanism: str):
    """One attention layer over the SP mesh: ``x`` ``[1, S, d_model]`` →
    (``[1, S, d_model]``, K rows ``[S, H, Dh]``, V rows ``[S, H, Dh]``),
    the rows position-major, as the single-device prefill writes them."""
    b, s, _ = x.shape
    h, d = attn.num_heads, attn.head_dim
    qkv = attn.qkv(x).view(b, s, 3, h, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, Dh]
    if attn.rope:
        cos, sin = attn.rope_cos[:s], attn.rope_sin[:s]
        q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
    if mechanism == "ulysses":
        o = ulysses_attention_sharded(q, k, v, mesh, axis_name=seq_axis, causal=True,
                                      scale=d ** -0.5)
    else:
        o = ring_attention_sharded(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                                   v.reshape(b * h, s, d), mesh, axis_name=seq_axis,
                                   causal=True, scale=d ** -0.5).view(b, h, s, d)
    out = attn.proj(o.transpose(1, 2).reshape(b, s, h * d))
    return out, k[0].transpose(0, 1), v[0].transpose(0, 1)


def sp_prefill_forward(model, tokens, mesh, seq_axis: str, mechanism: str):
    """Whole-prompt forward over the SP mesh, K/V captured a layer.

    ``tokens``: ``[1, S]`` int64 on the model's device, ``S`` from
    :func:`sp_pad_len` (padding tokens ride past the real prompt: causal
    attention keeps them invisible to every real position, and their K/V
    rows either are cut by the caller or land past the cursor, where a
    later write comes before any read).

    Returns ``(logits [1, S, vocab], {layer: (k, v)})``, each ``k``/``v``
    ``[S, H, Dh]``, position-major rows ready to reshape into pool blocks;
    the layers are named as the engine's pool names them
    (``blk{i}_attn``)."""
    s = tokens.shape[1]
    x = model.tok_embed(tokens)
    if model.positions is not None:
        x = x + model.positions[:s]
    kv = {}
    for i, block in enumerate(model.blocks):
        h, k, v = _sp_attention(block.attn, block.ln1(x), mesh, seq_axis, mechanism)
        kv[f"blk{i}_attn"] = (k, v)
        x = block.mlp(x + h)
    return model.lm_head(model.final_ln(x)), kv
