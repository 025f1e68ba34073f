"""Transformer model family over the Hopper flash-attention and
LayerNorm kernels.

Counterpart of ``elephas_tpu/models/transformer.py``:

- :class:`FlashMHA` — multi-head self-attention whose core is the flash
  kernel (:mod:`elephas_tpu_torch.ops.flash_attention`).
- :class:`FusedLayerNorm` — LayerNorm over the LayerNorm kernels
  (:mod:`elephas_tpu_torch.ops.layer_norm`), at every norm of the stack.
- :class:`PreNormBlock` — the pre-norm block around a feed-forward part:
  :class:`Block`'s dense one here, the Switch family's routed experts in
  :mod:`elephas_tpu_torch.models.switch`.
- :func:`transformer_classifier` — encoder stack + pooled head.
- :func:`transformer_lm` — causal decoder-only language model.
  Both builders compile the module as the reference compiles its model
  (Keras's Adam, the loss, ``accuracy``; :mod:`elephas_tpu_torch.training`).
- :func:`generate` — autoregressive sampling: recomputing the fixed
  ``maxlen`` sequence every step, or (``kv_cache=True``) one token a step
  through the decode step of :mod:`elephas_tpu_torch.serving.kv_cache`.
- :func:`validate_token_decode_model` — the gate of cached decode and of
  the serving engine.

Both builders take the reference's ``dtype_policy`` (``None``,
``"float32"`` or ``"mixed_bfloat16"``, :mod:`elephas_tpu_torch.models.layers`).
Under ``mixed_bfloat16`` the matmuls, the flash kernel and the LayerNorm
kernels run in bf16 on float32 variables, and the ``head`` / ``lm_head``
stay float32, as in the reference (``elephas_tpu/models/transformer.py:338,
391``).

The modules keep the reference's layer names, so Keras weights load by
path (:func:`elephas_tpu_torch.utils.weights.load_keras_weights`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.models.layers import (
    Dense,
    Dropout,
    build_module,
    zoo_builder,
    cast,
    dense_paths,
)
from elephas_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    flash_attention_qkv,
    flash_forward_reference,
)
from elephas_tpu_torch.ops.flash_serving import (
    flash_causal_prefill,
    flash_paged_span_chunk,
    flash_paged_span_decode,
    flash_span_chunk,
    flash_span_decode,
    paged_dense_span,
    span_bucket_for,
    span_buckets,
)
from elephas_tpu_torch.ops.layer_norm import layer_norm, layer_norm_forward_reference
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import (
    binary_crossentropy,
    compile_model,
    sparse_categorical_crossentropy,
)

def _is_neutral(value, neutral) -> bool:
    """``value`` leaves the behaviour as ``neutral`` does: equal to it (a
    list of axis names equal to the tuple too), and not a bool standing in
    for an int."""
    if isinstance(neutral, tuple) and isinstance(value, (list, tuple)):
        return tuple(value) == neutral
    return type(value) is type(neutral) and value == neutral


def _positions(maxlen: int, d_model: int) -> np.ndarray:
    """Sinusoidal position table (fixed, not learned — no extra state)."""
    pos = np.arange(maxlen)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


def _rope_tables(maxlen: int, head_dim: int):
    """cos/sin tables ``[S, D]`` for rotary position embeddings
    (half-split / GPT-NeoX convention; ``head_dim`` must be even)."""
    inv = 1.0 / (10000.0 ** (np.arange(0, head_dim, 2) / head_dim))
    ang = np.arange(maxlen)[:, None] * inv[None, :]  # [S, D/2]
    cos = np.concatenate([np.cos(ang), np.cos(ang)], axis=-1)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], axis=-1)
    return cos.astype(np.float32), sin.astype(np.float32)


def _apply_rope(x, cos, sin):
    """Rotate ``[..., S, D]`` heads: ``x·cos + rotate_half(x)·sin``."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rot * sin


def _dense_span_attention(q, gk, gv, pos):
    """The naive serving attention, the parity oracle: the dense masked
    softmax of ``q`` (``[B, H, D]`` at positions ``pos`` ``[B]``, or ``[B, H,
    C, D]`` at ``[B, C]``) over the span ``gk`` / ``gv`` (``[B, S, H, D]``),
    key ``j`` visible iff ``j <= pos``."""
    cols = torch.arange(gk.shape[1], device=q.device)
    scale = q.shape[-1] ** -0.5
    if q.ndim == 3:
        att = torch.einsum("bhd,bshd->bhs", q, gk) * scale
        visible = cols[None, None, :] <= pos.long()[:, None, None]
        att = torch.softmax(att.masked_fill(~visible, -torch.inf), dim=-1)
        return torch.einsum("bhs,bshd->bhd", att, gv)
    att = torch.einsum("bhcd,bshd->bhcs", q, gk) * scale
    visible = cols[None, None, None, :] <= pos.long()[:, None, :, None]
    att = torch.softmax(att.masked_fill(~visible, -torch.inf), dim=-1)
    return torch.einsum("bhcs,bshd->bhcd", att, gv)


class FlashMHA(nn.Module):
    """Multi-head self-attention over the flash kernel: a fused ``qkv``
    projection without bias, per-head scaled dot-product attention, and
    the ``proj`` output projection with bias.

    The qkv output splits as ``[B, S, 3, H, D]`` (``[3][H][D]`` order, as
    the reference's fused Dense lays it out). ``plain=True`` in
    :meth:`forward` computes the attention core with the kernel's plain
    version on any device — the reference a run on the card is checked
    against. :meth:`prefill` and :meth:`decode` are the serving
    counterparts of ``elephas_tpu/serving/kv_cache.py``'s attention
    handlers, as is :meth:`chunk`: they write K/V into a slot arena in
    place. :meth:`paged_decode` and :meth:`paged_chunk` are those of
    ``elephas_tpu/serving/paged_kv.py``: they write into a paged block pool
    in place (quantizing on write) and attend through block tables."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 causal: bool = False, rope: bool = False,
                 maxlen: int | None = None):
        super().__init__()
        if rope and head_dim % 2:
            raise ValueError(f"rope needs an even head_dim, got {head_dim}")
        if rope and not maxlen:
            raise ValueError("rope needs maxlen, the length of its tables")
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.causal = causal
        self.rope = rope
        self.qkv = Dense(d_model, 3 * num_heads * head_dim, bias=False)
        self.proj = Dense(num_heads * head_dim, d_model)
        if rope:
            cos, sin = _rope_tables(maxlen, head_dim)
            self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)

    def forward(self, x, plain: bool = False):
        b, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = self.qkv(x).view(b, s, 3, h, d)
        if not self.rope and not plain:
            out = flash_attention_qkv(qkv, causal=self.causal)
            return self.proj(out.reshape(b, s, h * d))
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, S, D]
        if self.rope:
            cos = self.rope_cos[:s].to(x.dtype)
            sin = self.rope_sin[:s].to(x.dtype)
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        if plain:
            out = flash_forward_reference(q, k, v, d ** -0.5, self.causal)[0]
        else:
            out = flash_attention(q, k, v, causal=self.causal)
        return self.proj(out.transpose(1, 2).reshape(b, s, h * d))

    def prefill(self, x, cache_k, cache_v, slots, attention: str = "flash"):
        """Causal attention of a bucket of prompts from position 0: ``x``
        ``[n, S, d_model]`` for the arena slots ``slots`` (``[n]`` int64).
        Writes positions ``0..S-1`` of those slots' rows of ``cache_k`` /
        ``cache_v`` (``[slots, maxlen, H, D]``) in place and returns
        ``[n, S, d_model]``. ``attention="naive"`` takes the dense softmax
        (the reference's parity oracle) instead of the flash forward."""
        n, s, _ = x.shape
        h, d = self.num_heads, self.head_dim
        qkv = self.qkv(x).view(n, s, 3, h, d)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [n, H, S, D]
        if self.rope:
            cos, sin = self.rope_cos[:s], self.rope_sin[:s]
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        if attention == "flash":
            out = flash_causal_prefill(q, k, v, scale=d ** -0.5)
        else:
            out = attention_reference(q, k, v, causal=True)
        cache_k[slots, :s] = k.transpose(1, 2)
        cache_v[slots, :s] = v.transpose(1, 2)
        return self.proj(out.transpose(1, 2).reshape(n, s, h * d))

    def decode(self, x, positions, cache_k, cache_v, active=None,
               attention: str = "flash", span: int | None = None):
        """One token for every arena slot: ``x`` ``[B, d_model]`` at the
        per-slot ``positions`` (``[B]`` int32, on ``x``'s device). Writes
        each slot's K/V at its position into ``cache_k`` / ``cache_v``
        (``[B, maxlen, H, D]``) in place, where ``active`` (``[B]`` bool,
        ``None`` = every slot) holds, and attends over the keys at
        positions ``<= positions[b]`` of ``cache[:, :span]`` (``span``
        ``None`` = ``maxlen``). Fixed shapes, no host sync. Returns
        ``[B, d_model]``."""
        b = x.shape[0]
        h, d = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).view(b, 3, h, d).unbind(1)  # [B, H, D]
        idx = positions.long()
        if self.rope:
            cos, sin = self.rope_cos[idx][:, None], self.rope_sin[idx][:, None]
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        lanes = torch.arange(b, device=x.device)
        if active is not None:
            keep = active[:, None, None]
            k = torch.where(keep, k, cache_k[lanes, idx])
            v = torch.where(keep, v, cache_v[lanes, idx])
        cache_k[lanes, idx] = k
        cache_v[lanes, idx] = v
        span = cache_k.shape[1] if span is None else int(span)
        ck, cv = cache_k[:, :span], cache_v[:, :span]
        if attention == "flash":
            out = flash_span_decode(q.contiguous(), ck, cv, positions, scale=d ** -0.5)
        else:
            out = _dense_span_attention(q, ck, cv, idx)
        return self.proj(out.reshape(b, h * d))

    def chunk(self, x, pos_mat, valid, cache_k, cache_v, slots=None,
              attention: str = "flash", span: int | None = None):
        """``C`` tokens a slot from per-slot offsets, over the resident
        arena row: ``x`` ``[n, C, d_model]`` at the absolute positions
        ``pos_mat`` (``[n, C]`` int32, on ``x``'s device) of the arena slots
        ``slots`` (``[n]`` int64; ``None`` = slot ``i`` for row ``i``).
        Writes the K/V of each ``valid`` (``[n, C]`` bool) token into
        ``cache_k`` / ``cache_v`` (``[slots, maxlen, H, D]``) in place
        FIRST, then attends over the keys at positions ``<= pos_mat[b, c]``
        of ``cache[:, :span]``: a chunk's queries see the copied prefix,
        the earlier chunks and their own chunk's causal part. Rows that are
        not valid compute values nobody reads. Fixed shapes, no host sync.
        Returns ``[n, C, d_model]``."""
        n, c, _ = x.shape
        h, d = self.num_heads, self.head_dim
        maxlen = cache_k.shape[1]
        q, k, v = self.qkv(x).view(n, c, 3, h, d).unbind(2)  # [n, C, H, D]
        if self.rope:
            # a padded tail may run past the tables: its rows are never read
            tbl = pos_mat.clamp(max=maxlen - 1).long()
            cos, sin = self.rope_cos[tbl][:, :, None], self.rope_sin[tbl][:, :, None]
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        rows = torch.arange(n, device=x.device) if slots is None else slots
        # a padded position past the arena writes (its own old value) C rows
        # earlier, before the chunk: no valid row shares that index
        wpos = torch.where(pos_mat < maxlen, pos_mat, pos_mat - c).long()
        lanes, keep = rows[:, None], valid[..., None, None]
        cache_k[lanes, wpos] = torch.where(keep, k, cache_k[lanes, wpos])
        cache_v[lanes, wpos] = torch.where(keep, v, cache_v[lanes, wpos])
        span = maxlen if span is None else int(span)
        q = q.transpose(1, 2).contiguous()  # [n, H, C, D]
        if attention == "flash":
            out = flash_span_chunk(q, cache_k[:, :span], cache_v[:, :span], pos_mat,
                                   scale=d ** -0.5, slots=slots)
        else:
            out = _dense_span_attention(q, cache_k[rows, :span], cache_v[rows, :span], pos_mat)
        return self.proj(out.transpose(1, 2).reshape(n, c, h * d))


    def _write_pool(self, entry, blk, off, k, v, kv_dtype):
        """This call's K/V rows into pool rows ``(blk, off)`` in place: fp
        rows, or codes and scales from
        :func:`~elephas_tpu_torch.serving.kv_quant.quantize_rows`. Lanes
        that must not write carry the sink block's id."""
        if kv_dtype == "fp":
            entry[0][blk, off] = k
            entry[1][blk, off] = v
            return
        from elephas_tpu_torch.serving.kv_quant import quantize_rows

        for i, rows in enumerate((k, v)):
            codes, scales = quantize_rows(rows, kv_dtype)
            entry[i][blk, off] = codes
            entry[2 + i][blk, off] = scales

    def _pool_attend(self, q, entry, tables, pos, attention, kv_dtype):
        """Attention of ``q`` (``[B, H, D]`` one row, or ``[B, H, C, D]``) at
        ``pos`` over each row's table span of the pool: the paged kernels,
        or the dense masked softmax over the gathered, dequantized span."""
        d = self.head_dim
        scales = None if kv_dtype == "fp" else entry[2:]
        if attention == "flash":
            fn = flash_paged_span_decode if q.ndim == 3 else flash_paged_span_chunk
            return fn(q.contiguous(), entry[0], entry[1], tables, pos, scale=d ** -0.5,
                      kv_dtype=kv_dtype, kv_scales=scales)
        gk, gv = paged_dense_span(entry[0], entry[1], tables, kv_dtype, scales, d)
        return _dense_span_attention(q, gk, gv, pos)

    def paged_decode(self, x, positions, entry, tables, blk, off, attention: str = "flash",
                     kv_dtype: str = "fp"):
        """One token a slot over the paged pool: ``x`` ``[B, d_model]`` at
        ``positions`` (``[B]`` int32). Writes each slot's K/V into pool row
        ``(blk[b], off[b])`` of ``entry`` (the layer's pool leaves; ``blk``
        the sink for a lane that must not write) in place, then attends over
        the keys at positions ``<= positions[b]`` of table row ``tables[b]``
        (``[B, T]`` int32). Returns ``[B, d_model]``."""
        b = x.shape[0]
        h, d = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).view(b, 3, h, d).unbind(1)  # [B, H, D]
        if self.rope:
            idx = positions.long()
            cos, sin = self.rope_cos[idx][:, None], self.rope_sin[idx][:, None]
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        self._write_pool(entry, blk, off, k, v, kv_dtype)
        out = self._pool_attend(q, entry, tables, positions, attention, kv_dtype)
        return self.proj(out.reshape(b, h * d))

    def paged_chunk(self, x, pos_mat, entry, tables, blk, off, attention: str = "flash",
                    kv_dtype: str = "fp"):
        """``C`` tokens a row over the paged pool: ``x`` ``[n, C, d_model]`` at
        ``pos_mat`` (``[n, C]`` int32). Writes the K/V of each token into
        pool row ``(blk, off)`` (``[n, C]``; the sink for padded and inactive
        tokens) FIRST, then attends over table row ``tables[b]``'s keys at
        positions ``<= pos_mat[b, c]``. Returns ``[n, C, d_model]``."""
        n, c, _ = x.shape
        h, d = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).view(n, c, 3, h, d).unbind(2)  # [n, C, H, D]
        if self.rope:
            # a padded tail may run past the tables: its rows are never read
            tbl = pos_mat.clamp(max=self.rope_cos.shape[0] - 1).long()
            cos, sin = self.rope_cos[tbl][:, :, None], self.rope_sin[tbl][:, :, None]
            q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        self._write_pool(entry, blk, off, k, v, kv_dtype)
        out = self._pool_attend(q.transpose(1, 2), entry, tables, pos_mat, attention,
                                kv_dtype)
        return self.proj(out.transpose(1, 2).reshape(n, c, h * d))


class FusedLayerNorm(nn.Module):
    """LayerNormalization over the last axis (Keras's math: f32
    statistics, affine float32 ``gamma``/``beta``), through the LayerNorm
    kernels, with its output in the compute dtype. Like the reference's
    stock ``LayerNormalization`` it does not cast its input: under
    ``mixed_bfloat16`` the residual stream is bf16 and the kernels take
    their bf16 route, but the first norm of a model with the additive
    position table normalises the float32 sum of embeddings and table (on
    the fp32 route), as the reference does. ``plain=True`` in
    :meth:`forward` runs the kernels' plain version instead,
    differentiated by autograd — the reference a run on the card is
    checked against."""

    def __init__(self, d_model: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(d_model))
        self.beta = nn.Parameter(torch.zeros(d_model))
        self.compute_dtype = torch.float32

    def forward(self, x, plain: bool = False):
        if plain:
            d = x.shape[-1]
            y = layer_norm_forward_reference(x.reshape(-1, d), self.gamma, self.beta,
                                             self.epsilon)[0]
            return cast(y.reshape(x.shape), self.compute_dtype)
        return cast(layer_norm(x, self.gamma, self.beta, self.epsilon), self.compute_dtype)


class PreNormBlock(nn.Module):
    """A pre-norm transformer block without its feed-forward part:
    LayerNorm → attention → residual, then :meth:`mlp`: LayerNorm → the
    subclass's :meth:`ffn` → residual. Each residual sum runs in the
    branch's (compute) dtype, as Keras's ``Add`` casts both inputs to it.
    The serving passes call :meth:`mlp` after their own attention."""

    def __init__(self, d_model, num_heads, head_dim, dropout, causal, rope, maxlen, seed=0):
        super().__init__()
        self.ln1 = FusedLayerNorm(d_model)
        self.attn = FlashMHA(d_model, num_heads, head_dim, causal, rope, maxlen)
        self.ln2 = FusedLayerNorm(d_model)
        # rate-0 dropout is elided, as in the reference
        if dropout > 0:
            self.drop1, self.drop2 = Dropout(dropout, seed), Dropout(dropout, seed + 1)
        else:
            self.drop1 = self.drop2 = nn.Identity()

    def forward(self, x, plain: bool = False):
        h = self.drop1(self.attn(self.ln1(x, plain=plain), plain=plain))
        return self.mlp(cast(x, h.dtype) + h, plain=plain)

    def mlp(self, x, plain: bool = False):
        """``x`` plus the feed-forward branch: LayerNorm → :meth:`ffn`."""
        return x + self.drop2(self.ffn(self.ln2(x, plain=plain), plain=plain))


class Block(PreNormBlock):
    """The dense block: its feed-forward part is Dense(gelu, exact) →
    Dense."""

    def __init__(self, d_model, num_heads, head_dim, dropout, causal, rope, maxlen,
                 seed=0, mlp_ratio=4.0):
        super().__init__(d_model, num_heads, head_dim, dropout, causal, rope, maxlen, seed)
        hidden = int(d_model * mlp_ratio)
        self.mlp1 = Dense(d_model, hidden)
        self.mlp2 = Dense(hidden, d_model)

    def ffn(self, x, plain: bool = False):
        return self.mlp2(F.gelu(self.mlp1(x)))

    def keras_paths(self, name: str) -> dict:
        """The block's Keras paths, in ``model.weights`` order, under its
        layer prefix ``name`` (``blk{i}``)."""
        return {**attention_paths(name, self), **dense_paths(f"{name}_mlp1", self.mlp1),
                **dense_paths(f"{name}_mlp2", self.mlp2)}


def norm_paths(prefix: str, ln: FusedLayerNorm) -> dict:
    return {f"{prefix}/gamma": (ln.gamma, None), f"{prefix}/beta": (ln.beta, None)}


def attention_paths(name: str, block) -> dict:
    """A block's first half and second norm, as Keras lists them:
    ``{name}_ln1``, ``{name}_attn`` (``qkv``, ``proj``), ``{name}_ln2``."""
    return {**norm_paths(f"{name}_ln1", block.ln1),
            **dense_paths(f"{name}_attn/qkv", block.attn.qkv),
            **dense_paths(f"{name}_attn/proj", block.attn.proj),
            **norm_paths(f"{name}_ln2", block.ln2)}


class _Transformer(nn.Module):
    """Embedding (+ sinusoidal positions unless rope) → ``num_layers``
    blocks made by ``block`` (``block(d_model, num_heads, head_dim, dropout,
    causal, rope, maxlen, seed=)``: a :class:`Block` of some ``mlp_ratio``,
    or the Switch family's block) → final LayerNorm; the subclasses add the
    head."""

    def __init__(self, vocab_size, maxlen, d_model, num_heads, num_layers, block,
                 dropout, causal, rope, seed):
        super().__init__()
        self.vocab_size = vocab_size
        self.maxlen = maxlen
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        if rope:
            self.positions = None
        else:
            self.register_buffer(
                "positions", torch.from_numpy(_positions(maxlen, d_model)),
                persistent=False,
            )
        head_dim = d_model // num_heads
        self.blocks = nn.ModuleList(
            block(d_model, num_heads, head_dim, dropout, causal, rope, maxlen,
                  seed=2 * (seed * num_layers + i))
            for i in range(num_layers)
        )
        self.final_ln = FusedLayerNorm(d_model)
        self.compute_dtype = torch.float32

    def features(self, tokens, plain: bool = False):
        # Keras's Embedding outputs the compute dtype; the f32 position
        # table then makes the sum f32, as in the reference
        x = cast(self.tok_embed(tokens), self.compute_dtype)
        if self.positions is not None:
            x = x + self.positions[: tokens.shape[1]]
        for block in self.blocks:
            x = block(x, plain=plain)
        return self.final_ln(x, plain=plain)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device

    def keras_paths(self) -> dict:
        """Keras variable path → (the port's tensor, the permutation of
        the Keras array's axes into it)."""
        paths = {"tok_embed/embeddings": (self.tok_embed.weight, None)}
        for i, blk in enumerate(self.blocks):
            paths.update(blk.keras_paths(f"blk{i}"))
        paths.update(norm_paths("final_ln", self.final_ln))
        for head in ("lm_head", "head"):
            if hasattr(self, head):
                paths.update(dense_paths(head, getattr(self, head)))
        return paths


class TransformerLM(_Transformer):
    """Decoder-only causal LM: ``[B, S]`` int tokens → ``[B, S, vocab]``
    fp32 logits (the ``lm_head`` is float32 under every policy)."""

    def __init__(self, vocab_size, maxlen, d_model, num_heads, num_layers, block,
                 dropout, rope, seed):
        super().__init__(vocab_size, maxlen, d_model, num_heads, num_layers, block,
                         dropout, True, rope, seed)
        self.lm_head = Dense(d_model, vocab_size, keep_float32=True)

    def forward(self, tokens, plain: bool = False):
        return self.lm_head(self.features(tokens, plain=plain))


class TransformerClassifier(_Transformer):
    """Encoder-stack classifier: ``[B, S]`` int tokens → ``[B, classes]``
    probabilities (sigmoid for one class, softmax otherwise), as the
    reference's model outputs them: the mean over the sequence in the
    compute dtype, then the float32 ``head``."""

    def __init__(self, vocab_size, maxlen, num_classes, d_model, num_heads,
                 num_layers, block, dropout, seed):
        super().__init__(vocab_size, maxlen, d_model, num_heads, num_layers, block,
                         dropout, False, False, seed)
        self.num_classes = num_classes
        self.head = Dense(d_model, num_classes, keep_float32=True)

    def forward(self, tokens, plain: bool = False):
        logits = self.head(self.features(tokens, plain=plain).mean(dim=1))
        if self.num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)


def _build(cls, seed, dtype_policy, device, lr, loss, *args):
    """The module in eval mode on its device, under ``dtype_policy``,
    compiled as the reference compiles its Keras model: ``Adam(lr)``,
    ``loss``, ``["accuracy"]``."""
    model = build_module(lambda: cls(*args, seed), seed, dtype_policy, device)
    return compile_model(model, Adam(model.parameters(), lr=lr), loss, ["accuracy"])


@zoo_builder
def transformer_classifier(
    vocab_size: int = 20000,
    maxlen: int = 128,
    num_classes: int = 2,
    d_model: int = 128,
    num_heads: int = 4,
    num_layers: int = 2,
    mlp_ratio: float = 4.0,
    dropout: float = 0.1,
    lr: float = 1e-3,
    seed: int = 0,
    dtype_policy: str | None = None,
    device=None,
):
    """Encoder-stack text classifier, in eval mode on ``device``
    (``cuda:0`` by default) under ``dtype_policy``, compiled with Keras's
    ``Adam(lr)``, binary
    cross-entropy for one class (sparse categorical otherwise, on the
    softmax probabilities) and ``accuracy``."""
    loss = binary_crossentropy if num_classes == 1 else sparse_categorical_crossentropy
    return _build(
        TransformerClassifier, seed, dtype_policy, device, lr, loss, vocab_size,
        maxlen, num_classes, d_model, num_heads, num_layers,
        functools.partial(Block, mlp_ratio=mlp_ratio), dropout,
    )


@zoo_builder
def transformer_lm(
    vocab_size: int = 32000,
    maxlen: int = 256,
    d_model: int = 256,
    num_heads: int = 4,
    num_layers: int = 4,
    mlp_ratio: float = 4.0,
    dropout: float = 0.0,
    lr: float = 3e-4,
    seed: int = 0,
    dtype_policy: str | None = None,
    rope: bool = False,
    device=None,
):
    """Decoder-only causal LM, in eval mode on ``device`` (``cuda:0`` by
    default) under ``dtype_policy``. ``rope=True`` uses rotary position embeddings in every
    attention layer instead of the additive sinusoidal table. Compiled
    with Keras's ``Adam(lr)``, sparse categorical cross-entropy from the
    logits and ``accuracy``."""
    return _build(
        TransformerLM, seed, dtype_policy, device, lr,
        functools.partial(sparse_categorical_crossentropy, from_logits=True),
        vocab_size, maxlen, d_model, num_heads, num_layers,
        functools.partial(Block, mlp_ratio=mlp_ratio), dropout, rope,
    )


def _sample_logits(logits, generator, temperature: float, top_k, top_p=None):
    """Greedy argmax at temperature 0; else temperature-scaled
    categorical sampling, optionally truncated to the top_k logits
    and/or the top_p (nucleus) probability mass."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = _filter_logits(logits / temperature, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _filter_logits(scaled, top_k, top_p):
    """top-k / top-p (nucleus) truncation of ``[B, V]`` scaled logits."""
    neg_inf = torch.tensor(-torch.inf, dtype=scaled.dtype, device=scaled.device)
    if top_k is not None:
        kth = torch.sort(scaled, dim=-1).values[:, -int(top_k)][:, None]
        scaled = torch.where(scaled < kth, neg_inf, scaled)
    if top_p is not None:
        # nucleus: keep the smallest set of tokens whose cumulative
        # probability reaches top_p (the first token past the threshold
        # is kept so the nucleus is never empty)
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < float(top_p)  # prev-cumulative below mass
        # threshold = smallest kept logit per row
        kept_min = torch.where(keep, sorted_desc, -neg_inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < kept_min, neg_inf, scaled)
    return scaled


def _validate_decode_args(model, prompt, steps, top_k, top_p):
    """Normalizes the prompt to ``[B, P]`` and checks the length/sampling
    bounds against the model. Returns ``(prompt, b, p, maxlen, vocab)``."""
    prompt = np.asarray(prompt)
    if prompt.ndim == 1:
        prompt = prompt[None]
    b, p = prompt.shape
    maxlen = int(model.maxlen)
    vocab = int(model.vocab_size)
    if p + steps > maxlen:
        raise ValueError(
            f"prompt ({p}) + steps ({steps}) exceeds the model's "
            f"maxlen ({maxlen})"
        )
    if top_k is not None and not 0 < int(top_k) <= vocab:
        raise ValueError(
            f"top_k={top_k} outside (0, vocab={vocab}]"
        )
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p={top_p} outside (0, 1]")
    return prompt, b, p, maxlen, vocab


def validate_token_decode_model(model, what: str = "kv_cache decode",
                                hint: str = "use kv_cache=False"):
    """Compatibility gate for token-at-a-time cached decode, shared by
    ``generate(kv_cache=True)`` and the serving engine
    (:mod:`elephas_tpu_torch.serving`): a :func:`transformer_lm` or
    :func:`~elephas_tpu_torch.models.switch.switch_transformer_lm` module
    whose every ``FlashMHA`` is causal and that computes in float32 (the
    reference reads the policy's compute dtype: a ``mixed_bfloat16``
    model, whose variables are float32, is refused).
    Returns the attention layers as ``[(name, FlashMHA)]`` by their Keras
    names (``blk{i}_attn``); raises ``ValueError`` (messages prefixed
    ``what``, suffixed ``hint``, as the reference words them) otherwise."""
    if not isinstance(model, _Transformer):
        raise ValueError(
            f"{what} needs a transformer_lm or switch_transformer_lm module (token "
            f"embedding, FlashMHA blocks, final LayerNorm), got "
            f"{type(model).__name__}; {hint} for "
            f"this architecture"
        )
    layers = [(f"blk{i}_attn", blk.attn) for i, blk in enumerate(model.blocks)]
    for name, attn in layers:
        if not attn.causal:
            raise ValueError(
                f"{what} is causal by construction, but FlashMHA "
                f"layer {name!r} has causal=False; {hint}"
            )
    if not isinstance(model, TransformerLM):
        raise ValueError(
            f"{what} replays the model one token at a time; "
            f"{type(model).__name__} pools the sequence axis — {hint}"
        )
    dtype = model.compute_dtype
    if dtype != torch.float32:
        raise ValueError(
            f"{what} computes in float32, which would diverge "
            f"from this model's {str(dtype).removeprefix('torch.')} forward (argmax flips "
            f"where top logits are close) — {hint} for "
            f"mixed-precision models"
        )
    return layers


def _generate_cached(model, prompt, b, p, steps, temperature, top_k, top_p, seed,
                     groups=None):
    """KV-cache decode (reference ``_generate_cached``): prompt and
    continuation run one token a step through the decode step of the
    serving arena, every row at position ``t``; prompt positions keep
    their token, and only generated positions sample (and advance the
    generator), as in the recomputing path. ``groups`` (the copies of a
    mesh, :func:`_mesh_groups`) decodes each copy's rows over its own
    arena, a shard's heads on the shard's device."""
    # the serving package imports this module: import it at call time
    from elephas_tpu_torch.serving.kv_cache import SlotKVCache, token_decode_step

    layers = validate_token_decode_model(model, "kv_cache decode", "use kv_cache=False")
    dev = model.device
    maxlen = int(model.maxlen)
    if groups is None:
        caches = [(model, SlotKVCache(layers, b, maxlen, dev), dev, slice(0, b))]
    else:
        from elephas_tpu_torch.parallel.tensor import ShardedSlotKVCache

        caches = [(copy, ShardedSlotKVCache(copy, rows.stop - rows.start, maxlen, gdev), gdev,
                   rows) for copy, gdev, rows in groups]
    tokens = torch.zeros(b, maxlen, dtype=torch.long, device=dev)
    tokens[:, :p] = torch.from_numpy(prompt.astype(np.int64))
    generator = torch.Generator(device=dev).manual_seed(seed)
    buckets = span_buckets(maxlen)
    for t in range(p + steps - 1):
        span = span_bucket_for(t + 1, buckets)
        parts = []
        for copy, cache, cdev, rows in caches:
            positions = torch.full((rows.stop - rows.start,), t, dtype=torch.int32, device=cdev)
            parts.append(token_decode_step(copy, tokens[rows, t].to(cdev), positions, cache,
                                           span=span).to(dev))
        logits = torch.cat(parts) if len(parts) > 1 else parts[0]
        if t + 1 >= p:
            tokens[:, t + 1] = _sample_logits(logits, generator, temperature, top_k, top_p)
    return tokens[:, : p + steps].to(torch.int32).cpu().numpy()


def _mesh_groups(model, mesh, batch_axes, model_axis, rules, bt):
    """``[(copy, its device, its rows)]``: a copy of ``model`` for each
    batch shard of ``mesh`` (sharded over ``model_axis`` under the
    planner's layouts when that axis is larger than 1, whole otherwise),
    each taking its contiguous ``1/dp`` of the ``bt`` padded rows."""
    from elephas_tpu_torch.parallel.tensor import decode_groups, decode_replicas

    copies = decode_replicas(model, mesh, batch_axes, model_axis, rules)
    devices = decode_groups(mesh, batch_axes, model_axis)
    per = bt // len(copies)
    return [(c, devs[0], slice(g * per, (g + 1) * per))
            for g, (c, devs) in enumerate(zip(copies, devices))]


@torch.inference_mode()
def generate(
    model,
    prompt,
    steps: int,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    seed: int = 0,
    kv_cache: bool = False,
    mesh=None,
    batch_axes=("data",),
    model_axis: str | None = None,
    rules=None,
):
    """Autoregressive sampling from a :func:`transformer_lm` or
    :func:`~elephas_tpu_torch.models.switch.switch_transformer_lm` model.

    ``prompt``: ``[B, P]`` int tokens (``P + steps`` must fit the
    model's ``maxlen``). Returns ``[B, P + steps]`` int32 tokens as a
    numpy array. ``temperature=0`` is greedy argmax; otherwise softmax
    sampling at that temperature from a ``torch.Generator`` seeded with
    ``seed``, optionally truncated to the ``top_k`` most likely tokens
    and/or the ``top_p`` nucleus.

    The sequence stays at the model's fixed ``maxlen``, zero-padded
    (causal attention makes positions ``>= t`` inert), and each step
    recomputes the whole prefix: step ``t`` samples from
    ``logits[:, t - 1]`` and writes ``tokens[:, t]``. ``kv_cache=True``
    instead decodes one token a step over per-layer K/V caches (the span
    decode kernel on the card); models it cannot run raise
    (:func:`validate_token_decode_model`). Runs on the model's device.

    ``mesh`` (a :class:`~elephas_tpu_torch.parallel.mesh.Mesh`) decodes
    over a mesh, as the reference does: the batch is padded to the product
    of the ``batch_axes`` (with copies of the last prompt row, sliced off
    at the end) and split over them, each shard's rows decoded by a copy
    of the model on its devices; with ``model_axis`` larger than 1 each
    copy's weights are sharded over it under the tensor-parallel planner's
    layouts (``rules`` overrides them,
    :mod:`elephas_tpu_torch.parallel.tensor`), and ``kv_cache=True`` keeps
    each shard's K/V cache for its rows and heads on its device (the span
    decode kernel runs over them). The logits come together on the
    model's device, where one generator samples every row. The copies are
    made from the model's weights at each call. Without a mesh,
    ``batch_axes``, ``model_axis`` and ``rules`` are not read."""
    prompt, b, p, maxlen, _vocab = _validate_decode_args(
        model, prompt, steps, top_k, top_p
    )
    groups = None
    if mesh is not None:
        if isinstance(batch_axes, str):
            batch_axes = (batch_axes,)
        batch_axes = tuple(batch_axes)
        missing = [a for a in batch_axes if a not in mesh.shape]
        if missing:
            raise ValueError(
                f"batch_axes {missing} not in mesh axes {tuple(mesh.shape)}"
            )
        dp = int(np.prod([mesh.shape[a] for a in batch_axes]))
        pad = (-b) % dp
        if pad:
            # padded rows decode a copy of the last prompt row; sliced off
            prompt = np.concatenate([prompt, np.repeat(prompt[-1:], pad, axis=0)])
        groups = _mesh_groups(model, mesh, batch_axes, model_axis, rules, b + pad)
    if kv_cache:
        out = _generate_cached(model, prompt, len(prompt), p, steps, temperature, top_k,
                               top_p, seed, groups)
        return out[:b]
    dev = model.device
    tokens = torch.zeros(len(prompt), maxlen, dtype=torch.long, device=dev)
    tokens[:, :p] = torch.from_numpy(prompt.astype(np.int64))
    generator = torch.Generator(device=dev).manual_seed(seed)
    for t in range(p, p + steps):
        if groups is None:
            logits = model(tokens)[:, t - 1]
        else:
            logits = torch.cat([c(tokens[rows].to(gdev))[:, t - 1].to(dev)
                                for c, gdev, rows in groups])
        tokens[:, t] = _sample_logits(logits, generator, temperature, top_k, top_p)
    return tokens[:b, : p + steps].to(torch.int32).cpu().numpy()
