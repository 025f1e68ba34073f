"""Transformer model family over the Hopper flash-attention and
LayerNorm kernels.

Counterpart of ``elephas_tpu/models/transformer.py``:

- :class:`FlashMHA` — multi-head self-attention whose core is the flash
  kernel (:mod:`elephas_tpu_torch.ops.flash_attention`).
- :class:`FusedLayerNorm` — LayerNorm over the LayerNorm kernels
  (:mod:`elephas_tpu_torch.ops.layer_norm`), at every norm of the stack.
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
    flash_span_decode,
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

_MESH_TODO = (
    "generate({}) is not ported yet (ROADMAP.md, Queue A item 5: meshes and "
    "scale-out)"
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
    handlers: they write K/V into a slot arena in place."""

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
            att = torch.einsum("bhd,bshd->bhs", q, ck) * d ** -0.5
            visible = torch.arange(span, device=x.device)[None, None, :] <= idx[:, None, None]
            att = torch.softmax(att.masked_fill(~visible, -torch.inf), dim=-1)
            out = torch.einsum("bhs,bshd->bhd", att, cv)
        return self.proj(out.reshape(b, h * d))


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


class Block(nn.Module):
    """Pre-norm transformer block: LayerNorm → attention → residual,
    LayerNorm → Dense(gelu, exact) → Dense → residual. Each residual sum
    runs in the branch's (compute) dtype, as Keras's ``Add`` casts both
    inputs to it."""

    def __init__(self, d_model, num_heads, head_dim, mlp_ratio, dropout,
                 causal, rope, maxlen, seed=0):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.ln1 = FusedLayerNorm(d_model)
        self.attn = FlashMHA(d_model, num_heads, head_dim, causal, rope, maxlen)
        self.ln2 = FusedLayerNorm(d_model)
        self.mlp1 = Dense(d_model, hidden)
        self.mlp2 = Dense(hidden, d_model)
        # rate-0 dropout is elided, as in the reference
        if dropout > 0:
            self.drop1, self.drop2 = Dropout(dropout, seed), Dropout(dropout, seed + 1)
        else:
            self.drop1 = self.drop2 = nn.Identity()

    def forward(self, x, plain: bool = False):
        h = self.drop1(self.attn(self.ln1(x, plain=plain), plain=plain))
        return self.mlp(cast(x, h.dtype) + h, plain=plain)

    def mlp(self, x, plain: bool = False):
        """``x`` plus the MLP branch: LayerNorm → Dense(gelu) → Dense."""
        h = self.mlp2(F.gelu(self.mlp1(self.ln2(x, plain=plain))))
        return x + self.drop2(h)


class _Transformer(nn.Module):
    """Embedding (+ sinusoidal positions unless rope) → blocks → final
    LayerNorm; the subclasses add the head."""

    def __init__(self, vocab_size, maxlen, d_model, num_heads, num_layers,
                 mlp_ratio, dropout, causal, rope, seed):
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
            Block(d_model, num_heads, head_dim, mlp_ratio, dropout, causal,
                  rope, maxlen, seed=2 * (seed * num_layers + i))
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

        def norm(prefix: str, ln: FusedLayerNorm):
            paths[f"{prefix}/gamma"] = (ln.gamma, None)
            paths[f"{prefix}/beta"] = (ln.beta, None)

        for i, blk in enumerate(self.blocks):
            norm(f"blk{i}_ln1", blk.ln1)
            paths.update(dense_paths(f"blk{i}_attn/qkv", blk.attn.qkv))
            paths.update(dense_paths(f"blk{i}_attn/proj", blk.attn.proj))
            norm(f"blk{i}_ln2", blk.ln2)
            paths.update(dense_paths(f"blk{i}_mlp1", blk.mlp1))
            paths.update(dense_paths(f"blk{i}_mlp2", blk.mlp2))
        norm("final_ln", self.final_ln)
        for head in ("lm_head", "head"):
            if hasattr(self, head):
                paths.update(dense_paths(head, getattr(self, head)))
        return paths


class TransformerLM(_Transformer):
    """Decoder-only causal LM: ``[B, S]`` int tokens → ``[B, S, vocab]``
    fp32 logits (the ``lm_head`` is float32 under every policy)."""

    def __init__(self, vocab_size, maxlen, d_model, num_heads, num_layers,
                 mlp_ratio, dropout, rope, seed):
        super().__init__(vocab_size, maxlen, d_model, num_heads, num_layers,
                         mlp_ratio, dropout, True, rope, seed)
        self.lm_head = Dense(d_model, vocab_size, keep_float32=True)

    def forward(self, tokens, plain: bool = False):
        return self.lm_head(self.features(tokens, plain=plain))


class TransformerClassifier(_Transformer):
    """Encoder-stack classifier: ``[B, S]`` int tokens → ``[B, classes]``
    probabilities (sigmoid for one class, softmax otherwise), as the
    reference's model outputs them: the mean over the sequence in the
    compute dtype, then the float32 ``head``."""

    def __init__(self, vocab_size, maxlen, num_classes, d_model, num_heads,
                 num_layers, mlp_ratio, dropout, seed):
        super().__init__(vocab_size, maxlen, d_model, num_heads, num_layers,
                         mlp_ratio, dropout, False, False, seed)
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
        maxlen, num_classes, d_model, num_heads, num_layers, mlp_ratio, dropout,
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
        vocab_size, maxlen, d_model, num_heads, num_layers, mlp_ratio, dropout, rope,
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
    (:mod:`elephas_tpu_torch.serving`): a :func:`transformer_lm` module
    whose every ``FlashMHA`` is causal and that computes in float32 (the
    reference reads the policy's compute dtype: a ``mixed_bfloat16``
    model, whose variables are float32, is refused).
    Returns the attention layers as ``[(name, FlashMHA)]`` by their Keras
    names (``blk{i}_attn``); raises ``ValueError`` (messages prefixed
    ``what``, suffixed ``hint``, as the reference words them) otherwise."""
    if not isinstance(model, _Transformer):
        raise ValueError(
            f"{what} needs a transformer_lm module (token embedding, FlashMHA "
            f"blocks, final LayerNorm), got {type(model).__name__}; {hint} for "
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


def _generate_cached(model, prompt, b, p, steps, temperature, top_k, top_p, seed):
    """KV-cache decode (reference ``_generate_cached``): prompt and
    continuation run one token a step through the decode step of the
    serving arena, every row at position ``t``; prompt positions keep
    their token, and only generated positions sample (and advance the
    generator), as in the recomputing path."""
    # the serving package imports this module: import it at call time
    from elephas_tpu_torch.serving.kv_cache import SlotKVCache, token_decode_step

    layers = validate_token_decode_model(model, "kv_cache decode", "use kv_cache=False")
    dev = model.device
    maxlen = int(model.maxlen)
    cache = SlotKVCache(layers, b, maxlen, dev)
    tokens = torch.zeros(b, maxlen, dtype=torch.long, device=dev)
    tokens[:, :p] = torch.from_numpy(prompt.astype(np.int64))
    generator = torch.Generator(device=dev).manual_seed(seed)
    buckets = span_buckets(maxlen)
    for t in range(p + steps - 1):
        positions = torch.full((b,), t, dtype=torch.int32, device=dev)
        logits = token_decode_step(model, tokens[:, t], positions, cache,
                                   span=span_bucket_for(t + 1, buckets))
        if t + 1 >= p:
            tokens[:, t + 1] = _sample_logits(logits, generator, temperature, top_k, top_p)
    return tokens[:, : p + steps].to(torch.int32).cpu().numpy()


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
    """Autoregressive sampling from a :func:`transformer_lm` model.

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

    ``mesh``, ``batch_axes``, ``model_axis`` and ``rules`` are the
    reference's mesh-aware decode: accepted at their defaults (no mesh),
    any other value raises ``NotImplementedError``."""
    for name, value, neutral in (("mesh", mesh, None), ("batch_axes", batch_axes, ("data",)),
                                 ("model_axis", model_axis, None), ("rules", rules, None)):
        if not _is_neutral(value, neutral):
            raise NotImplementedError(_MESH_TODO.format(f"{name}={value!r}"))
    prompt, b, p, maxlen, _vocab = _validate_decode_args(
        model, prompt, steps, top_k, top_p
    )
    if kv_cache:
        return _generate_cached(model, prompt, b, p, steps, temperature, top_k, top_p, seed)
    dev = model.device
    tokens = torch.zeros(b, maxlen, dtype=torch.long, device=dev)
    tokens[:, :p] = torch.from_numpy(prompt.astype(np.int64))
    generator = torch.Generator(device=dev).manual_seed(seed)
    for t in range(p, p + steps):
        logits = model(tokens)
        tokens[:, t] = _sample_logits(
            logits[:, t - 1], generator, temperature, top_k, top_p
        )
    return tokens[:, : p + steps].to(torch.int32).cpu().numpy()
