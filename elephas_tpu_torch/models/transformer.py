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
- :func:`generate` — autoregressive sampling, recomputing the fixed
  ``maxlen`` sequence every step.

The modules keep the reference's layer names, so Keras weights load by
path (:func:`elephas_tpu_torch.utils.weights.load_keras_weights`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.device import resolve_device
from elephas_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_qkv,
    flash_forward_reference,
)
from elephas_tpu_torch.ops.layer_norm import layer_norm, layer_norm_forward_reference
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import (
    binary_crossentropy,
    compile_model,
    sparse_categorical_crossentropy,
)

_BF16_TODO = (
    "dtype_policy={!r} is not ported yet: the port trains and serves "
    "float32 (ROADMAP.md, Queue A item 2: the mixed_bfloat16 policy follows "
    "the float32 training slice)"
)
_KV_CACHE_TODO = (
    "generate(kv_cache=True) is not ported yet (ROADMAP.md, Queue A item 1: "
    "cached decode and the InferenceEngine)"
)


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
    against."""

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
        self.qkv = nn.Linear(d_model, 3 * num_heads * head_dim, bias=False)
        self.proj = nn.Linear(num_heads * head_dim, d_model)
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


class FusedLayerNorm(nn.Module):
    """LayerNormalization over the last axis (Keras's math: f32
    statistics, affine ``gamma``/``beta``), through the LayerNorm kernels.
    ``plain=True`` in :meth:`forward` runs the kernels' plain version
    instead, differentiated by autograd — the reference a run on the card
    is checked against."""

    def __init__(self, d_model: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)
        self.gamma = nn.Parameter(torch.ones(d_model))
        self.beta = nn.Parameter(torch.zeros(d_model))

    def forward(self, x, plain: bool = False):
        if plain:
            d = x.shape[-1]
            y = layer_norm_forward_reference(x.reshape(-1, d), self.gamma, self.beta,
                                             self.epsilon)[0]
            return y.reshape(x.shape)
        return layer_norm(x, self.gamma, self.beta, self.epsilon)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from its own ``torch.Generator``,
    seeded from the builder's seed. It draws other bits than Keras's
    dropout from the same seed: the same in distribution, not bit for
    bit."""

    def __init__(self, rate: float, seed: int):
        super().__init__()
        self.rate = float(rate)
        self.seed = int(seed)
        self._generator = None

    def forward(self, x):
        if not self.training:
            return x
        if self._generator is None or self._generator.device != x.device:
            self._generator = torch.Generator(device=x.device).manual_seed(self.seed)
        keep = torch.rand(x.shape, generator=self._generator, device=x.device) >= self.rate
        return x * keep / (1.0 - self.rate)


class Block(nn.Module):
    """Pre-norm transformer block: LayerNorm → attention → residual,
    LayerNorm → Dense(gelu, exact) → Dense → residual."""

    def __init__(self, d_model, num_heads, head_dim, mlp_ratio, dropout,
                 causal, rope, maxlen, seed=0):
        super().__init__()
        hidden = int(d_model * mlp_ratio)
        self.ln1 = FusedLayerNorm(d_model)
        self.attn = FlashMHA(d_model, num_heads, head_dim, causal, rope, maxlen)
        self.ln2 = FusedLayerNorm(d_model)
        self.mlp1 = nn.Linear(d_model, hidden)
        self.mlp2 = nn.Linear(hidden, d_model)
        # rate-0 dropout is elided, as in the reference
        if dropout > 0:
            self.drop1, self.drop2 = Dropout(dropout, seed), Dropout(dropout, seed + 1)
        else:
            self.drop1 = self.drop2 = nn.Identity()

    def forward(self, x, plain: bool = False):
        x = x + self.drop1(self.attn(self.ln1(x, plain=plain), plain=plain))
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

    def features(self, tokens, plain: bool = False):
        x = self.tok_embed(tokens)
        if self.positions is not None:
            x = x + self.positions[: tokens.shape[1]]
        for block in self.blocks:
            x = block(x, plain=plain)
        return self.final_ln(x, plain=plain)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.weight.device


class TransformerLM(_Transformer):
    """Decoder-only causal LM: ``[B, S]`` int tokens → ``[B, S, vocab]``
    fp32 logits."""

    def __init__(self, vocab_size, maxlen, d_model, num_heads, num_layers,
                 mlp_ratio, dropout, rope, seed):
        super().__init__(vocab_size, maxlen, d_model, num_heads, num_layers,
                         mlp_ratio, dropout, True, rope, seed)
        self.lm_head = nn.Linear(d_model, vocab_size)

    def forward(self, tokens, plain: bool = False):
        return self.lm_head(self.features(tokens, plain=plain))


class TransformerClassifier(_Transformer):
    """Encoder-stack classifier: ``[B, S]`` int tokens → ``[B, classes]``
    probabilities (sigmoid for one class, softmax otherwise), as the
    reference's model outputs them."""

    def __init__(self, vocab_size, maxlen, num_classes, d_model, num_heads,
                 num_layers, mlp_ratio, dropout, seed):
        super().__init__(vocab_size, maxlen, d_model, num_heads, num_layers,
                         mlp_ratio, dropout, False, False, seed)
        self.num_classes = num_classes
        self.head = nn.Linear(d_model, num_classes)

    def forward(self, tokens, plain: bool = False):
        logits = self.head(self.features(tokens, plain=plain).mean(dim=1))
        if self.num_classes == 1:
            return torch.sigmoid(logits)
        return torch.softmax(logits, dim=-1)


def _keras_init(model: nn.Module) -> None:
    """The reference's Keras initialisers: glorot-uniform Dense kernels,
    zero biases, uniform(±0.05) embeddings (LayerNorm is ones/zeros)."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            nn.init.xavier_uniform_(mod.weight)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            nn.init.uniform_(mod.weight, -0.05, 0.05)


def _build(cls, seed, dtype_policy, device, lr, loss, *args):
    """The module in eval mode on its device, compiled as the reference
    compiles its Keras model: ``Adam(lr)``, ``loss``, ``["accuracy"]``."""
    if dtype_policy not in (None, "float32"):
        raise NotImplementedError(_BF16_TODO.format(dtype_policy))
    dev = resolve_device(device)
    # weights from the seed alone, without touching the global generator
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = cls(*args, seed)
        _keras_init(model)
    model = model.to(dev).eval()
    return compile_model(model, Adam(model.parameters(), lr=lr), loss, ["accuracy"])


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
    (``cuda:0`` by default), compiled with Keras's ``Adam(lr)``, binary
    cross-entropy for one class (sparse categorical otherwise, on the
    softmax probabilities) and ``accuracy``."""
    loss = binary_crossentropy if num_classes == 1 else sparse_categorical_crossentropy
    return _build(
        TransformerClassifier, seed, dtype_policy, device, lr, loss, vocab_size,
        maxlen, num_classes, d_model, num_heads, num_layers, mlp_ratio, dropout,
    )


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
    default). ``rope=True`` uses rotary position embeddings in every
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
    ``logits[:, t - 1]`` and writes ``tokens[:, t]``. Runs on the
    model's device."""
    if kv_cache:
        raise NotImplementedError(_KV_CACHE_TODO)
    prompt, b, p, maxlen, _vocab = _validate_decode_args(
        model, prompt, steps, top_k, top_p
    )
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
