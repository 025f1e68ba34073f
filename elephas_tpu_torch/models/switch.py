"""Switch / GShard mixture-of-experts transformers.

Counterpart of ``elephas_tpu/models/switch.py``:

- :class:`MoeFFN` — the routed-experts feed-forward layer over
  :mod:`elephas_tpu_torch.ops.moe` (top-k routing with a capacity bound),
  adding the Switch load-balance loss ``aux_weight · aux`` in training
  mode (:func:`~elephas_tpu_torch.training.add_loss`, as Keras's
  ``add_loss`` does under ``training``);
- :class:`SwitchBlock` — the pre-norm block whose feed-forward part is a
  :class:`MoeFFN`;
- :func:`switch_transformer_lm` and :func:`switch_transformer_classifier`
  — the reference's builders, signatures and defaults, compiled as the
  reference compiles them and registered with the zoo, so that
  :meth:`SparkModel.save <elephas_tpu_torch.SparkModel.save>` /
  :func:`~elephas_tpu_torch.load_spark_model` rebuild them.

Their modules keep the reference's layer names and Keras layouts
(``blk{i}_moe/gate_kernel [D, E]``, ``expert_w1 [E, D, H]``, ``expert_b1
[E, H]``, ``expert_w2 [E, H, D]``, ``expert_b2 [E, D]``), so Keras weights
load by path and :func:`~elephas_tpu_torch.utils.weights.get_weights`
gives Keras's ``get_weights()`` list (the parameter server's wire).

The builders make the dense family's modules
(:class:`~elephas_tpu_torch.models.transformer.TransformerLM`,
:class:`~elephas_tpu_torch.models.transformer.TransformerClassifier`) over
Switch blocks. The LM trains through ``SparkModel``, decodes through
``generate`` (full and cached) and serves through the engine on every
arena and option, whose passes call each block's ``mlp``. Routing
capacity is computed from the tokens present in each call: the
recomputing ``generate`` routes ``B · maxlen`` tokens a step, the cached
one ``B``, the engine's prefill only its admitted rows' ``n · bucket``, a
chunk ``n · C``, a decode step every slot's row, idle slots included.
Where tokens drop, the outputs then depend on the path, and on these
populations, which differ from the reference engine's (it prefills
``num_slots · bucket`` rows); with enough capacity (``k · capacity_factor
≥ num_experts``) nothing drops and every path computes the same tokens.
Experts replicate per worker under data parallelism; expert parallelism
(``model_parallel``) is not ported yet (ROADMAP.md, Queue A item 5).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.nn import functional as F

from elephas_tpu_torch.models.layers import zoo_builder
from elephas_tpu_torch.models.transformer import (
    PreNormBlock,
    TransformerClassifier,
    TransformerLM,
    _build,
    attention_paths,
)
from elephas_tpu_torch.ops.moe import capacity_for, check_k, moe_ffn, moe_ffn_reference
from elephas_tpu_torch.training import (
    add_loss,
    binary_crossentropy,
    sparse_categorical_crossentropy,
)

# Keras's activation names → functions ("gelu" is exact, approximate=False)
ACTIVATIONS = {"gelu": F.gelu}
# the layer's weights, in Keras's order
WEIGHTS = ("gate_kernel", "expert_w1", "expert_b1", "expert_w2", "expert_b2")
# Keras's truncated normal draws within two standard deviations; this
# corrects its variance (VarianceScaling)
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(t: torch.Tensor, scale: float = 2.0) -> None:
    """Keras's ``VarianceScaling(scale, "fan_in", "truncated_normal")``:
    fan_in of an ``[E, D, H]`` kernel is ``D · E``, as Keras takes the
    leading axes for a receptive field."""
    fan_in = t.shape[-2] * math.prod(t.shape[:-2])
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


class MoeFFN(nn.Module):
    """Mixture-of-experts FFN: top-``k`` routed, capacity-bounded, with the
    Switch load-balance loss added in training mode. Input ``[B, S, D]`` or
    ``[T, D]``, output the same shape; dropped tokens (capacity overflow)
    output zero, so wrap the layer in a residual, as Switch does.

    The weights exist from construction when ``d_model`` is given (the
    builders give it), else at the first call, as Keras builds a layer.
    :meth:`forward` runs :func:`~elephas_tpu_torch.ops.moe.moe_ffn` (routing
    by index), or with ``plain=True`` the dense
    :func:`~elephas_tpu_torch.ops.moe.moe_ffn_reference`."""

    def __init__(self, num_experts: int, d_hidden: int, k: int = 2,
                 capacity_factor: float = 1.25, aux_weight: float = 1e-2,
                 activation: str = "gelu", d_model: int | None = None):
        super().__init__()
        check_k(k, num_experts)
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                             f"got {activation!r}")
        self.num_experts = int(num_experts)
        self.d_hidden = int(d_hidden)
        self.k = int(k)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        self.activation = activation
        for name in WEIGHTS:
            self.register_parameter(name, None)
        if d_model is not None:
            self.build(d_model)

    def build(self, d_model: int, device=None) -> None:
        """Make the weights with Keras's initialisers: glorot-uniform
        ``gate_kernel``, variance-scaled truncated-normal expert kernels,
        zero biases."""
        e, h = self.num_experts, self.d_hidden

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.gate_kernel = param(d_model, e)
        self.expert_w1, self.expert_b1 = param(e, d_model, h), param(e, h)
        self.expert_w2, self.expert_b2 = param(e, h, d_model), param(e, d_model)
        with torch.no_grad():
            nn.init.xavier_uniform_(self.gate_kernel)
            _variance_scaling_(self.expert_w1)
            _variance_scaling_(self.expert_w2)

    def weights(self):
        return tuple(getattr(self, name) for name in WEIGHTS)

    def forward(self, x, plain: bool = False):
        if self.gate_kernel is None:
            self.build(x.shape[-1], x.device)
        tokens = x.reshape(-1, x.shape[-1])
        act = ACTIVATIONS[self.activation]
        if plain:
            out, aux = moe_ffn_reference(tokens, *self.weights(), self.capacity_factor, act,
                                         k=self.k, return_aux=True)
        else:
            capacity = capacity_for(tokens.shape[0], self.num_experts, self.capacity_factor,
                                    self.k)
            out = moe_ffn(tokens, *self.weights(), capacity, self.k, act,
                          return_aux=self.training)
            if self.training:
                out, aux = out
        if self.training:
            add_loss(self.aux_weight * aux)
        return out.reshape(x.shape)

    def keras_paths(self, prefix: str) -> dict:
        return {f"{prefix}/{name}": (getattr(self, name), None) for name in WEIGHTS}


class SwitchBlock(PreNormBlock):
    """The Switch block: pre-norm attention, then a :class:`MoeFFN` as the
    feed-forward part (``blk{i}_moe``)."""

    def __init__(self, d_model, num_heads, head_dim, dropout, causal, rope, maxlen, seed=0,
                 *, num_experts, expert_hidden, k, capacity_factor, aux_weight):
        super().__init__(d_model, num_heads, head_dim, dropout, causal, rope, maxlen, seed)
        self.moe = MoeFFN(num_experts, expert_hidden, k=k, capacity_factor=capacity_factor,
                          aux_weight=aux_weight, d_model=d_model)

    def ffn(self, x, plain: bool = False):
        return self.moe(x, plain=plain)

    def keras_paths(self, name: str) -> dict:
        return {**attention_paths(name, self), **self.moe.keras_paths(f"{name}_moe")}


def _switch_blocks(d_model, num_experts, expert_hidden, k, capacity_factor, aux_weight):
    """The block factory of a Switch model (``expert_hidden`` ``4 ·
    d_model`` unless given)."""
    return functools.partial(SwitchBlock, num_experts=num_experts,
                             expert_hidden=expert_hidden or 4 * d_model, k=k,
                             capacity_factor=capacity_factor, aux_weight=aux_weight)


@zoo_builder
def switch_transformer_lm(
    vocab_size: int = 20000,
    maxlen: int = 128,
    d_model: int = 128,
    num_heads: int = 4,
    num_layers: int = 2,
    num_experts: int = 4,
    expert_hidden: int | None = None,
    k: int = 2,
    capacity_factor: float = 1.5,
    aux_weight: float = 1e-2,
    dropout: float = 0.0,
    lr: float = 1e-3,
    seed: int = 0,
    rope: bool = False,
    device=None,
):
    """Causal decoder LM whose blocks' feed-forward parts are ``num_experts``
    routed experts of ``expert_hidden`` units (``4 · d_model`` by default),
    top-``k``, in eval mode on ``device`` (``cuda:0`` by default).
    ``rope=True`` rotates the attention heads instead of adding the
    sinusoidal table. Compiled with Keras's ``Adam(lr)``, sparse
    categorical cross-entropy from the logits and ``accuracy``; training
    adds ``aux_weight`` times each layer's load-balance loss. Capacity and
    the paths it makes differ on: see the module's docstring."""
    check_k(k, num_experts)
    return _build(
        TransformerLM, seed, None, device, lr,
        functools.partial(sparse_categorical_crossentropy, from_logits=True),
        vocab_size, maxlen, d_model, num_heads, num_layers,
        _switch_blocks(d_model, num_experts, expert_hidden, k, capacity_factor, aux_weight),
        dropout, rope,
    )


@zoo_builder
def switch_transformer_classifier(
    vocab_size: int = 20000,
    maxlen: int = 128,
    num_classes: int = 2,
    d_model: int = 128,
    num_heads: int = 4,
    num_layers: int = 2,
    num_experts: int = 4,
    expert_hidden: int | None = None,
    k: int = 2,
    capacity_factor: float = 1.5,
    aux_weight: float = 1e-2,
    dropout: float = 0.1,
    lr: float = 1e-3,
    seed: int = 0,
    device=None,
):
    """Transformer encoder classifier whose blocks' feed-forward parts are
    routed experts, in eval mode on ``device`` (``cuda:0`` by default).
    Compiled with Keras's ``Adam(lr)``, binary cross-entropy for one class
    (sparse categorical otherwise, on the softmax probabilities) and
    ``accuracy``; training adds the layers' load-balance losses."""
    check_k(k, num_experts)
    loss = binary_crossentropy if num_classes == 1 else sparse_categorical_crossentropy
    return _build(
        TransformerClassifier, seed, None, device, lr, loss, vocab_size, maxlen,
        num_classes, d_model, num_heads, num_layers,
        _switch_blocks(d_model, num_experts, expert_hidden, k, capacity_factor, aux_weight),
        dropout,
    )
