"""Mixture-of-Experts FFN: top-k capacity routing and the expert products.

Counterpart of ``elephas_tpu/ops/moe.py`` on one device. Tokens are
routed top-1 (Switch) or top-k (GShard) to ``E`` experts, each of which
takes at most ``capacity`` tokens; the tokens past it are dropped (their
output is zero, and the residual around the layer carries them). The
Switch load-balance loss ``E · Σ_e f_e · P_e`` comes with the routing.

Two routes compute the same function:

- :func:`_topk_dispatch` and :func:`moe_ffn_reference` are the **plain
  versions**: the reference's dense one-hot ``dispatch`` / ``combine``
  tensors ``[T, E, C]`` and its einsums, line for line. They are the
  oracle of the tests and of the card's checks. Since ``C`` grows with
  ``T``, their size grows as ``T²`` (12.9 GB each at 32,768 tokens of
  T's training batch), so the main path never runs them.
- :func:`moe_ffn` is the **main path**: it routes by index. Each choice's
  expert and its place in that expert's queue are ``[T]`` int32 vectors
  (:func:`topk_route`); the tokens are copied into the rows of an ``[E·C +
  1, D]`` buffer whose last row takes the dropped ones; the experts run as
  two batched products over ``[E, C, D]``; each token gathers its ``k``
  output rows back, weighted by its gates. Its shapes follow from ``T`` and
  ``capacity`` alone, host values, so it makes no host synchronisation
  and no shape that depends on the data.

The routing semantics are the reference's, bit for bit in the integers:
routing runs in int32 whatever the activation dtype; top-k is an
iterative argmax (ties to the first index), each pick masked by
multiplying with ``1 − one_hot``; for ``k > 1`` the gates are renormalised
by ``max(Σ, 1e-9)``; every routed token of a choice, kept or dropped,
advances its expert's queue, so the second choices queue behind all the
first choices; the aux loss takes ``f`` from the first choice only. The
capacity is ``max(1, int(k·T·cf/E))`` in Python floats, on the host
(:func:`capacity_for`).

:func:`expert_parallel_ffn` (experts sharded over a process group, the
reference's ``lax.all_to_all`` route) is not ported yet.
"""

from __future__ import annotations

import functools

import torch
from torch.nn import functional as F

# the ops' default activation, jax.nn.gelu's: the tanh approximation (the
# Keras layer's "gelu" is the exact one, which MoeFFN passes)
gelu_tanh = functools.partial(F.gelu, approximate="tanh")

_EP_TODO = (
    "expert_parallel_ffn is not ported yet (ROADMAP.md, Queue A item 5: expert "
    "parallelism over a process group)"
)


def check_k(k: int, num_experts: int) -> None:
    """The reference's refusal of more routing choices than experts."""
    if k > num_experts:
        raise ValueError(f"k={k} routing choices exceed num_experts={num_experts}")


def capacity_for(tokens: int, num_experts: int, capacity_factor: float, k: int = 1) -> int:
    """Slots an expert has for ``tokens`` routed tokens: ``max(1, int(k ·
    tokens · capacity_factor / num_experts))``, in Python floats as the
    reference computes it (``elephas_tpu/models/switch.py:98-101``)."""
    return max(1, int(k * tokens * capacity_factor / num_experts))


def _one_hot(index, n: int, dtype):
    """``one_hot(index, n)`` by comparison with ``arange(n)``: unlike
    ``F.one_hot`` on the CPU, it reads no value of ``index`` on the host."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def _router_probs(x, gate_w):
    """``softmax(x @ gate_w)`` in the two operands' promoted dtype (a bf16
    ``x`` against a float32 gate routes in float32, as jnp promotes)."""
    dtype = torch.promote_types(x.dtype, gate_w.dtype)
    return torch.softmax(x.to(dtype) @ gate_w.to(dtype), dim=-1)


def _choose(probs, num_experts: int, k: int):
    """The reference's iterative top-k: ``k`` ``[T]`` expert ids (argmax,
    ties to the first index, each pick masked by multiplying with ``1 −
    one_hot``) and their gates (:func:`_gates`)."""
    choices = []
    masked = probs
    for _ in range(k):
        expert = torch.argmax(masked, dim=-1)
        choices.append(expert)
        masked = masked * (1.0 - _one_hot(expert, num_experts, probs.dtype))
    return choices, _gates(probs, choices)


def _gates(probs, choices):
    """Each choice's raw probability; with more than one choice,
    renormalised by ``max(Σ, 1e-9)``."""
    gates = [torch.gather(probs, 1, expert[:, None])[:, 0] for expert in choices]
    if len(choices) > 1:
        denom = sum(gates)
        gates = [g / torch.clamp(denom, min=1e-9) for g in gates]
    return gates


def _aux_loss(probs, first, num_experts: int):
    """``E · Σ_e f_e · P_e``: ``f`` the share of first choices, ``P`` the
    mean router probability."""
    f = _one_hot(first, num_experts, probs.dtype).mean(dim=0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def _topk_dispatch(x, gate_w, num_experts: int, capacity: int, k: int = 1):
    """The plain routing tensors, the reference's dense one-hot form:
    ``(dispatch [T, E, C], combine [T, E, C], aux)``. ``dispatch`` is in
    ``x``'s dtype; ``combine`` in the promoted dtype of ``x`` and the
    gates, as jnp promotes ``dispatch · gate``."""
    check_k(k, num_experts)
    probs = _router_probs(x, gate_w)
    choices, gates = _choose(probs, num_experts, k)
    t = x.shape[0]
    dispatch = torch.zeros(t, num_experts, capacity, dtype=x.dtype, device=x.device)
    combine = torch.zeros(t, num_experts, capacity,
                          dtype=torch.promote_types(x.dtype, probs.dtype), device=x.device)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=x.device)
    for expert, gate in zip(choices, gates):
        onehot = _one_hot(expert, num_experts, torch.int32)  # [T, E]
        position = (torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot - onehot
                    + counts[None, :] * onehot)
        kept = (position < capacity) & (onehot > 0)
        rank = torch.sum(torch.where(kept, position, 0), dim=-1, dtype=torch.int32)
        pos_onehot = _one_hot(rank, capacity, x.dtype)  # [T, C]
        keep_mask = torch.any(kept, dim=-1).to(x.dtype)
        d = onehot.to(x.dtype)[:, :, None] * pos_onehot[:, None, :] * keep_mask[:, None, None]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        counts = counts + torch.sum(onehot, dim=0, dtype=torch.int32)
    return dispatch, combine, _aux_loss(probs, choices[0], num_experts)


def _top1_dispatch(x, gate_w, num_experts: int, capacity: int):
    """Switch top-1 routing: ``(dispatch, combine)``."""
    dispatch, combine, _ = _topk_dispatch(x, gate_w, num_experts, capacity, k=1)
    return dispatch, combine


def moe_ffn_reference(x, gate_w, w1, b1, w2, b2, capacity_factor: float = 1.25,
                      activation=gelu_tanh, num_shards: int = 1, k: int = 1,
                      return_aux: bool = False):
    """The plain MoE FFN over ``x`` ``[T, D]``: dense routing tensors and the
    reference's einsums. ``num_shards`` routes each of that many equal
    token shards with its own capacity (the reference's expert-parallel
    split); with ``return_aux`` also the aux loss averaged over shards."""
    e_total = gate_w.shape[-1]
    outs, auxes = [], []
    for xs in torch.chunk(x, num_shards, dim=0):
        capacity = capacity_for(xs.shape[0], e_total, capacity_factor, k)
        dispatch, combine, aux = _topk_dispatch(xs, gate_w, e_total, capacity, k=k)
        auxes.append(aux)
        expert_inputs = torch.einsum("td,tec->ecd", xs, dispatch)
        h = activation(torch.einsum("ecd,edh->ech", expert_inputs, w1) + b1[:, None, :])
        out = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
        outs.append(torch.einsum("ecd,tec->td", out, combine))
    result = torch.cat(outs, dim=0)
    if return_aux:
        return result, sum(auxes) / len(auxes)
    return result


def topk_route(x, gate_w, num_experts: int, capacity: int, k: int = 1):
    """The main path's routing: ``(experts, positions, gates, probs)`` with
    ``experts`` and ``positions`` ``[k, T]`` int32 (each choice's expert
    and its 0-based place in that expert's queue; kept iff ``positions <
    capacity``), ``gates`` ``[k, T]`` and the router's ``probs`` ``[T, E]``.

    The queue places are one int32 cumulative sum over the ``[k·T, E]``
    one-hot of the choices in choice-major order: a token's place counts
    every earlier token of its choice and every token of the earlier
    choices routed to the same expert, kept or not, as the reference's
    ``counts`` does."""
    check_k(k, num_experts)
    probs = _router_probs(x, gate_w)
    choices, gates = _choose(probs, num_experts, k)
    experts = torch.stack(choices).to(torch.int32)  # [k, T]
    flat = experts.reshape(-1).long()
    queue = torch.cumsum(_one_hot(flat, num_experts, torch.int32), dim=0, dtype=torch.int32)
    positions = torch.gather(queue, 1, flat[:, None])[:, 0] - 1
    return experts, positions.view_as(experts), torch.stack(gates), probs


def moe_ffn(x, gate_w, w1, b1, w2, b2, capacity: int, k: int = 1, activation=gelu_tanh,
            return_aux: bool = False):
    """The MoE FFN of ``x`` ``[T, D]`` routed by index (the main path):
    :func:`topk_route`, the tokens copied into the rows ``e·C + place`` of
    an ``[E·C + 1, D]`` buffer (the last row the sink of dropped tokens),
    ``activation(x @ w1 + b1) @ w2 + b2`` as two batched products over
    ``[E, C, D]``, then each token's ``k`` output rows gathered back (a
    dropped choice reads a zero row), weighted by its gates and summed in
    choice order. ``w1`` ``[E, D, H]``, ``b1`` ``[E, H]``, ``w2`` ``[E, H,
    D]``, ``b2`` ``[E, D]``; ``capacity`` a host int (:func:`capacity_for`).
    Equal to :func:`moe_ffn_reference` at that capacity within float
    rounding; with ``return_aux`` also the aux loss."""
    num_experts = gate_w.shape[-1]
    t, d = x.shape
    experts, positions, gates, probs = topk_route(x, gate_w, num_experts, capacity, k)
    sink = num_experts * capacity
    rows = torch.where(positions < capacity, experts * capacity + positions, sink)
    rows = rows.reshape(-1).long()  # [k·T], choice-major
    buf = x.new_zeros(sink + 1, d).index_copy(0, rows, x.repeat(k, 1))
    expert_inputs = buf[:sink].view(num_experts, capacity, d)
    h = activation(torch.bmm(expert_inputs, w1) + b1[:, None, :])
    out = (torch.bmm(h, w2) + b2[:, None, :]).reshape(sink, d)
    picked = F.pad(out, (0, 0, 0, 1)).index_select(0, rows).view(k, t, d)
    weighted = picked * gates[:, :, None].to(picked.dtype)
    result = weighted[0]
    for j in range(1, k):
        result = result + weighted[j]
    if return_aux:
        return result, _aux_loss(probs, experts[0].long(), num_experts)
    return result


def init_moe_params(generator: torch.Generator, d_model: int, d_hidden: int,
                    num_experts: int, dtype=torch.float32, device=None):
    """``(gate_w, w1, b1, w2, b2)`` for ``num_experts`` experts, drawn from
    ``generator`` as the reference draws them (normal, scaled by
    ``sqrt(2 / fan_in)``; zero biases)."""
    device = generator.device if device is None else device
    scale1 = (2.0 / d_model) ** 0.5
    scale2 = (2.0 / d_hidden) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    return (
        normal(d_model, num_experts) * scale1,
        normal(num_experts, d_model, d_hidden) * scale1,
        torch.zeros(num_experts, d_hidden, dtype=dtype, device=device),
        normal(num_experts, d_hidden, d_model) * scale2,
        torch.zeros(num_experts, d_model, dtype=dtype, device=device),
    )


def expert_parallel_ffn(*args, **kwargs):
    """The reference's expert-parallel FFN (experts sharded over a mesh
    axis, tokens exchanged by all-to-all): not ported yet."""
    raise NotImplementedError(_EP_TODO)
