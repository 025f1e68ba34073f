"""Ulysses sequence parallelism — all-to-all head↔sequence resharding.

Counterpart of ``elephas_tpu/ops/ulysses.py``. Tokens arrive
sequence-sharded, ``[B, H, S/W, D]`` a position; one all-to-all of the
stacked q/k/v trades the sequence split for a head split (``[B, H/W, S,
D]`` a position: all of the sequence for heads ``[j·H/W, (j+1)·H/W)`` at
position j), every position runs the port's flash attention over its head
group (the CUDA forward on the card, with its autograd backward), and the
inverse all-to-all restores the sequence split. ``num_heads % W == 0`` is
required; ring attention (:mod:`elephas_tpu_torch.ops.ring_attention`)
has no head constraint.

The reference runs this inside ``shard_map`` with ``lax.all_to_all``; the
port runs it single-controller, the all-to-all being ``.to(device,
non_blocking=True)`` copies of the pieces between the positions' devices
(a pure re-layout where the positions share a device). It is
differentiable end to end with no custom backward: the copies and
concatenations carry their own.
"""

from __future__ import annotations

import torch

from elephas_tpu_torch.ops.flash_attention import flash_attention
from elephas_tpu_torch.ops.ring_attention import shard_sequence


def _check_heads(h: int, w: int) -> None:
    if h % w:
        raise ValueError(
            f"Ulysses needs num_heads ({h}) divisible by the sequence "
            f"axis size ({w}) — use ring attention for odd head counts"
        )


def _all_to_all(shards: list, split_axis: int, concat_axis: int) -> list:
    """``lax.all_to_all(tiled=True)`` over the positions: position j
    receives piece j of every position's ``split_axis``, concatenated along
    ``concat_axis`` in position order, on its own device."""
    w = len(shards)
    pieces = [s.chunk(w, dim=split_axis) for s in shards]
    return [torch.cat([pieces[i][j].to(shards[j].device, non_blocking=True)
                       for i in range(w)], dim=concat_axis)
            for j in range(w)]


def ulysses_attention(
    qs,
    ks,
    vs,
    causal: bool = False,
    scale: float | None = None,
):
    """Sequence-parallel attention over W positions (the reference's
    per-shard ``ulysses_attention``, single-controller).

    ``qs``/``ks``/``vs``: lists of the W local shards ``[B, H, S_local,
    D]`` (the sequence axis sharded, heads whole), each on its position's
    device. Returns the list of output shards ``[B, H, S_local, D]``."""
    w = len(qs)
    _check_heads(qs[0].shape[1], w)
    # ONE stacked all-to-all of q/k/v: [3, B, H, S/W, D] -> [3, B, H/W, S, D]
    heads = _all_to_all([torch.stack((q, k, v)) for q, k, v in zip(qs, ks, vs)],
                        split_axis=2, concat_axis=3)
    outs = [flash_attention(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale)
            for qkv in heads]
    # [B, H/W, S, D] -> [B, H, S/W, D]: the sequence split again
    return _all_to_all(outs, split_axis=2, concat_axis=1)


def ulysses_attention_sharded(
    q,
    k,
    v,
    mesh,
    axis_name: str = "workers",
    causal: bool = False,
    scale: float | None = None,
):
    """Whole-array wrapper: shards the sequence axis of ``[B, H, S, D]``
    inputs over ``mesh``'s ``axis_name``, runs :func:`ulysses_attention`,
    and returns ``[B, H, S, D]`` on q's device."""
    devices = mesh.axis_devices(axis_name)
    _check_heads(q.shape[1], len(devices))
    outs = ulysses_attention(shard_sequence(q, devices, 2), shard_sequence(k, devices, 2),
                             shard_sequence(v, devices, 2), causal=causal, scale=scale)
    return torch.cat([o.to(q.device) for o in outs], dim=2)
