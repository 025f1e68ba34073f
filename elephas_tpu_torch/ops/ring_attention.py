"""Ring attention — sequence parallelism over a mesh axis.

Counterpart of ``elephas_tpu/ops/ring_attention.py``. The sequence axis of
``[bh, S, D]`` attention is cut into W shards, shard i on the mesh
device at position i of the axis. Each position keeps its query shard and
the K/V chunks rotate around the ring; each (query shard, K/V chunk) pair
runs the port's flash forward (``ops/flash_attention.py``
``_flash_forward``: the CUDA kernel on the card, its plain version on the
CPU), which returns the chunk's output and lse, and the partials merge by
log-sum-exp (:func:`_merge`). Causality across shards uses global
positions: the diagonal chunk runs causal, an earlier chunk runs
unmasked, and a later chunk is skipped (a zero output with lse
``NEG_INF``, which the merge leaves without weight).

The reference runs this inside ``shard_map`` with a ``lax.ppermute`` to
the next device a step; the port runs it single-controller: one process
holds every shard, and the rotation is a ``.to(next_device,
non_blocking=True)`` copy a chunk a step, no copy where the ring's
positions share a device (a mesh of ``cuda:0`` W times runs W shards on
one card).

The backward (:class:`_RingAttention`) is the reference's second ring
pass (``_ring_backward``) in plain PyTorch, as the port's
``flash_backward`` is plain: the dK/dV accumulators rotate with their
chunks and land home after W steps.
"""

from __future__ import annotations

import torch

from elephas_tpu_torch.ops.flash_attention import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    NEG_INF,
    _flash_forward,
)


def _merge(o1, lse1, o2, lse2):
    """Merge two attention partials by log-sum-exp of their normalizers."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2 * w2, lse


def _rotate(chunks: list, devices: list) -> list:
    """One ring step: position i receives position i-1's chunk
    (``ppermute`` to the next device)."""
    w = len(chunks)
    return [chunks[(i - 1) % w].to(devices[i], non_blocking=True) for i in range(w)]


def _chunk(q, kc, vc, scale, causal, block_q, block_k):
    """One (query shard, K/V chunk) pair through the flash forward:
    ``[bh, Sq, D]`` → (out ``[bh, Sq, D]``, lse ``[bh, Sq]`` f32)."""
    out, lse = _flash_forward(q[:, None], kc[:, None], vc[:, None], scale, causal,
                              min(block_q, q.shape[1]), min(block_k, kc.shape[1]))
    return out[:, 0], lse


def _ring_forward(qs, ks, vs, causal, scale, block_q, block_k):
    """``(outs, lses)`` a position: each query shard against every K/V
    chunk as the chunks rotate, merged by lse."""
    w = len(qs)
    devices = [q.device for q in qs]
    f32 = torch.float32
    os_ = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
    lses = [torch.full(q.shape[:2], NEG_INF, dtype=f32, device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for t in range(w):
        for me in range(w):
            src = (me - t) % w
            q = qs[me]
            if causal and src > me:
                # a chunk wholly in the future: no work, no weight
                oc = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
                lsec = torch.full(q.shape[:2], NEG_INF, dtype=f32, device=q.device)
            else:
                oc, lsec = _chunk(q, kc[me], vc[me], scale, causal and src == me,
                                  block_q, block_k)
            os_[me], lses[me] = _merge(os_[me], lses[me], oc.float(), lsec)
        if t + 1 < w:
            kc, vc = _rotate(kc, devices), _rotate(vc, devices)
    return [o.to(q.dtype) for o, q in zip(os_, qs)], lses


def _chunk_grads(q, kc, vc, g, lse, delta, scale, mask):
    """Flash-backward recurrences for one (query shard × K/V chunk) pair.

    ``lse``/``delta`` are the *global* log-sum-exp and rowsum(dO∘O) of the
    local query rows, so each chunk's probabilities ``exp(s − lse)`` are
    the exact global attention weights. ``mask`` is the ``[Sq, Sk]``
    validity mask (None: all valid)."""
    f32 = torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(f32), kc.to(f32)) * scale
    if mask is not None:
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    # a row whose global lse is NEG_INF (every position masked) would
    # otherwise get p = exp(NEG_INF - NEG_INF) = 1
    p = torch.where(lse[..., None] <= NEG_INF * 0.5, torch.zeros_like(p), p)
    dp = torch.einsum("bqd,bkd->bqk", g.to(f32), vc.to(f32))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, kc.to(f32)) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(f32)) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, g.to(f32))
    return dq, dk, dv


def _ring_backward(qs, ks, vs, outs, lses, gs, causal, scale):
    """``(dqs, dks, dvs)`` a position: the second ring pass, the dK/dV
    accumulators travelling with their chunks."""
    w = len(qs)
    devices = [q.device for q in qs]
    f32 = torch.float32
    s_local = qs[0].shape[1]
    deltas = [(g.to(f32) * o.to(f32)).sum(dim=-1) for g, o in zip(gs, outs)]
    dqs = [torch.zeros(q.shape, dtype=f32, device=q.device) for q in qs]
    dk_rot = [torch.zeros(k.shape, dtype=f32, device=k.device) for k in ks]
    dv_rot = [torch.zeros(v.shape, dtype=f32, device=v.device) for v in vs]
    kc, vc = list(ks), list(vs)
    for t in range(w):
        for me in range(w):
            src = (me - t) % w
            mask = None
            if causal:
                rows = torch.arange(s_local, device=devices[me])[:, None] + me * s_local
                cols = torch.arange(s_local, device=devices[me])[None, :] + src * s_local
                mask = rows >= cols
            dq_c, dk_c, dv_c = _chunk_grads(qs[me], kc[me], vc[me], gs[me], lses[me],
                                            deltas[me], scale, mask)
            dqs[me] = dqs[me] + dq_c
            dk_rot[me] = dk_rot[me] + dk_c
            dv_rot[me] = dv_rot[me] + dv_c
        # the chunks and their accumulators travel together; after W steps
        # the accumulators are back on the chunk's home position
        kc, vc = _rotate(kc, devices), _rotate(vc, devices)
        dk_rot, dv_rot = _rotate(dk_rot, devices), _rotate(dv_rot, devices)
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)],
            [d.to(k.dtype) for d, k in zip(dk_rot, ks)],
            [d.to(v.dtype) for d, v in zip(dv_rot, vs)])


class _RingAttention(torch.autograd.Function):
    """The ring over W positions: inputs ``(*qs, *ks, *vs)``, outputs the W
    output shards."""

    @staticmethod
    def forward(ctx, w, causal, scale, block_q, block_k, *shards):
        qs, ks, vs = shards[:w], shards[w:2 * w], shards[2 * w:]
        outs, lses = _ring_forward(qs, ks, vs, causal, scale, block_q, block_k)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.w, ctx.causal, ctx.scale = w, causal, scale
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        w = ctx.w
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * w:(i + 1) * w] for i in range(5))
        gs = [g if g is not None else torch.zeros_like(o) for g, o in zip(grads, outs)]
        dqs, dks, dvs = _ring_backward(qs, ks, vs, outs, lses, gs, ctx.causal, ctx.scale)
        return (None, None, None, None, None, *dqs, *dks, *dvs)


def ring_attention(
    qs,
    ks,
    vs,
    causal: bool = False,
    scale: float | None = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
):
    """Sequence-parallel attention over the ring's W positions (the
    reference's per-shard ``ring_attention``, single-controller).

    ``qs``/``ks``/``vs``: lists of the W local shards ``[bh, S_local, D]``
    in ring order, each on its position's device. Returns the list of
    output shards ``[bh, S_local, D]``, each on its position's device.
    Differentiable (the ring-pass backward)."""
    w = len(qs)
    if not w or len(ks) != w or len(vs) != w:
        raise ValueError(f"the ring needs as many q, k and v shards, got "
                         f"{len(qs)}, {len(ks)}, {len(vs)}")
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    return list(_RingAttention.apply(w, bool(causal), float(scale), int(block_q),
                                     int(block_k), *qs, *ks, *vs))


def shard_sequence(x, devices, axis: int):
    """``x`` cut into ``len(devices)`` equal pieces along ``axis``, piece i
    on ``devices[i]``."""
    w = len(devices)
    if x.shape[axis] % w:
        raise ValueError(f"sequence length {x.shape[axis]} does not split over {w} shards")
    return [piece.to(dev, non_blocking=True).contiguous()
            for piece, dev in zip(x.chunk(w, dim=axis), devices)]


def ring_attention_sharded(
    q,
    k,
    v,
    mesh,
    axis_name: str = "workers",
    causal: bool = False,
    scale: float | None = None,
):
    """Whole-array wrapper: shards the sequence axis of ``[bh, S, D]``
    inputs over ``mesh``'s ``axis_name`` (a
    :class:`~elephas_tpu_torch.parallel.mesh.Mesh`), runs
    :func:`ring_attention`, and returns ``[bh, S, D]`` on q's device."""
    devices = mesh.axis_devices(axis_name)
    outs = ring_attention(shard_sequence(q, devices, 1), shard_sequence(k, devices, 1),
                          shard_sequence(v, devices, 1), causal=causal, scale=scale)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
