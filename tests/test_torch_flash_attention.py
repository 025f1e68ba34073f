"""The port's flash attention (``elephas_tpu_torch.ops.flash_attention``)
against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as the JAX package's own tests run it here) and through
the port's CPU path (the kernel's plain version). fp32 tolerance 1e-5:
the two sum in different orders. The backward (plain PyTorch on both
devices) is held to ``jax.vjp`` of the JAX op within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops.flash_attention import (
    _flash_forward as jax_flash_forward,
    _flash_forward_packed as jax_flash_forward_packed,
    attention_reference as jax_attention_reference,
    flash_attention as jax_flash_attention,
    flash_attention_qkv as jax_flash_attention_qkv,
    packed_layout_supported as jax_packed_layout_supported,
)
from elephas_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5
# gradients: fp32, different summation orders over S=64 keys and D
GRAD_ATOL = 1e-4
B, S, BLOCK = 2, 64, 16  # four kv tiles of 16


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0
    )


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bhsd_matches_jax(causal, D, H):
    q, k, v = (_normal((B, H, S, D), seed) for seed in range(3))
    scale = D ** -0.5
    j_out, j_lse = jax_flash_forward(
        *(x.reshape(B * H, S, D) for x in (q, k, v)),
        scale, causal, BLOCK, BLOCK, True,
    )
    t_out, t_lse = tfa._flash_forward(
        *map(torch.from_numpy, (q, k, v)), scale, causal, BLOCK, BLOCK
    )
    _close(t_out.reshape(B * H, S, D), j_out)
    _close(t_lse, j_lse)

    # public entry points, 4-D and the [BH, S, D] form
    j_pub = jax_flash_attention(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK)
    t_pub = tfa.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, block_q=BLOCK, block_k=BLOCK
    )
    _close(t_pub, j_pub)
    flat = [torch.from_numpy(x.reshape(B * H, S, D)) for x in (q, k, v)]
    _close(tfa.flash_attention(*flat, causal=causal, block_q=BLOCK, block_k=BLOCK),
           np.asarray(j_pub).reshape(B * H, S, D))


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_qkv_matches_jax(causal, D, H):
    """Packed [B, S, 3, H, D] qkv. On the JAX side this covers the packed
    per-head kernel (D=128), the lane-grouped one (D=64, even H) and the
    transposed fallback (D=16, D=64 with odd H)."""
    qkv = _normal((B, S, 3, H, D), 3)
    scale = D ** -0.5
    assert tfa.packed_layout_supported(D, H) == jax_packed_layout_supported(D, H)
    if jax_packed_layout_supported(D, H):
        j_out, j_lse = jax_flash_forward_packed(
            qkv.reshape(B, S, 3 * H * D), H, D, scale, causal, BLOCK, BLOCK, True
        )
    else:
        bhsd = [qkv[:, :, i].transpose(0, 2, 1, 3).reshape(B * H, S, D) for i in range(3)]
        j_out, j_lse = jax_flash_forward(*bhsd, scale, causal, BLOCK, BLOCK, True)
        j_out = np.asarray(j_out).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    t_out, t_lse = tfa._flash_forward_packed(
        torch.from_numpy(qkv), scale, causal, BLOCK, BLOCK
    )
    _close(t_out, np.asarray(j_out).reshape(B, S, H, D))
    _close(t_lse, j_lse)

    j_pub = jax_flash_attention_qkv(qkv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    t_pub = tfa.flash_attention_qkv(
        torch.from_numpy(qkv), causal=causal, block_q=BLOCK, block_k=BLOCK
    )
    assert t_pub.shape == (B, S, H, D)
    _close(t_pub, j_pub)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v = (_normal((B, 3, S, 32), seed) for seed in range(3))
    _close(
        tfa.attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal),
        jax_attention_reference(q, k, v, causal=causal),
    )


@pytest.mark.parametrize("packed", [False, True])
def test_ragged_blocks_raise_like_jax(packed):
    s, blocks = 48, dict(block_q=32, block_k=32)
    if packed:
        qkv = _normal((1, s, 3, 2, 16), 0)
        with pytest.raises(ValueError) as j_err:
            jax_flash_attention_qkv(qkv, **blocks)
        with pytest.raises(ValueError) as t_err:
            tfa.flash_attention_qkv(torch.from_numpy(qkv), **blocks)
    else:
        q = _normal((2, s, 16), 0)
        with pytest.raises(ValueError) as j_err:
            jax_flash_attention(q, q, q, **blocks)
        with pytest.raises(ValueError) as t_err:
            tfa.flash_attention(*(torch.from_numpy(q),) * 3, **blocks)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("packed", [False, True])
def test_backward_raises_until_the_training_slice(packed):
    """The training slice ported the backward: the wrappers that raised
    in ``backward`` now differentiate, here with q, k and v one tensor
    (their three gradients sum), as ``jax.grad`` of the JAX op does."""
    if packed:
        x = _normal((1, 32, 3, 2, 16), 0)
        t_x = torch.from_numpy(x).requires_grad_()
        out = tfa.flash_attention_qkv(t_x, causal=True)
        j_grad = jax.grad(lambda a: jnp.sum(jnp.sin(jax_flash_attention_qkv(
            a, causal=True))))(x)
    else:
        x = _normal((1, 2, 32, 16), 0)
        t_x = torch.from_numpy(x).requires_grad_()
        out = tfa.flash_attention(t_x, t_x, t_x, causal=True)
        j_grad = jax.grad(lambda a: jnp.sum(jnp.sin(jax_flash_attention(
            a, a, a, causal=True))))(x)
    torch.sin(out).sum().backward()
    _close(t_x.grad, j_grad, atol=GRAD_ATOL)


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_jax_vjp(causal, D, H):
    """dq, dk, dv of the bhsd wrapper against ``jax.vjp`` of the JAX
    op (its blockwise XLA backward), for one cotangent."""
    q, k, v = (_normal((B, H, S, D), seed) for seed in range(3))
    g = _normal((B, H, S, D), 9)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal=causal,
                                            block_q=BLOCK, block_k=BLOCK),
        q, k, v,
    )
    want = vjp(g)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=causal, block_q=BLOCK, block_k=BLOCK)
    out.backward(torch.from_numpy(g))
    for t, w in zip(ts, want):
        _close(t.grad, w, atol=GRAD_ATOL)


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_qkv_backward_matches_jax_vjp(causal, D, H):
    """d(qkv) of the packed wrapper, in the packed [B, S, 3, H, D]
    layout, against ``jax.vjp`` of the JAX packed op."""
    qkv = _normal((B, S, 3, H, D), 4)
    g = _normal((B, S, H, D), 5)
    _, vjp = jax.vjp(
        lambda a: jax_flash_attention_qkv(a, causal=causal, block_q=BLOCK,
                                          block_k=BLOCK),
        qkv,
    )
    (want,) = vjp(g)
    t_qkv = torch.from_numpy(qkv).requires_grad_()
    out = tfa.flash_attention_qkv(t_qkv, causal=causal, block_q=BLOCK, block_k=BLOCK)
    out.backward(torch.from_numpy(g))
    assert t_qkv.grad.shape == (B, S, 3, H, D)
    _close(t_qkv.grad, want, atol=GRAD_ATOL)


def test_flash_backward_masked_rows_are_zero():
    """A query row with every key masked (lse NEG_INF, as the forward
    leaves it) takes P = 0: its dq is 0 and it adds nothing to dk, dv."""
    q, k, v = (torch.from_numpy(_normal((1, 1, 4, 8), s)) for s in range(3))
    out, lse = tfa.flash_forward_reference(q, k, v, 0.5, False)
    lse = lse.clone()
    lse[..., 0] = tfa.NEG_INF
    g = torch.from_numpy(_normal((1, 1, 4, 8), 3))
    dq, dk, dv = tfa.flash_backward(q, k, v, out, lse, g, 0.5, False)
    assert torch.all(dq[..., 0, :] == 0)
    g0 = g.clone()
    g0[..., 0, :] = 0
    _, dk0, dv0 = tfa.flash_backward(q, k, v, out, lse, g0, 0.5, False)
    _close(dk, dk0.numpy())
    _close(dv, dv0.numpy())


# -- the kernel's arithmetic and launch choice, emulated on the CPU --------
#
# The CUDA kernel runs only on the card. These tests hold its design to
# the JAX reference where the CPU can: its fp32 route (3xTF32 products on
# the tensor cores) and its bf16 route (p rounded to bf16 for p.v),
# emulated with numpy in the kernel's order (online softmax over kv tiles,
# exp2 with log2 e folded in), and the launch configuration it is given.

LOG2E = np.float32(1.4426950408889634)


def _tf32(x):
    """What a TF32 tensor-core operand keeps of an fp32 value, by bit
    arithmetic: the sign, the exponent and the top 10 of 23 mantissa bits
    (the kernel's ``hi = x & 0xffffe000``; the tensor core reads any fp32
    operand the same way)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, passes):
    """a @ b as the kernel's mma.sync computes it: one pass is plain TF32
    (hi.hi); three passes add lo.hi and hi.lo first (3xTF32), with
    lo = x - hi exact in fp32 and read by the tensor core as TF32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _emulate_kernel(q, k, v, scale, causal, block_k, product, round_p=None):
    """The kernel's online softmax for one head, ``[S, D]`` fp32 inputs →
    (out, lse): scores per kv tile through ``product``, the mask, m, l and
    the rescale in fp32 with exp2, and p.v through ``product`` on p (after
    ``round_p``, where given)."""
    s_q, s_k = q.shape[0], k.shape[0]
    rows = np.arange(s_q)[:, None]
    m = np.full((s_q, 1), NEG_INF, np.float32)
    l = np.zeros((s_q, 1), np.float32)
    acc = np.zeros((s_q, q.shape[1]), np.float32)
    scale = np.float32(scale)
    for k0 in range(0, s_k, block_k):
        kt, vt = k[k0:k0 + block_k], v[k0:k0 + block_k]
        s = product(q, kt.T) * scale
        if causal:
            s = np.where(k0 + np.arange(kt.shape[0])[None, :] <= rows, s, NEG_INF)
        m_new = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp2((m - m_new) * LOG2E)
        p = np.where(m_new <= NEG_INF * 0.5, np.float32(0), np.exp2((s - m_new) * LOG2E))
        l = l * alpha + p.sum(axis=1, keepdims=True)
        acc = acc * alpha + product(p if round_p is None else round_p(p), vt)
        m = m_new
    safe_l = np.where(l == 0, np.float32(1), l)
    return acc / safe_l, (m + np.log(safe_l))[:, 0]


NEG_INF = np.float32(tfa.NEG_INF)


def _jax_reference(q, k, v, scale, causal):
    """out from the JAX package's ``attention_reference`` and lse as the
    logsumexp of the same masked scores, fp32."""
    out = jax_attention_reference(q, k, v, causal=causal, scale=scale)
    s = jnp.einsum("qd,kd->qk", q, k) * scale
    if causal:
        s = jnp.where(jnp.arange(k.shape[0])[None, :] <= jnp.arange(q.shape[0])[:, None],
                      s, tfa.NEG_INF)
    return np.asarray(out), np.asarray(jax.nn.logsumexp(s, axis=-1))


# (S, D, causal, kv tile): config A's attention head and the training one;
# the fp32 kernel takes 32-key tiles at D = 128
FP32_SHAPES = {"A": (512, 128, True, 32), "T": (256, 128, False, 32)}


@pytest.mark.parametrize("shape", sorted(FP32_SHAPES))
def test_fp32_route_3xtf32_meets_fp32_accuracy(shape):
    """Three TF32 passes keep the kernel within 1e-5 of the fp32
    reference, out and lse; one pass (plain TF32) would not meet the
    card's 1e-4 gate."""
    s_len, d, causal, block_k = FP32_SHAPES[shape]
    scale = d ** -0.5
    errs = {1: 0.0, 3: 0.0}
    for head in range(2):
        q, k, v = (_normal((s_len, d), 10 * head + i) for i in range(3))
        want_out, want_lse = _jax_reference(q, k, v, scale, causal)
        for passes in errs:
            out, lse = _emulate_kernel(
                q, k, v, scale, causal, block_k,
                lambda a, b, n=passes: _tf32_product(a, b, n))
            errs[passes] = max(errs[passes], np.abs(out - want_out).max(),
                               np.abs(lse - want_lse).max())
    assert errs[3] <= 1e-5, errs
    assert errs[1] > 1e-4, errs


def test_bf16_route_rounded_p_meets_the_bf16_gate():
    """At config A's head (S 512, D 128, causal, 64-key tiles) the bf16
    route rounds p to bf16 for p.v; out, rounded to bf16, stays within
    the card's 2e-2 gate of the fp32 reference on the same bf16 inputs,
    and lse within 1e-4."""
    def bf16(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).bfloat16().float().numpy()

    s_len, d = 512, 128
    q, k, v = (bf16(_normal((s_len, d), 20 + i)) for i in range(3))
    # bf16 products are exact in fp32: the mma sums them in fp32
    out, lse = _emulate_kernel(q, k, v, d ** -0.5, True, 64, np.matmul, round_p=bf16)
    want_out, want_lse = _jax_reference(q, k, v, d ** -0.5, True)
    assert np.abs(bf16(out) - bf16(want_out)).max() <= 2e-2
    assert np.abs(lse - want_lse).max() <= 1e-4


H100_SMS = 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_config_at_the_main_path_shapes(dtype):
    """8 warps (128 rows) where that grid fills half a wave of the H100's
    SMs, else 4 (64 rows). At config A's generate shape (batch 1) that
    is 32 blocks of 4 warps: the last q tile's walk over all 512 keys
    sets the kernel's time there, not the SM count. The key length does
    not change the choice."""
    def cfg(b, h, s, d):
        return tfa.launch_config(b, h, s, s, d, dtype, H100_SMS)

    assert cfg(1, 4, 512, 128) == (4, 64, 32)  # A, batch 1
    assert tfa.launch_config(1, 4, 512, 2048, 128, dtype, H100_SMS) == (4, 64, 32)
    assert cfg(8, 4, 512, 128) == (8, 128, 128)  # A, batch 8
    assert cfg(8, 4, 256, 64) == (4, 64, 128)  # B, batch 8
    assert cfg(128, 8, 256, 128) == (8, 128, 2048)  # T


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
@pytest.mark.parametrize("b,h,s_q,s_k", [(1, 1, 1, 1), (1, 4, 512, 512), (8, 4, 256, 256),
                                         (2, 3, 300, 136), (128, 8, 256, 256)])
def test_launch_config_is_valid_for_every_width(b, h, s_q, s_k, D, dtype):
    cfg = tfa.launch_config(b, h, s_q, s_k, D, dtype, H100_SMS)
    assert cfg.warps in tfa.WARP_CHOICES and cfg.block_q == 16 * cfg.warps
    assert cfg.blocks == -(-s_q // cfg.block_q) * b * h
    # 128-row blocks whenever they make half a wave
    assert (cfg.warps == 8) == (2 * b * h * -(-s_q // 128) >= H100_SMS)


def test_launch_config_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tfa.launch_config(1, 1, 64, 64, 48, torch.float32, H100_SMS)
    with pytest.raises(ValueError):
        tfa.launch_config(1, 1, 64, 64, 64, torch.float16, H100_SMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["q", "k", "v", "out"])
def test_operand_check_rejects_a_misaligned_view(operand, dtype):
    """The kernel's 16-byte cp.async copies need 16-byte-aligned
    operands: a view one element off is refused (checked here on CPU
    tensors; the check is the one CUDA tensors take)."""
    shape = (1, 2, 64, 32)
    ops = {name: torch.zeros(shape, dtype=dtype) for name in ("q", "k", "v", "out")}
    tfa._check_cuda_operands(**ops)
    flat = torch.zeros(2 * 64 * 32 + 1, dtype=dtype)
    ops[operand] = flat[1:].view(shape)
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_cuda_operands(**ops)


def test_other_devices_raise():
    q = torch.empty(1, 2, 32, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q, q, q)
