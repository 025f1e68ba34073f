"""The port's flash attention (``elephas_tpu_torch.ops.flash_attention``)
against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
(interpret mode, as the JAX package's own tests run it here) and through
the port's CPU path (the kernel's plain version). fp32 tolerance 1e-5:
the two sum in different orders.
"""

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
    if packed:
        qkv = torch.from_numpy(_normal((1, 32, 3, 2, 16), 0)).requires_grad_()
        out = tfa.flash_attention_qkv(qkv, causal=True)
    else:
        q = torch.from_numpy(_normal((1, 2, 32, 16), 0)).requires_grad_()
        out = tfa.flash_attention(q, q, q, causal=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def test_other_devices_raise():
    q = torch.empty(1, 2, 32, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q, q, q)
