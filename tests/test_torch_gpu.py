"""The port's CUDA kernels (flash forward, LayerNorm forward and
backward) against their plain versions, and one SparkModel fit, on the
card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu_torch.ops import flash_attention as fa
from elephas_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s_q,s_k", [(100, 100), (64, 192), (200, 72)])
def test_ragged_and_cross_lengths(cuda, dtype, tol, causal, s_q, s_k):
    """Sequence lengths that are not multiples of the kernel's 64-row
    tiles, and q/k of different lengths (causal on absolute positions)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, 2, 3, s_q, 64, dtype=dtype)
    k = _randn(gen, 2, 3, s_k, 64, dtype=dtype)
    v = _randn(gen, 2, 3, s_k, 64, dtype=dtype)
    out, lse = fa._flash_forward(q, k, v, 0.125, causal, s_q, s_k)
    ref, ref_lse = fa.flash_forward_reference(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse.reshape(6, s_q)).abs().max().item() <= 1e-4


def test_counts_launches_and_matches_qkv(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = _randn(gen, 2, 128, 3, 4, 32)
    before = fa.launches
    out = fa.flash_attention_qkv(qkv, causal=True)
    assert fa.launches == before + 1
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    ref = fa.attention_reference(q, k, v, causal=True).transpose(1, 2)
    assert (out - ref).abs().max().item() <= 1e-4


def test_refuses_what_the_kernel_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, 1, 2, 64, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = _randn(gen, 1, 2, 64, 64).half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = _randn(gen, 1, 2, 64, 128)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q, q, q)


def _ln_case(gen, n, d, dtype):
    x = (_randn(gen, n, d) * 3 + 1.5).to(dtype)
    g, b = _randn(gen, d), _randn(gen, d)
    dy = _randn(gen, n, d, dtype=dtype)
    return x, g, b, dy


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,d", [(1, 1), (7, 1), (1000, 200), (33, 1024), (5, 3000),
                                 (3, 8192)])
def test_layer_norm_kernels_match_plain(cuda, dtype, tol, n, d):
    """Ragged row counts, d of 1 and 200, and each row layout of the
    dispatch (one warp a row, and 2 to 8 warps)."""
    gen = torch.Generator(device=cuda).manual_seed(n * 10007 + d)
    x, g, b, dy = _ln_case(gen, n, d, dtype)
    f0, b0 = ln.fwd_launches, ln.bwd_launches
    y, mean, rstd = ln.layer_norm_forward(x, g, b, 1e-6)
    dx, dg, db = ln.layer_norm_backward(x, g, dy, mean, rstd)
    assert (ln.fwd_launches - f0, ln.bwd_launches - b0) == (1, 2)
    ry, rmean, rrstd = ln.layer_norm_forward_reference(x, g, b, 1e-6)
    rdx, rdg, rdb = ln.layer_norm_backward_reference(x, g, dy, rmean, rrstd)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype
    # bf16: one rounding, relative to max(1, |y|)
    scale = ry.float().abs().clamp_min(1) if dtype == torch.bfloat16 else 1.0
    assert ((y.float() - ry.float()).abs() / scale).max().item() <= tol
    assert ((mean - rmean).abs() / rmean.abs().clamp_min(1)).max().item() <= 1e-5
    assert ((rstd - rrstd).abs() / rrstd).max().item() <= 1e-5
    if dtype == torch.float32:
        assert (dx - rdx).abs().max().item() <= 1e-4
        for got, want in ((dg, rdg), (db, rdb)):
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().clamp_min(1).item()


def test_layer_norm_backward_repeats_bit_for_bit(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x, g, _, dy = _ln_case(gen, 4096, 1024, torch.float32)
    _, mean, rstd = ln.layer_norm_forward(x, g, g, 1e-6)
    first = ln.layer_norm_backward(x, g, dy, mean, rstd)
    again = ln.layer_norm_backward(x, g, dy, mean, rstd)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_layer_norm_refuses_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    x, g, b, _ = _ln_case(gen, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ln.layer_norm(x.half(), g, b)
    with pytest.raises(ValueError, match="contiguous rows"):
        ln.layer_norm(_randn(gen, 8, 128)[:, :64], g, b)
    with pytest.raises(ValueError, match="gamma"):
        ln.layer_norm(x, g.double(), b)
    with pytest.raises(ValueError, match="d <= 8192"):
        ln.layer_norm(_randn(gen, 2, 8193), _randn(gen, 8193), _randn(gen, 8193))
    with pytest.raises(ValueError, match="on cpu"):
        ln.layer_norm(x, g.cpu(), b)


def test_spark_model_fit_on_cuda_matches_cpu(cuda):
    """A tiny classifier trained through the kernels on the card gives the
    history the plain versions give on the CPU (fp32, TF32 off)."""
    cfg = dict(vocab_size=61, maxlen=32, num_classes=2, d_model=64, num_heads=2,
               num_layers=2, dropout=0.0, seed=5)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 61, (40, 32)).astype(np.int32)
    y = rng.integers(0, 2, 40).astype(np.int32)
    hists = {}
    for dev in ("cpu", "cuda:0"):
        model = et.transformer_classifier(**cfg, device=dev)
        et.load_keras_weights(model, et.keras_weights(
            et.transformer_classifier(**cfg, device="cpu")))
        hists[dev] = et.SparkModel(model, device=dev).fit((x, y), epochs=2, batch_size=16)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(hists["cuda:0"][key], hists["cpu"][key], rtol=1e-4)
