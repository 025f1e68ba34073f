"""The port's CUDA flash kernel against its plain version, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The
file imports torch and the port only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from elephas_tpu_torch.ops import flash_attention as fa

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
