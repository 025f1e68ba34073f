"""The port's LayerNorm (``elephas_tpu_torch.ops.layer_norm``) against the
JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX Pallas kernels
(interpret mode, as the JAX package's own tests run them here) and through
the port's CPU path (the kernels' plain versions). Tolerances: forward
1e-5 and gradients (dx through ``jax.vjp``, dγ and dβ summed over every
row) 1e-4, absolute, fp32; the two sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models.transformer import FusedLayerNorm as JaxFusedLayerNorm
from elephas_tpu.ops.layer_norm import _fwd_call as jax_fwd_call
from elephas_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from elephas_tpu_torch import FusedLayerNorm
from elephas_tpu_torch.ops import layer_norm as tln

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4
# the shapes of tests/test_ops.py's layer-norm test, and 37 rows: a count
# no row block of the reference but 1 divides
SHAPES = [(8, 16, 64), (128, 256), (5, 7, 128), (37, 96)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    g = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape):
    x, g, b, _ = _inputs(shape)
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = tln.layer_norm(*map(torch.from_numpy, (x, g, b)))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_statistics_match_jax(shape):
    """mean and rstd, saved for the backward, as the TPU kernel writes
    them ([N, 1] there, [N] here)."""
    x, g, b, _ = _inputs(shape)
    x2 = x.reshape(-1, shape[-1])
    _, j_mean, j_rstd = jax_fwd_call(jnp.asarray(x2), jnp.asarray(g), jnp.asarray(b),
                                     1e-6, True)
    _, mean, rstd = tln.layer_norm_forward(*map(torch.from_numpy, (x2, g, b)), 1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean)[:, 0], atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(j_rstd)[:, 0], rtol=FWD_ATOL, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_vjp(shape):
    x, g, b, dy = _inputs(shape)
    _, vjp = jax.vjp(lambda a, c, e: jax_layer_norm(a, c, e), *map(jnp.asarray, (x, g, b)))
    want = vjp(jnp.asarray(dy))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    tln.layer_norm(*ts).backward(torch.from_numpy(dy))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)


def test_backward_formula_matches_autograd_of_the_forward():
    """The plain backward (the kernels' formula) against autograd through
    the plain forward: the two differentiate the same function."""
    x, g, b, dy = _inputs((9, 40), seed=3)
    ts = [torch.from_numpy(a).double().requires_grad_() for a in (x, g, b)]
    y = tln.layer_norm_forward_reference(ts[0], ts[1], ts[2], 1e-6)[0]
    y.backward(torch.from_numpy(dy).double())
    x64, g64 = ts[0].detach(), ts[1].detach()
    _, mean, rstd = tln.layer_norm_forward_reference(x64, g64, ts[2].detach(), 1e-6)
    mean, rstd = mean.double(), rstd.double()
    dx = torch.from_numpy(dy).double()
    got = tln.layer_norm_backward_reference(x64, g64, dx, mean, rstd)
    for t, w in zip(ts, got):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_fused_layer_norm_module_matches_jax_layer():
    """The module (ones/zeros init, epsilon 1e-6) against the JAX package's
    FusedLayerNorm layer on the same weights, kernel and plain paths."""
    x, g, b, _ = _inputs((4, 8, 48), seed=5)
    ref = JaxFusedLayerNorm(epsilon=1e-6)
    ref.build(x.shape)
    ref.gamma.assign(g)
    ref.beta.assign(b)
    want = np.asarray(ref(x))
    port = FusedLayerNorm(48)
    assert port.epsilon == 1e-6
    assert torch.equal(port.gamma, torch.ones(48)) and torch.equal(port.beta, torch.zeros(48))
    with torch.no_grad():
        port.gamma.copy_(torch.from_numpy(g))
        port.beta.copy_(torch.from_numpy(b))
        for plain in (False, True):
            got = port(torch.from_numpy(x), plain=plain)
            np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


def test_bfloat16_rows_keep_their_dtype():
    x, g, b, dy = _inputs((6, 32))
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    y = tln.layer_norm(xb, torch.from_numpy(g), torch.from_numpy(b))
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(dy).bfloat16())
    assert xb.grad.dtype == torch.bfloat16
    want = tln.layer_norm_forward_reference(xb.detach().float(), torch.from_numpy(g),
                                            torch.from_numpy(b), 1e-6)[0]
    np.testing.assert_allclose(y.detach().float().numpy(), want.numpy(), atol=5e-2, rtol=0)


def test_other_devices_raise():
    x = torch.empty(4, 8, device="meta")
    g = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tln.layer_norm(x, g, g)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tln.layer_norm_backward(x, g, x, g, g)
