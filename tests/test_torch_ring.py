"""The port's sequence-parallel attention (``ops/ring_attention.py``,
``ops/ulysses.py``) against the JAX package's, on the CPU.

The JAX side runs over the 8 virtual CPU devices of ``tests/conftest.py``
(its flash kernel in interpret mode); the port's runs single-controller
over a :class:`~elephas_tpu_torch.parallel.mesh.Mesh` that names the CPU
once a position. Inputs are the same numpy arrays made from a seed.
Outputs agree within 2e-5 (the reference's own tolerance against its
dense oracle, ``tests/test_ops.py``); gradients within 5e-4 of
``jax.grad`` of the JAX ring / Ulysses (the reference holds its own VJPs
to its dense oracle at 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from elephas_tpu.ops.ring_attention import ring_attention as jax_ring
from elephas_tpu.ops.ring_attention import ring_attention_sharded as jax_ring_sharded
from elephas_tpu.ops.ulysses import ulysses_attention as jax_ulysses
from elephas_tpu.ops.ulysses import ulysses_attention_sharded as jax_ulysses_sharded
from elephas_tpu.parallel.mesh import shard_map_compat
from elephas_tpu_torch.ops import flash_attention as fa
from elephas_tpu_torch.ops import ring_attention as ra
from elephas_tpu_torch.ops.ring_attention import ring_attention_sharded
from elephas_tpu_torch.ops.ulysses import ulysses_attention_sharded
from elephas_tpu_torch.parallel.mesh import Mesh

TOL = 2e-5
TOL_GRAD = 5e-4


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _port_mesh(w, axis="workers"):
    return Mesh(["cpu"] * w, (axis,))


def _jax_mesh(w, axis="workers"):
    return JaxMesh(np.array(jax.devices()[:w]), (axis,))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(causal):
    q, k, v = _arrays((2, 8 * 64, 32), 3)
    want = jax_ring_sharded(*map(jnp.asarray, (q, k, v)), _jax_mesh(8), axis_name="workers",
                            causal=causal)
    got = ring_attention_sharded(*map(torch.from_numpy, (q, k, v)), _port_mesh(8),
                                 axis_name="workers", causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax(causal):
    q, k, v = _arrays((2, 4 * 32, 16), 5)
    spec = P(None, "workers", None)

    def loss(q, k, v):
        fn = lambda q, k, v: jax_ring(q, k, v, axis_name="workers", causal=causal)  # noqa: E731
        out = shard_map_compat(fn, mesh=_jax_mesh(4), in_specs=(spec,) * 3, out_specs=spec,
                               check=False)(q, k, v)
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ring_attention_sharded(tq, tk, tv, _port_mesh(4), causal=causal)
    (out ** 2).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_GRAD, rtol=TOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal):
    q, k, v = _arrays((2, 4, 4 * 32, 16), 3)
    want = jax_ulysses_sharded(*map(jnp.asarray, (q, k, v)), _jax_mesh(4, "seq"),
                               axis_name="seq", causal=causal)
    got = ulysses_attention_sharded(*map(torch.from_numpy, (q, k, v)), _port_mesh(4, "seq"),
                                    axis_name="seq", causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_ulysses_gradients_match_jax():
    q, k, v = _arrays((2, 4, 4 * 32, 16), 5)
    spec = P(None, None, "seq", None)

    def loss(q, k, v):
        fn = lambda q, k, v: jax_ulysses(q, k, v, axis_name="seq", causal=True)  # noqa: E731
        out = shard_map_compat(fn, mesh=_jax_mesh(4, "seq"), in_specs=(spec,) * 3,
                               out_specs=spec, check=False)(q, k, v)
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ulysses_attention_sharded(tq, tk, tv, _port_mesh(4, "seq"), axis_name="seq",
                                    causal=True)
    (out ** 2).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_GRAD, rtol=TOL_GRAD,
                                   err_msg=name)


def test_ulysses_head_count_guard():
    q, k, v = _arrays((1, 3, 4 * 8, 8), 0)  # 3 heads over 4 positions
    with pytest.raises(ValueError, match="divisible") as j_err:
        jax_ulysses_sharded(*map(jnp.asarray, (q, k, v)), _jax_mesh(4, "seq"), axis_name="seq")
    with pytest.raises(ValueError, match="divisible") as t_err:
        ulysses_attention_sharded(*map(torch.from_numpy, (q, k, v)), _port_mesh(4, "seq"),
                                  axis_name="seq")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("s_local", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_runs_the_flash_forward_at_short_shards(monkeypatch, s_local, causal):
    """Every (query shard, chunk) pair the ring computes goes through the
    flash forward (W² pairs, W·(W+1)/2 causal: the later chunks are
    skipped), whose block rule takes local lengths of 8 to 256 (a power of
    two at most 128, or a multiple of 128, as ``sp_pad_len`` makes them),
    and whose kernel launch has a configuration for each. The skipped
    chunks' rows merge without NaN."""
    w = 4
    calls = []
    real = ra._flash_forward

    def counted(q, k, v, scale, causal_, block_q, block_k):
        calls.append((q.shape[2], k.shape[2], causal_))
        return real(q, k, v, scale, causal_, block_q, block_k)

    monkeypatch.setattr(ra, "_flash_forward", counted)
    q, k, v = (torch.from_numpy(a) for a in _arrays((2, w * s_local, 16), 7))
    got = ring_attention_sharded(q, k, v, _port_mesh(w), causal=causal)
    want = fa.attention_reference(q, k, v, causal=causal)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    assert len(calls) == (w * (w + 1) // 2 if causal else w * w)
    assert all(sq == sk == s_local for sq, sk, _ in calls)
    assert sum(c for _, _, c in calls) == (w if causal else 0)
    cfg = fa.launch_config(2, 1, s_local, s_local, 16, torch.float32, 132)
    assert cfg.warps in fa.WARP_CHOICES and cfg.blocks >= 1


def test_ulysses_gives_each_position_its_head_group():
    """On one device the all-to-all is a pure re-layout, and position j
    still attends over heads ``[j·H/W, (j+1)·H/W)`` of the whole
    sequence, in the reference's order."""
    from elephas_tpu_torch.ops import ulysses

    w, h, s = 4, 8, 32
    x = torch.arange(2 * h * s * 4, dtype=torch.float32).reshape(2, h, s, 4)
    shards = list(x.chunk(w, dim=2))
    heads = ulysses._all_to_all(shards, split_axis=1, concat_axis=2)
    for j, got in enumerate(heads):
        assert torch.equal(got, x[:, j * h // w:(j + 1) * h // w])
    back = ulysses._all_to_all(heads, split_axis=2, concat_axis=1)
    assert all(torch.equal(b, s_) for b, s_ in zip(back, shards))
