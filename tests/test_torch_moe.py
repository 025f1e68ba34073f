"""The port's MoE op (``elephas_tpu_torch.ops.moe``) against the JAX
package's (``elephas_tpu.ops.moe``), on the CPU.

The same numpy inputs from a seed go through both. The dense routing
tensors of ``_topk_dispatch`` are equal (dispatch) or within 1e-6
(combine, aux); the main path's index routing (``topk_route``) keeps
exactly the (token, expert, queue place) triples of the reference's
dispatch; ``moe_ffn`` is within 1e-6 of max(1, |out|) of the port's dense
plain version, gradients too; ``moe_ffn_reference`` is within 1e-5 of the
JAX oracle forward and 1e-4 in its gradients (the oracle side of the
reference's ``test_ep_gradients_flow``). Reference cases of
``tests/test_moe.py`` that need no mesh run on the port through
``tests/_port_cases.py``, over a small stand-in for ``jax.numpy`` that
makes torch tensors.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tests.test_moe as ref_moe
from elephas_tpu.ops import moe as jmoe
from elephas_tpu_torch.ops import moe
from tests._port_cases import port_namespace

E, D, H = 4, 8, 16


def _inputs(t, seed=0, d=D, e=E, h=H):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    params = [rng.normal(size=s).astype(np.float32) * scale for s, scale in (
        ((d, e), 1.0), ((e, d, h), (2.0 / d) ** 0.5), ((e, h), 0.1),
        ((e, h, d), (2.0 / h) ** 0.5), ((e, d), 0.1))]
    return x, params


def _kept_triples(dispatch):
    """The (token, expert, place) of every kept routing in a dense
    dispatch tensor."""
    return sorted(map(tuple, np.argwhere(np.asarray(dispatch, np.float32) > 0).tolist()))


def _route_triples(experts, positions, capacity):
    kept = positions < capacity
    return sorted((t, int(experts[j, t]), int(positions[j, t]))
                  for j, t in zip(*np.nonzero(kept.numpy())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [5, 64], ids=["tight", "roomy"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_dispatch_and_route_match_jax(k, capacity, dtype):
    x, (gate, *_) = _inputs(64, seed=k)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    px = torch.from_numpy(x).to(getattr(torch, dtype))
    dispatch, combine, aux = jmoe._topk_dispatch(jx, jnp.asarray(gate), E, capacity, k=k)
    pd, pc, pa = moe._topk_dispatch(px, torch.from_numpy(gate), E, capacity, k=k)
    assert pd.dtype == px.dtype and pc.dtype == torch.float32
    np.testing.assert_array_equal(pd.float().numpy(), np.asarray(dispatch, np.float32))
    np.testing.assert_allclose(pc.numpy(), np.asarray(combine), atol=1e-6, rtol=0)
    assert abs(float(pa) - float(aux)) <= 1e-6
    experts, positions, gates, _ = moe.topk_route(px, torch.from_numpy(gate), E, capacity, k)
    assert experts.dtype == positions.dtype == torch.int32
    assert _route_triples(experts, positions, capacity) == _kept_triples(dispatch)
    if capacity == 5:
        assert len(_kept_triples(dispatch)) < k * 64  # tokens dropped


@pytest.mark.parametrize("capacity_factor", [0.5, 1.5, 4.0])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_moe_ffn_matches_its_plain_version(k, capacity_factor):
    """The index route against the dense plain version: the same kept
    routing, outputs, aux and every gradient within 1e-6 of max(1, |·|)."""
    x, params = _inputs(96, seed=10 + k)
    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *params]]
    capacity = moe.capacity_for(96, E, capacity_factor, k)
    out, aux = moe.moe_ffn(*xs, capacity, k, return_aux=True)
    ref, ref_aux = moe.moe_ffn_reference(*xs, capacity_factor, k=k, return_aux=True)
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-6 * scale
    assert abs(aux.item() - ref_aux.item()) <= 1e-6
    grads = torch.autograd.grad((out ** 2).sum() + aux, xs)
    ref_grads = torch.autograd.grad((ref ** 2).sum() + ref_aux, xs)
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 1e-6 * max(1.0, r.abs().max().item())
    dispatch = moe._topk_dispatch(xs[0], xs[1], E, capacity, k)[0]
    experts, positions, _, _ = moe.topk_route(xs[0], xs[1], E, capacity, k)
    assert _route_triples(experts, positions, capacity) == _kept_triples(dispatch.detach())


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("num_shards", [1, 4])
def test_moe_ffn_reference_matches_jax(num_shards, k):
    """Forward within 1e-5, the gradients of sum(out²) in x and every
    weight within 1e-4: the oracle of the reference's
    test_ep_gradients_flow, on the same inputs."""
    x, params = _inputs(128, seed=20 + num_shards)

    def forward(x, params):
        return jmoe.moe_ffn_reference(x, *params, num_shards=num_shards, k=k)

    jargs = (jnp.asarray(x), [jnp.asarray(p) for p in params])
    want = jax.jit(forward)(*jargs)
    jgrads = jax.jit(jax.grad(lambda x, p: jnp.sum(forward(x, p) ** 2), argnums=(0, 1)))(*jargs)
    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *params]]
    out = moe.moe_ffn_reference(*xs, num_shards=num_shards, k=k)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    for g, w in zip(grads, [jgrads[0], *jgrads[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    assert any(g.abs().max().item() > 0 for g in grads[2:])


class _Ops(TorchDispatchMode):
    """Every aten op a call makes, with its outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = [tuple(t.shape) for t in torch.utils._pytree.tree_leaves(out)
                  if isinstance(t, torch.Tensor)]
        self.ops.append((str(func.overloadpacket.__name__), shapes))
        return out


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_has_no_dense_routing_tensor_and_no_host_read(k):
    """The main path's forward and backward at T = 512, E = 8: no tensor
    as large as [T, E, C], no op whose output shape depends on the data
    (nonzero, masked_select, unique) and no read of a device value
    (item, is_nonzero), so it neither grows as T² nor synchronises."""
    t, e = 512, 8
    x, params = _inputs(t, seed=3, e=e)
    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *params]]
    capacity = moe.capacity_for(t, e, 1.5, k)
    with _Ops() as rec:
        out, aux = moe.moe_ffn(*xs, capacity, k, return_aux=True)
        torch.autograd.grad((out ** 2).sum() + aux, xs)
    dense = t * e * capacity
    biggest = max((int(np.prod(s)) for _, shapes in rec.ops for s in shapes), default=0)
    assert biggest < dense // 4, biggest
    names = {name for name, _ in rec.ops}
    host = names & {"_local_scalar_dense", "is_nonzero", "nonzero", "masked_select",
                    "unique", "_unique2", "equal"}
    assert not host, host
    assert "cumsum" in names and "bmm" in names


def test_expert_parallel_ffn_refusal_cites_item_5():
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue A item 5\b"):
        moe.expert_parallel_ffn(None, None, None, None, None, None, axis_name="ep")


def test_init_moe_params_shapes_and_generator():
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(gen, 16, 32, 4)
    assert [tuple(p.shape) for p in params] == [(16, 4), (4, 16, 32), (4, 32), (4, 32, 16),
                                                (4, 16)]
    again = moe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4)
    assert all(torch.equal(a, b) for a, b in zip(params, again))
    assert not params[2].any() and not params[4].any()


# -- the reference's cases on the port ---------------------------------


class _Indexed:
    def __init__(self, t, idx):
        self.t, self.idx = t, idx

    def set(self, value):
        out = self.t.clone()
        out[self.idx] = value
        return out


class _At:
    def __init__(self, t):
        self.t = t

    def __getitem__(self, idx):
        return _Indexed(self.t, idx)


class _Tensor(torch.Tensor):
    """A torch tensor with jax.numpy's ``.at[idx].set(value)``."""

    @property
    def at(self):
        return _At(self)


def _jnp_array(a, dtype=None):
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(dtype or (torch.float32 if a.is_floating_point() else a.dtype)) \
        .as_subclass(_Tensor)


def _np_asarray(a, dtype=None):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a, dtype=dtype)


# jax.numpy and numpy as the cases use them, over torch tensors
_JNP = types.SimpleNamespace(
    float32=torch.float32, bfloat16=torch.bfloat16, asarray=_jnp_array, abs=torch.abs,
    ones=lambda shape, dtype=torch.float32: torch.ones(shape, dtype=dtype).as_subclass(_Tensor),
    zeros=lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype)
    .as_subclass(_Tensor),
)
_NP = types.SimpleNamespace(**{n: getattr(np, n) for n in dir(np) if not n.startswith("__")})
_NP.asarray = _np_asarray

_NS = port_namespace(ref_moe, jnp=_JNP, np=_NP)
test_routing_exact_in_bfloat16 = _NS["test_routing_exact_in_bfloat16"]
test_top2_combine_weights_normalized = _NS["test_top2_combine_weights_normalized"]
test_aux_loss_minimized_by_uniform_router = _NS["test_aux_loss_minimized_by_uniform_router"]
test_topk_rejects_k_above_num_experts = _NS["test_topk_rejects_k_above_num_experts"]


@pytest.mark.parametrize("route", ["oracle", "moe_ffn"])
def test_capacity_drops_overflow(route):
    """The reference's case on the single-device oracle (and the main
    path) at its mesh's token sharding: with capacity_factor → 0 every
    expert keeps one slot, most tokens drop and their output rows are
    zero; roomy capacity keeps about all of them."""
    w, e = ref_moe.W, ref_moe.W * 2
    params = moe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, e)
    x = torch.randn(w * 32, 16, generator=torch.Generator().manual_seed(1))

    def run(cf):
        if route == "oracle":
            return moe.moe_ffn_reference(x, *params, capacity_factor=cf, num_shards=w)
        return torch.cat([moe.moe_ffn(xs, *params, moe.capacity_for(32, e, cf))
                          for xs in x.chunk(w)])

    def zero_rows(out):
        return (out.abs() < 1e-12).all(dim=-1).float().mean().item()

    tight, roomy = zero_rows(run(1e-6)), zero_rows(run(4.0))
    assert tight > roomy
    assert roomy < 0.05
