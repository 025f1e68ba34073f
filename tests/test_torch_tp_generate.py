"""``generate`` on a mesh: the port against the JAX package, on the CPU.

The reference's mesh-aware decode (``elephas_tpu/models/transformer.py:
539-685``): the batch padded to the data axis and split over it, the
weights sharded over the model axis under the tensor-parallel planner's
layouts, and with ``kv_cache=True`` each shard's K/V cache holding its rows
and its heads. Against JAX, conftest's ``serving_lm`` (trained, so that
greedy parity across layouts is not a coin flip) loads into the port by
its Keras weights; the port's own cases decode an LM of the same widths
that the port trains on the same periodic data. The port runs under
``force_devices(4)`` on ``device="cpu"`` over a 2 × 2 ``('data', 'model')``
mesh, the JAX side over conftest's virtual devices. Tokens at temperature 0 must be equal, token for token;
the port's sharded logits within 1e-5 of its unsharded ones (fp32, the
row-parallel sums in another order).
"""

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.models.transformer import generate as jax_generate
from elephas_tpu.parallel.tensor import dp_tp_mesh as jax_dp_tp_mesh
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.models import transformer as port_transformer
from elephas_tpu_torch.parallel import tensor
from elephas_tpu_torch.parallel.mesh import Mesh
from elephas_tpu_torch.parallel.tensor import dp_tp_mesh

STEPS = 12


@pytest.fixture(autouse=True)
def four_slots():
    """Four worker slots on the CPU, and one intra-op thread: the tensors
    are tiny, and under pytest-xdist every worker's thread pool would
    otherwise contend for the same cores."""
    previous, threads = force_devices(4), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    force_devices(previous)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_pair(serving_lm):
    """``serving_lm`` and the port's LM from its Keras weights."""
    port = et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2,
                             device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in serving_lm.weights})
    return serving_lm, port


@pytest.fixture(scope="module")
def port_lm():
    """``serving_lm``'s widths, data and fit, trained by the port."""
    rng = np.random.default_rng(0)
    seq = (rng.integers(2, 6, size=256)[:, None] + np.arange(33)) % 4 + 2
    port = et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2, num_layers=2,
                             dropout=0.0, lr=1e-2, seed=0, device="cpu")
    previous, threads = force_devices(4), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        et.SparkModel(port, num_workers=4, device="cpu").fit((seq[:, :-1], seq[:, 1:]), epochs=4,
                                                              batch_size=32)
    finally:
        force_devices(previous)
        torch.set_num_threads(threads)
    return port


def _prompts(rows=3, seed=9):
    """Periodic prompts of the trained LM's kind; 3 rows pad to 4 on the
    2-way data axis."""
    starts = np.random.default_rng(seed).integers(2, 6, size=rows)
    return ((starts[:, None] + np.arange(5)) % 4 + 2).astype(np.int32)


@pytest.mark.parametrize("kv_cache", [False, True])
def test_mesh_generate_matches_jax_and_unmeshed(jax_pair, kv_cache):
    serving_lm, port_lm = jax_pair
    prompt = _prompts()
    want = jax_generate(serving_lm, prompt, STEPS, kv_cache=kv_cache,
                        mesh=jax_dp_tp_mesh(2, data_parallel=2), model_axis="model")
    got = et.generate(port_lm, prompt, STEPS, kv_cache=kv_cache,
                      mesh=dp_tp_mesh(2, data_parallel=2, device="cpu"), model_axis="model")
    assert got.dtype == np.int32 and got.shape == (3, 5 + STEPS)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, et.generate(port_lm, prompt, STEPS, kv_cache=kv_cache))


@pytest.mark.parametrize("case", ["data_only", "model_axis_1", "rules_replicate", "seq_axis"])
def test_other_meshes_equal_unmeshed(port_lm, case):
    """Meshes whose copies are whole (no model axis, a 1-wide one, rules
    that shard nothing) or whose batch spans two axes decode what the
    unmeshed generate decodes."""
    prompt = _prompts(rows=5, seed=4)
    kwargs = {
        "data_only": dict(mesh=Mesh(["cpu"] * 4, ("data",))),
        "model_axis_1": dict(mesh=dp_tp_mesh(1, data_parallel=4, device="cpu"),
                             model_axis="model"),
        "rules_replicate": dict(mesh=dp_tp_mesh(2, data_parallel=2, device="cpu"),
                                model_axis="model", rules=[]),
        "seq_axis": dict(mesh=Mesh([[["cpu"] * 2] * 2], ("stage", "data", "seq")),
                         batch_axes=("data", "seq")),
    }[case]
    for kv_cache in (False, True):
        np.testing.assert_array_equal(
            et.generate(port_lm, prompt, 6, kv_cache=kv_cache, **kwargs),
            et.generate(port_lm, prompt, 6, kv_cache=kv_cache))


@pytest.mark.parametrize("batch_axes", [("seq",), ("data", "workers"), "stages"])
def test_batch_axes_missing_from_the_mesh_match_jax(jax_pair, batch_axes):
    serving_lm, port_lm = jax_pair
    prompt = _prompts()
    with pytest.raises(ValueError) as want:
        jax_generate(serving_lm, prompt, 2, mesh=jax_dp_tp_mesh(2, data_parallel=2),
                     batch_axes=batch_axes)
    with pytest.raises(ValueError) as got:
        et.generate(port_lm, prompt, 2, mesh=dp_tp_mesh(2, data_parallel=2, device="cpu"),
                    batch_axes=batch_axes)
    assert str(got.value) == str(want.value)


def test_shards_attend_over_their_own_heads(port_lm, monkeypatch):
    """Under a 2-way model axis every attention call of the decode runs on
    one head of the LM's two (the flash forward of the recomputing path
    and the span decode over a shard's own cache), and the first step's
    logits of a sharded copy are within 1e-5 of the whole model's."""
    heads = []
    for name in ("flash_attention_qkv", "flash_span_decode"):
        real = getattr(port_transformer, name)

        def spy(q, *args, real=real, **kwargs):
            heads.append(q.shape[-2])
            return real(q, *args, **kwargs)

        monkeypatch.setattr(port_transformer, name, spy)
    mesh = dp_tp_mesh(2, data_parallel=2, device="cpu")
    prompt = _prompts()
    for kv_cache in (False, True):
        et.generate(port_lm, prompt, 3, kv_cache=kv_cache, mesh=mesh, model_axis="model")
    assert heads and set(heads) == {1}
    copy = tensor.decode_replicas(port_lm, mesh, ("data",), "model")[0]
    tokens = torch.from_numpy(prompt.astype(np.int64))
    with torch.no_grad():
        np.testing.assert_allclose(copy(tokens).numpy(), port_lm(tokens).numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_spark_model_generate_decodes_on_its_mesh(port_lm):
    """SparkModel(model_parallel=2).generate decodes over the wrapper's
    mesh, the batch over 'data' and the weights over 'model'."""
    sm = et.SparkModel(port_lm, model_parallel=2, device="cpu")
    assert dict(sm.mesh.shape) == {"data": 2, "model": 2}
    prompt = _prompts()
    for kv_cache in (False, True):
        np.testing.assert_array_equal(sm.generate(prompt, 8, kv_cache=kv_cache),
                                      et.generate(port_lm, prompt, 8, kv_cache=kv_cache))
