"""The port's Switch transformers (``elephas_tpu_torch.models.switch``)
against the JAX package's, on the CPU: forwards, W-worker fits, decoding,
serving and persistence.

Weights cross by Keras path (``load_keras_weights``); data is numpy from
a seed. Each JAX fit runs once (module fixtures) and its port twin trains
from the same initial weights under ``force_devices(4)``. Tolerances
(fp32, other summation orders): logits and probabilities 1e-4; fit
histories (the task loss plus the layers' load-balance losses, as the
reference's total) 1e-4 relative, ``evaluate`` too; final weights within
1e-4. Tokens at temperature 0 are equal: ``generate`` (full and cached),
``SparkModel.generate`` and the engine on the fixed arena, the paged arena,
with speculative decoding and with chunked prefill and the prefix cache,
on weights the port trained (the JAX LM holding the same), where ``k ·
capacity_factor ≥ num_experts`` (nothing drops). The reference's
MoE serving cases of ``tests/test_serving_flash.py`` run on the port
through ``tests/_port_cases.py``.
"""

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
import tests.test_serving_flash as ref_serving
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.models import generate as jax_generate
from elephas_tpu.models import switch_transformer_classifier as jax_classifier
from elephas_tpu.models import switch_transformer_lm as jax_lm
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.ops.moe import moe_ffn_reference
from elephas_tpu_torch.training import auxiliary_losses
from elephas_tpu_torch.utils.weights import get_weights, weight_paths
from tests._port_cases import port_namespace
from tests.test_moe import _token_blobs

W = 4
ATOL = 1e-4
CLASSIFIER = dict(vocab_size=64, maxlen=16, num_classes=2, d_model=32, num_heads=2,
                  num_layers=1, num_experts=4, expert_hidden=64, k=2, dropout=0.0, seed=0,
                  lr=3e-3, aux_weight=5e-2)
# tests/test_moe.py's LM: k·cf = 4 ≥ E = 2, so nothing drops
LM = dict(vocab_size=8, maxlen=16, d_model=32, num_heads=2, num_layers=1, num_experts=2,
          k=2, capacity_factor=2.0, dropout=0.0, lr=1e-2, seed=0)
CLF_ROWS, CLF_EPOCHS, CLF_BATCH = 128, 2, 16
LM_EPOCHS, LM_BATCH = 4, 32


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


def _pair(jax_builder, port_builder, cfg):
    ref = jax_builder(**cfg)
    port = port_builder(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    return ref, port


def _periodic(n=256, maxlen=16, seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.integers(2, 6, size=n)
    seq = (starts[:, None] + np.arange(maxlen + 1)) % 4 + 2
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def _fit_both(jax_builder, port_builder, cfg, data, epochs, batch, **modes):
    ref, port = _pair(jax_builder, port_builder, cfg)
    j_sm = JaxSparkModel(ref, num_workers=W, **modes)
    want = j_sm.fit(data, epochs=epochs, batch_size=batch)
    previous = force_devices(W)
    try:
        p_sm = et.SparkModel(port, num_workers=W, device="cpu", **modes)
        got = p_sm.fit(data, epochs=epochs, batch_size=batch)
    finally:
        force_devices(previous)
    return {"ref": ref, "port": port, "j_sm": j_sm, "p_sm": p_sm, "want": want, "got": got}


@pytest.fixture(scope="module", params=[
    dict(mode="synchronous"), dict(mode="asynchronous", frequency="batch")],
    ids=["synchronous", "asynchronous-batch"])
def classifier_fit(request):
    return _fit_both(jax_classifier, et.switch_transformer_classifier, CLASSIFIER,
                     _token_blobs(n=CLF_ROWS), CLF_EPOCHS, CLF_BATCH, **request.param)


@pytest.fixture(scope="module")
def lm_fit():
    return _fit_both(jax_lm, et.switch_transformer_lm, LM, _periodic(), LM_EPOCHS, LM_BATCH)


@pytest.fixture(scope="module")
def trained_lm():
    """The port LM trained on the periodic rows (one worker), and the JAX
    LM holding the same weights (Keras's get_weights() order): the pair the
    decoding and serving tests compare."""
    port = et.switch_transformer_lm(**LM, device="cpu")
    sm = et.SparkModel(port, device="cpu")
    sm.fit(_periodic(), epochs=LM_EPOCHS, batch_size=LM_BATCH)
    ref = jax_lm(**LM)
    ref.set_weights(get_weights(port))
    return ref, port, sm


# -- forwards -----------------------------------------------------------


@pytest.mark.parametrize("rope", [False, True])
def test_lm_logits_match_jax(rope):
    cfg = dict(vocab_size=61, maxlen=16, d_model=64, num_heads=2, num_layers=2,
               num_experts=4, k=2, capacity_factor=1.25, rope=rope, seed=3)
    ref, port = _pair(jax_lm, et.switch_transformer_lm, cfg)
    x = np.random.default_rng(0).integers(0, 61, (2, 16)).astype(np.int32)
    with torch.inference_mode():
        logits = port(torch.from_numpy(x).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref(x, training=False)),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_classifier_matches_jax(num_classes):
    cfg = dict(vocab_size=61, maxlen=16, num_classes=num_classes, d_model=64, num_heads=2,
               num_layers=2, num_experts=4, k=1, seed=4)
    ref, port = _pair(jax_classifier, et.switch_transformer_classifier, cfg)
    x = np.random.default_rng(1).integers(0, 61, (3, 16)).astype(np.int32)
    with torch.inference_mode():
        probs = port(torch.from_numpy(x).long())
    assert probs.shape == (3, num_classes)
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref(x, training=False)),
                               atol=ATOL, rtol=0)


def test_weights_in_keras_order_and_builder_defaults():
    """get_weights' order is the reference's model.weights order (the
    parameter server's wire); the builders' defaults are the reference's."""
    for jax_builder, port_builder in ((jax_lm, et.switch_transformer_lm),
                                      (jax_classifier, et.switch_transformer_classifier)):
        ref, port = _pair(jax_builder, port_builder, dict(vocab_size=16, maxlen=8, d_model=8,
                                                          num_heads=2, num_layers=2))
        assert weight_paths(port) == [v.path for v in ref.weights]
        spec = port.build_spec["kwargs"]
        moe = ref.get_layer("blk0_moe")
        assert (spec["num_experts"], spec["k"], spec["capacity_factor"], spec["aux_weight"]) \
            == (moe.num_experts, moe.k, moe.capacity_factor, moe.aux_weight)
        assert port.blocks[0].moe.d_hidden == moe.d_hidden == 32


def test_moe_ffn_layer_adds_its_loss_only_in_training():
    layer = et.MoeFFN(4, 32, k=2, aux_weight=0.5).eval()  # built at the first call
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    with auxiliary_losses() as losses:
        out = layer(x)
    assert out.shape == x.shape and losses == []
    assert tuple(layer.expert_w1.shape) == (4, 16, 32)
    layer.train()
    with auxiliary_losses() as losses:
        layer(x)
    _, aux = moe_ffn_reference(x.reshape(-1, 16), *layer.weights(), 1.25,
                               torch.nn.functional.gelu, k=2, return_aux=True)
    assert len(losses) == 1 and torch.allclose(losses[0], 0.5 * aux)


# -- fits ----------------------------------------------------------------


def _check_fit(fit):
    got, want = fit["got"], fit["want"]
    assert list(got) == list(want), (got, want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    ref_weights = _keras_weights(fit["ref"])
    for path, w in et.keras_weights(fit["port"]).items():
        np.testing.assert_allclose(w, ref_weights[path], atol=ATOL, rtol=0, err_msg=path)


def test_classifier_fit_matches_jax(classifier_fit):
    """History (the loss with the load-balance term: without it the loss
    would part from the reference's by aux_weight · aux ≈ 0.05), accuracy,
    final weights, and evaluate (task loss only, as Keras evaluates with
    training=False)."""
    _check_fit(classifier_fit)
    x, y = _token_blobs(n=CLF_ROWS)
    previous = force_devices(W)
    try:
        got = classifier_fit["p_sm"].evaluate(x, y, batch_size=32)
    finally:
        force_devices(previous)
    want = classifier_fit["j_sm"].evaluate(x, y, batch_size=32)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_lm_fit_matches_jax(lm_fit):
    _check_fit(lm_fit)
    assert lm_fit["got"]["loss"][-1] < lm_fit["got"]["loss"][0]


# -- decoding and serving ---------------------------------------------------


def _prompts():
    return np.array([[2, 3, 4, 5], [4, 5, 2, 3], [3, 4, 5, 2]], np.int32)


@pytest.mark.parametrize("kv_cache", [False, True])
def test_generate_matches_jax(trained_lm, kv_cache):
    ref, port, _ = trained_lm
    want = jax_generate(ref, _prompts(), steps=8, kv_cache=kv_cache)
    got = et.generate(port, _prompts(), 8, kv_cache=kv_cache)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(et.SparkModel(port, device="cpu").generate(
        _prompts(), 8, kv_cache=kv_cache), want)


@pytest.mark.parametrize("options", [
    dict(), dict(paged=True, block_size=4), dict(speculative=True, spec_k=3),
    dict(paged=True, block_size=4, speculative=True, spec_k=3),
    dict(prefill_chunk=4, prefix_cache=True)],
    ids=["fixed", "paged", "speculative", "paged-speculative", "chunked-prefix"])
def test_engine_matches_jax_generate(trained_lm, options):
    ref, port, _ = trained_lm
    prompts = [np.array(p, np.int32) for p in ([2, 3, 4, 5], [4, 5, 2], [3, 4, 5, 2, 3, 4])]
    want = [jax_generate(ref, p[None], steps=6, kv_cache=True)[0].tolist() for p in prompts]
    engine = et.InferenceEngine(port, num_slots=2, **options)
    got = engine.run([(p, 6) for p in prompts])
    assert [seq.tolist() for _rid, seq in sorted(got.items())] == want
    engine.release_telemetry()


def test_spark_model_serves_the_switch_lm(trained_lm):
    ref, port, _ = trained_lm
    engine = et.SparkModel(port, device="cpu").serve(num_slots=2)
    got = engine.run([(_prompts()[0], 6)])
    assert [seq.tolist() for seq in got.values()] == \
        [jax_generate(ref, _prompts()[:1], steps=6, kv_cache=True)[0].tolist()]
    engine.release_telemetry()


@pytest.fixture(scope="module")
def switch_lm():
    """The reference fixture's model (tests/test_serving_flash.py) on the
    port."""
    return et.switch_transformer_lm(vocab_size=16, maxlen=32, d_model=32, num_heads=2,
                                    num_layers=1, num_experts=2, k=2, capacity_factor=2.0,
                                    dropout=0.0, seed=0, device="cpu")


_SERVING_NS = port_namespace(ref_serving, InferenceEngine=et.InferenceEngine)
test_switch_moe_serves_fixed_and_paged = _SERVING_NS["test_switch_moe_serves_fixed_and_paged"]
test_switch_moe_speculative_serving = _SERVING_NS["test_switch_moe_speculative_serving"]


# -- persistence and refusals --------------------------------------------------


def test_save_and_load_spark_model_bit_equal(trained_lm, tmp_path):
    _, port, sm = trained_lm
    path = str(tmp_path / "switch.pt")
    sm.save(path)
    loaded = et.load_spark_model(path, device="cpu")
    x = _periodic(8)[0]
    np.testing.assert_array_equal(loaded.predict(x), sm.predict(x))
    for path_, w in et.keras_weights(loaded.master_network).items():
        np.testing.assert_array_equal(w, et.keras_weights(port)[path_])


@pytest.mark.parametrize("option", ["model_parallel", "pipeline_parallel",
                                    "sequence_parallel"])
def test_scale_out_refusals_cite_item_5(option):
    port = et.switch_transformer_classifier(**CLASSIFIER, device="cpu")
    et.SparkModel(port, device="cpu", **{option: 1})
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue A item 5\b"):
        et.SparkModel(port, device="cpu", **{option: 2})


def test_builders_refuse_k_above_num_experts():
    with pytest.raises(ValueError, match="exceed"):
        et.switch_transformer_lm(vocab_size=8, maxlen=8, d_model=8, num_heads=2,
                                 num_experts=2, k=3, device="cpu")
