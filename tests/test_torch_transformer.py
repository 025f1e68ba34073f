"""The port's transformer family (``elephas_tpu_torch``) against the JAX
package's, on the CPU: forward logits on the same Keras weights, greedy
``generate`` tokens, the sampling filter, argument errors, and the
port's device and import rules.

Weights cross as ``{v.path: np.asarray(v)}`` through
``load_keras_weights``; inputs are numpy arrays made from a seed. Logits
and probabilities agree within 1e-4 (fp32, different summation orders).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.models.transformer import _filter_logits as jax_filter_logits
from elephas_tpu.models.transformer import generate as jax_generate
from elephas_tpu_torch.device import force_devices, resolve_device
from elephas_tpu_torch.models.transformer import _filter_logits

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d_model", [64, 128])
def test_lm_logits_match_jax(d_model, rope):
    """d64/H2 has head_dim 32 and d128/H2 head_dim 64 (the JAX side's
    transposed and lane-grouped kernels); rope takes the bhsd path."""
    cfg = dict(vocab_size=61, maxlen=32, d_model=d_model, num_heads=2,
               num_layers=2, rope=rope, seed=3)
    ref = jax_lm(**cfg)
    port = et.transformer_lm(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    x = _tokens(61, (2, 32))
    with torch.inference_mode():
        logits = port(torch.from_numpy(x).long())
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(ref(x, training=False)), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("num_classes", [1, 3])
def test_classifier_matches_jax(num_classes):
    cfg = dict(vocab_size=61, maxlen=32, num_classes=num_classes, d_model=64,
               num_heads=2, num_layers=2, seed=4)
    ref = jax_classifier(**cfg)
    port = et.transformer_classifier(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    x = _tokens(61, (3, 32), seed=1)
    with torch.inference_mode():
        probs = port(torch.from_numpy(x).long())
    assert probs.shape == (3, num_classes)
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(ref(x, training=False)), atol=ATOL, rtol=0
    )


@pytest.mark.parametrize("sampling", [
    dict(),
    # top_k=1 leaves one token: sampling must reproduce greedy
    dict(temperature=0.7, top_k=1, seed=5),
])
def test_generate_tokens_match_jax(serving_lm, sampling):
    port = et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2,
                             num_layers=2, device="cpu")
    et.load_keras_weights(port, _keras_weights(serving_lm))
    rng = np.random.default_rng(7)
    starts = rng.integers(2, 6, size=4)
    prompt = ((starts[:, None] + np.arange(6)) % 4 + 2).astype(np.int32)
    want = jax_generate(serving_lm, prompt, 16)
    got = et.generate(port, prompt, 16, **sampling)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_cache", [False, True])
def test_spark_model_generate_matches_generate_and_jax(serving_lm, kv_cache):
    """SparkModel.generate is the port's generate on the master network:
    token for token, and equal to the JAX generate on the same Keras
    weights at temperature 0."""
    port = et.transformer_lm(vocab_size=8, maxlen=32, d_model=32, num_heads=2,
                             num_layers=2, device="cpu")
    et.load_keras_weights(port, _keras_weights(serving_lm))
    rng = np.random.default_rng(9)
    starts = rng.integers(2, 6, size=3)
    prompt = ((starts[:, None] + np.arange(5)) % 4 + 2).astype(np.int32)
    got = et.SparkModel(port, device="cpu").generate(prompt, 12, kv_cache=kv_cache)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, et.generate(port, prompt, 12, kv_cache=kv_cache))
    np.testing.assert_array_equal(got, jax_generate(serving_lm, prompt, 12, kv_cache=kv_cache))


@pytest.mark.parametrize("option", ["model_parallel", "pipeline_parallel", "sequence_parallel"])
def test_scale_out_refusals_cite_item_5(lm_pair, option):
    """Pipeline and sequence parallelism still refuse, naming item 5.
    model_parallel is ported (item 5c, tests/test_torch_tensor_parallel.py):
    on 2 worker slots it builds its 1 × 2 mesh; on the CPU's one slot it
    raises the reference's ValueError."""
    _, port = lm_pair
    et.SparkModel(port, device="cpu", **{option: 1})
    if option == "model_parallel":
        with pytest.raises(ValueError, match=r"model_parallel=2 exceeds the 1 available"):
            et.SparkModel(port, device="cpu", model_parallel=2)
        previous = force_devices(2)
        try:
            sm = et.SparkModel(port, device="cpu", model_parallel=2)
        finally:
            force_devices(previous)
        assert dict(sm.mesh.shape) == {"data": 1, "model": 2}
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue A item 5\b"):
        et.SparkModel(port, device="cpu", **{option: 2})


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9), (7, 0.5), (None, 1.0)])
def test_filter_logits_matches_jax(top_k, top_p):
    x = (np.random.default_rng(2).normal(size=(4, 50)) * 3).astype(np.float32)
    want = np.asarray(jax_filter_logits(x, top_k, top_p))
    got = _filter_logits(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def lm_pair():
    cfg = dict(vocab_size=8, maxlen=16, d_model=32, num_heads=2, num_layers=1)
    return jax_lm(**cfg), et.transformer_lm(**cfg, device="cpu")


@pytest.mark.parametrize("prompt_len,kwargs", [
    (12, dict(steps=8)),
    (4, dict(steps=4, top_k=0)),
    (4, dict(steps=4, top_k=9)),
    (4, dict(steps=4, top_p=0.0)),
    (4, dict(steps=4, top_p=1.5)),
])
def test_generate_argument_errors_match_jax(lm_pair, prompt_len, kwargs):
    ref, port = lm_pair
    prompt = np.ones((1, prompt_len), np.int32)
    with pytest.raises(ValueError) as j_err:
        jax_generate(ref, prompt, **kwargs)
    with pytest.raises(ValueError) as t_err:
        et.generate(port, prompt, **kwargs)
    assert str(t_err.value) == str(j_err.value)


def test_unported_options_raise(lm_pair):
    _, port = lm_pair
    # the SP prefill is ported (tests/test_torch_sp_prefill.py); the
    # engine's decode mesh is still to port
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        et.InferenceEngine(port, mesh="mesh")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        et.transformer_lm(vocab_size=8, maxlen=16, d_model=32, num_heads=2,
                          num_layers=1, dtype_policy="mixed_float16", device="cpu")


def test_load_keras_weights_rejects_mismatches(lm_pair):
    ref, port = lm_pair
    weights = _keras_weights(ref)
    missing = dict(weights)
    del missing["blk0_attn/qkv/kernel"]
    with pytest.raises(ValueError, match="missing"):
        et.load_keras_weights(port, missing)
    with pytest.raises(ValueError, match="unexpected"):
        et.load_keras_weights(port, {**weights, "head/bias": np.zeros(2)})
    bad = dict(weights)
    bad["blk0_mlp1/kernel"] = bad["blk0_mlp1/kernel"].T
    with pytest.raises(ValueError, match="blk0_mlp1/kernel"):
        et.load_keras_weights(port, bad)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        et.transformer_lm(vocab_size=8, maxlen=16, d_model=32, num_heads=2, num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        et.transformer_classifier(vocab_size=8, maxlen=16, d_model=32, num_heads=2,
                                  num_layers=1)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_import_loads_no_jax_keras_or_reference():
    code = (
        "import importlib, pkgutil, sys, elephas_tpu_torch\n"
        "for m in pkgutil.walk_packages(elephas_tpu_torch.__path__, 'elephas_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'keras', 'ml_dtypes', 'elephas_tpu')]\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_chip_smoke_imports_no_jax_keras_or_reference():
    """chip_smoke.py, the port's driver on the card, loads none of them
    either (the gateway, parameter-server, fleet, deploy, gang and
    sequence-parallel phases' modules included)."""
    code = (
        "import sys; sys.argv = ['chip_smoke.py']\n"
        "import chip_smoke, elephas_tpu_torch.serving.gateway, elephas_tpu_torch.fleet\n"
        "import elephas_tpu_torch.parameter.native, elephas_tpu_torch.fault\n"
        "import elephas_tpu_torch.deploy, elephas_tpu_torch.telemetry.merge\n"
        "import elephas_tpu_torch.launch, elephas_tpu_torch.ops.ring_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'keras', 'ml_dtypes', 'elephas_tpu')]\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_import_check_walks_every_module():
    """The subprocess check above imports what ``pkgutil`` finds: every
    module of the package, the training, serving, parameter-server, fleet
    and deployment slices' included."""
    import pkgutil

    found = {m.name for m in pkgutil.walk_packages(et.__path__, "elephas_tpu_torch.")}
    for name in ("ops.layer_norm", "ops.flash_attention", "training", "optimizers",
                 "worker", "spark_model", "device", "data.context", "data.rdd",
                 "utils.rdd_utils", "utils.weights", "models.transformer",
                 "ops.flash_serving", "serving.kv_cache", "serving.scheduler",
                 "serving.engine", "data.streaming", "data.dataframe", "data.linalg",
                 "mllib.adapter", "ml.params", "ml.adapter", "ml.pipeline", "ml_model",
                 "models.keras_config", "hyperparam", "serving.prefix_cache",
                 "serving.blocks", "serving.kv_quant", "serving.paged_kv",
                 "telemetry", "telemetry.registry", "telemetry.expose", "telemetry.events",
                 "telemetry.flight", "telemetry.watch", "fleet", "fleet.migration",
                 "serving.gateway", "parameter", "parameter.codec", "parameter.journal",
                 "parameter.server", "parameter.client", "parameter.sharding",
                 "parameter.native", "fault", "fault.plan", "fault.harness",
                 "utils.sockets", "utils.functional_utils", "fleet.placement",
                 "fleet.router", "deploy", "deploy.versions", "deploy.subscriber",
                 "deploy.rollout", "telemetry.aggregate", "telemetry.merge",
                 "serving.locks", "parallel", "parallel.distributed", "parallel.mesh",
                 "launch", "ops.ring_attention", "ops.ulysses", "serving.sp_prefill"):
        assert f"elephas_tpu_torch.{name}" in found
