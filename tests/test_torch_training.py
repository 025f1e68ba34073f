"""The port's training slice against the JAX package's, on the CPU:
Keras's Adam, the compiled losses and accuracy, first-step gradients of
both transformer builders, and ``SparkModel`` fit/evaluate/predict end to
end, plus the port's refusals.

Weights cross as ``{v.path: np.asarray(v)}`` through
``load_keras_weights`` (and back through ``keras_weights``); inputs are
numpy arrays made from a seed. The JAX side runs as its own tests run it:
Pallas in interpret mode on the CPU. Tolerances (fp32, different
summation orders) are stated at each comparison:
- Adam: 1e-7 absolute over 5 steps;
- losses and accuracy: 1e-6 relative;
- first-step gradients: 1e-5 of each tensor's largest magnitude;
- fit: per-epoch loss/accuracy and evaluate within 1e-4 relative,
  predictions within 1e-4; final weights with 99.9 % of elements within
  1e-5 and every element within 2·lr·steps (the most Adam can move a
  weight whose tiny gradient changed sign at rounding).
"""

import logging

import jax
import keras
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.data import SparkContext as JaxSparkContext
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu.models import transformer_lm as jax_lm
from elephas_tpu.utils.rdd_utils import to_simple_rdd as jax_to_simple_rdd
from elephas_tpu_torch import training
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.device import worker_count
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.utils.weights import _keras_paths
from elephas_tpu_torch.worker import FREQUENCIES, MODES, pad_to_batches, stack_worker_batches

CLF = dict(vocab_size=61, maxlen=16, d_model=32, num_heads=2, num_layers=2, dropout=0.0)
LM = dict(vocab_size=17, maxlen=16, d_model=32, num_heads=2, num_layers=2)


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _labels(classes, n, seed):
    return np.random.default_rng(seed).integers(0, classes, n).astype(np.int32)


def _port_from(ref, build, cfg):
    port = build(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    return port


# -- Adam -----------------------------------------------------------------


@pytest.mark.parametrize("lr", [1e-3, 3e-4])
def test_adam_matches_keras(lr):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    kvars = [keras.Variable(a) for a in init]
    kopt = keras.optimizers.Adam(lr)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    topt = Adam(params, lr=lr)
    for step in grads:
        kopt.apply_gradients(zip([keras.ops.convert_to_tensor(g) for g in step], kvars))
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        topt.step()
        for p, kv in zip(params, kvars):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(kv), atol=1e-7, rtol=0)
    assert all(topt.state[p]["step"] == 5 for p in params)


def test_adam_differs_from_torch_adam():
    """The reason the port carries its own Adam: torch's puts epsilon
    inside the bias correction (and defaults it to 1e-8)."""
    g = torch.full((3,), 1e-6)
    ours = torch.nn.Parameter(torch.zeros(3))
    theirs = torch.nn.Parameter(torch.zeros(3))
    ours.grad, theirs.grad = g.clone(), g.clone()
    Adam([ours], lr=1e-3).step()
    torch.optim.Adam([theirs], lr=1e-3).step()
    assert not torch.allclose(ours, theirs, rtol=1e-3, atol=0)


# -- losses and accuracy --------------------------------------------------


def _probs(shape, seed):
    p = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    p[0, 0] = 0.0  # values at 0 and 1 meet the clip
    p[1] = 0.0
    p[1, -1] = 1.0
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("case", ["logits", "probabilities", "one_class"])
def test_losses_and_accuracy_match_keras(case):
    rng = np.random.default_rng(1)
    if case == "logits":
        y_pred = rng.normal(size=(3, 5, 7)).astype(np.float32) * 4
        y = _labels(7, 15, 2).reshape(3, 5)
        loss = keras.losses.SparseCategoricalCrossentropy(from_logits=True)
        ours = lambda a, b: training.sparse_categorical_crossentropy(a, b, from_logits=True)  # noqa: E731
        metric, our_metric = keras.metrics.SparseCategoricalAccuracy(), \
            training.sparse_categorical_accuracy
    elif case == "probabilities":
        y_pred = _probs((6, 4), 3)
        y = _labels(4, 6, 4)
        y[1] = 0  # the label's probability is 0: log of the clip
        loss = keras.losses.SparseCategoricalCrossentropy()
        ours = training.sparse_categorical_crossentropy
        metric, our_metric = keras.metrics.SparseCategoricalAccuracy(), \
            training.sparse_categorical_accuracy
    else:
        y_pred = rng.uniform(size=(8, 1)).astype(np.float32)
        y_pred[0, 0], y_pred[1, 0], y_pred[2, 0] = 0.0, 1.0, 0.5
        y = _labels(2, 8, 5)
        loss = keras.losses.BinaryCrossentropy()
        ours = training.binary_crossentropy
        metric, our_metric = keras.metrics.BinaryAccuracy(), training.binary_accuracy
    t_y, t_pred = torch.from_numpy(y), torch.from_numpy(y_pred)
    got = ours(t_y, t_pred)
    np.testing.assert_allclose(got.mean().item(), float(loss(y, y_pred)), rtol=1e-6)
    m = training.MeanMetric("cpu")
    m.update(our_metric(t_y, t_pred))
    metric.update_state(y, y_pred)
    np.testing.assert_allclose(m.result(), float(metric.result()), rtol=1e-6)


def test_compile_model_resolves_accuracy_like_keras():
    m = et.transformer_classifier(**CLF, num_classes=1, device="cpu")
    assert m.training_spec.metrics == {"accuracy": training.binary_accuracy}
    m = et.transformer_lm(**LM, device="cpu")
    assert m.training_spec.metrics == {"accuracy": training.sparse_categorical_accuracy}
    assert isinstance(m.training_spec.optimizer, Adam)
    assert m.training_spec.optimizer.defaults["lr"] == 3e-4
    with pytest.raises(ValueError, match="unsupported loss"):
        training.compile_model(m, m.training_spec.optimizer, "hinge")
    with pytest.raises(ValueError, match="unsupported metric"):
        training.compile_model(m, m.training_spec.optimizer, "binary_crossentropy", ["auc"])


# -- first-step gradients -------------------------------------------------


def _jax_grads(model, x, y):
    tv = [v.value for v in model.trainable_variables]
    ntv = [v.value for v in model.non_trainable_variables]

    def loss_fn(tv):
        y_pred, _ = model.stateless_call(tv, ntv, x, training=True)
        return model.compute_loss(x=x, y=y, y_pred=y_pred)

    grads = jax.grad(loss_fn)(tv)
    return {v.path: np.asarray(g) for v, g in zip(model.trainable_variables, grads)}


@pytest.mark.parametrize("kind", ["lm", "lm_rope", "classifier", "classifier_one_class"])
def test_first_step_gradients_match_jax(kind):
    if kind.startswith("lm"):
        cfg = dict(LM, rope=kind == "lm_rope", seed=3)
        ref, build = jax_lm(**cfg), et.transformer_lm
        x = _tokens(17, (4, 16), 0)
        y = np.roll(x, -1, axis=1)
    else:
        cfg = dict(CLF, num_classes=1 if kind.endswith("one_class") else 3, seed=4)
        ref, build = jax_classifier(**cfg), et.transformer_classifier
        x = _tokens(61, (4, 16), 1)
        y = _labels(cfg["num_classes"] + (cfg["num_classes"] == 1), 4, 2)
    want = _jax_grads(ref, x, y)
    port = _port_from(ref, build, cfg)
    port.train()
    t_x, t_y = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    port.training_spec.loss(t_y, port(t_x)).mean().backward()
    paths = _keras_paths(port)
    assert set(paths) == set(want)
    for path, (param, transpose) in paths.items():
        got = param.grad.numpy()
        got = got.T if transpose else got
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(got, want[path], atol=1e-5 * scale, rtol=0, err_msg=path)


# -- SparkModel end to end --------------------------------------------------


def _check_weights(port, ref, lr, steps):
    want = _keras_weights(ref)
    got = et.keras_weights(port)
    assert set(got) == set(want)
    bound = 2 * lr * steps
    for path, w in want.items():
        diff = np.abs(got[path] - w)
        assert diff.max() <= bound, (path, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, (path, np.mean(diff <= 1e-5))


@pytest.mark.parametrize("source", ["arrays", "rdd"])
def test_spark_model_fit_matches_jax(source):
    """The classifier: 50 rows, batch 16 (four wrap-padded batches), two
    epochs, one worker on each side."""
    cfg = dict(CLF, num_classes=2, seed=1)
    ref = jax_classifier(**cfg)
    port = _port_from(ref, et.transformer_classifier, cfg)
    x, y = _tokens(61, (50, 16), 0), _labels(2, 50, 1)
    if source == "rdd":
        j_data = jax_to_simple_rdd(JaxSparkContext("local[2]"), x, y)
        t_data = et.to_simple_rdd(SparkContext("local[2]"), x, y)
    else:
        j_data = t_data = (x, y)
    j_sm = JaxSparkModel(ref, num_workers=1)
    t_sm = et.SparkModel(port, device="cpu")
    j_hist = j_sm.fit(j_data, epochs=2, batch_size=16)
    t_hist = t_sm.fit(t_data, epochs=2, batch_size=16)
    assert list(t_hist) == list(j_hist) == ["loss", "accuracy"]
    for key in j_hist:
        np.testing.assert_allclose(t_hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    assert t_sm.training_histories == [t_hist]
    assert not port.training  # fit restores eval mode
    _check_weights(port, ref, lr=1e-3, steps=8)
    np.testing.assert_allclose(t_sm.evaluate(x, y, batch_size=16),
                               j_sm.evaluate(x, y, batch_size=16), rtol=1e-4)
    np.testing.assert_allclose(t_sm.predict(x[:21], batch_size=8),
                               j_sm.predict(x[:21], batch_size=8), atol=1e-4, rtol=0)


def test_spark_model_fit_lm_matches_jax():
    """The LM: per-token targets [B, S], loss from logits. (The
    reference's evaluate cannot weight a [B, S] loss by [B] row weights,
    so only fit and predict are compared.)"""
    cfg = dict(LM, seed=2)
    ref = jax_lm(**cfg)
    port = _port_from(ref, et.transformer_lm, cfg)
    x = _tokens(17, (20, 16), 3)
    y = np.roll(x, -1, axis=1)
    j_sm = JaxSparkModel(ref, num_workers=1)
    t_sm = et.SparkModel(port, device="cpu")
    j_hist = j_sm.fit((x, y), epochs=2, batch_size=8)
    t_hist = t_sm.fit((x, y), epochs=2, batch_size=8)
    for key in j_hist:
        np.testing.assert_allclose(t_hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    _check_weights(port, ref, lr=3e-4, steps=6)
    np.testing.assert_allclose(t_sm.predict(x[:5]), j_sm.predict(x[:5]), atol=1e-4, rtol=0)


def test_keras_weights_round_trips():
    port = et.transformer_lm(**LM, rope=True, device="cpu")
    weights = et.keras_weights(port)
    assert weights["blk0_attn/qkv/kernel"].shape == (32, 96)
    other = et.transformer_lm(**LM, rope=True, seed=9, device="cpu")
    et.load_keras_weights(other, weights)
    for name, value in et.keras_weights(other).items():
        np.testing.assert_array_equal(value, weights[name])


# -- one worker: the nine mode x frequency pairs, and the refusals ---------


@pytest.fixture(scope="module")
def one_worker_data():
    return _tokens(61, (20, 16), 4), _labels(2, 20, 5)


def _fit_weights(mode, frequency, data):
    port = et.transformer_classifier(**CLF, num_classes=2, seed=6, device="cpu")
    sm = et.SparkModel(port, mode=mode, frequency=frequency, device="cpu")
    hist = sm.fit(data, epochs=2, batch_size=8)
    return hist, et.keras_weights(port)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("frequency", FREQUENCIES)
def test_mode_frequency_pairs_train_identically(mode, frequency, one_worker_data):
    hist, weights = _fit_weights(mode, frequency, one_worker_data)
    ref_hist, ref_weights = _fit_weights("synchronous", "epoch", one_worker_data)
    assert hist == ref_hist
    for name, value in ref_weights.items():
        np.testing.assert_array_equal(weights[name], value)


def test_padding_and_batch_order_match_the_reference():
    from elephas_tpu.worker import pad_to_batches as jax_pad
    from elephas_tpu.worker import stack_worker_batches as jax_stack

    x = np.arange(14).reshape(7, 2)
    np.testing.assert_array_equal(pad_to_batches(x, 3, 3), jax_pad(x, 3, 3))
    parts = [(x, x[:, 0]), (x[:3], x[:3, 0])]
    for got, want in zip(stack_worker_batches(parts, 4), jax_stack(parts, 4)):
        np.testing.assert_array_equal(got, want)


def test_fit_trains_in_train_mode_with_seeded_dropout():
    """fit switches the module to train() (dropout on) and back; masks
    come from the seeded generators, so a rebuild repeats the run."""
    def run():
        port = et.transformer_classifier(**dict(CLF, dropout=0.3), num_classes=2,
                                         seed=7, device="cpu")
        modes = []
        port.blocks[0].register_forward_hook(lambda mod, i, o: modes.append(mod.training))
        hist = et.SparkModel(port, device="cpu").fit(
            (_tokens(61, (16, 16), 6), _labels(2, 16, 7)), epochs=1, batch_size=8)
        return port, modes, hist

    port, modes, hist = run()
    assert modes == [True, True] and not port.training
    assert run()[2] == hist


def test_refusals(tmp_path):
    port = et.transformer_classifier(**CLF, device="cpu")
    bare = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="compiled"):
        et.SparkModel(bare, device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        et.SparkModel(port, mode="eventual", device="cpu")
    with pytest.raises(ValueError, match="frequency must be"):
        et.SparkModel(port, frequency="hourly", device="cpu")
    with pytest.raises(ValueError, match="parameter_server_mode must be"):
        et.SparkModel(port, parameter_server_mode="grpc", device="cpu")
    for kwargs in (dict(model_parallel=2), dict(pipeline_parallel=2),
                   dict(sequence_parallel=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            et.SparkModel(port, device="cpu", **kwargs)
    # ported since: the parameter server
    assert et.SparkModel(port, parameter_server_mode="socket", device="cpu").ps_endpoints is None
    with pytest.raises(ValueError, match="ps_shards > 1 needs"):
        et.SparkModel(port, parameter_server_mode="native", ps_shards=2, device="cpu")
    sm = et.SparkModel(port, device="cpu")
    data = (_tokens(61, (4, 16), 0), _labels(2, 4, 0))
    # ported since: streaming, validation, checkpoints and resume, save and load
    for kwargs in (dict(steps_per_epoch=2), dict(stream_block_steps=2)):
        assert len(sm.fit(data, epochs=1, batch_size=2, **kwargs)["loss"]) == 1
    hist = sm.fit(data, epochs=1, validation_split=0.25,
                  checkpoint_dir=str(tmp_path / "ckpt"), resume=True)
    assert sorted(hist) == ["accuracy", "loss", "val_accuracy", "val_loss"]
    sm.save(str(tmp_path / "m.pt"))
    assert et.load_spark_model(str(tmp_path / "m.pt"), device="cpu").num_workers == 1
    # the engine and its gateway are ported: a classifier is refused as the
    # reference refuses it, with or without a gateway port
    for kwargs in ({}, dict(gateway_port=0)):
        with pytest.raises(ValueError, match="causal by construction"):
            sm.serve(**kwargs)


def test_worker_count_clamps_like_the_reference(monkeypatch, caplog):
    with caplog.at_level(logging.WARNING, logger="elephas_tpu_torch.device"):
        assert worker_count(4, "cpu") == 1
    assert "clamping" in caplog.text
    assert worker_count(None, "cpu") == 1
    # a host with two cards: several physical GPUs in one process are
    # refused, naming the launcher (one rank a card), rather than quietly
    # taking one worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="python -m elephas_tpu_torch.launch"):
        worker_count(None, "cuda:0")
    assert worker_count(1, "cuda:0") == 1
    port = et.transformer_classifier(**CLF, device="cpu")
    with pytest.raises(NotImplementedError, match="2 workers on 2 CUDA devices"):
        et.SparkModel(port, device="cuda:0")
    assert et.SparkModel(port, num_workers=1, device="cpu").num_workers == 1
