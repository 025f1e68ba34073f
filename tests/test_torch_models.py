"""The port's model zoo (``mnist_mlp``, ``cifar10_cnn``, ``imdb_lstm``,
``resnet``, ``resnet50``) against the JAX package's builders on the CPU,
in float32, and the Keras layers under it: "same" padding, BatchNorm's
moving statistics, SGD, the categorical loss and accuracy, and the weight
paths both ways.

Weights cross as ``{v.path: np.asarray(v)}`` through
``load_keras_weights`` (and back through ``keras_weights``); inputs are
numpy arrays made from a seed; every dropout rate is set to 0 on both
sides after building. Tolerances (float32, different summation orders):
- forward, ``predict`` and ``evaluate`` from the same weights: 1e-5;
- a 2-epoch ``SparkModel.fit``: history and every final weight,
  BatchNorm's moving statistics included, path by path within 1e-4;
- single layers (padding, BatchNorm, SGD, losses): 1e-6 or tighter.
"""

import jax
import keras
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.models import cifar10_cnn as jax_cnn
from elephas_tpu.models import imdb_lstm as jax_lstm
from elephas_tpu.models import mnist_mlp as jax_mlp
from elephas_tpu.models import resnet as jax_resnet
from elephas_tpu_torch import training
from elephas_tpu_torch.models.layers import (
    BatchNorm,
    Conv2D,
    Dropout,
    max_pool,
    same_padding,
)
from elephas_tpu_torch.optimizers import SGD
from elephas_tpu_torch.utils.weights import _keras_paths, canonical_keras_names

ROWS, BATCH, EPOCHS = 40, 16, 2


def _rng(seed):
    return np.random.default_rng(seed)


def _images(shape, seed, rows=ROWS):
    return _rng(seed).normal(size=(rows, *shape)).astype(np.float32)


# name -> (JAX builder, port builder, config, inputs, labels' classes)
CASES = {
    "mlp": (jax_mlp, et.mnist_mlp, dict(input_dim=10, num_classes=3, hidden=8, seed=1),
            lambda: _rng(0).normal(size=(ROWS, 10)).astype(np.float32), 3),
    "cnn": (jax_cnn, et.cifar10_cnn, dict(input_shape=(16, 16, 3), num_classes=4, seed=2),
            lambda: _images((16, 16, 3), 1), 4),
    "lstm": (jax_lstm, et.imdb_lstm, dict(vocab_size=50, maxlen=8, embed_dim=8, units=8,
                                          seed=3),
             lambda: _rng(2).integers(0, 50, (ROWS, 8)).astype(np.int32), 2),
    "resnet": (jax_resnet, et.resnet, dict(input_shape=(32, 32, 3), num_classes=5,
                                           depths=(1, 1), width=8, seed=4),
               lambda: _images((32, 32, 3), 3, 48), 5),
}


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


def _no_dropout(ref, port):
    for layer in ref._flatten_layers():
        if isinstance(layer, keras.layers.Dropout):
            layer.rate = 0.0
        if isinstance(layer, keras.layers.LSTM):
            layer.cell.dropout = 0.0
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0


def _pair(name, **overrides):
    j_build, t_build, cfg, make_x, classes = CASES[name]
    cfg = {**cfg, **overrides}
    ref = j_build(**cfg)
    port = t_build(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    _no_dropout(ref, port)
    x = make_x()
    y = _rng(9).integers(0, classes, len(x)).astype(np.int32)
    return ref, port, x, y


def _torch_in(x):
    t = torch.from_numpy(x)
    return t.long() if not t.is_floating_point() else t


def _one_hot(y, classes):
    return np.eye(classes, dtype=np.float32)[y]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_predict_and_evaluate_match_jax(name):
    ref, port, x, y = _pair(name)
    with torch.inference_mode():
        got = port(_torch_in(x[:5])).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(x[:5], training=False)), atol=1e-5, rtol=0)
    j_sm, t_sm = JaxSparkModel(ref, num_workers=1), et.SparkModel(port, device="cpu")
    np.testing.assert_allclose(t_sm.predict(x[:21], batch_size=8),
                               j_sm.predict(x[:21], batch_size=8), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_sm.evaluate(x, y, batch_size=BATCH),
                               j_sm.evaluate(x, y, batch_size=BATCH), atol=1e-5, rtol=0)


def _check_fit(ref, port, data):
    j_hist = JaxSparkModel(ref, num_workers=1).fit(data, epochs=EPOCHS, batch_size=BATCH)
    t_hist = et.SparkModel(port, device="cpu").fit(data, epochs=EPOCHS, batch_size=BATCH)
    assert list(t_hist) == list(j_hist) == ["loss", "accuracy"]
    for key in j_hist:
        np.testing.assert_allclose(t_hist[key], j_hist[key], atol=1e-4, rtol=0, err_msg=key)
    want = _keras_weights(ref)
    names = canonical_keras_names(port, want)
    got = et.keras_weights(port)
    assert set(got) == set(names.values())
    for path, value in want.items():
        np.testing.assert_allclose(got[names[path]], value, atol=1e-4, rtol=0, err_msg=path)
    assert not port.training


@pytest.mark.parametrize("name,sparse", [("mlp", True), ("mlp", False), ("cnn", True),
                                         ("lstm", True), ("resnet", True), ("resnet", False)])
def test_fit_matches_jax(name, sparse):
    """Two epochs of three batches from the same weights (wrap-padded
    but for ResNet): Adam (MLP, convnet, LSTM) or SGD with momentum and
    BatchNorm's moving statistics (ResNet); one-hot labels through the
    categorical loss and accuracy where ``sparse`` is False.

    ResNet trains on 48 rows: on 40, the fourth step's batch meets a
    near-tie (float32 rounding of the two runs' weights, 3e-7 apart after
    three steps, picks different branches), and SGD at lr 0.1 carries the
    gap to 2e-4 in one step; from the same weights that step's gradients
    agree (:func:`test_resnet_gradients_match_jax_at_the_fourth_step`)."""
    classes = CASES[name][4]
    extra = {} if sparse else dict(sparse_labels=False)
    ref, port, x, y = _pair(name, **extra)
    before = {k: v.copy() for k, v in _keras_weights(ref).items()}
    _check_fit(ref, port, (x, y if sparse else _one_hot(y, classes)))
    if name == "resnet":  # the statistics moved, and moved alike
        moved = [p for p in before if "moving" in p
                 and not np.allclose(before[p], np.asarray(_keras_weights(ref)[p]))]
        assert len(moved) == len([p for p in before if "moving" in p])


def _jax_grads(model, x, y):
    tv = [v.value for v in model.trainable_variables]
    ntv = [v.value for v in model.non_trainable_variables]

    def loss_fn(tv):
        y_pred, _ = model.stateless_call(tv, ntv, x, training=True)
        return model.compute_loss(x=x, y=y, y_pred=y_pred)

    grads = jax.grad(loss_fn)(tv)
    return {v.path: np.asarray(g) for v, g in zip(model.trainable_variables, grads)}


def test_resnet_gradients_match_jax_at_the_fourth_step():
    """The step where two 40-row fits part: the JAX weights after three
    wrap-padded steps, loaded into the port, give the fourth batch's
    gradients within 1e-4 of each tensor's largest."""
    ref, port, x, y = _pair("resnet")
    x, y = x[:ROWS], y[:ROWS]
    JaxSparkModel(ref, num_workers=1).fit((x, y), epochs=1, batch_size=BATCH)
    et.load_keras_weights(port, _keras_weights(ref))
    want = _jax_grads(ref, x[:BATCH], y[:BATCH])
    port.train()
    port.training_spec.loss(torch.from_numpy(y[:BATCH]).long(),
                            port(torch.from_numpy(x[:BATCH]))).mean().backward()
    trainable = {p: t for p, (t, _) in _keras_paths(port).items() if t.requires_grad}
    assert set(trainable) == set(want)
    for path, (tensor, perm) in _keras_paths(port).items():
        if path in want:
            got = tensor.grad.numpy().transpose(np.argsort(perm)) if perm else tensor.grad.numpy()
            np.testing.assert_allclose(got, want[path], rtol=0,
                                       atol=1e-4 * np.abs(want[path]).max(), err_msg=path)


def test_resnet50_structure_and_paths():
    """53 convolutions, 25–26 M parameters and statistics at 1000 classes
    (as ``tests/test_models.py``), and the reference's set of Keras paths
    (built uncompiled at 64×64)."""
    port = et.resnet50(input_shape=(64, 64, 3), num_classes=1000, compile_model=False,
                       device="cpu")
    ref = jax_resnet(input_shape=(64, 64, 3), num_classes=1000, compile_model=False)
    assert port.name == ref.name == "resnet50"
    assert not hasattr(port, "training_spec")
    assert len([m for m in port.modules() if isinstance(m, torch.nn.Conv2d)]) == 53
    count = sum(p.numel() for p in port.parameters()) + sum(b.numel() for b in port.buffers())
    assert 25_000_000 < count < 26_000_000
    assert count == ref.count_params()
    weights = et.keras_weights(port)
    assert set(weights) == {v.path for v in ref.weights}
    for v in ref.weights:
        assert weights[v.path].shape == tuple(v.shape), v.path


# -- the Keras layers -------------------------------------------------------


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("op", ["conv7s2", "conv3s2", "conv3s1", "pool3s2"])
def test_same_padding_matches_keras(op, n):
    """Keras's "same" at an odd and an even size: stride 2 pads unevenly
    (more after), which a symmetric pad would shift by a pixel."""
    x = _rng(5).normal(size=(2, n, n, 3)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    k, s = int(op[-3]), int(op[-1])
    if op.startswith("pool"):
        want = keras.layers.MaxPooling2D(k, strides=s, padding="same")(x)
        got = max_pool(tx, k, s, padding="same")
    else:
        layer = keras.layers.Conv2D(4, k, strides=s, padding="same")
        want = layer(x)
        conv = Conv2D(3, 4, k, s, padding="same")
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(np.array(layer.kernel)).permute(3, 2, 0, 1))
            conv.bias.copy_(torch.from_numpy(np.array(layer.bias)))
            got = conv(tx)
    want = np.asarray(want)
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, -(-n // s), -(-n // s), want.shape[-1])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    before, after = same_padding(n, k, s)
    assert (before, after) == ((k - 1) // 2, (k - 1) // 2) if s == 1 else before <= after


def test_same_padding_at_resnet50_sizes():
    assert same_padding(224, 7, 2) == (2, 3)  # the stem
    assert same_padding(112, 3, 2) == (0, 1)  # the max-pool
    assert same_padding(56, 3, 2) == (0, 1)  # stage 1's first 3x3
    assert same_padding(56, 3, 1) == (1, 1)


def _bn_run(layer, bn, xs):
    """The same batches through both in training mode; returns the last
    outputs as float32 NHWC arrays."""
    for x in xs:
        xk = keras.ops.cast(x, layer.compute_dtype)
        tx = torch.from_numpy(np.array(keras.ops.cast(xk, "float32")))
        want = np.asarray(keras.ops.cast(layer(xk, training=True), "float32"))
        out = bn(tx.to(bn.compute_dtype).permute(0, 3, 1, 2))
        assert out.dtype == bn.compute_dtype
    return out.float().permute(0, 2, 3, 1).detach().numpy(), want


@pytest.mark.parametrize("dtype", ["float32", "mixed_bfloat16"])
def test_batch_norm_matches_keras(dtype):
    """Three training steps then inference: the output, and moving
    statistics moved by the biased batch variance with momentum 0.99 and
    epsilon 1e-3; a bf16 input under mixed_bfloat16 (float32 statistics,
    bf16 output)."""
    rng = _rng(7)
    layer = keras.layers.BatchNormalization(dtype=dtype)
    layer.build((None, 5, 5, 4))
    layer.gamma.assign(rng.uniform(0.5, 1.5, 4).astype(np.float32))
    layer.beta.assign(rng.normal(size=4).astype(np.float32))
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(np.array(layer.gamma)))
        bn.beta.copy_(torch.from_numpy(np.array(layer.beta)))
    bn.compute_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    out_tol = 1e-6 if dtype == "float32" else 2e-2
    xs = [(rng.normal(size=(6, 5, 5, 4)) * 3 + 1).astype(np.float32) for _ in range(3)]
    bn.train()
    got, want = _bn_run(layer, bn, xs)
    np.testing.assert_allclose(got, want, atol=out_tol, rtol=0)
    for name in ("moving_mean", "moving_variance"):
        np.testing.assert_allclose(getattr(bn, name).numpy(), np.asarray(getattr(layer, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        assert getattr(bn, name).dtype == torch.float32
    bn.eval()
    x = xs[0]
    xk = keras.ops.cast(x, layer.compute_dtype)
    want = np.asarray(keras.ops.cast(layer(xk, training=False), "float32"))
    tx = torch.from_numpy(np.array(keras.ops.cast(xk, "float32"))).to(bn.compute_dtype)
    got = bn(tx.permute(0, 3, 1, 2)).float().permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=out_tol, rtol=0)
    # nn.BatchNorm2d keeps the unbiased variance (and momentum 0.1): it
    # would leave the reference after one step
    torch_bn = torch.nn.BatchNorm2d(4, momentum=0.01, eps=1e-3).train()
    torch_bn(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    keras_first = 0.99 + 0.01 * xs[0].reshape(-1, 4).var(axis=0)
    assert not np.allclose(torch_bn.running_var.numpy(), keras_first, rtol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_keras(momentum):
    rng = _rng(8)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    kvars = [keras.Variable(a) for a in init]
    kopt = keras.optimizers.SGD(0.1, momentum=momentum)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    topt = SGD(params, lr=0.1, momentum=momentum)
    for step in grads:
        kopt.apply_gradients(zip([keras.ops.convert_to_tensor(g) for g in step], kvars))
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        topt.step()
        for p, kv in zip(params, kvars):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(kv), atol=1e-6, rtol=1e-6)


def test_sgd_refuses_bad_settings():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kwargs in (dict(lr=0.0), dict(lr=0.1, momentum=1.5)):
        with pytest.raises(ValueError, match="bad SGD settings"):
            SGD(p, **kwargs)


@pytest.mark.parametrize("from_logits", [False, True])
def test_categorical_loss_and_accuracy_match_keras(from_logits):
    rng = _rng(10)
    if from_logits:
        y_pred = (rng.normal(size=(6, 5)) * 4).astype(np.float32)
    else:
        y_pred = rng.uniform(size=(6, 5)).astype(np.float32)
        y_pred[0, 0], y_pred[1] = 0.0, 0.0
        y_pred[1, -1] = 1.0
        y_pred /= y_pred.sum(-1, keepdims=True)
    y = _one_hot(rng.integers(0, 5, 6), 5)
    y[1] = _one_hot(np.array([0]), 5)[0]  # the label's probability is 0: the clip
    loss = keras.losses.CategoricalCrossentropy(from_logits=from_logits)
    got = training.categorical_crossentropy(torch.from_numpy(y), torch.from_numpy(y_pred),
                                            from_logits=from_logits)
    np.testing.assert_allclose(got.mean().item(), float(loss(y, y_pred)), rtol=1e-6)
    metric = keras.metrics.CategoricalAccuracy()
    metric.update_state(y, y_pred)
    m = training.MeanMetric("cpu")
    m.update(training.categorical_accuracy(torch.from_numpy(y), torch.from_numpy(y_pred)))
    np.testing.assert_allclose(m.result(), float(metric.result()), rtol=1e-6)


def test_compile_resolves_the_zoo_like_keras():
    mlp = et.mnist_mlp(input_dim=4, hidden=4, num_classes=3, sparse_labels=False, device="cpu")
    assert mlp.training_spec.metrics == {"accuracy": training.categorical_accuracy}
    assert mlp.training_spec.loss is training.categorical_crossentropy
    lstm = et.imdb_lstm(vocab_size=10, maxlen=4, embed_dim=4, units=4, device="cpu")
    assert lstm.training_spec.metrics == {"accuracy": training.binary_accuracy}
    trained = {id(p) for g in lstm.training_spec.optimizer.param_groups for p in g["params"]}
    assert id(lstm.lstm.bias_hh_l0) not in trained  # Keras's LSTM has one bias
    assert not lstm.lstm.bias_hh_l0.any()
    res = et.resnet(input_shape=(16, 16, 3), num_classes=3, depths=(1,), width=4, lr=0.05,
                    device="cpu")
    opt = res.training_spec.optimizer
    assert isinstance(opt, SGD) and opt.defaults["lr"] == 0.05
    assert opt.defaults["momentum"] == 0.9
    assert res.training_spec.metrics == {"accuracy": training.sparse_categorical_accuracy}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        et.resnet(input_shape=(16, 16, 3), depths=(1,), width=4,
                  dtype_policy="mixed_float16", device="cpu")


# -- weights both ways --------------------------------------------------------


def test_sequential_weights_load_whatever_keras_named_them():
    """Keras's Sequential layer names come from a process-wide counter:
    two builds give ``dense_k`` and ``dense_{k+3}``. Both load, in any
    order of the dict, and ``keras_weights`` names them as a fresh
    process does."""
    cfg = dict(input_dim=6, num_classes=3, hidden=5)
    first, second = jax_mlp(**cfg, seed=1), jax_mlp(**cfg, seed=2)
    w1, w2 = _keras_weights(first), _keras_weights(second)
    assert set(w1) != set(w2)
    port = et.mnist_mlp(**cfg, device="cpu")
    for weights in (w1, dict(reversed(list(w2.items())))):
        et.load_keras_weights(port, weights)
        got = et.keras_weights(port)
        assert set(got) == {"mnist_mlp/dense/kernel", "mnist_mlp/dense/bias",
                            "mnist_mlp/dense_1/kernel", "mnist_mlp/dense_1/bias",
                            "mnist_mlp/dense_2/kernel", "mnist_mlp/dense_2/bias"}
        names = canonical_keras_names(port, weights)
        for path, value in weights.items():
            np.testing.assert_array_equal(got[names[path]], value)


@pytest.mark.parametrize("name", list(CASES))
def test_keras_weights_round_trip(name):
    _, build, cfg, _, _ = CASES[name]
    port = build(**cfg, device="cpu")
    weights = et.keras_weights(port)
    other = build(**{**cfg, "seed": cfg["seed"] + 10}, device="cpu")
    assert any(not np.array_equal(v, weights[k]) for k, v in et.keras_weights(other).items())
    et.load_keras_weights(other, weights)
    for path, value in et.keras_weights(other).items():
        np.testing.assert_array_equal(value, weights[path])


@pytest.mark.parametrize("name,key", [("mlp", "mnist_mlp/dense_1/kernel"),
                                      ("resnet", "s0_b0_bn2/moving_variance"),
                                      ("cnn", "cifar10_cnn/conv2d_2/kernel"),
                                      ("lstm", "imdb_lstm/lstm/lstm_cell/recurrent_kernel")])
def test_load_keras_weights_rejects_mismatches(name, key):
    _, build, cfg, _, _ = CASES[name]
    port = build(**cfg, device="cpu")
    weights = et.keras_weights(port)
    missing = dict(weights)
    del missing[key]
    with pytest.raises(ValueError, match="missing"):
        et.load_keras_weights(port, missing)
    with pytest.raises(ValueError, match="unexpected"):
        et.load_keras_weights(port, {**weights, "head_2/bias": np.zeros(2)})
    bad = dict(weights)
    bad[key] = np.zeros(bad[key].shape[:-1] + (bad[key].shape[-1] + 1,), np.float32)
    with pytest.raises(ValueError, match=key):
        et.load_keras_weights(port, bad)
