"""The port's W-worker training against the JAX package's, on the CPU.

The port runs under ``force_devices(8)`` on ``device="cpu"`` (its W
replicas on the one CPU); the JAX ``SparkModel`` on conftest's 8 virtual
CPU devices. Weights cross through ``load_keras_weights`` and
``keras_weights``; data is numpy from a seed (the ``blobs`` fixture).
The JAX transformer runs Pallas in interpret mode. Tolerances (fp32,
other summation orders), as ``tests/test_torch_training.py`` states them:
- per-epoch loss, accuracy and ``val_*``, and ``evaluate``: 1e-4
  relative;
- final weights: 99.9 % of elements within 1e-5 and every element within
  2·lr·steps (the most Adam can move a weight whose tiny gradient changed
  sign at rounding);
- the first step's mean gradient: 1e-5 of each tensor's largest;
- the SGD ResNet (no Adam normalisation to hide a wrong scale): every
  weight and moving statistic within 1e-5 of its tensor's largest.
"""

import copy
import json
import math

import jax
import keras
import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.data import SparkContext as JaxSparkContext
from elephas_tpu.data.rdd import Rdd as JaxRdd
from elephas_tpu.models import resnet as jax_resnet
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu.utils.rdd_utils import to_simple_rdd as jax_to_simple_rdd
from elephas_tpu_torch import worker
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.data.rdd import Rdd
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.models.layers import Dense, dense_paths
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.training import compile_model
from elephas_tpu_torch.utils.weights import _keras_paths, canonical_keras_names
from elephas_tpu_torch.worker import FREQUENCIES, MODES, stack_worker_batches
from tests.conftest import make_mlp

W = 8
MLP_ROWS, MLP_BATCH, EPOCHS = 400, 16, 2


@pytest.fixture(autouse=True)
def eight_workers():
    previous = force_devices(W)
    yield
    force_devices(previous)


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


class MLP(nn.Module):
    """``make_mlp``'s Sequential: Dense(32, relu) → Dense(k, softmax)."""

    def __init__(self, keras_name, d, k):
        super().__init__()
        self.keras_sequential = keras_name
        self.dense = Dense(d, 32)
        self.dense_1 = Dense(32, k)

    def forward(self, x):
        return torch.softmax(self.dense_1(F.relu(self.dense(x))), dim=-1)

    def keras_paths(self):
        name = self.keras_sequential
        return {**dense_paths(f"{name}/dense", self.dense),
                **dense_paths(f"{name}/dense_1", self.dense_1)}


def _mlp_pair(d, k, seed=7):
    ref = make_mlp(d, k, seed=seed)
    port = MLP(ref.name, d, k)
    compile_model(port, Adam(port.parameters(), lr=1e-2), "sparse_categorical_crossentropy",
                  ["accuracy"])
    et.load_keras_weights(port, _keras_weights(ref))
    return ref, port


def _rdds(x, y, slices=3):
    return (jax_to_simple_rdd(JaxSparkContext(f"local[{slices}]"), x, y),
            et.to_simple_rdd(SparkContext(f"local[{slices}]"), x, y))


def _check_history(got, want, keys=("loss", "accuracy")):
    assert list(got) == list(want) and set(keys) <= set(want), (got, want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def _check_weights(port, ref, lr, steps):
    want = _keras_weights(ref)
    names = canonical_keras_names(port, want)
    got = et.keras_weights(port)
    assert set(got) == set(names.values())
    bound = 2 * lr * steps
    for path, w in want.items():
        diff = np.abs(got[names[path]] - w)
        assert diff.max() <= bound, (path, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, (path, np.mean(diff <= 1e-5))


def _steps(rows, batch):
    """Optimizer steps of each worker over the fit."""
    return EPOCHS * math.ceil(math.ceil(rows / W) / batch)


# -- the nine mode x frequency pairs, MLP on blobs -------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("frequency", FREQUENCIES)
def test_mode_frequency_matrix_matches_jax(mode, frequency, blobs):
    x, y, d, k = blobs
    x, y = x[:MLP_ROWS], y[:MLP_ROWS]
    ref, port = _mlp_pair(d, k)
    j_rdd, t_rdd = _rdds(x, y)
    j_sm = JaxSparkModel(ref, mode=mode, frequency=frequency, num_workers=W)
    t_sm = et.SparkModel(port, mode=mode, frequency=frequency, num_workers=W, device="cpu")
    assert t_sm.num_workers == j_sm.num_workers == W
    _check_history(t_sm.fit(t_rdd, epochs=EPOCHS, batch_size=MLP_BATCH),
                   j_sm.fit(j_rdd, epochs=EPOCHS, batch_size=MLP_BATCH))
    _check_weights(port, ref, lr=1e-2, steps=_steps(MLP_ROWS, MLP_BATCH))
    np.testing.assert_allclose(t_sm.evaluate(x, y, batch_size=32),
                               j_sm.evaluate(x, y, batch_size=32), rtol=1e-4)


# -- the transformer classifier at 8 workers -------------------------------

CLF = dict(vocab_size=61, maxlen=16, num_classes=2, d_model=32, num_heads=2, num_layers=2,
           dropout=0.0, seed=5)
CLF_ROWS, CLF_BATCH = 64, 4


def _first_mean_gradient(monkeypatch):
    """Wrap the synchronous collective: the mean gradient it leaves on
    worker 0 at the first step, by parameter."""
    seen = {}
    mean_gradients = worker.mean_gradients

    def spy(replicas):
        mean_gradients(replicas)
        if not seen:
            seen.update({id(p): p.grad.clone() for p in replicas[0].parameters()})

    monkeypatch.setattr(worker, "mean_gradients", spy)
    return seen


def _jax_grads(model, x, y):
    tv = [v.value for v in model.trainable_variables]
    ntv = [v.value for v in model.non_trainable_variables]

    def loss_fn(tv):
        y_pred, _ = model.stateless_call(tv, ntv, x, training=True)
        return model.compute_loss(x=x, y=y, y_pred=y_pred)

    grads = jax.grad(loss_fn)(tv)
    return {v.path: np.asarray(g) for v, g in zip(model.trainable_variables, grads)}


@pytest.mark.parametrize("mode,frequency", [("synchronous", "epoch"), ("asynchronous", "batch")])
def test_transformer_workers_match_jax(mode, frequency, monkeypatch):
    """The first step's mean gradient is held to the gradient of the JAX
    model's loss over every worker's first batch (what the reference's
    ``pmean`` of the per-worker gradients computes)."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, CLF["vocab_size"], (CLF_ROWS, CLF["maxlen"])).astype(np.int32)
    y = rng.integers(0, 2, CLF_ROWS).astype(np.int32)
    ref = jax_classifier(**CLF)
    port = et.transformer_classifier(**CLF, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    splits = [(a, b) for a, b in zip(np.array_split(x, W), np.array_split(y, W))]
    xs, ys, _, _ = stack_worker_batches(splits, CLF_BATCH)
    want_grad = _jax_grads(ref, xs[:, 0].reshape(-1, CLF["maxlen"]), ys[:, 0].reshape(-1))
    seen = _first_mean_gradient(monkeypatch)
    j_sm = JaxSparkModel(ref, mode=mode, frequency=frequency, num_workers=W)
    t_sm = et.SparkModel(port, mode=mode, frequency=frequency, num_workers=W, device="cpu")
    j_hist = j_sm.fit((x, y), epochs=EPOCHS, batch_size=CLF_BATCH)
    t_hist = t_sm.fit((x, y), epochs=EPOCHS, batch_size=CLF_BATCH)
    _check_history(t_hist, j_hist)
    _check_weights(port, ref, lr=1e-3, steps=_steps(CLF_ROWS, CLF_BATCH))
    np.testing.assert_allclose(t_sm.evaluate(x, y, batch_size=16),
                               j_sm.evaluate(x, y, batch_size=16), rtol=1e-4)
    if mode != "synchronous":
        assert not seen  # no gradient collective outside synchronous
        return
    paths = _keras_paths(port)
    assert set(paths) == set(want_grad)
    for path, (param, perm) in paths.items():
        got = seen[id(param)].numpy()
        got = got.T if perm else got
        scale = np.abs(want_grad[path]).max()
        np.testing.assert_allclose(got, want_grad[path], atol=1e-5 * scale, rtol=0,
                                   err_msg=path)


# -- the small ResNet with SGD: the average must be a mean ------------------

RESNET = dict(input_shape=(16, 16, 3), num_classes=5, depths=(1, 1), width=8, seed=4)


def test_resnet_sgd_synchronous_matches_jax():
    """Keras's ``SGD(0.1, momentum=0.9)`` at 4 workers: a sum in place of
    the mean would step 4× too far; BatchNorm's moving statistics are
    averaged every step."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, *RESNET["input_shape"])).astype(np.float32)
    y = rng.integers(0, RESNET["num_classes"], 64).astype(np.int32)
    ref = jax_resnet(**RESNET)
    port = et.resnet(**RESNET, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    before = _keras_weights(ref)
    j_hist = JaxSparkModel(ref, num_workers=4).fit((x, y), epochs=EPOCHS, batch_size=8)
    t_hist = et.SparkModel(port, num_workers=4, device="cpu").fit(
        (x, y), epochs=EPOCHS, batch_size=8)
    _check_history(t_hist, j_hist)
    got = et.keras_weights(port)
    for path, w in _keras_weights(ref).items():
        np.testing.assert_allclose(got[path], w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=path)
    moving = [p for p in before if "moving" in p]
    assert moving and all(not np.allclose(before[p], got[p]) for p in moving)


# -- replicas and data shaping ---------------------------------------------


def test_replicas_stay_bit_identical_under_synchronous(blobs, monkeypatch):
    x, y, d, k = blobs
    _, port = _mlp_pair(d, k)
    seen = []
    mean_gradients = worker.mean_gradients

    def keep(replicas):
        mean_gradients(replicas)
        seen[:] = replicas

    monkeypatch.setattr(worker, "mean_gradients", keep)
    et.SparkModel(port, num_workers=W, device="cpu").fit((x[:200], y[:200]), epochs=2,
                                                         batch_size=8)
    assert len(seen) == W and seen[0] is port
    master = port.state_dict()
    for replica in seen[1:]:
        for name, t in replica.state_dict().items():
            assert torch.equal(t, master[name]), name


def test_each_replica_optimizer_steps_only_its_own_parameters(blobs):
    """Its own parameters and its own copy of the master's optimizer state
    (a trained master: Adam's step, m and v exist)."""
    x, y, d, k = blobs
    _, port = _mlp_pair(d, k)
    et.SparkModel(port, num_workers=1, device="cpu").fit((x[:16], y[:16]), epochs=1,
                                                         batch_size=8)
    master = {n: p.detach().clone() for n, p in port.named_parameters()}
    live = port.training_spec.optimizer.state_dict()["state"]
    master_state = copy.deepcopy(live)
    replica = worker.replicate(port)
    own = {id(p) for p in replica.parameters()}
    opt = replica.training_spec.optimizer
    assert opt is not port.training_spec.optimizer
    stepped = [p for g in opt.param_groups for p in g["params"]]
    assert {id(p) for p in stepped} == own
    assert not own & {id(p) for p in port.parameters()}
    copied = opt.state_dict()["state"]
    assert copied.keys() == master_state.keys()
    for i, st in copied.items():
        assert st["step"] == master_state[i]["step"] == 2
        for key in ("m", "v"):
            assert torch.equal(st[key], master_state[i][key])
            assert st[key].data_ptr() != live[i][key].data_ptr()
    replica.train()
    loss = replica.training_spec.loss(torch.from_numpy(y[:8]).long(),
                                      replica(torch.from_numpy(x[:8]))).mean()
    loss.backward()
    opt.step()
    for name, p in port.named_parameters():
        assert torch.equal(p, master[name]), name
    for i, st in port.training_spec.optimizer.state_dict()["state"].items():
        assert st["step"] == 2
        assert all(torch.equal(st[key], master_state[i][key]) for key in ("m", "v"))
    assert any(not torch.equal(p, master[n]) for n, p in replica.named_parameters())


def test_ragged_partitions_and_fewer_rows_than_workers(blobs):
    """``tests/test_spark_model.py``'s ragged and tiny cases, held to the
    JAX ``SparkModel``: 100 rows in 3 partitions train on 8 workers, and 5
    rows predict 5 rows."""
    x, y, d, k = blobs
    ref, port = _mlp_pair(d, k)
    j_rdd = jax_to_simple_rdd(JaxSparkContext("local[8]"), x[:100], y[:100], num_partitions=3)
    t_rdd = et.to_simple_rdd(SparkContext("local[8]"), x[:100], y[:100], num_partitions=3)
    j_sm = JaxSparkModel(ref, num_workers=W)
    t_sm = et.SparkModel(port, num_workers=W, device="cpu")
    t_hist = t_sm.fit(t_rdd, epochs=1, batch_size=8)
    assert len(t_hist["loss"]) == 1
    _check_history(t_hist, j_sm.fit(j_rdd, epochs=1, batch_size=8))
    preds = t_sm.predict(x[:5])
    assert preds.shape == (5, k)
    with torch.inference_mode():
        np.testing.assert_allclose(preds, port(torch.from_numpy(x[:5])).numpy(), atol=1e-6,
                                   rtol=0)
    np.testing.assert_allclose(preds, j_sm.predict(x[:5]), atol=1e-5, rtol=0)
    # 5 rows on 8 workers: three workers train on a copy of the first row
    _check_history(t_sm.fit((x[:5], y[:5]), epochs=1, batch_size=4),
                   j_sm.fit((x[:5], y[:5]), epochs=1, batch_size=4))
    np.testing.assert_allclose(t_sm.evaluate(x[:5], y[:5]), j_sm.evaluate(x[:5], y[:5]),
                               rtol=1e-4)


@pytest.mark.parametrize("parts,n", [(3, 8), (8, 3), (5, 5)])
def test_repartition_matches_the_reference(parts, n):
    elements = list(range(23))
    sizes = np.diff(np.linspace(0, 23, parts + 1).astype(int))
    split = np.split(np.array(elements), np.cumsum(sizes)[:-1])
    ours, theirs = Rdd(split).repartition(n), JaxRdd(split).coalesce(n)
    assert ours.getNumPartitions() == theirs.getNumPartitions() == n
    assert [list(p) for p in ours.partitions()] == [list(p) for p in theirs.partitions()]
    assert ours.collect() == theirs.collect() and ours.count() == 23
    assert ours.map(lambda v: 2 * v).collect() == theirs.map(lambda v: 2 * v).collect()


# -- validation and the history log ----------------------------------------


@pytest.mark.parametrize("frequency", ["epoch", "fit"])
def test_validation_split_matches_jax(frequency, blobs):
    """Per epoch, or with ``frequency="fit"`` once on the averaged model
    (the reference's ``test_frequency_fit_validates_averaged_model``)."""
    x, y, d, k = blobs
    x, y = x[:MLP_ROWS], y[:MLP_ROWS]
    ref, port = _mlp_pair(d, k, seed=27)
    j_rdd, t_rdd = _rdds(x, y, slices=W)
    j_sm = JaxSparkModel(ref, frequency=frequency, num_workers=W)
    t_sm = et.SparkModel(port, frequency=frequency, num_workers=W, device="cpu")
    t_hist = t_sm.fit(t_rdd, epochs=EPOCHS, batch_size=MLP_BATCH, validation_split=0.2)
    _check_history(t_hist, j_sm.fit(j_rdd, epochs=EPOCHS, batch_size=MLP_BATCH,
                                    validation_split=0.2),
                   keys=("loss", "accuracy", "val_loss", "val_accuracy"))
    assert len(t_hist["val_loss"]) == (1 if frequency == "fit" else EPOCHS)
    n_val = int(len(x) * 0.2)
    post = t_sm.evaluate(x[-n_val:], y[-n_val:], batch_size=32)
    assert abs(t_hist["val_loss"][-1] - post[0]) < 1e-5


def test_history_log_has_the_reference_lines(tmp_path, blobs):
    x, y, d, k = blobs
    x, y = x[:MLP_ROWS], y[:MLP_ROWS]
    ref, port = _mlp_pair(d, k, seed=55)
    j_rdd, t_rdd = _rdds(x, y, slices=W)
    logs = {}
    for name, sm, rdd in (("jax", JaxSparkModel(ref, num_workers=W), j_rdd),
                          ("port", et.SparkModel(port, num_workers=W, device="cpu"), t_rdd)):
        path = tmp_path / f"{name}.jsonl"
        history = sm.fit(rdd, epochs=3, batch_size=32, validation_split=0.2,
                         history_log=str(path))
        logs[name] = [json.loads(line) for line in open(path)]
        epoch_lines = [line for line in logs[name] if "epoch" in line]
        final = [line for line in logs[name] if line.get("final")]
        assert [line["epoch"] for line in epoch_lines] == [1, 2, 3]
        assert all(np.isfinite(line["loss"]) for line in epoch_lines)
        assert len(final) == 1 and final[0]["history"]["val_loss"] == history["val_loss"]
    assert [sorted(line) for line in logs["port"]] == [sorted(line) for line in logs["jax"]]
    assert sorted(logs["port"][-1]["history"]) == sorted(logs["jax"][-1]["history"])
    for got, want in zip(logs["port"][:3], logs["jax"][:3]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_profile_dir_writes_a_chrome_trace(tmp_path, blobs):
    x, y, d, k = blobs
    _, port = _mlp_pair(d, k)
    et.SparkModel(port, num_workers=W, device="cpu").fit(
        (x[:64], y[:64]), epochs=1, batch_size=8, profile_dir=str(tmp_path / "prof"))
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_force_devices_offers_slots_and_restores(caplog):
    from elephas_tpu_torch.device import worker_count

    previous = force_devices(3)
    try:
        assert previous == W
        assert worker_count(None, "cpu") == 3
        assert SparkContext("local[*]").defaultParallelism == 3
        with caplog.at_level("WARNING", logger="elephas_tpu_torch.device"):
            assert worker_count(5, "cpu") == 3
        assert "clamping" in caplog.text
        with pytest.raises(ValueError, match="n >= 1"):
            force_devices(0)
    finally:
        assert force_devices(previous) == 3
    assert force_devices(None) == W
    try:
        assert worker_count(None, "cpu") == 1  # unforced: the one CPU
        assert SparkContext("local[*]").defaultParallelism == 1
    finally:
        force_devices(W)
