"""The port's hyperparameter search (``elephas_tpu_torch.hyperparam``)
against the JAX package's, on the CPU.

- The search-space DSL, ``TpeSampler`` and the params codec are the
  reference's numpy code: the sampled params are bit-equal for the same
  seeds and histories, in both strategies.
- ``HyperParamModel.minimize`` at 1 and 4 worker slots
  (``force_devices``; the JAX search on conftest's 8 virtual devices) with
  ``devices_per_trial`` 1 and 2, on a tiny MLP without dropout whose
  every trial starts from the Keras weights of the same seed
  (``load_keras_weights``): the same params trial by trial, validation
  losses within 1e-4 (another summation order), the same best trial.
- The reference's errors, word for word.
"""

import keras
import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

import elephas_tpu_torch as et
from elephas_tpu import hyperparam as jhp
from elephas_tpu_torch import hyperparam as hp
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.models.layers import Dense, dense_paths
from elephas_tpu_torch.optimizers import SGD, Adam
from elephas_tpu_torch.training import compile_model

TOL = 1e-4
ROWS, VAL, BATCH, EPOCHS = 320, 96, 32, 2


def _space(mod):
    return {
        "units": mod.choice([8, 16, 24]),
        "lr": mod.loguniform(1e-3, 3e-2),
        "drop": mod.uniform(0.0, 0.5),
        "layers": mod.quniform(1, 4),
        "step": mod.quniform(0.1, 0.9, q=0.1),
        "fixed": "adam",
    }


@pytest.fixture(autouse=True)
def restore_devices():
    previous = force_devices(None)
    yield
    force_devices(previous)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sample_space_is_bit_equal(seed):
    want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(16):
        want = jhp.sample_space(_space(jhp), want_rng)
        got = hp.sample_space(_space(hp), got_rng)
        assert got == want
        assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def _history(rng, n, nan_every=0):
    space = _space(jhp)
    out = []
    for i in range(n):
        p = jhp.sample_space(space, rng)
        loss = float("nan") if nan_every and i % nan_every == 0 else float(rng.normal())
        out.append((p, loss))
    return out


@pytest.mark.parametrize("seed,n,nan_every", [(0, 3, 0), (1, 8, 0), (2, 12, 3), (5, 20, 0)])
def test_tpe_sampler_is_bit_equal(seed, n, nan_every):
    """Below ``min_observations`` the sampler draws at random, above it the
    Parzen estimators: bit-equal either way, NaN losses included, over two
    rounds that share the generator."""
    history = _history(np.random.default_rng(100 + seed), n, nan_every)
    want_s = jhp.TpeSampler(_space(jhp), seed=seed)
    got_s = hp.TpeSampler(_space(hp), seed=seed)
    for _ in range(2):
        want = want_s.sample_batch(5, history)
        got = got_s.sample_batch(5, history)
        assert got == want
        history = history + [(p, float(i)) for i, p in enumerate(want)]


def test_params_codec_is_bit_equal():
    rng = np.random.default_rng(4)
    for _ in range(8):
        params = jhp.sample_space(_space(jhp), rng)
        want = jhp._encode_params(params, _space(jhp))
        got = hp._encode_params(params, _space(hp))
        assert got == want
        assert hp._decode_params(got, _space(hp)) == jhp._decode_params(want, _space(jhp))


# -- minimize against the JAX search ----------------------------------------

class MLP(nn.Module):
    """The Keras builder's Sequential: Dense(units, relu) → Dense(k, softmax)."""

    def __init__(self, keras_name, d, units, k):
        super().__init__()
        self.keras_sequential = keras_name
        self.dense = Dense(d, units)
        self.dense_1 = Dense(units, k)

    def forward(self, x):
        return torch.softmax(self.dense_1(F.relu(self.dense(x))), dim=-1)

    def keras_paths(self):
        name = self.keras_sequential
        return {**dense_paths(f"{name}/dense", self.dense),
                **dense_paths(f"{name}/dense_1", self.dense_1)}


def _keras_mlp(params, d, k):
    keras.utils.set_random_seed(7)
    model = keras.Sequential([
        keras.layers.Input((d,)),
        keras.layers.Dense(int(params["units"]), activation="relu"),
        keras.layers.Dense(k, activation="softmax"),
    ])
    model.compile(optimizer=keras.optimizers.Adam(params["lr"]),
                  loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    return model


def _port_mlp(params, d, k):
    ref = _keras_mlp(params, d, k)
    port = MLP(ref.name, d, int(params["units"]), k)
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in ref.weights})
    return compile_model(port, Adam(port.parameters(), lr=params["lr"]),
                         "sparse_categorical_crossentropy", ["accuracy"])


def _data(blobs):
    x, y, d, k = blobs
    return (x[:ROWS], y[:ROWS], x[ROWS:ROWS + VAL], y[ROWS:ROWS + VAL]), d, k


def _search_space(mod):
    return {"units": mod.choice([8, 16, 24]), "lr": mod.loguniform(1e-3, 3e-2)}


@pytest.mark.parametrize("workers,per_trial,strategy,evals", [
    (1, 1, "adaptive", 6),
    (4, 1, "random", 4),
    (4, 2, "adaptive", 6),
])
def test_minimize_matches_the_jax_search(blobs, workers, per_trial, strategy, evals):
    data, d, k = _data(blobs)
    kwargs = dict(max_evals=evals, epochs=EPOCHS, batch_size=BATCH, strategy=strategy,
                  devices_per_trial=per_trial)
    ref = jhp.HyperParamModel(num_workers=workers, seed=2)
    ref_best = ref.minimize(lambda p: _keras_mlp(p, d, k), data,
                            search_space=_search_space(jhp), **kwargs)
    force_devices(workers)
    port = et.HyperParamModel(num_workers=workers, seed=2, device="cpu")
    assert port.num_workers == workers
    best = port.minimize(lambda p: _port_mlp(p, d, k), data,
                         search_space=_search_space(hp), **kwargs)
    assert [t.params for t in port.trials] == [t.params for t in ref.trials]
    want = np.array([t.loss for t in ref.trials])
    got = np.array([t.loss for t in port.trials])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the same winner on both sides: the least loss (a tie is between
    # trials of equal params, which the sampler can repeat at a bound)
    assert port.best_trial().loss == got.min() and ref.best_trial().loss == want.min()
    assert port.best_model_params() == ref.best_model_params()
    assert best is port.best_models[0]
    np.testing.assert_allclose(port.best_trial().metrics["accuracy"],
                               ref.best_trial().metrics["accuracy"], atol=TOL, rtol=0)
    # the returned module is the trained winner
    x_val, y_val = data[2], data[3]
    with torch.no_grad():
        got_p = best(torch.from_numpy(x_val[:8])).numpy()
    np.testing.assert_allclose(got_p, np.asarray(ref_best(x_val[:8])), atol=1e-4)


# -- errors ------------------------------------------------------------------

def _errors(fn_ref, fn_port, kind):
    with pytest.raises(kind) as want:
        fn_ref()
    with pytest.raises(kind) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def test_uncompiled_builder_rejected(blobs):
    data, d, k = _data(blobs)
    force_devices(2)
    _errors(lambda: jhp.HyperParamModel(num_workers=2).minimize(
                lambda p: keras.Sequential([keras.layers.Input((d,)), keras.layers.Dense(k)]),
                data, max_evals=1),
            lambda: et.HyperParamModel(num_workers=2, device="cpu").minimize(
                lambda p: MLP("m", d, 8, k), data, max_evals=1),
            ValueError)


def test_divergent_search_raises(blobs):
    data, d, k = _data(blobs)

    def ref_build(p):
        m = _keras_mlp({"units": 8, "lr": 1e-2}, d, k)
        m.compile(optimizer=keras.optimizers.SGD(1e-2),
                  loss=lambda yt, yp: keras.ops.sum(yp, axis=-1) * float("nan"))
        return m

    def port_build(p):
        m = MLP("m", d, 8, k)
        return compile_model(m, SGD(m.parameters(), lr=1e-2),
                             lambda yt, yp: yp.sum(-1) * float("nan"))

    force_devices(2)
    _errors(lambda: jhp.HyperParamModel(num_workers=2, seed=0).minimize(
                ref_build, data, max_evals=2, epochs=1, batch_size=BATCH),
            lambda: et.HyperParamModel(num_workers=2, seed=0, device="cpu").minimize(
                port_build, data, max_evals=2, epochs=1, batch_size=BATCH),
            RuntimeError)


@pytest.mark.parametrize("kwargs", [dict(devices_per_trial=0), dict(devices_per_trial=3),
                                    dict(strategy="bogus")])
def test_argument_errors(blobs, kwargs):
    data, d, k = _data(blobs)
    force_devices(2)
    _errors(lambda: jhp.HyperParamModel(num_workers=2).minimize(
                lambda p: _keras_mlp(p, d, k), data, max_evals=1, **kwargs),
            lambda: et.HyperParamModel(num_workers=2, device="cpu").minimize(
                lambda p: _port_mlp(p, d, k), data, max_evals=1, **kwargs),
            ValueError)


def test_worker_slots_clamp_like_the_reference():
    force_devices(4)
    assert et.HyperParamModel(device="cpu").num_workers == 4
    assert et.HyperParamModel(num_workers=9, device="cpu").num_workers == 4
    assert et.HyperParamModel(num_workers=3, device="cpu").num_workers == 3
    force_devices(None)
    assert et.HyperParamModel(device="cpu").num_workers == 1
    with pytest.raises(ValueError, match="no trials run yet"):
        et.HyperParamModel(device="cpu").best_trial()


def test_sync_round_waits_for_item_9():
    """Item 9 (the process gang) is ported: out of a gang ``_sync_round``
    gathers this process's own round through the reference's float32
    encoding, padding rows dropped (``tests/test_torch_gang.py`` runs it
    across ranks)."""
    space = {"units": hp.choice([8, 16]), "lr": hp.loguniform(1e-3, 1e-1)}
    results = [({"units": 16, "lr": 0.01}, 0.5), ({"units": 8, "lr": 0.002}, 0.25)]
    got = et.HyperParamModel(device="cpu")._sync_round(results, 2, 3, space)
    assert [p["units"] for p, _ in got] == [16, 8]
    np.testing.assert_allclose([p["lr"] for p, _ in got], [0.01, 0.002], rtol=1e-6)
    assert [loss for _, loss in got] == [0.5, 0.25]


def test_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        et.HyperParamModel()
