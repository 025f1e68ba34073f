"""``SparkModel`` with a parameter server on the port against the JAX
package's, on the CPU.

- Keras's weight order: :func:`~elephas_tpu_torch.utils.weights.get_weights`
  lists every builder's weights in ``[v.path for v in model.weights]``
  order, with the reference's values after ``load_keras_weights``. A
  worker of one package and a store of the other exchange this list.
- Fit parity: the same Keras weights and rows through
  ``SparkModel(..., parameter_server_mode=)`` of both packages (an MLP in
  every mode × store, the small transformer in every mode with one store
  each), 2 workers. The history is within 1e-4 and the store's final
  weights are bit-equal to the port master's ``keras_weights``.
- Resume: a port ``fit(resume=True)`` adopts the journal a JAX fit wrote
  (one store, and two shards), its master within 1e-6 of the journal.
- The failure budget within and beyond it, with and without
  ``reassign_orphans``; the reference's budget, resume, stale-journal,
  orphan and native-store cases of ``test_fault_tolerance.py``,
  ``test_ps_sharding.py`` and ``test_native_ps.py``, written out for a
  port module built from the Keras model's JSON.
"""

import shutil

import keras
import numpy as np
import pytest

import elephas_tpu
import elephas_tpu.models as jax_models
import elephas_tpu_torch as et
from elephas_tpu.parameter import journal as jax_journal
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.fault import FaultBudgetExceeded, FaultPlan, use_plan
from elephas_tpu_torch.models.keras_config import model_from_json
from elephas_tpu_torch.optimizers import Adam
from elephas_tpu_torch.parameter import journal
from elephas_tpu_torch.training import compile_model
from elephas_tpu_torch.utils.weights import (
    canonical_keras_names,
    get_weights,
    set_weights,
    weight_paths,
)
from tests.conftest import make_mlp

W = 4
MODES = ("synchronous", "asynchronous", "hogwild")
STORES = ("http", "socket", "native")
# each mode's store for the transformer (one JAX fit a mode)
TRANSFORMER_STORE = dict(zip(MODES, STORES))
TINY = dict(vocab_size=40, maxlen=8, num_classes=2, d_model=16, num_heads=2, num_layers=1,
            dropout=0.0)
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


@pytest.fixture(autouse=True)
def four_workers():
    previous = force_devices(W)
    yield
    force_devices(previous)


def _port_of(keras_model, lr=None, metrics=()):
    """The port module of a Keras Sequential: built from its JSON, the
    Keras weights loaded in ``get_weights()`` order, compiled with Adam
    (``lr`` or Keras's default) and sparse categorical cross-entropy."""
    port = model_from_json(keras_model.to_json(), device="cpu")
    set_weights(port, keras_model.get_weights())
    opt = Adam(port.parameters()) if lr is None else Adam(port.parameters(), lr=lr)
    return compile_model(port, opt, "sparse_categorical_crossentropy", metrics)


def _small_mlp(d, k):
    """The reference tests' Dense(8, relu) → Dense(k, softmax), Adam."""
    keras.utils.set_random_seed(0)
    model = keras.Sequential([keras.layers.Input((d,)), keras.layers.Dense(8, activation="relu"),
                              keras.layers.Dense(k, activation="softmax")])
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    return model


def _fit_keeping_store(sm, *args, **kwargs):
    """``sm.fit`` and the weights its store held when the fit stopped it."""
    held = {}
    stop = sm.stop_server

    def stop_and_keep():
        if sm._parameter_server is not None:
            held["weights"] = sm._parameter_server.get_parameters()
            held["endpoints"] = sm.ps_endpoints
        stop()

    sm.stop_server = stop_and_keep
    history = sm.fit(*args, **kwargs)
    return history, held


# -- Keras's weight order ------------------------------------------------


@pytest.mark.parametrize("builder,kwargs", [
    ("transformer_classifier", dict(vocab_size=50, maxlen=16, num_classes=2, d_model=16,
                                    num_heads=2, num_layers=2)),
    ("transformer_lm", dict(vocab_size=50, maxlen=16, d_model=16, num_heads=2, num_layers=1)),
    ("mnist_mlp", dict(input_dim=16, hidden=8, num_classes=3)),
    ("cifar10_cnn", dict(input_shape=(12, 12, 3), num_classes=4)),
    ("imdb_lstm", dict(vocab_size=50, maxlen=8, embed_dim=8, units=8)),
    ("resnet", dict(input_shape=(8, 8, 3), num_classes=4, depths=(1, 1), width=4)),
])
def test_get_weights_follows_keras_order(builder, kwargs):
    jax_model = getattr(jax_models, builder)(**kwargs)
    port = getattr(et, builder)(**kwargs, device="cpu")
    paths = [v.path for v in jax_model.weights]
    names = canonical_keras_names(port, paths)
    assert weight_paths(port) == [names[p] for p in paths]
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in jax_model.weights})
    ours = get_weights(port)
    for got, want in zip(ours, jax_model.get_weights()):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # host copies that share no memory with the module: training it later
    # cannot tear them
    for arr, (tensor, _) in zip(ours, et.utils.weights._keras_paths(port).values()):
        assert not np.shares_memory(arr, tensor.detach().numpy())
    set_weights(port, [w + 1 for w in ours])
    np.testing.assert_array_equal(get_weights(port)[0], ours[0] + 1)
    with pytest.raises(ValueError, match="weights for a model of"):
        set_weights(port, ours[:-1])


# -- fit parity ----------------------------------------------------------


def _mlp_data(blobs):
    x, y, d, k = blobs
    return x[:256], y[:256], d, k


@pytest.fixture(scope="module")
def jax_mlp_fits(blobs):
    """mode -> (initial Keras weights, the Keras model's JSON, JAX history)."""
    x, y, d, k = _mlp_data(blobs)
    out = {}
    for mode in MODES:
        km = make_mlp(d, k)
        init = km.get_weights()
        hist = elephas_tpu.SparkModel(km, mode=mode, num_workers=2).fit(
            (x, y), epochs=2, batch_size=32)
        out[mode] = (init, km.to_json(), hist)
    return out


def _history_close(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("mode", MODES)
def test_mlp_fit_with_store_matches_jax(blobs, jax_mlp_fits, mode, store):
    if store == "native" and shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    x, y, d, k = _mlp_data(blobs)
    init, model_json, jax_hist = jax_mlp_fits[mode]
    port = model_from_json(model_json, device="cpu")
    set_weights(port, init)
    compile_model(port, Adam(port.parameters(), lr=1e-2), "sparse_categorical_crossentropy",
                  ["accuracy"])
    sm = et.SparkModel(port, mode=mode, num_workers=2, parameter_server_mode=store, port=0,
                       device="cpu")
    hist, held = _fit_keeping_store(sm, (x, y), epochs=2, batch_size=32)
    _history_close(hist, jax_hist)
    master = et.keras_weights(port)
    for got, path in zip(held["weights"], weight_paths(port)):
        np.testing.assert_array_equal(got, master[path])
    assert held["endpoints"].startswith("127.0.0.1:")
    assert sm.ps_endpoints is None  # stopped with the fit


@pytest.mark.parametrize("mode", MODES)
def test_transformer_fit_with_store_matches_jax(mode):
    if TRANSFORMER_STORE[mode] == "native" and shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(1)
    x = rng.integers(0, TINY["vocab_size"], size=(32, TINY["maxlen"])).astype(np.int32)
    y = rng.integers(0, 2, size=32).astype(np.int32)
    km = jax_models.transformer_classifier(**TINY)
    port = et.transformer_classifier(**TINY, device="cpu")
    et.load_keras_weights(port, {v.path: np.asarray(v) for v in km.weights})
    jax_hist = elephas_tpu.SparkModel(km, mode=mode, num_workers=2).fit(
        (x, y), epochs=2, batch_size=8)
    sm = et.SparkModel(port, mode=mode, num_workers=2,
                       parameter_server_mode=TRANSFORMER_STORE[mode], port=0, device="cpu")
    hist, held = _fit_keeping_store(sm, (x, y), epochs=2, batch_size=8)
    _history_close(hist, jax_hist)
    master = et.keras_weights(port)
    for got, path in zip(held["weights"], weight_paths(port)):
        np.testing.assert_array_equal(got, master[path])


def test_fit_publishes_every_epoch_and_traces_it(blobs):
    """One publication an epoch (in the background with ``ps_overlap``)
    plus the final synchronous one, ``fit.epoch`` events under the fit's
    trace id, which the PS applies carry too."""
    from elephas_tpu_torch import telemetry

    x, y, d, k = _mlp_data(blobs)
    port = _port_of(make_mlp(d, k), lr=1e-2)
    sm = et.SparkModel(port, mode="asynchronous", num_workers=2, parameter_server_mode="socket",
                       port=0, device="cpu")
    published = []
    real = sm._publish_weights
    sm._publish_weights = lambda final=False: published.append(final) or real(final)
    seq0 = telemetry.tracer().seq
    sm.fit((x, y), epochs=3, batch_size=64)
    assert published == [False, False, False, True]
    epochs = telemetry.tracer().events(since_seq=seq0, name="fit.epoch")
    assert [e["args"]["epoch"] for e in epochs] == [0, 1, 2]
    assert len({e["args"]["trace"] for e in epochs}) == 1
    assert epochs[0]["args"]["trace"].startswith("fit-r")


# -- resume from a journal the JAX package wrote -------------------------


@pytest.mark.parametrize("shards", [1, 2])
def test_resume_adopts_a_jax_journal(blobs, tmp_path, shards):
    x, y, d, k = _mlp_data(blobs)
    ckpt, jdir = str(tmp_path / "ckpt"), str(tmp_path / "ps")
    km = _small_mlp(d, k)
    port = _port_of(km)
    # the port's epoch checkpoint, then the JAX fit's newer store state
    et.SparkModel(port, mode="asynchronous", num_workers=2, device="cpu").fit(
        (x, y), epochs=1, batch_size=32, checkpoint_dir=ckpt)
    elephas_tpu.SparkModel(km, mode="asynchronous", num_workers=2,
                           parameter_server_mode="socket", port=0, ps_journal_dir=jdir,
                           ps_shards=shards).fit((x, y), epochs=1, batch_size=32)
    sm = et.SparkModel(port, mode="asynchronous", num_workers=2, parameter_server_mode="socket",
                       port=0, ps_journal_dir=jdir, ps_shards=shards, device="cpu")
    journaled = sm._load_ps_journal_weights()
    for got, want in zip(journaled, km.get_weights()):
        np.testing.assert_array_equal(got, want)
    # equal epochs: the fit exits at the restore point holding the journal
    assert sm.fit((x, y), epochs=1, batch_size=32, checkpoint_dir=ckpt,
                  resume=True)["loss"] == []
    for got, want in zip(get_weights(port), journaled):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_partial_shard_journal_is_refused(blobs, tmp_path, caplog):
    x, y, d, k = _mlp_data(blobs)
    port = _port_of(_small_mlp(d, k))
    sm = et.SparkModel(port, mode="asynchronous", num_workers=2, parameter_server_mode="socket",
                       port=0, ps_journal_dir=str(tmp_path), ps_shards=2, device="cpu")
    sm.start_server()
    sm.stop_server()
    shutil.rmtree(tmp_path / "shard-1")
    assert sm._load_ps_journal_weights() is None
    assert "refusing a mixed journal/checkpoint" in caplog.text


# -- the failure budget --------------------------------------------------


def _budget_fit(blobs, failure_budget, failed_partitions, reassign_orphans=True,
                parameter_server_mode=None):
    x, y, d, k = blobs
    sm = et.SparkModel(_port_of(_small_mlp(d, k)), mode="asynchronous", num_workers=4,
                       failure_budget=failure_budget, reassign_orphans=reassign_orphans,
                       parameter_server_mode=parameter_server_mode, port=0, device="cpu")
    plan = FaultPlan(seed=0, failed_partitions=failed_partitions)
    rows = []
    real = sm._runner.run_epochs
    sm._runner.run_epochs = lambda parts, *a, **kw: rows.append(
        [len(p[0]) for p in parts]) or real(parts, *a, **kw)
    with use_plan(plan):
        history = sm.fit((x[:256], y[:256]), epochs=1, batch_size=32)
    return history, rows[0], sm


@pytest.mark.parametrize("reassign", [True, False])
def test_worker_loss_within_budget(blobs, reassign):
    history, rows, sm = _budget_fit(blobs, 1, (2,), reassign_orphans=reassign,
                                    parameter_server_mode="socket")
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"]).all()
    # the runner trains on the workers that are left (their partitions
    # re-split to them); with reassignment every row still trains
    assert sum(rows) == (256 if reassign else 192)
    assert sm.failure_budget == 1


@pytest.mark.parametrize("reassign", [True, False])
def test_worker_loss_beyond_budget_raises(blobs, reassign):
    with pytest.raises(FaultBudgetExceeded, match="failure_budget=1"):
        _budget_fit(blobs, 1, (0, 2), reassign_orphans=reassign)
    with pytest.raises(FaultBudgetExceeded, match="failure_budget=0"):
        _budget_fit(blobs, -3, (1,), reassign_orphans=reassign)  # clamped to 0


def test_reassign_orphans_walks_nested_targets():
    x = np.arange(12.0).reshape(6, 2)
    y = {"a": np.arange(6), "b": (np.arange(6) * 2, [np.arange(6) * 3])}

    def part(lo, hi):
        return x[lo:hi], {"a": y["a"][lo:hi], "b": (y["b"][0][lo:hi], [y["b"][1][0][lo:hi]])}

    merged = et.SparkModel._reassign_orphans([part(0, 2), part(2, 4)], [part(4, 6)])
    mx, my = merged[0]
    np.testing.assert_array_equal(mx, x[[0, 1, 4, 5]])
    np.testing.assert_array_equal(my["a"], [0, 1, 4, 5])
    np.testing.assert_array_equal(my["b"][0], [0, 2, 8, 10])
    np.testing.assert_array_equal(my["b"][1][0], [0, 3, 12, 15])
    assert isinstance(my["b"], tuple) and isinstance(my["b"][1], list)


# -- the reference's Keras-model cases, written out for the port ----------


def test_worker_loss_within_budget_continues(blobs):
    history, _, _ = _budget_fit(blobs, failure_budget=1, failed_partitions=(2,))
    assert len(history["loss"]) == 1  # trained on the survivors


def test_worker_loss_beyond_budget_raises_clearly(blobs):
    with pytest.raises(FaultBudgetExceeded, match="failure_budget=1"):
        _budget_fit(blobs, failure_budget=1, failed_partitions=(0, 2))


def test_resume_seeds_master_from_ps_journal(blobs, tmp_path):
    x, y, d, k = blobs
    ckpt_dir, journal_dir = str(tmp_path / "ckpt"), str(tmp_path / "ps")
    model = _port_of(_small_mlp(d, k))
    spark_model = et.SparkModel(model, mode="asynchronous", num_workers=2,
                                parameter_server_mode="socket", port=0,
                                ps_journal_dir=journal_dir, device="cpu")
    spark_model.fit((x[:128], y[:128]), epochs=1, batch_size=32, checkpoint_dir=ckpt_dir)
    weights, table, _ = journal.load_journal(journal_dir)
    marker = [np.asarray(w) + 0.125 for w in weights]
    journal.save_journal(journal_dir, marker, table)
    spark_model2 = et.SparkModel(model, mode="asynchronous", num_workers=2,
                                 parameter_server_mode="socket", port=0,
                                 ps_journal_dir=journal_dir, device="cpu")
    spark_model2.fit((x[:128], y[:128]), epochs=1, batch_size=32, checkpoint_dir=ckpt_dir,
                     resume=True)
    for a, b in zip(get_weights(spark_model2.master_network), marker):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_non_resume_fit_does_not_replay_stale_journal(blobs, tmp_path):
    x, y, d, k = blobs
    journal_dir = str(tmp_path)
    km = _small_mlp(d, k)
    model = _port_of(km)
    stale = [np.asarray(w) + 9.0 for w in km.get_weights()]
    jax_journal.save_journal(journal_dir, stale, {"old-worker": 99})
    spark_model = et.SparkModel(model, mode="asynchronous", num_workers=2,
                                parameter_server_mode="socket", port=0,
                                ps_journal_dir=journal_dir, device="cpu")
    spark_model.start_server(restore_journal=False)  # the fit() default
    try:
        server = spark_model._parameter_server
        assert not server.restored_from_journal
        assert server.seq_table == {}
        for a, b in zip(server.get_parameters(), km.get_weights()):
            np.testing.assert_array_equal(a, b)  # fresh, not stale
    finally:
        spark_model.stop_server()
    restored, seq, _ = jax_journal.load_journal(journal_dir)
    assert seq == {}
    np.testing.assert_array_equal(restored[0], km.get_weights()[0])


def test_orphaned_partitions_reassigned_under_budget(blobs):
    x, y, d, k = blobs
    sm = et.SparkModel(_port_of(_small_mlp(d, k)), mode="asynchronous", num_workers=4,
                       failure_budget=1, device="cpu")
    parts = [(x[i * 64:(i + 1) * 64], y[i * 64:(i + 1) * 64]) for i in range(4)]
    merged = sm._reassign_orphans(parts[:3], parts[3:])
    assert sum(len(px) for px, _ in merged) == 4 * 64  # no rows lost
    with use_plan(FaultPlan(seed=0, failed_partitions=(2,))):
        history = sm.fit((x[:256], y[:256]), epochs=1, batch_size=32)
    assert len(history["loss"]) == 1
    with use_plan(FaultPlan(seed=0, failed_partitions=(0, 2))):
        with pytest.raises(FaultBudgetExceeded):
            sm.fit((x[:256], y[:256]), epochs=1, batch_size=32)


@needs_gxx
def test_native_in_spark_model(blobs):
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils.rdd_utils import to_simple_rdd

    x, y, d, k = blobs
    sm = et.SparkModel(_port_of(make_mlp(d, k), lr=1e-2), mode="asynchronous",
                       parameter_server_mode="native", num_workers=4, port=0, device="cpu")
    history = sm.fit(to_simple_rdd(SparkContext("local[4]"), x[:400], y[:400]), epochs=2,
                     batch_size=64)
    assert np.isfinite(history["loss"]).all()


def test_sharded_store_serves_the_master(blobs, tmp_path):
    """``ps_shards=2``: two journaled shard servers on consecutive
    endpoints; the gathered final state is the master's."""
    from elephas_tpu_torch.parameter import ShardMap

    x, y, d, k = _mlp_data(blobs)
    port = _port_of(_small_mlp(d, k))
    sm = et.SparkModel(port, mode="hogwild", num_workers=2, parameter_server_mode="http",
                       port=0, ps_shards=2, ps_journal_dir=str(tmp_path), device="cpu")
    _, held = _fit_keeping_store(sm, (x, y), epochs=1, batch_size=32)
    assert len(held["endpoints"].split(",")) == 2
    smap = ShardMap.from_weights(get_weights(port), 2)
    slices = [journal.load_journal(str(tmp_path / f"shard-{i}"))[0] for i in range(2)]
    for got, want in zip(smap.gather(slices), get_weights(port)):
        np.testing.assert_array_equal(got, want)
