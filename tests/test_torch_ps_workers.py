"""The port's Spark-side workers (``SparkWorker``, ``AsynchronousSparkWorker``)
and the chaos harness's training runs, on the CPU, against live weight
stores of both packages.

- A port worker builds its module from the Keras model's JSON and trains
  it on ``device="cpu"``; a JAX worker trains the Keras model. Either one
  pulls from and pushes to a store of either package, over HTTP, the
  socket protocol and the native store, and every sync period lands once.
- The reference's worker cases (``test_worker_classes.py``'s worker
  half, ``test_ps_overlap.py``'s trained workers, ``test_native_ps.py``'s
  native workers, ``test_fault_tolerance.py``'s chaos run and
  ``test_ps_sharding.py``'s sharded chaos and elastic runs) written out
  for the port: losses are read by the Keras model over the final
  weights (one weight order in both packages).
- The chaos runs lose and double no update: the same applied count as the
  fault-free run, every duplicate skipped, no update lost at the end.

Every server binds port 0.
"""

import shutil

import keras
import numpy as np
import pytest

import elephas_tpu.worker as jax_worker
from elephas_tpu import parameter as jax_parameter
from elephas_tpu.fault import harness as jax_harness
from elephas_tpu.parameter import client as jax_client
from elephas_tpu.parameter import native as jax_native
from elephas_tpu_torch import parameter, telemetry
from elephas_tpu_torch.fault import FaultPlan, run_chaos_training
from elephas_tpu_torch.fault import harness
from elephas_tpu_torch.parameter import client, codec, native
from elephas_tpu_torch.utils.weights import get_weights
from elephas_tpu_torch.worker import AsynchronousSparkWorker, SparkWorker

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
LOSS = "sparse_categorical_crossentropy"


def _keras_mlp(d, k, units=16, seed=0):
    keras.utils.set_random_seed(seed)
    model = keras.Sequential([keras.layers.Input((d,)),
                              keras.layers.Dense(units, activation="relu"),
                              keras.layers.Dense(k, activation="softmax")])
    model.compile(optimizer="adam", loss=LOSS)
    return model


def _loss_of(model, weights, x, y):
    model.set_weights(weights)
    return float(model.evaluate(x, y, verbose=0))


def _server(pkg, store, weights, mode="asynchronous"):
    if store == "native":
        mod = {"jax": jax_native, "torch": native}[pkg]
        return mod.NativeParameterServer(weights, mode=mode, port=0)
    mod = {"jax": jax_parameter, "torch": parameter}[pkg]
    server = {"http": mod.HttpServer, "socket": mod.SocketServer}[store](
        weights, mode=mode, port=0)
    server.start()
    return server


# -- SparkWorker ---------------------------------------------------------


def test_spark_worker_trains_partition(blobs):
    x, y, d, k = blobs
    km = _keras_mlp(d, k)
    worker = SparkWorker(km.to_json(), km.get_weights(), {"epochs": 2, "batch_size": 32},
                         master_optimizer="adam", master_loss=LOSS,
                         master_metrics=["accuracy"], device="cpu")
    results = list(worker.train(iter(zip(x[:200], y[:200]))))
    assert len(results) == 1
    weights, history = results[0]
    assert [w.shape for w in weights] == [w.shape for w in km.get_weights()]
    assert sorted(history) == ["accuracy", "loss"] and len(history["loss"]) == 2
    assert any(not np.allclose(a, b) for a, b in zip(weights, km.get_weights()))
    assert _loss_of(km, weights, x[:200], y[:200]) < _loss_of(
        km, worker.parameters, x[:200], y[:200])


def test_spark_worker_empty_partition_and_validation_split(blobs):
    x, y, d, k = blobs
    km = _keras_mlp(d, k)
    assert list(SparkWorker(km.to_json(), km.get_weights(), {}, device="cpu").train(
        iter([]))) == []
    worker = SparkWorker(km.to_json(), km.get_weights(),
                         {"epochs": 2, "batch_size": 32, "validation_split": 0.25},
                         master_optimizer="sgd", master_loss=LOSS, device="cpu")
    (_, history), = worker.train(iter(zip(x[:64], y[:64])))
    assert sorted(history) == ["loss", "val_loss"] and len(history["val_loss"]) == 2


def test_worker_device_defaults_to_cuda():
    """A worker names its device when it builds: ``cuda:0`` unless told,
    and no GPU and no explicit CPU raises."""
    import torch

    km = _keras_mlp(4, 2)
    worker = SparkWorker(km.to_json(), km.get_weights(), {})
    if torch.cuda.is_available():
        assert next(worker._build().parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            list(worker.train(iter(zip(np.zeros((2, 4), np.float32), [0, 1]))))


# -- AsynchronousSparkWorker across the packages ------------------------


@pytest.mark.parametrize("store", ["http", "socket", "native"])
@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_port_worker_against_live_store(blobs, store, server_pkg):
    if store == "native" and shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    x, y, d, k = blobs
    km = _keras_mlp(d, k)
    initial = [w.copy() for w in km.get_weights()]
    server = _server(server_pkg, store, initial)
    try:
        worker = AsynchronousSparkWorker(
            km.to_json(), train_config={"epochs": 3, "batch_size": 64}, frequency="epoch",
            parameter_server_mode=store, master=f"127.0.0.1:{server.port}",
            master_optimizer="adam", master_loss=LOSS, client_id="port-worker",
            device="cpu")
        results = list(worker.train(iter(zip(x[:400], y[:400]))))
        final = server.get_parameters()
        if store != "native":
            assert server.updates_applied == 3  # one push an epoch, each once
            assert "port-worker" in server.members()
    finally:
        server.stop()
    assert len(results) == 1
    assert _loss_of(km, final, x[:400], y[:400]) < _loss_of(km, initial, x[:400], y[:400]) * 0.9


@pytest.mark.parametrize("store", ["http", "socket"])
def test_jax_worker_against_port_store(blobs, store):
    x, y, d, k = blobs
    km = _keras_mlp(d, k)
    initial = [w.copy() for w in km.get_weights()]
    server = _server("torch", store, initial)
    try:
        worker = jax_worker.AsynchronousSparkWorker(
            km.to_json(), train_config={"epochs": 2, "batch_size": 64}, frequency="batch",
            parameter_server_mode=store, master=f"127.0.0.1:{server.port}",
            master_optimizer="adam", master_loss=LOSS, client_id="jax-worker")
        list(worker.train(iter(zip(x[:256], y[:256]))))
        final = server.get_parameters()
        assert server.updates_applied == 2 * 4 and server.updates_duplicate == 0
        assert server.seq_table["jax-worker"] == 7
    finally:
        server.stop()
    assert _loss_of(km, final, x[:256], y[:256]) < _loss_of(km, initial, x[:256], y[:256])


def _pushes_of(pkg, monkeypatch):
    """Record every delta a ``pkg`` client encodes and the bytes it sends."""
    cls = {"jax": jax_client, "torch": client}[pkg].BaseParameterClient
    encode, log = cls._encode_update, []

    def recorded(self, delta):
        body = encode(self, delta)
        log.append(([np.array(a, copy=True) for a in delta], body))
        return body

    monkeypatch.setattr(cls, "_encode_update", recorded)
    return log


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_port_worker_matches_jax_worker(blobs, monkeypatch, optimizer, compression):
    """With ``frequency='batch'`` both workers take one step a batch in row
    order (the reference's ``train_on_batch``, which does not shuffle), so
    from the same weights and rows, each against a fresh store of its own
    package, they push the same deltas: the optimizer's defaults, its
    state carried across periods, the period split and the delta's sign
    and scale all show in the stores' final weights. With the int8 codec
    the port's codec, fed the JAX worker's deltas in turn with its own
    error feedback, writes the JAX worker's bytes bit for bit."""
    x, y, d, k = blobs
    km = _keras_mlp(d, k)
    initial = [w.copy() for w in km.get_weights()]
    finals, pushes = {}, {}
    for pkg, worker_cls, kwargs in (("jax", jax_worker.AsynchronousSparkWorker, {}),
                                    ("torch", AsynchronousSparkWorker, {"device": "cpu"})):
        pushes[pkg] = _pushes_of(pkg, monkeypatch)
        server = _server(pkg, "socket", [w.copy() for w in initial])
        try:
            worker = worker_cls(
                km.to_json(), train_config={"epochs": 2, "batch_size": 64}, frequency="batch",
                parameter_server_mode="socket", master=f"127.0.0.1:{server.port}",
                master_optimizer=optimizer, master_loss=LOSS, compression=compression,
                client_id="w", **kwargs)
            list(worker.train(iter(zip(x[:256], y[:256]))))
            assert server.updates_applied == 2 * 4 and server.updates_duplicate == 0
            finals[pkg] = server.get_parameters()
        finally:
            server.stop()
        monkeypatch.undo()
    assert len(pushes["torch"]) == len(pushes["jax"]) == 2 * 4
    for (ours, _), (theirs, _) in zip(pushes["torch"], pushes["jax"]):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b, w0 in zip(finals["torch"], finals["jax"], initial):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        assert not np.array_equal(a, w0)
    if compression == "int8":
        replay, feedback = codec.WireCodec(compression="int8"), codec.ErrorFeedback()
        for delta, body in pushes["jax"]:
            assert replay.encode(delta, feedback) == body
        for (_, ours), (_, theirs) in zip(pushes["torch"], pushes["jax"]):
            for a, b in zip(codec.decode(ours), codec.decode(theirs)):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _train_worker(blobs, server_mode="asynchronous", **worker_kwargs):
    """``test_ps_overlap._train_worker`` on the port: one worker run against
    a live port SocketServer; returns (final server weights, the Keras
    model that holds the initial weights)."""
    x, y, d, k = blobs
    model = _keras_mlp(d, k)
    server = _server("torch", "socket", model.get_weights(), mode=server_mode)
    try:
        worker = AsynchronousSparkWorker(
            model.to_json(), train_config={"epochs": 3, "batch_size": 64}, frequency="epoch",
            parameter_server_mode="socket", master=f"127.0.0.1:{server.port}",
            master_optimizer="adam", master_loss=LOSS, device="cpu", **worker_kwargs)
        list(worker.train(iter(zip(x[:400], y[:400]))))
        return server.get_parameters(), model
    finally:
        server.stop()


def test_int8_error_feedback_convergence_matches_uncompressed(blobs):
    x, y, d, k = blobs
    dense_w, model = _train_worker(blobs)
    comp_w, _ = _train_worker(blobs, compression="int8", topk=0.25, pull_compression="none")
    initial_loss = _loss_of(model, model.get_weights(), x[:400], y[:400])
    dense_loss = _loss_of(model, dense_w, x[:400], y[:400])
    comp_loss = _loss_of(model, comp_w, x[:400], y[:400])
    assert dense_loss < initial_loss * 0.9
    assert comp_loss < initial_loss * 0.9
    assert comp_loss < dense_loss * 1.25 + 0.05, (comp_loss, dense_loss)


def test_overlapped_worker_descends(blobs):
    x, y, d, k = blobs
    ref = _keras_mlp(d, k)
    initial = _loss_of(ref, ref.get_weights(), x[:400], y[:400])
    final_w, model = _train_worker(blobs, server_mode="hogwild", compression="int8", topk=0.25,
                                   pull_compression="none", overlap=True, staleness=1)
    assert _loss_of(model, final_w, x[:400], y[:400]) < initial * 0.9


@needs_gxx
def test_native_client_parses_master_port(blobs):
    x, y, d, k = blobs
    model = _keras_mlp(d, k, units=32)
    server = native.NativeParameterServer(model.get_weights(), port=0)
    try:
        worker = AsynchronousSparkWorker(
            model.to_json(), train_config={"epochs": 1, "batch_size": 64},
            parameter_server_mode="native", master=f"127.0.0.1:{server.port}",
            port=1,  # wrong on purpose; the master string must win
            master_optimizer="adam", master_loss=LOSS, device="cpu")
        assert len(list(worker.train(iter(zip(x[:100], y[:100]))))) == 1
        with pytest.raises(ValueError, match="raw float32"):
            AsynchronousSparkWorker(model.to_json(), parameter_server_mode="native",
                                    compression="int8", device="cpu")._client(None)
    finally:
        server.stop()


# -- chaos runs ----------------------------------------------------------


def _reference_weights(rows, seed=0):
    """The reference's seeded chaos network's initial weights."""
    _, _, d, k = jax_harness._chaos_data(seed, rows)
    return [w.copy() for w in jax_harness._chaos_model(seed, d, k).get_weights()]


def _chaos_losses(out, rows, initial=None):
    """Initial and final losses of a chaos run's network, read by Keras
    (``initial``: the weights the run started from, else the port's own
    seeded draw)."""
    x, y, d, k = harness._chaos_data(0, rows)
    model, model_json = harness._chaos_model(0, d, k, device="cpu", weights=initial)
    km = keras.models.model_from_json(model_json)
    km.compile(optimizer="adam", loss=LOSS)
    initial = _loss_of(km, get_weights(model), x, y)
    return initial, _loss_of(km, out["final_weights"], x, y)


CHAOS = dict(rows=192, epochs=2, seed=0, batch_size=64)


@pytest.fixture(scope="module")
def clean_chaos_run():
    """The port's fault-free chaos run from the reference's seeded weights."""
    return run_chaos_training("socket", plan=None, device="cpu",
                              initial_weights=_reference_weights(CHAOS["rows"]), **CHAOS)


def test_fault_free_chaos_run_matches_the_reference(clean_chaos_run):
    """At the same seed and from the same network, the port's fault-free
    ``run_chaos_training`` applies what the reference's does, and ends
    where it ends."""
    theirs = jax_harness.run_chaos_training("socket", plan=None, **CHAOS)
    ours = clean_chaos_run
    assert ours["updates_applied"] == theirs["updates_applied"] == 2 * 3
    assert ours["duplicates_skipped"] == theirs["duplicates_skipped"] == 0
    for a, b in zip(ours["data"], theirs["data"]):
        np.testing.assert_array_equal(a, b)
    assert len(ours["final_weights"]) == len(theirs["final_weights"])
    for a, b in zip(ours["final_weights"], theirs["final_weights"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_chaos_training_survives_ps_crash_and_converges(tmp_path, clean_chaos_run):
    clean = clean_chaos_run
    initial_weights = _reference_weights(CHAOS["rows"])
    plan = FaultPlan(seed=0, kill_ps_after_updates=2, restart_delay_s=0.4,
                     duplicate_fraction=0.25)
    faulted = run_chaos_training("socket", plan=plan, journal_dir=str(tmp_path),
                                 journal_every=1, device="cpu",
                                 initial_weights=initial_weights, **CHAOS)
    assert faulted["kills"] == 1 and faulted["restarts"] == 1
    assert faulted["journal_restored"]
    assert faulted["recovery_s"] is not None and faulted["recovery_s"] > 0
    assert faulted["updates_applied"] == clean["updates_applied"] == 2 * 3
    assert faulted["duplicates_sent"] >= 1
    assert faulted["duplicates_skipped"] >= faulted["duplicates_sent"]
    assert faulted["updates_lost_final"] == 0
    initial, clean_loss = _chaos_losses(clean, CHAOS["rows"], initial_weights)
    _, faulted_loss = _chaos_losses(faulted, CHAOS["rows"], initial_weights)
    assert clean_loss < initial * 0.95
    assert faulted_loss < initial * 0.95
    # the kill, the restart and the duplicates cost the run at most a
    # re-trained period: within 5 % of the fault-free loss
    assert faulted_loss < clean_loss * 1.05, (faulted_loss, clean_loss)


@pytest.mark.parametrize("transport", ["http", "socket"])
def test_sharded_chaos_kills_one_shard_and_loses_nothing(tmp_path, transport):
    plan = FaultPlan(seed=0, kill_ps_after_updates=2, restart_delay_s=0.3,
                     duplicate_fraction=0.25, kill_shard=0)
    out = harness.run_sharded_chaos_training(
        transport, num_shards=2, rows=192, epochs=2, batch_size=64, seed=0, plan=plan,
        journal_dir=str(tmp_path), device="cpu")
    assert out["kills"] == [1, 0] and out["restarts"] == [1, 0]
    # the warm-up's 2 periods + 2 epochs of 3 batches, on each shard, each once
    assert out["updates_applied_by_shard"] == [8, 8]
    assert out["duplicates_sent"] >= 1 and out["updates_lost_final"] == 0
    assert not any(out["pending_final"])
    assert out["recovery_s_by_shard"][0] is not None
    assert out["trace_id"].startswith(f"chaos-sharded-{transport}-s0-")


def test_elastic_workers_join_and_leave_mid_run():
    out = harness.run_elastic_membership("socket", num_shards=2, rows=96, batch_size=32, seed=0,
                                         device="cpu")
    for members in out["members_by_shard"]:
        assert {"steady", "leaver", "joiner"} <= set(members)
    assert out["updates_duplicate"] == 0
    assert out["updates_applied"] == 2 * 6
    initial, final = _chaos_losses(out, 96)
    assert final < initial


def test_harness_refuses_null_mode():
    was = telemetry.set_null(True)
    try:
        with pytest.raises(RuntimeError, match="requires telemetry"):
            run_chaos_training("socket", rows=64, device="cpu")
    finally:
        telemetry.set_null(was)


def test_shard_kill_fires_the_watchdog_then_clears(tmp_path):
    """``tests/test_telemetry_fleet.py``'s chaos-watch case (``slow`` in the
    reference) on the port: the port's watchdog reads the port's PS client
    series, so the shard kill fires ``ps_unreachable`` with the killed
    shard's label and clears on recovery, and one trace id spans the
    worker's push, the shard's apply and its journal write."""
    import json

    plan = FaultPlan(seed=0, kill_ps_after_updates=2, restart_delay_s=0.75, kill_shard=0)
    out = harness.run_sharded_chaos_training(
        "socket", num_shards=2, rows=256, epochs=2, batch_size=64, plan=plan,
        journal_dir=str(tmp_path / "j"), watch=True, trace_export=str(tmp_path / "trace.json"),
        device="cpu")
    assert any(a["rule"] == "ps_unreachable" and a.get("shard") == "0"
               for a in out["watch_anomalies"]), out["watch_anomalies"]
    assert any(a["rule"] == "ps_unreachable" for a in out["watch_cleared"])
    assert out["watch_report"]["active"] == []
    doc = json.loads((tmp_path / "trace.json").read_text())
    for name in ("ps.push", "ps.apply", "ps.journal_write"):
        assert any(e["name"] == name and e["args"].get("trace") == out["trace_id"]
                   for e in doc["traceEvents"]), name
