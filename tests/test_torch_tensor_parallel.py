"""The port's tensor parallelism against the JAX package's, on the CPU.

``elephas_tpu_torch.parallel.tensor`` (the planner, ``ShardedTrainer``,
``TensorParallelRunner`` behind ``SparkModel(model_parallel=N)``, the
sharded checkpoints) against ``elephas_tpu.parallel.tensor`` on the
reference's MLP (``tests/test_tensor_parallel.py:16``) and a one-layer
transformer. Inputs come from numpy seeds (conftest's ``blobs``); Keras
weights cross through ``load_keras_weights``. The port runs under
``force_devices`` on ``device="cpu"``; the JAX side keeps to 2-device
meshes (1 data × 2 model, and 2 data × 1 model for the replicas'
averages) and to six fits, the MLP's made once each in a module
fixture. Tolerances (fp32, other summation orders):

- history and final weights against JAX: 1e-4 relative and absolute (the
  reference's own contract between layouts, ``test_tensor_parallel.py:
  92-108``);
- the port's ``model_parallel=2`` against its own ``model_parallel=1``:
  1e-5 (the same arithmetic but for the order of the row-parallel sums);
- evaluate 1e-5 relative, predict 1e-5 absolute;
- resume against the uninterrupted fit: 1e-5.
"""

import logging
import os

import keras
import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F

import elephas_tpu_torch as et
from elephas_tpu.parallel.tensor import ShardedTrainer as JaxShardedTrainer
from elephas_tpu.parallel.tensor import dp_tp_mesh as jax_dp_tp_mesh
from elephas_tpu.models import transformer_classifier as jax_classifier
from elephas_tpu_torch import device as port_device
from elephas_tpu_torch.data.streaming import ShardedStream
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.models.layers import Dense, dense_paths
from elephas_tpu_torch.optimizers import SGD, Adam
from elephas_tpu_torch.parallel import tensor
from elephas_tpu_torch.parallel.mesh import Mesh
from elephas_tpu_torch.parallel.tensor import ShardedTrainer, dp_tp_mesh
from elephas_tpu_torch.training import add_loss, compile_model
from elephas_tpu_torch.utils.weights import canonical_keras_names

ROWS, BATCH, EPOCHS = 249, 64, 2  # 249 = 3·64 + 57: a padded tail batch
TOL_JAX = 1e-4
TOL_LAYOUT = 1e-5
JAX_MODES = [("synchronous", "epoch"), ("hogwild", "batch"), ("asynchronous", "epoch")]
MATRIX = [("synchronous", "epoch"), ("synchronous", "fit"), ("asynchronous", "epoch"),
          ("asynchronous", "batch"), ("hogwild", "epoch"), ("hogwild", "batch")]


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


def _keras_weights(model):
    return {v.path: np.asarray(v) for v in model.weights}


def _keras_mlp(d, k, hidden=32, seed=5, lr=1e-2):
    """The reference's TP test MLP: Dense(hidden, relu) → Dense(k, softmax)."""
    keras.utils.set_random_seed(seed)
    model = keras.Sequential([keras.layers.Input((d,)),
                              keras.layers.Dense(hidden, activation="relu"),
                              keras.layers.Dense(k, activation="softmax")])
    model.compile(optimizer=keras.optimizers.Adam(lr), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    return model


class MLP(nn.Module):
    """The Keras Sequential above, loadable by its paths."""

    def __init__(self, keras_name, d, k, hidden=32, penalty=0.0):
        super().__init__()
        self.keras_sequential = keras_name
        self.dense = Dense(d, hidden)
        self.dense_1 = Dense(hidden, k)
        self.penalty = penalty

    def forward(self, x):
        if self.training and self.penalty:
            # an L2 kernel regulariser on the first layer, added as Keras adds one
            add_loss(self.penalty * self.dense.weight.square().sum())
        return torch.softmax(self.dense_1(F.relu(self.dense(x))), dim=-1)

    def keras_paths(self):
        name = self.keras_sequential
        return {**dense_paths(f"{name}/dense", self.dense),
                **dense_paths(f"{name}/dense_1", self.dense_1)}


def _port_mlp(ref, d, k, hidden=32, lr=1e-2, penalty=0.0, optimizer=Adam):
    port = MLP(ref.name, d, k, hidden, penalty)
    compile_model(port, optimizer(port.parameters(), lr=lr), "sparse_categorical_crossentropy",
                  ["accuracy"])
    et.load_keras_weights(port, _keras_weights(ref))
    return port


def _assert_weights(port, want, tol):
    got = et.keras_weights(port)
    names = canonical_keras_names(port, want)
    for path, w in want.items():
        np.testing.assert_allclose(got[names[path]], w, rtol=tol, atol=tol, err_msg=path)


# -- meshes and the planner ------------------------------------------------


@pytest.mark.parametrize("kwargs", [dict(model_parallel=4), dict(model_parallel=3),
                                    dict(model_parallel=3, data_parallel=2),
                                    dict(model_parallel=2, data_parallel=0),
                                    dict(model_parallel=4, data_parallel=3),
                                    dict(model_parallel=0)])
def test_mesh_construction_matches_reference(kwargs):
    """Over 8 slots (conftest's 8 virtual devices on the JAX side): the same
    shapes, and the reference's errors word for word."""
    force_devices(8)
    try:
        want = jax_dp_tp_mesh(**kwargs)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            dp_tp_mesh(**kwargs, device="cpu")
        assert str(got.value) == str(err)
        return
    mesh = dp_tp_mesh(**kwargs, device="cpu")
    assert dict(mesh.shape) == dict(want.shape)
    assert {d.type for d in mesh.devices.reshape(-1)} == {"cpu"}


def _transformer_pair(**cfg):
    ref = jax_classifier(**cfg)
    port = et.transformer_classifier(**cfg, device="cpu")
    et.load_keras_weights(port, _keras_weights(ref))
    return ref, port


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    x = np.where(rng.random((n, 16)) < np.where(y[:, None] == 1, 0.8, 0.2),
                 rng.integers(31, 61, size=(n, 16)), rng.integers(1, 31, size=(n, 16)))
    return x.astype(np.int64), y.astype(np.int64)


CLASSIFIER = dict(vocab_size=61, maxlen=16, num_classes=2, d_model=32, num_heads=2,
                  num_layers=1, dropout=0.0)


@pytest.mark.parametrize("which", ["mlp", "transformer", "untileable"])
def test_sharding_summary_matches_reference(blobs, caplog, which):
    """The planner decides as the reference does, path for path, on a
    2-way model axis; where nothing tiles both log the same warning."""
    _, _, d, k = blobs
    if which == "transformer":
        ref, port = _transformer_pair(**CLASSIFIER)
    else:
        ref = _keras_mlp(d, k, hidden=63 if which == "untileable" else 32)
        port = _port_mlp(ref, d, k, hidden=63 if which == "untileable" else 32)
    with caplog.at_level(logging.WARNING):
        want = JaxShardedTrainer(ref, mesh=jax_dp_tp_mesh(2, data_parallel=1))
        got = ShardedTrainer(port, mesh=dp_tp_mesh(2, data_parallel=1, device="cpu"))
    names = canonical_keras_names(port, want.sharding_summary())
    assert got.sharding_summary() == {names[p]: s for p, s in
                                      want.sharding_summary().items()}
    warned = {r.name: r.getMessage() for r in caplog.records if "sharded NOTHING" in
              r.getMessage()}
    if which != "untileable":
        assert not warned
        return
    message = warned["elephas_tpu.parallel.tensor"]
    for path, canonical in names.items():
        message = message.replace(path, canonical)
    assert warned["elephas_tpu_torch.parallel.tensor"] == message


def test_planner_rules_and_port_axes():
    """A Dense kernel's Keras column split is the nn.Linear weight's axis 0,
    its row split axis 1; qkv splits by heads; ``rules=[]`` replicates
    everything without a warning."""
    port = et.transformer_classifier(**CLASSIFIER, device="cpu")
    mesh = dp_tp_mesh(2, data_parallel=1, device="cpu")
    trainer = ShardedTrainer(port, mesh=mesh)
    dims = trainer._dims
    assert dims["blocks.0.mlp1.weight"] == 0 and dims["blocks.0.mlp2.weight"] == 1
    assert dims["tok_embed.weight"] == 1 and dims["head.weight"] == 0
    assert dims["blocks.0.ln1.gamma"] is None
    rep = trainer._ensure_replicas()[0]
    assert isinstance(rep.module.blocks[0].attn, tensor.TensorParallelMHA)
    qkv = rep.variables["blocks.0.attn.qkv.weight"]
    whole = port.blocks[0].attn.qkv.weight.detach()
    # shard j holds the q, k and v rows of head j
    for j, shard in enumerate(qkv.shards):
        want = whole.view(3, 2, 16, 32)[:, j].reshape(-1, 32)
        assert torch.equal(shard.detach(), want)
    plain = ShardedTrainer(port, mesh=mesh, rules=[])
    assert set(plain.sharding_summary().values()) == {"PartitionSpec()"}


# -- training against the reference ----------------------------------------


@pytest.fixture(scope="module")
def fits(blobs):
    """``fits(mode, frequency, data_parallel=1)``: the JAX ShardedTrainer's
    fit on a ``data_parallel`` × ``2 // data_parallel`` mesh (two devices)
    and the port's from the same weights on a ``data_parallel`` × 2 mesh,
    each made once a module and only for the cases a worker's tests ask
    for: ``(jax trainer, history, final weights)``, ``(port module,
    history, trainer)``."""
    x, y, d, k = blobs
    cache = {}

    def get(mode, frequency, data_parallel=1):
        key = mode, frequency, data_parallel
        if key not in cache:
            ref = _keras_mlp(d, k)
            port = _port_mlp(ref, d, k)
            want = JaxShardedTrainer(
                ref, mesh=jax_dp_tp_mesh(2 // data_parallel, data_parallel=data_parallel),
                mode=mode, frequency=frequency)
            want_history = want.fit(x[:ROWS], y[:ROWS], epochs=EPOCHS, batch_size=BATCH)
            got = ShardedTrainer(
                port, mesh=dp_tp_mesh(2, data_parallel=data_parallel, device="cpu"),
                mode=mode, frequency=frequency)
            history = got.fit(x[:ROWS], y[:ROWS], epochs=EPOCHS, batch_size=BATCH)
            cache[key] = ((want, want_history, _keras_weights(ref)), (port, history, got))
        return cache[key]

    return get


def _assert_fit_matches(fitted):
    (_, want_history, want_weights), (port, history, _) = fitted
    assert history.keys() == want_history.keys()
    for key in history:
        np.testing.assert_allclose(history[key], want_history[key], rtol=TOL_JAX, atol=TOL_JAX)
    _assert_weights(port, want_weights, TOL_JAX)


@pytest.mark.parametrize("mode,frequency", JAX_MODES)
def test_tp_fit_matches_reference(fits, mode, frequency):
    _assert_fit_matches(fits(mode, frequency))


@pytest.mark.parametrize("mode,frequency", [("hogwild", "batch"), ("asynchronous", "epoch")])
def test_data_replicas_match_reference(fits, mode, frequency):
    """Two data replicas, each a copy sharded over a 2-way model axis (the
    port's 2 × 2 mesh), against the JAX trainer's two replicas (its 2 × 1
    mesh: the layout does not change its numbers): each replica's share
    of every batch, the padded tail (57 rows → 29 + 29, one pad row of zero
    weight), and the average at the batch or epoch boundary."""
    _assert_fit_matches(fits(mode, frequency, data_parallel=2))


def test_tp_evaluate_and_predict_match_reference(blobs, fits):
    """After the synchronous fit: evaluate (301 rows, a wrap-padded tail)
    and predict (batched, and fewer rows than a batch) agree with the
    reference's trainer."""
    x, y, _, _ = blobs
    (want_trainer, _, _), (_, _, trainer) = fits("synchronous", "epoch")
    got, want = trainer.evaluate(x[:301], y[:301], 32), want_trainer.evaluate(x[:301], y[:301], 32)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_JAX)
    for rows in (301, 3):
        np.testing.assert_allclose(trainer.predict(x[:rows], 64),
                                   want_trainer.predict(x[:rows], 64), atol=TOL_JAX)


def test_tp_transformer_fit_matches_reference():
    """A one-layer transformer classifier (flash attention; the reference's
    Pallas kernel in interpret mode) on a 1 × 2 mesh: the port's qkv split
    by heads and the reference's contiguous split train the same model."""
    x, y = _tokens(64, seed=2)
    ref, port = _transformer_pair(**CLASSIFIER)
    want = JaxShardedTrainer(ref, mesh=jax_dp_tp_mesh(2, data_parallel=1)).fit(
        x.astype(np.int32), y.astype(np.int32), epochs=EPOCHS, batch_size=16)
    got = ShardedTrainer(port, mesh=dp_tp_mesh(2, data_parallel=1, device="cpu")).fit(
        x, y, epochs=EPOCHS, batch_size=16)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_JAX, atol=TOL_JAX)
    _assert_weights(port, _keras_weights(ref), TOL_JAX)


# -- the layout does not change the numbers ---------------------------------


@pytest.mark.parametrize("mode,frequency", MATRIX)
def test_mode_matrix_model_parallel_2_equals_1(blobs, mode, frequency):
    """Each of the reference's mode × frequency pairs through
    ``SparkModel(model_parallel=2)`` on a 2 × 2 mesh against the port's
    trainer on a 2 × 1 mesh (two data replicas each): history, weights,
    evaluate and predict."""
    x, y, d, k = blobs
    ref = _keras_mlp(d, k, seed=11)
    a, b = _port_mlp(ref, d, k), _port_mlp(ref, d, k)
    sm = et.SparkModel(a, mode=mode, frequency=frequency, model_parallel=2, num_workers=2,
                       device="cpu")
    assert sm.num_workers == 2 and dict(sm.mesh.shape) == {"data": 2, "model": 2}
    history = sm.fit((x[:ROWS], y[:ROWS]), epochs=EPOCHS, batch_size=BATCH)
    one = ShardedTrainer(b, mesh=dp_tp_mesh(1, data_parallel=2, device="cpu"), mode=mode,
                         frequency=frequency)
    want = one.fit(x[:ROWS], y[:ROWS], epochs=EPOCHS, batch_size=BATCH)
    for key in want:
        np.testing.assert_allclose(history[key], want[key], rtol=TOL_LAYOUT, atol=TOL_LAYOUT)
    _assert_weights(a, et.keras_weights(b), TOL_LAYOUT)
    loss, acc = sm.evaluate(x[:301], y[:301])
    want_eval = one.evaluate(x[:301], y[:301], 32)
    np.testing.assert_allclose([loss, acc], [want_eval["loss"], want_eval["accuracy"]],
                               rtol=TOL_LAYOUT)
    np.testing.assert_allclose(sm.predict(x[:50]), one.predict(x[:50]), atol=TOL_LAYOUT)


def test_tail_rows_and_regulariser_ride_unscaled(blobs):
    """249 rows at batch 64 on a 2-replica data axis pad the tail (57 → 58
    rows, the pad of zero weight); the regulariser the layers add rides
    unscaled. SGD, so that no Adam normalisation hides a wrong scale: the
    2 × 2 fit equals the 1 × 1 fit, which pads nothing."""
    x, y, d, k = blobs
    ref = _keras_mlp(d, k, seed=19)
    a = _port_mlp(ref, d, k, lr=0.05, penalty=0.1, optimizer=SGD)
    b = _port_mlp(ref, d, k, lr=0.05, penalty=0.1, optimizer=SGD)
    h2 = ShardedTrainer(a, mesh=dp_tp_mesh(2, data_parallel=2, device="cpu")).fit(
        x[:ROWS], y[:ROWS], epochs=EPOCHS, batch_size=BATCH)
    h1 = ShardedTrainer(b, mesh=dp_tp_mesh(1, data_parallel=1, device="cpu")).fit(
        x[:ROWS], y[:ROWS], epochs=EPOCHS, batch_size=BATCH)
    np.testing.assert_allclose(h2["loss"], h1["loss"], rtol=TOL_LAYOUT)
    _assert_weights(a, et.keras_weights(b), TOL_LAYOUT)
    # the rows of zero weight count nowhere: 10 rows at batch 64 still train
    small = ShardedTrainer(_port_mlp(ref, d, k), mesh=dp_tp_mesh(2, 2, device="cpu"))
    assert np.isfinite(small.fit(x[:10], y[:10], epochs=2, batch_size=64)["loss"]).all()


def test_streamed_fit_through_spark_model(blobs):
    """A streamed fit (stream_block_steps) through SparkModel(model_parallel=2)
    learns, and equals the same stream (a data replica's share of the
    global batch a step) through the trainer at model_parallel=1."""
    x, y, d, k = blobs
    ref = _keras_mlp(d, k, seed=6)
    a, b = _port_mlp(ref, d, k), _port_mlp(ref, d, k)
    sm = et.SparkModel(a, model_parallel=2, num_workers=2, device="cpu")
    h2 = sm.fit((x, y), epochs=3, batch_size=32, stream_block_steps=2)
    runner = tensor.TensorParallelRunner(b, "synchronous", "epoch",
                                         dp_tp_mesh(1, data_parallel=2, device="cpu"))
    h1 = runner.run_epochs_stream(ShardedStream(x, y, 16, 2, block_steps=2), 3)
    assert h2["loss"][-1] < h2["loss"][0] and len(h2["accuracy"]) == 3
    for key in h1:
        np.testing.assert_allclose(h2[key], h1[key], rtol=TOL_LAYOUT)
    _assert_weights(a, et.keras_weights(b), TOL_LAYOUT)


# -- sharded checkpoints ---------------------------------------------------


def test_resume_from_sharded_checkpoint_equals_uninterrupted(tmp_path):
    """A one-layer transformer through SparkModel(model_parallel=2) on a
    2 × 2 mesh, synchronous as the reference's test: 2 epochs, a sharded
    checkpoint, then resumed to 4 equals the uninterrupted 4-epoch fit
    (optimizer state included). (The per-replica modes resume every replica
    from the canonical copy, replica 0's optimizer slots, as the reference
    does; they part from an uninterrupted fit.)"""
    x, y = _tokens(96)
    ckdir = str(tmp_path / "tp_ckpt")

    def fit(**kwargs):
        port = et.transformer_classifier(**CLASSIFIER, seed=3, device="cpu")
        sm = et.SparkModel(port, model_parallel=2, device="cpu")
        return port, sm.fit((x, y), batch_size=16, **kwargs)

    full, h_full = fit(epochs=4)
    fit(epochs=2, checkpoint_dir=ckdir)
    assert not any(n.endswith(".pt") and n.startswith("ckpt-") for n in os.listdir(ckdir))
    resumed, h_resumed = fit(epochs=4, checkpoint_dir=ckdir, resume=True)
    np.testing.assert_allclose(h_resumed["loss"], h_full["loss"][2:], rtol=1e-5)
    _assert_weights(resumed, et.keras_weights(full), 1e-5)


def test_checkpoint_is_sharded_on_disk(tmp_path):
    """One file a model-axis position; each holds its shard of every
    sharded variable (qkv: its head's rows) and none holds one whole;
    restore puts back bit for bit what was saved."""
    x, y = _tokens(64, seed=1)
    port = et.transformer_classifier(**CLASSIFIER, device="cpu")
    trainer = ShardedTrainer(port, mesh=dp_tp_mesh(2, data_parallel=2, device="cpu"),
                             mode="asynchronous", frequency="epoch")
    trainer.fit(x, y, epochs=1, batch_size=16)
    saved = et.keras_weights(port)
    opt_saved = {id(p): {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                 for p, s in port.training_spec.optimizer.state.items()}
    path = trainer.save_checkpoint(str(tmp_path / "ck"), 1)
    assert sorted(os.listdir(path)) == ["shard-000.pt", "shard-001.pt"]
    shards = [torch.load(os.path.join(path, f), weights_only=True)
              for f in sorted(os.listdir(path))]
    qkv = port.blocks[0].attn.qkv.weight
    for s in shards:
        assert s["blocks.0.attn.qkv.weight"].shape == (qkv.shape[0] // 2, qkv.shape[1])
        assert s["blocks.0.attn.qkv.weight#m"].shape == (qkv.shape[0] // 2, qkv.shape[1])
    assert "blocks.0.ln1.gamma" in shards[0] and "blocks.0.ln1.gamma" not in shards[1]
    # train on, then restore: the saved state comes back bit for bit
    trainer.fit(x, y, epochs=1, batch_size=16)
    meta = trainer.restore_checkpoint(str(tmp_path / "ck"))
    assert meta["epoch"] == 1 and meta["model_parallel"] == 2
    for path_, w in et.keras_weights(port).items():
        np.testing.assert_array_equal(w, saved[path_])
    for p, s in port.training_spec.optimizer.state.items():
        for key, value in s.items():
            want = opt_saved[id(p)][key]
            assert torch.equal(value, want) if torch.is_tensor(value) else value == want
    other = ShardedTrainer(et.transformer_classifier(**CLASSIFIER, device="cpu"),
                           mesh=dp_tp_mesh(1, data_parallel=2, device="cpu"))
    with pytest.raises(ValueError, match="other shard layouts"):
        other.restore_checkpoint(str(tmp_path / "ck"))


# -- the surface -----------------------------------------------------------


def test_spark_model_surface_and_refusals(blobs, monkeypatch):
    """``model_parallel`` builds the reference's sub-mesh (3 on 4 slots: 1 ×
    3), is kept in the config, exports ShardedTrainer at the top level;
    serve() on it, a gang and a cuda mesh without CUDA raise."""
    x, y, d, k = blobs
    ref = _keras_mlp(d, k, hidden=63, seed=17)
    sm = et.SparkModel(_port_mlp(ref, d, k, hidden=63), model_parallel=3, device="cpu")
    assert sm.num_workers == 1 and sm.get_config()["model_parallel"] == 3
    assert np.isfinite(sm.fit((x[:96], y[:96]), epochs=1, batch_size=32)["loss"]).all()
    assert et.ShardedTrainer is ShardedTrainer and "ShardedTrainer" in et.__all__
    lm = et.transformer_lm(vocab_size=8, maxlen=16, d_model=32, num_heads=2, num_layers=1,
                           device="cpu")
    with pytest.raises(NotImplementedError, match=r"Queue A item 5c\b"):
        et.SparkModel(lm, model_parallel=2, device="cpu").serve()
    monkeypatch.setattr(port_device, "_gang",
                        port_device.Gang(0, 2, torch.device("cpu")))
    with pytest.raises(NotImplementedError, match=r"Queue A item 5c\b"):
        et.SparkModel(lm, model_parallel=2, device="cpu")
    monkeypatch.setattr(port_device, "_gang", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedTrainer(lm, mesh=Mesh([["cuda:0", "cuda:0"]], ("data", "model")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dp_tp_mesh(2)


def test_other_sharded_layers_gather_their_shards():
    """The IMDB LSTM at model_parallel=2: its embedding is column-parallel,
    the LSTM's kernels (the catch-all ``/kernel$`` rule) live as shards that
    the layer gathers before its forward; the fit equals the same weights'
    at model_parallel=1 within 1e-5, and the master's weights come back
    whole."""
    rng = np.random.default_rng(3)
    x, y = rng.integers(1, 50, size=(64, 8)), rng.integers(0, 2, size=64)

    def lstm():
        model = et.imdb_lstm(vocab_size=50, maxlen=8, embed_dim=8, units=8, seed=2,
                             device="cpu")
        model.drop.rate = 0.0
        return model

    a, b = lstm(), lstm()
    two = ShardedTrainer(a, mesh=dp_tp_mesh(2, data_parallel=1, device="cpu"))
    assert two._dims["lstm.weight_ih_l0"] == 0 and two._dims["embedding.weight"] == 1
    replica = two._ensure_replicas()[0].module
    assert isinstance(replica.embedding, tensor.ColumnParallelEmbedding)
    assert len(replica.lstm.weight_ih_l0_shards) == 2
    h2 = two.fit(x, y, epochs=2, batch_size=16)
    h1 = ShardedTrainer(b, mesh=dp_tp_mesh(1, data_parallel=1, device="cpu")).fit(
        x, y, epochs=2, batch_size=16)
    for key in h1:
        np.testing.assert_allclose(h2[key], h1[key], rtol=TOL_LAYOUT, atol=TOL_LAYOUT)
    _assert_weights(a, et.keras_weights(b), TOL_LAYOUT)
