"""The port's Spark ML surface against the JAX package's, on the CPU:
the DataFrame stand-in, the ``Has*`` params, the Keras-JSON reader, the
optimizers the estimator deserializes, and ``ElephasEstimator`` /
``ElephasTransformer`` / ``Pipeline``.

Keras models of the reference give the JSON (``to_json()``) and weights
(``get_weights()``); data is numpy from a seed (the ``blobs`` fixture).
Tolerances:
- DataFrame, params and adapter results: equal;
- a module read from the JSON against the Keras model's forward: 1e-6;
- the optimizers against Keras's own steps (JAX on the CPU): 1e-5 of
  each weight after 5 steps;
- transformer probabilities against the JAX transformer's: 1e-5, and the
  class column equal;
- the estimator's weights against ``SparkModel.fit`` of the module built
  from the same JSON: bit for bit.
"""

import json

import keras
import numpy as np
import pytest
import torch

import elephas_tpu.ml.params as jax_params
import elephas_tpu_torch as et
import elephas_tpu_torch.ml.params as params
from elephas_tpu.data.dataframe import Row as JaxRow
from elephas_tpu.data.dataframe import SparkSession as JaxSparkSession
from elephas_tpu.data.dataframe import vectorize_column as jax_vectorize
from elephas_tpu.ml import adapter as jax_adapter
from elephas_tpu.ml_model import ElephasTransformer as JaxTransformer
from elephas_tpu.ml_model import load_ml_transformer as jax_load_transformer
from elephas_tpu_torch.data import SparkContext
from elephas_tpu_torch.data.dataframe import DataFrame, Row, SparkSession, vectorize_column
from elephas_tpu_torch.data.linalg import DenseVector
from elephas_tpu_torch.device import force_devices
from elephas_tpu_torch.ml import Pipeline, PipelineModel, adapter
from elephas_tpu_torch.models.keras_config import model_from_json
from elephas_tpu_torch.optimizers import SGD, Adam, RMSprop, deserialize
from elephas_tpu_torch.utils.weights import canonical_keras_names

W = 8


@pytest.fixture(autouse=True)
def eight_workers():
    previous = force_devices(W)
    yield
    force_devices(previous)


def _sequential(d, k, *hidden):
    return keras.Sequential([keras.layers.Input((d,)), *hidden,
                             keras.layers.Dense(k, activation="softmax")])


def _rows(x, y):
    return [(row, float(label)) for row, label in zip(x, y)]


@pytest.fixture(scope="module")
def frames(blobs):
    """The blobs as a DataFrame of each package."""
    x, y, _, _ = blobs
    return (SparkSession().createDataFrame(_rows(x, y), schema=["features", "label"]),
            JaxSparkSession().createDataFrame(_rows(x, y), schema=["features", "label"]))


def _estimator(d, k, **overrides):
    kw = dict(keras_model_config=_sequential(d, k, keras.layers.Dense(32, activation="relu"))
              .to_json(),
              optimizer_config=keras.optimizers.serialize(keras.optimizers.Adam(1e-2)),
              loss="categorical_crossentropy", metrics=["accuracy"], categorical_labels=True,
              nb_classes=k, epochs=4, batch_size=32, num_workers=W, mode="synchronous",
              predict_classes=True, device="cpu")
    kw.update(overrides)
    return et.ElephasEstimator(**kw)


# -- DataFrame and params ---------------------------------------------------


def _same_frame(ours, theirs):
    assert ours.columns == theirs.columns and ours.count() == theirs.count()
    for c in ours.columns:
        for a, b in zip(ours.column_values(c), theirs.column_values(c)):
            assert type(a).__name__ == type(b).__name__, c
            if hasattr(a, "toArray"):
                a, b = a.toArray(), b.toArray()
            assert np.array_equal(np.asarray(a), np.asarray(b)), c


def test_dataframe_matches_the_reference(frames):
    ours, theirs = frames
    for seed in (0, 1, 7):
        for weights in ([0.8, 0.2], [1, 1, 2]):
            for a, b in zip(ours.randomSplit(weights, seed=seed),
                            theirs.randomSplit(weights, seed=seed)):
                _same_frame(a, b)
    _same_frame(ours.select("label"), theirs.select("label"))
    _same_frame(ours.select(["label", "features"]), theirs.select(["label", "features"]))
    extra = list(range(ours.count()))
    _same_frame(ours.withColumn("i", extra), theirs.withColumn("i", extra))
    _same_frame(ours.drop("label").withColumnRenamed("features", "f"),
                theirs.drop("label").withColumnRenamed("features", "f"))
    np.testing.assert_array_equal(vectorize_column(ours.column_values("features")),
                                  jax_vectorize(theirs.column_values("features")))
    mixed = [DenseVector([1.0, 2.0]), np.array([3.0, 4.0]), [5, 6]]
    np.testing.assert_array_equal(vectorize_column(mixed), np.array(
        [[1, 2], [3, 4], [5, 6]], np.float32))
    assert [r.asDict()["label"] for r in ours.take(3)] == \
        [r.asDict()["label"] for r in theirs.take(3)]
    assert ours.first() == Row(**theirs.first().asDict()) and ours.rdd.count() == ours.count()
    with pytest.raises(KeyError, match="no such column"):
        ours.select("nope")
    with pytest.raises(ValueError, match="values for"):
        ours.withColumn("short", [1])
    with pytest.raises(ValueError, match="ragged"):
        DataFrame({"a": [1], "b": [1, 2]})


def test_session_and_rows_match_the_reference():
    rows = [Row(a=1, b=np.arange(2)), Row(a=2, b=np.arange(2) + 1)]
    session = SparkSession.builder.appName("t").master("local[2]").getOrCreate()
    df = session.createDataFrame(rows)
    theirs = JaxSparkSession().createDataFrame([JaxRow(**r.asDict()) for r in rows])
    _same_frame(df, theirs)
    _same_frame(session.createDataFrame({"a": [1, 2]}), JaxSparkSession().createDataFrame(
        {"a": [1, 2]}))
    assert df.collect() == rows and hash(rows[0]) == hash(Row(a=1, b=np.arange(2)))
    assert rows[0].a == rows[0]["a"] == rows[0][0] == 1 and repr(rows[0]) == repr(
        JaxRow(a=1, b=np.arange(2)))
    from_rdd = session.createDataFrame(SparkContext("local[2]").parallelize([(1, 2), (3, 4)]),
                                       schema=["p", "q"])
    assert from_rdd.column_values("q") == [2, 4]
    with pytest.raises(ValueError, match="schema"):
        session.createDataFrame([(1, 2)])
    with pytest.raises(ValueError, match="empty"):
        session.createDataFrame([])


def test_param_surface_matches_the_reference():
    ours = {n: getattr(params, n) for n in dir(params) if n.startswith("Has")}
    theirs = {n: getattr(jax_params, n) for n in dir(jax_params) if n.startswith("Has")}
    assert sorted(ours) == sorted(theirs) and len(ours) == 23
    for name, cls in ours.items():
        (p,), (q,) = cls.params(), theirs[name].params()
        assert (p.name, p.default) == (q.name, q.default), name
        accessors = {a for a in vars(cls) if a.startswith(("get", "set"))}
        assert accessors == {a for a in vars(theirs[name]) if a.startswith(("get", "set"))}
    est = et.ElephasEstimator()
    assert est.get_config() == et.ElephasEstimator.__mro__[0]().get_config()
    from elephas_tpu.ml_model import ElephasEstimator as JaxEstimator

    assert est.get_config() == JaxEstimator().get_config()
    est.setEpochs(7).setBatchSize(16).setMode("hogwild").setFrequency("batch")
    assert (est.getEpochs(), est.getBatchSize()) == (7, 16)
    est2 = et.ElephasEstimator()
    est2.set_config({**est.get_config(), "not_a_param": 1})
    assert est2.getFrequency() == "batch" and est2.get_config() == est.get_config()
    assert est2.hasParam("epochs") and not est2.hasParam("not_a_param")
    with pytest.raises(KeyError, match="no param"):
        est2.set("not_a_param", 1)


def test_data_frame_adapter_matches_the_reference(blobs):
    x, y, d, k = blobs
    ours = adapter.to_data_frame(None, x[:40], y[:40])
    theirs = jax_adapter.to_data_frame(None, x[:40], y[:40])
    _same_frame(ours, theirs)
    onehot = np.eye(k, dtype=np.float32)[y[:40]]
    _same_frame(adapter.to_data_frame(None, x[:40], onehot, categorical=True),
                jax_adapter.to_data_frame(None, x[:40], onehot, categorical=True))
    for categorical in (False, True):
        for got, want in zip(adapter.from_data_frame(ours, categorical, k),
                             jax_adapter.from_data_frame(theirs, categorical, k)):
            np.testing.assert_array_equal(got, want)
        for (gx, gy), (wx, wy) in zip(
                adapter.df_to_simple_rdd(ours, categorical, k).collect(),
                jax_adapter.df_to_simple_rdd(theirs, categorical, k).collect()):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


# -- the Keras JSON reader and the optimizers ------------------------------


KERAS_MODELS = {
    "relu_softmax": lambda: _sequential(6, 3, keras.layers.Dense(5, activation="relu")),
    "sigmoid_dropout": lambda: keras.Sequential([
        keras.layers.Input((6,)), keras.layers.Dense(7, activation="tanh"),
        keras.layers.Dropout(0.4), keras.layers.Dense(4, use_bias=False),
        keras.layers.Activation("relu"), keras.layers.Dense(1, activation="sigmoid")]),
    "flatten": lambda: keras.Sequential([
        keras.layers.Input((3, 4)), keras.layers.Dense(5, activation="linear"),
        keras.layers.Flatten(), keras.layers.Dropout(0.2),
        keras.layers.Dense(2, activation="softmax")]),
}


@pytest.mark.parametrize("name", list(KERAS_MODELS))
def test_keras_json_builds_the_keras_forward(name):
    keras.utils.set_random_seed(3)
    ref = KERAS_MODELS[name]()
    port = model_from_json(ref.to_json(), device="cpu")
    port.set_weights(ref.get_weights())
    assert [w.shape for w in port.get_weights()] == [w.shape for w in ref.get_weights()]
    x = np.random.default_rng(0).normal(size=(9,) + tuple(ref.input_shape[1:])).astype(
        np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(x, training=False)), atol=1e-6, rtol=0)
    # the same weights by Keras path, and back
    again = model_from_json(ref.to_json(), seed=1, device="cpu")
    et.load_keras_weights(again, {v.path: np.asarray(v) for v in ref.weights})
    for a, b in zip(again.get_weights(), ref.get_weights()):
        np.testing.assert_array_equal(a, b)
    names = canonical_keras_names(again, [v.path for v in ref.weights])
    assert sorted(et.keras_weights(again)) == sorted(names.values())


def test_keras_json_refuses_what_is_not_ported():
    cases = [
        keras.Sequential([keras.layers.Input((4, 4, 1)), keras.layers.Conv2D(2, 3)]).to_json(),
        keras.Sequential([keras.layers.Input((4,)),
                          keras.layers.Dense(2, activation="elu")]).to_json(),
        keras.Sequential([keras.layers.Input((4,)), keras.layers.Dense(
            2, kernel_regularizer="l2")]).to_json(),
    ]
    inp = keras.Input((4,))
    cases.append(keras.Model(inp, keras.layers.Dense(2)(inp)).to_json())
    for model_json in cases:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue A item 2\b"):
            model_from_json(model_json, device="cpu")
    with pytest.raises(NotImplementedError, match=r"custom_objects.*Queue A item 2\b"):
        model_from_json(KERAS_MODELS["relu_softmax"]().to_json(),
                        custom_objects={"Mine": object}, device="cpu")
    port = model_from_json(KERAS_MODELS["relu_softmax"]().to_json(), device="cpu")
    with pytest.raises(ValueError, match="weights for a model"):
        port.set_weights(port.get_weights()[:1])


def _keras_steps(optimizer, shapes, grads):
    variables = [keras.Variable(np.zeros(s, np.float32) + 0.5) for s in shapes]
    for step in grads:
        optimizer.apply([keras.ops.convert_to_tensor(g) for g in step], variables)
    return [np.asarray(v) for v in variables]


def _port_steps(make, shapes, grads):
    params_ = [torch.nn.Parameter(torch.zeros(s) + 0.5) for s in shapes]
    opt = make(params_)
    for step in grads:
        for p, g in zip(params_, step):
            p.grad = torch.from_numpy(g)
        opt.step()
    return [p.detach().numpy() for p in params_]


OPTIMIZERS = {
    "rmsprop": (lambda: keras.optimizers.RMSprop(), None),
    "rmsprop_centered_momentum": (
        lambda: keras.optimizers.RMSprop(3e-3, rho=0.8, momentum=0.5, centered=True), None),
    "adam": (lambda: keras.optimizers.Adam(1e-2), None),
    "sgd_momentum": (lambda: keras.optimizers.SGD(0.1, momentum=0.9), None),
    "sgd": (lambda: keras.optimizers.SGD(0.05), None),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_track_keras(name):
    """The port's optimizer deserialized from the Keras one (as a dict and
    as JSON text; RMSprop also built directly) against Keras's own steps."""
    shapes = [(3, 4), (4,)]
    rng = np.random.default_rng(5)
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    make = OPTIMIZERS[name][0]
    want = _keras_steps(make(), shapes, grads)
    config = keras.optimizers.serialize(make())
    for spec in (config, json.dumps(config)):
        got = _port_steps(lambda p: deserialize(spec, p), shapes, grads)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    expected = {"rmsprop": RMSprop, "adam": Adam, "sgd": SGD}[name.split("_")[0]]
    assert type(deserialize(config, [torch.nn.Parameter(torch.zeros(1))])) is expected
    if name == "rmsprop":
        for g, w in zip(_port_steps(RMSprop, shapes, grads), want):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_deserialize_refuses_what_is_not_ported():
    p = [torch.nn.Parameter(torch.zeros(2))]
    for opt in (keras.optimizers.Adagrad(), keras.optimizers.Adam(amsgrad=True),
                keras.optimizers.SGD(0.1, nesterov=True, momentum=0.9),
                keras.optimizers.Adam(clipnorm=1.0), keras.optimizers.AdamW()):
        with pytest.raises(NotImplementedError, match=r"Queue A item 2\b"):
            deserialize(keras.optimizers.serialize(opt), p)
    # Keras's defaults where the config leaves a setting out
    assert isinstance(deserialize({"class_name": "RMSprop"}, p), RMSprop)
    assert isinstance(deserialize(json.dumps({"class_name": "Adam", "config": {}}), p), Adam)


# -- the estimator, the transformer and the pipeline -----------------------


def test_transformer_matches_the_jax_transformer(frames, blobs):
    x, y, d, k = blobs
    keras.utils.set_random_seed(7)
    ref = _sequential(d, k, keras.layers.Dense(32, activation="relu"))
    common = dict(keras_model_config=ref.to_json(), batch_size=64, num_workers=W)
    ours_df, theirs_df = frames
    for classes in (True, False):
        ours = et.ElephasTransformer(weights=ref.get_weights(), device="cpu",
                                     predict_classes=classes, **common)
        theirs = JaxTransformer(weights=ref.get_weights(), predict_classes=classes, **common)
        got = ours.transform(ours_df)
        want = theirs.transform(theirs_df)
        assert got.columns == want.columns == ["features", "label", "prediction"]
        g, w = got.column_values("prediction"), want.column_values("prediction")
        if classes:
            assert g == w
        else:
            np.testing.assert_allclose(np.stack(g), np.stack(w), atol=1e-5, rtol=0)


def test_transformer_json_crosses_both_ways(tmp_path, frames, blobs):
    x, y, d, k = blobs
    keras.utils.set_random_seed(9)
    ref = _sequential(d, k, keras.layers.Dense(16, activation="relu"))
    ours_df, theirs_df = frames
    common = dict(keras_model_config=ref.to_json(), predict_classes=False, batch_size=128)
    ours = et.ElephasTransformer(weights=ref.get_weights(), device="cpu", **common)
    theirs = JaxTransformer(weights=ref.get_weights(), **common)
    ours.save(str(tmp_path / "ours.json"))
    theirs.save(str(tmp_path / "theirs.json"))
    assert sorted(json.load(open(tmp_path / "ours.json"))) == \
        sorted(json.load(open(tmp_path / "theirs.json")))
    by_jax = jax_load_transformer(str(tmp_path / "ours.json"))
    by_port = et.load_ml_transformer(str(tmp_path / "theirs.json"), device="cpu")
    for a, b in zip(by_port.weights, theirs.weights):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = np.stack(theirs.transform(theirs_df).column_values("prediction"))
    for loaded, df in ((by_jax, theirs_df), (by_port, ours_df)):
        np.testing.assert_allclose(np.stack(loaded.transform(df).column_values("prediction")),
                                   want, atol=1e-5, rtol=0)


def test_estimator_fit_reaches_the_reference_bar_and_equals_spark_model_fit(frames, blobs):
    """The blobs at the reference test's bar (accuracy ≥ 0.80), and the
    fitted weights bit-equal to ``SparkModel.fit`` of the module built from
    the same JSON (Keras's initialisers from seed 0) on the same RDD."""
    x, y, d, k = blobs
    ours_df, _ = frames
    est = _estimator(d, k)
    transformer = est.fit(ours_df)
    assert isinstance(transformer, et.ElephasTransformer)
    out = transformer.transform(ours_df)
    acc = np.mean(np.array(out.column_values("prediction")) ==
                  np.array(out.column_values("label")))
    assert acc >= 0.80, acc
    model = est.get_model()
    rdd = adapter.df_to_simple_rdd(ours_df, categorical=True, nb_classes=k)
    et.SparkModel(model, num_workers=W, batch_size=32, device="cpu").fit(
        rdd, epochs=4, batch_size=32)
    for a, b in zip(transformer.weights, model.get_weights()):
        assert np.array_equal(a, b)
    assert transformer.getOrDefault("nb_classes") == k and transformer.getPredictClasses()


def test_pipeline_chains_and_a_fit_without_loss_raises(frames, blobs, tmp_path):
    x, y, d, k = blobs
    ours_df, theirs_df = frames
    fitted = Pipeline(stages=[_estimator(d, k, epochs=1)]).fit(ours_df)
    assert isinstance(fitted, PipelineModel)
    out = fitted.transform(ours_df)
    assert len(out.column_values("prediction")) == ours_df.count()
    # a transformer stage in the middle is applied, not fitted
    keras.utils.set_random_seed(2)
    ref = _sequential(d, k)
    first = et.ElephasTransformer(weights=ref.get_weights(), keras_model_config=ref.to_json(),
                                  output_col="probs", predict_classes=False, device="cpu")
    two = Pipeline(stages=[first, _estimator(d, k, epochs=1)]).fit(ours_df)
    assert two.transform(ours_df).columns == ["features", "label", "probs", "prediction"]
    with pytest.raises(TypeError, match="neither fit nor transform"):
        Pipeline(stages=[object()]).fit(ours_df)
    from elephas_tpu.ml_model import ElephasEstimator as JaxEstimator

    messages = []
    for est, df in ((et.ElephasEstimator(keras_model_config="{}", device="cpu"), ours_df),
                    (JaxEstimator(keras_model_config="{}"), theirs_df)):
        with pytest.raises(ValueError, match="loss") as err:
            est.fit(df)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="keras_model_config"):
        et.ElephasEstimator(loss="mse", device="cpu").fit(ours_df)


def test_estimator_and_weightless_transformer_save_load(tmp_path, frames, blobs):
    x, y, d, k = blobs
    ours_df, _ = frames
    est = _estimator(d, k, epochs=1, custom_objects=None)
    est.save(str(tmp_path / "est.json"))
    loaded = et.load_ml_estimator(str(tmp_path / "est.json"), device="cpu")
    assert loaded.get_config() == est.get_config()
    from elephas_tpu.ml_model import load_ml_estimator as jax_load_estimator

    assert jax_load_estimator(str(tmp_path / "est.json")).get_config() == est.get_config()
    assert loaded.fit(ours_df).weights
    keras.utils.set_random_seed(4)
    ref = keras.Sequential([keras.layers.Input((d,)), keras.layers.Dense(k, activation="softmax")])
    t = et.ElephasTransformer(keras_model_config=ref.to_json(), device="cpu")
    t.save(str(tmp_path / "untrained.json"))
    back = et.load_ml_transformer(str(tmp_path / "untrained.json"), device="cpu")
    assert back.weights is None
    assert sum(w.size for w in back.get_model().get_weights()) == ref.count_params()
    # an RMSprop estimator (no optimizer_config) builds and trains
    rms = _estimator(d, k, epochs=1, optimizer_config=None)
    assert isinstance(rms.get_model().training_spec.optimizer, RMSprop)
