"""``ElephasEstimator`` / ``ElephasTransformer``: the ML-pipeline API
(counterpart of ``elephas_tpu/ml_model.py``).

- :class:`ElephasEstimator` (the ``Has*`` params of
  :mod:`elephas_tpu_torch.ml.params`): ``fit(df)`` turns the DataFrame
  into a simple RDD, builds the module from the ``keras_model_config``
  JSON (:func:`elephas_tpu_torch.models.keras_config.model_from_json`),
  compiles it with the ``optimizer_config`` (Keras's ``RMSprop`` when
  empty), ``loss`` and ``metrics`` params, trains it with the port's
  :class:`~elephas_tpu_torch.SparkModel` in the configured mode,
  frequency and workers, and returns a fitted :class:`ElephasTransformer`
  holding the trained weights in Keras's ``get_weights()`` order.
- :class:`ElephasTransformer`: ``transform(df)`` predicts over the
  features column and adds the output column (class indices with
  ``predict_classes``, else probability arrays).
- :func:`load_ml_estimator` / :func:`load_ml_transformer` reload what
  ``save`` wrote: the reference's payload keys (``estimator_config``;
  ``transformer_config``, ``weights``, ``weight_dtypes``), so a saved
  stage crosses between the two packages both ways.

Both stages run on ``device`` (``cuda:0`` unless the caller names
another); the device is not a param and is not saved.
"""

from __future__ import annotations

import json

import numpy as np

from elephas_tpu_torch.data.dataframe import DataFrame, vectorize_column
from elephas_tpu_torch.ml.adapter import df_to_simple_rdd
from elephas_tpu_torch.ml.params import (
    HasBatchSize,
    HasCategoricalLabels,
    HasCustomObjects,
    HasEpochs,
    HasFeaturesCol,
    HasFrequency,
    HasKerasModelConfig,
    HasLabelCol,
    HasLoss,
    HasMetrics,
    HasMode,
    HasModelParallel,
    HasNumberOfClasses,
    HasNumberOfWorkers,
    HasOptimizerConfig,
    HasOutputCol,
    HasParameterServerMode,
    HasPipelineParallel,
    HasPredictClasses,
    HasSequenceAttention,
    HasSequenceParallel,
    HasValidationSplit,
    HasVerbosity,
)
from elephas_tpu_torch.models.keras_config import model_from_json
from elephas_tpu_torch.optimizers import SGD, RMSprop, deserialize
from elephas_tpu_torch.training import compile_model


class _ElephasParams(
    HasKerasModelConfig,
    HasOptimizerConfig,
    HasMode,
    HasFrequency,
    HasNumberOfWorkers,
    HasModelParallel,
    HasPipelineParallel,
    HasSequenceParallel,
    HasSequenceAttention,
    HasEpochs,
    HasBatchSize,
    HasVerbosity,
    HasValidationSplit,
    HasLoss,
    HasMetrics,
    HasNumberOfClasses,
    HasCategoricalLabels,
    HasFeaturesCol,
    HasLabelCol,
    HasOutputCol,
    HasCustomObjects,
    HasParameterServerMode,
    HasPredictClasses,
):
    pass


def _build_model(config: dict, device=None):
    """``keras_model_config`` and the optimizer, loss and metrics params →
    the compiled module, on ``device``. Its weights are Keras's default
    initialisers from seed 0, so two builds of one config start equal."""
    model_json = config.get("keras_model_config")
    if not model_json:
        raise ValueError("keras_model_config param is required")
    loss = config.get("loss")
    if not loss:
        raise ValueError("loss param is required")
    model = model_from_json(model_json, custom_objects=config.get("custom_objects"),
                            device=device)
    opt_config = config.get("optimizer_config")
    optimizer = (deserialize(opt_config, model.parameters()) if opt_config
                 else RMSprop(model.parameters()))
    return compile_model(model, optimizer, loss, config.get("metrics") or ())


class ElephasEstimator(_ElephasParams):
    """Trains a model described by its Keras JSON from DataFrame input."""

    def __init__(self, device=None, **kwargs):
        super().__init__()
        self.device = device
        self.setParams(**kwargs)

    def fit(self, df: DataFrame) -> "ElephasTransformer":
        from elephas_tpu_torch.spark_model import SparkModel

        config = self.get_config()
        model = _build_model(config, self.device)
        rdd = df_to_simple_rdd(df, categorical=config["categorical_labels"],
                               nb_classes=config["nb_classes"],
                               features_col=config["features_col"],
                               label_col=config["label_col"])
        spark_model = SparkModel(
            model, mode=config["mode"], frequency=config["frequency"],
            parameter_server_mode=config["parameter_server_mode"],
            num_workers=config["num_workers"], custom_objects=config["custom_objects"],
            batch_size=config["batch_size"], model_parallel=config["model_parallel"],
            pipeline_parallel=config["pipeline_parallel"],
            sequence_parallel=config["sequence_parallel"],
            sequence_attention=config["sequence_attention"], device=self.device)
        spark_model.fit(rdd, epochs=config["epochs"], batch_size=config["batch_size"],
                        verbose=config["verbose"], validation_split=config["validation_split"])
        transformer = ElephasTransformer(
            weights=spark_model.master_network.get_weights(), device=self.device,
            keras_model_config=config["keras_model_config"],
            custom_objects=config["custom_objects"])
        transformer.set_config({k: config[k] for k in (
            "features_col", "label_col", "output_col", "batch_size", "num_workers",
            "predict_classes", "categorical_labels", "nb_classes")})
        return transformer

    def save(self, file_name: str) -> None:
        """Write the string-keyed config as JSON. ``custom_objects`` are
        live objects: dropped here, given again to
        :func:`load_ml_estimator`."""
        config = self.get_config()
        config.pop("custom_objects", None)
        with open(file_name, "w") as f:
            json.dump({"estimator_config": config}, f)

    def get_model(self):
        return _build_model(self.get_config(), self.device)


class ElephasTransformer(_ElephasParams):
    """Applies a trained model to a DataFrame."""

    def __init__(self, weights=None, device=None, **kwargs):
        super().__init__()
        self.device = device
        self.setParams(**kwargs)
        self.weights = [np.asarray(w) for w in weights] if weights is not None else None

    def get_model(self):
        """The module of ``keras_model_config`` holding :attr:`weights`
        (Keras's initialisers when there are none)."""
        model = model_from_json(self.getOrDefault("keras_model_config"),
                                custom_objects=self.getOrDefault("custom_objects"),
                                device=self.device)
        if self.weights is not None:
            model.set_weights(self.weights)
        return model

    def transform(self, df: DataFrame) -> DataFrame:
        from elephas_tpu_torch.spark_model import SparkModel

        model = self.get_model()
        # SparkModel takes a compiled module; the compile does not touch
        # the forward
        compile_model(model, SGD(model.parameters()), "mean_squared_error")
        spark_model = SparkModel(model, num_workers=self.getOrDefault("num_workers"),
                                 batch_size=self.getBatchSize(), device=self.device)
        features = vectorize_column(df.column_values(self.getFeaturesCol()))
        preds = spark_model.predict(features, self.getBatchSize())
        if self.getPredictClasses():
            values = [int(np.argmax(p)) for p in preds]
        else:
            values = [np.asarray(p) for p in preds]
        return df.withColumn(self.getOutputCol(), values)

    def save(self, file_name: str) -> None:
        """Write the config and the weights as JSON (``custom_objects``
        dropped, as in :meth:`ElephasEstimator.save`); ``weights=None``
        stays None."""
        config = self.get_config()
        config.pop("custom_objects", None)
        payload = {
            "transformer_config": config,
            "weights": None if self.weights is None else [w.tolist() for w in self.weights],
            "weight_dtypes": None if self.weights is None
            else [str(w.dtype) for w in self.weights],
        }
        with open(file_name, "w") as f:
            json.dump(payload, f)


def load_ml_estimator(file_name: str, custom_objects: dict | None = None,
                      device=None) -> ElephasEstimator:
    with open(file_name) as f:
        payload = json.load(f)
    est = ElephasEstimator(device=device)
    est.set_config(payload["estimator_config"])
    if custom_objects is not None:
        est.setCustomObjects(custom_objects)
    return est


def load_ml_transformer(file_name: str, custom_objects: dict | None = None,
                        device=None) -> ElephasTransformer:
    with open(file_name) as f:
        payload = json.load(f)
    weights = None if payload["weights"] is None else [
        np.asarray(w, dtype=d) for w, d in zip(payload["weights"], payload["weight_dtypes"])]
    t = ElephasTransformer(weights=weights, device=device)
    t.set_config(payload["transformer_config"])
    if custom_objects is not None:
        t.setCustomObjects(custom_objects)
    return t
