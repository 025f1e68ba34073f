"""String-keyed Param mixins: the Estimator's config surface (copy of
``elephas_tpu/ml/params.py``).

Each setting is a named param with a default, a ``set<Name>`` /
``get<Name>`` pair and dict round-tripping (``get_config`` /
``set_config``), so a config survives serialization: the model
architecture and the optimizer ride as JSON, as in the reference.
"""

from __future__ import annotations

import copy
from typing import Any


class Param:
    def __init__(self, name: str, doc: str = "", default: Any = None):
        self.name = name
        self.doc = doc
        self.default = default

    def __repr__(self):
        return f"Param({self.name!r})"


class Params:
    """Base: instances carry a param map; classes declare ``Param`` attrs."""

    def __init__(self):
        self._paramMap: dict[str, Any] = {}

    # -- declaration discovery ----------------------------------------

    @classmethod
    def params(cls) -> list[Param]:
        out = []
        for klass in cls.__mro__:
            for v in vars(klass).values():
                if isinstance(v, Param):
                    out.append(v)
        return out

    def hasParam(self, name: str) -> bool:
        return any(p.name == name for p in self.params())

    def _param(self, name: str) -> Param:
        for p in self.params():
            if p.name == name:
                return p
        raise KeyError(f"no param {name!r} on {type(self).__name__}")

    # -- get/set -------------------------------------------------------

    def set(self, name: str, value: Any) -> "Params":
        self._param(name)  # validate
        self._paramMap[name] = value
        return self

    def getOrDefault(self, name: str) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        return self._param(name).default

    def setParams(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def get_config(self) -> dict:
        cfg = {p.name: p.default for p in self.params()}
        cfg.update(copy.deepcopy(self._paramMap))
        return cfg

    def set_config(self, config: dict) -> "Params":
        for k, v in config.items():
            if self.hasParam(k):
                self._paramMap[k] = v
        return self


def _mixin(param_name: str, doc: str, default: Any = None, cap: str | None = None):
    """Build a Has<X> mixin class with set/get accessors."""
    cap = cap or param_name[0].upper() + param_name[1:]
    param = Param(param_name, doc, default)

    def setter(self, value):
        self._paramMap[param_name] = value
        return self

    def getter(self):
        return self.getOrDefault(param_name)

    cls = type(
        f"Has{cap}",
        (Params,),
        {
            param_name: param,
            f"set{cap}": setter,
            f"get{cap}": getter,
            "__doc__": doc,
        },
    )
    return cls


HasKerasModelConfig = _mixin(
    "keras_model_config",
    "Keras model architecture as a JSON string (model.to_json()).",
)
HasOptimizerConfig = _mixin(
    "optimizer_config",
    "Keras optimizer config dict/JSON (keras.optimizers.serialize).",
)
HasMode = _mixin(
    "mode", "Training mode: synchronous | asynchronous | hogwild.", "synchronous"
)
HasFrequency = _mixin(
    "frequency", "Weight sync frequency: epoch | batch | fit.", "epoch"
)
HasNumberOfWorkers = _mixin(
    "num_workers", "Mesh workers (devices); None = all.", None, cap="NumberOfWorkers"
)
HasModelParallel = _mixin(
    "model_parallel",
    "Model-axis size of the ('data','model') mesh; 1 = data-parallel only.",
    1,
    cap="ModelParallel",
)
HasPipelineParallel = _mixin(
    "pipeline_parallel",
    "Pipeline stages (keras.Sequential depth sharding); 1 = off.",
    1,
    cap="PipelineParallel",
)
HasSequenceParallel = _mixin(
    "sequence_parallel",
    "Seq-axis size of the ('data','seq') mesh (ring attention); 1 = off.",
    1,
    cap="SequenceParallel",
)
HasSequenceAttention = _mixin(
    "sequence_attention",
    "SP attention mechanism: 'ring' (ppermute KV) | 'ulysses' (all-to-all).",
    "ring",
    cap="SequenceAttention",
)
HasEpochs = _mixin("epochs", "Training epochs.", 10)
HasBatchSize = _mixin("batch_size", "Per-worker batch size.", 32, cap="BatchSize")
HasVerbosity = _mixin("verbose", "Verbosity 0/1/2.", 0, cap="Verbosity")
HasValidationSplit = _mixin(
    "validation_split", "Held-out tail fraction.", 0.0, cap="ValidationSplit"
)
HasLoss = _mixin("loss", "Keras loss identifier.", None)
HasMetrics = _mixin("metrics", "List of Keras metric identifiers.", None)
HasNumberOfClasses = _mixin(
    "nb_classes", "Number of label classes.", None, cap="NumberOfClasses"
)
HasCategoricalLabels = _mixin(
    "categorical_labels",
    "Whether labels are one-hot encoded.",
    False,
    cap="CategoricalLabels",
)
HasFeaturesCol = _mixin("features_col", "Features column name.", "features", cap="FeaturesCol")
HasLabelCol = _mixin("label_col", "Label column name.", "label", cap="LabelCol")
HasOutputCol = _mixin("output_col", "Prediction output column name.", "prediction", cap="OutputCol")
HasCustomObjects = _mixin(
    "custom_objects", "Custom Keras objects for deserialization.", None, cap="CustomObjects"
)
HasParameterServerMode = _mixin(
    "parameter_server_mode",
    "Weight-store transport: http | socket | None.",
    None,
    cap="ParameterServerMode",
)
HasPredictClasses = _mixin(
    "predict_classes",
    "Emit argmax class indices instead of raw probabilities.",
    False,
    cap="PredictClasses",
)
