"""A minimal ML Pipeline (copy of ``elephas_tpu/ml/pipeline.py``): an
Estimator stage has ``fit(df) -> Transformer``, a Transformer stage
``transform(df) -> df``; ``Pipeline.fit`` folds a DataFrame through the
stages and returns a :class:`PipelineModel` of the fitted transformers."""

from __future__ import annotations


class Pipeline:
    def __init__(self, stages: list):
        self.stages = list(stages)

    def fit(self, df):
        fitted = []
        current = df
        for i, stage in enumerate(self.stages):
            is_last = i == len(self.stages) - 1
            if hasattr(stage, "fit"):
                model = stage.fit(current)
                fitted.append(model)
                if not is_last:  # the last stage's output is never read
                    current = model.transform(current)
            elif hasattr(stage, "transform"):
                fitted.append(stage)
                if not is_last:
                    current = stage.transform(current)
            else:
                raise TypeError(f"stage {stage!r} has neither fit nor transform")
        return PipelineModel(fitted)


class PipelineModel:
    def __init__(self, stages: list):
        self.stages = list(stages)

    def transform(self, df):
        for stage in self.stages:
            df = stage.transform(df)
        return df
