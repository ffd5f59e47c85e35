"""Estimator/Transformer/Pipeline — the SparkML-shaped public API surface.

The reference is an ecosystem of SparkML pipeline stages; every component is an
``Estimator`` (``fit(df) -> Model``) or ``Transformer`` (``transform(df) ->
df``) composed into ``Pipeline``s (see SURVEY §1). The port keeps that exact
surface; stages run eagerly, their tensor work in PyTorch on the device each
stage resolves.

The JAX package's fused-segment protocol (``Transformer._trace``) and its
pipeline profiler hook belong to its XLA compile plane; their counterparts
come with the port's compile slice.
"""

from __future__ import annotations

from typing import Sequence

from .dataframe import DataFrame
from .param import Params, StageListParam
from .logging import BasicLogging
from .serialize import SaveLoadMixin, register_stage


class PipelineStage(Params, BasicLogging, SaveLoadMixin):
    """Common base of all stages."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        register_stage(cls)

    def __init__(self, **kwargs):
        Params.__init__(self, **kwargs)
        self.log_class()


class Transformer(PipelineStage):
    def transform(self, df: DataFrame) -> DataFrame:
        with self.log_call("transform"):
            return self._transform(df)

    def _transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Estimator(PipelineStage):
    def fit(self, df: DataFrame) -> "Model":
        with self.log_call("fit"):
            model = self._fit(df)
        model._resolve_parent(self)
        return model

    def _fit(self, df: DataFrame) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted transformer produced by an Estimator."""

    parent: Estimator | None = None

    def _resolve_parent(self, parent: Estimator) -> None:
        self.parent = parent


class Pipeline(Estimator):
    """Sequential composition of stages (SparkML ``Pipeline`` analogue)."""

    stages = StageListParam("stages", "pipeline stages", default=[],
                            has_default=True)

    def _fit(self, df: DataFrame) -> "PipelineModel":
        fitted = []
        cur = df
        stages = self.getOrDefault("stages")
        last_estimator = max(
            (i for i, s in enumerate(stages) if isinstance(s, Estimator)),
            default=-1)
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                model = stage
            else:
                raise TypeError(f"stage {stage!r} is not a pipeline stage")
            # Transforms past the last estimator feed nothing during fit.
            if i < last_estimator:
                cur = model.transform(cur)
        return PipelineModel().setStages(fitted)


class PipelineModel(Model):
    """Fitted pipeline: a chain of transformers."""

    stages = StageListParam("stages", "fitted stages", default=[],
                            has_default=True)

    def __init__(self, stages: Sequence[Transformer] | None = None, **kwargs):
        super().__init__(**kwargs)
        if stages is not None:
            self.setStages(list(stages))

    def _transform(self, df: DataFrame) -> DataFrame:
        cur = df
        for stage in self.getOrDefault("stages"):
            cur = stage.transform(cur)
        return cur


# ---------------------------------------------------------------- fluent API
# Reference core/spark/FluentAPI.scala:12-30 — df.mlTransform(t1, t2),
# df.mlFit(e): chain stages without building a Pipeline.
def ml_transform(df: DataFrame, *stages: Transformer) -> DataFrame:
    return PipelineModel(list(stages)).transform(df)


def ml_fit(df: DataFrame, estimator: Estimator) -> Model:
    return estimator.fit(df)


DataFrame.mlTransform = lambda self, *stages: ml_transform(self, *stages)
DataFrame.mlFit = lambda self, est: ml_fit(self, est)
