"""Estimator/Transformer/Pipeline — the SparkML-shaped public API surface.

The reference is an ecosystem of SparkML pipeline stages; every component is an
``Estimator`` (``fit(df) -> Model``) or ``Transformer`` (``transform(df) ->
df``) composed into ``Pipeline``s (see SURVEY §1). The port keeps that exact
surface; stages run eagerly, their tensor work in PyTorch on the device each
stage resolves.

``PipelineModel.transform`` carries the JAX package's opt-in per-stage
profiler (``obs.profile.enable_pipeline_profiling`` or
``MMLSPARK_TPU_PROFILE_PIPELINE=1``); the default path is untouched. The
traceable-stage protocol (``Transformer._trace``) is the JAX package's: a
stage's traced form runs on device tensors inside a fused segment of
``core/compile.py`` (``PipelineModel.compile``).
"""

from __future__ import annotations

from typing import Sequence

from ..obs.profile import pipeline_profiler as _pipeline_profiler
from .dataframe import DataFrame
from .param import Params, StageListParam, StageParam
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
    # ------------------------------------------- traceable-stage protocol
    # A stage that can run inside a fused segment (core/compile.py)
    # exposes ``_trace(columns) -> columns``: a function of torch tensors
    # over a dict of numeric columns on the segment's device (strings and
    # ragged cells never enter a segment). The contract, the JAX
    # package's:
    #
    # - no host ops and no synchronisation: no numpy calls, no ``.item()``,
    #   ``.cpu()`` or ``.tolist()`` of a tensor, no I/O, no clock, no
    #   Python control flow on tensor values;
    # - static shapes: output shapes are a function of the input shapes
    #   and the stage's params, never of the values;
    # - ``_trace_ok(schema, n_rows)`` is the static-shape contract check:
    #   given ``{col: (dtype, trailing_shape)}`` and the row count, the
    #   stage says whether THIS configuration can trace;
    # - each output column has the dtype the stage's eager transform
    #   gives it (the JAX package's 32-bit narrowing does not apply).
    #
    # Default = ``_trace`` absent → host-bound: the pipeline compiler runs
    # the stage eagerly and splits the fused segment around it.
    _trace = None

    #: set True by stages whose _trace changes the row count (mini-
    #: batchers, FlattenBatch): they can only fuse when EVERY column is
    #: in the traced dict — a host-carried column could not be re-
    #: attached to a different-length frame.
    _trace_changes_rows = False

    def supports_trace(self, schema: dict, n_rows: int | None = None
                       ) -> bool:
        """Can this stage instance run inside a fused segment for a frame
        with this ``schema`` (``DataFrame.schema``)?"""
        if getattr(type(self), "_trace", None) is None:
            return False
        try:
            return bool(self._trace_ok(schema, n_rows))
        except Exception:
            return False

    def _trace_ok(self, schema: dict, n_rows: int | None) -> bool:
        """Per-stage static-shape contract; override to veto configs."""
        return True

    def _post_host(self, df: DataFrame) -> DataFrame:
        """Host-side metadata hook applied after a fused segment that
        contained this stage (partition counts, column metadata —
        things that live on the DataFrame, not in the tensors)."""
        return df

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
        prof = _pipeline_profiler()
        if prof is None:
            for stage in self.getOrDefault("stages"):
                cur = stage.transform(cur)
            return cur
        # per-stage host-dispatch vs device-execute attribution (opt-in):
        # the synchronize after each stage is the measurement, and it
        # serializes the queued device work, which is why the default
        # path stays untouched
        for stage in self.getOrDefault("stages"):
            with prof.step(type(stage).__name__) as h:
                cur = h.done(stage.transform(cur), cuda_devices(stage))
        return cur

    def compile(self, example_df: DataFrame, *, mesh=None, rules=None,
                donate: bool = True, service: str = "pipeline",
                device=None):
        """Lower this pipeline into a :class:`~.compile.CompiledPipeline`:
        maximal runs of traceable stages fuse into segments that upload
        each numeric column once, run every stage's traced form on
        ``device`` (CUDA unless ``"cpu"`` is asked for) and bring the
        outputs back in one batched copy; host-bound stages run eagerly
        between segments. ``example_df`` drives schema propagation —
        segment grouping needs each stage's OUTPUT schema, so the example
        is transformed once at compile time. ``mesh``/``rules`` raise
        ``NotImplementedError`` (ROADMAP.md §1 item 10)."""
        from .compile import compile_pipeline
        return compile_pipeline(self, example_df, mesh=mesh, rules=rules,
                                donate=donate, service=service,
                                device=device)


def cuda_devices(stage) -> set:
    """The CUDA devices ``stage`` and the stages it holds (stage and
    stage-list params) compute on, by their ``device`` params."""
    found, todo = set(), [stage]
    while todo:
        s = todo.pop()
        for p in type(s).params():
            value = s.get(p)
            if p.name == "device" and value is not None \
                    and str(value).startswith("cuda"):
                found.add(str(value))
            elif isinstance(p, StageParam) and value is not None:
                todo.append(value)
            elif isinstance(p, StageListParam):
                todo.extend(value or [])
    return found


# ---------------------------------------------------------------- fluent API
# Reference core/spark/FluentAPI.scala:12-30 — df.mlTransform(t1, t2),
# df.mlFit(e): chain stages without building a Pipeline.
def ml_transform(df: DataFrame, *stages: Transformer) -> DataFrame:
    return PipelineModel(list(stages)).transform(df)


def ml_fit(df: DataFrame, estimator: Estimator) -> Model:
    return estimator.fit(df)


DataFrame.mlTransform = lambda self, *stages: ml_transform(self, *stages)
DataFrame.mlFit = lambda self, est: ml_fit(self, est)
