"""Generic DataFrame plumbing transformers.

Reference ``stages/`` (SURVEY §2.9): the ~20 utility transformers every
pipeline uses — column selection/renaming, UDFs, lambdas, repartitioning,
caching, timing. The port of ``mmlspark_tpu/stages/basic.py``'s eager
paths; its fused-segment forms (``_trace``) belong to the compile slice.
"""

from __future__ import annotations

import time

from ..core import (Estimator, Param, StageListParam, StageParam,
                    Transformer, TypeConverters as TC, UDFParam)
from ..core.contracts import HasInputCol, HasInputCols, HasOutputCol
from ..core.dataframe import object_column


class DropColumns(Transformer):
    cols = Param("cols", "columns to drop", TC.toListString, default=[],
                 has_default=True)

    def _transform(self, df):
        present = [c for c in self.getCols() if c in df.columns]
        return df.drop(*present) if present else df


class SelectColumns(Transformer):
    cols = Param("cols", "columns to keep", TC.toListString)

    def _transform(self, df):
        return df.select(*self.getCols())


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    def _transform(self, df):
        return df.with_column_renamed(self.getInputCol(), self.getOutputCol())


class UDFTransformer(Transformer, HasInputCol, HasInputCols, HasOutputCol):
    """Apply a user function to one or more columns (reference
    ``stages/UDFTransformer.scala``). The function receives numpy arrays
    (whole-column, not per-row — columnar by design).

    ``jitSafe`` is the JAX package's fusion flag (the udf is pure array
    math with static shapes); the port runs every stage eagerly and keeps
    it for the shared Param surface and save format."""

    udf = UDFParam("udf", "function(column_array...) -> column_array")
    jitSafe = Param("jitSafe",
                    "udf is pure jax.numpy with static shapes (enables "
                    "whole-pipeline fusion)", TC.toBoolean, default=False,
                    has_default=True)

    def _transform(self, df):
        fn = self.get("udf")
        if self.isSet("inputCols"):
            args = [df[c] for c in self.getInputCols()]
        else:
            args = [df[self.getInputCol()]]
        return df.with_column(self.getOutputCol(), fn(*args))


class Lambda(Transformer):
    """Arbitrary DataFrame → DataFrame function (reference
    ``stages/Lambda.scala``)."""

    transformFunc = UDFParam("transformFunc", "df -> df function")

    def _transform(self, df):
        return self.get("transformFunc")(df)


class MultiColumnAdapter(Transformer, HasInputCols):
    """Apply a single-column stage across many columns (reference
    ``stages/MultiColumnAdapter.scala``)."""

    baseStage = StageParam("baseStage", "single-column stage to replicate")
    outputCols = Param("outputCols", "output column names", TC.toListString)

    def _transform(self, df):
        base = self.get("baseStage")
        cur = df
        for in_col, out_col in zip(self.getInputCols(), self.getOutputCols()):
            stage = base.copy({"inputCol": in_col, "outputCol": out_col})
            cur = stage.transform(cur)
        return cur


class Repartition(Transformer):
    n = Param("n", "target partition count", TC.toInt)
    disable = Param("disable", "no-op passthrough", TC.toBoolean,
                    default=False)

    def _transform(self, df):
        if self.getDisable():
            return df
        return df.repartition(self.getN())


class Cacher(Transformer):
    disable = Param("disable", "no-op passthrough", TC.toBoolean,
                    default=False)

    def _transform(self, df):
        return df if self.getDisable() else df.cache()


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Explode a list column into one row per element (reference
    ``stages/Explode.scala``).

    Output length is the SUM of per-row list lengths — data-dependent,
    host work by nature."""

    def _transform(self, df):
        col = df[self.getInputCol()]
        idx: list[int] = []
        exploded: list = []
        for i, v in enumerate(col):
            for item in v:
                idx.append(i)
                exploded.append(item)
        out = df.take(idx)
        return out.with_column(self.getOutputCol(),
                               object_column(exploded))


class Timer(Transformer):
    """Wrap a stage and log its wall time (reference ``stages/Timer.scala``).

    ``lastDuration`` is the seconds from the call to the wrapped stage's
    device work being done: after the stage returns (``lastDispatch``, the
    host's share) the timer waits with ``torch.cuda.synchronize`` on every
    CUDA device the stage and the stages inside it run on, as the JAX
    package's timer waits with ``block_until_ready``; a host-only stage
    waits for nothing. Both numbers go to the telemetry log.
    """

    stage = StageParam("stage", "stage to time")
    logToScala = Param("logToScala", "kept for API parity; logs to telemetry",
                       TC.toBoolean, default=True)

    lastDuration: float | None = None
    lastDispatch: float | None = None

    def _transform(self, df):
        inner = self.get("stage")
        t0 = time.perf_counter()
        if isinstance(inner, Estimator):
            fitted = inner.fit(df)
            out = fitted.transform(df)
            devices = _cuda_devices(inner) | _cuda_devices(fitted)
        else:
            out = inner.transform(df)
            devices = _cuda_devices(inner)
        self.lastDispatch = time.perf_counter() - t0
        if devices:
            import torch
            for dev in devices:
                torch.cuda.synchronize(dev)
        self.lastDuration = time.perf_counter() - t0
        self._log_event("timer", stage=type(inner).__name__,
                        seconds=self.lastDuration,
                        dispatch_seconds=self.lastDispatch)
        return out


def _cuda_devices(stage) -> set:
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
