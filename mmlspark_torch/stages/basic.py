"""Generic DataFrame plumbing transformers.

Reference ``stages/`` (SURVEY §2.9): the ~20 utility transformers every
pipeline uses — column selection/renaming, UDFs, lambdas, repartitioning,
caching, timing. The port of ``mmlspark_tpu/stages/basic.py``: the eager
paths and the traced forms (``_trace``, on device tensors inside a fused
segment of ``core/compile.py``) with the reference's ``_trace_ok``
contracts.
"""

from __future__ import annotations

from ..core import (Estimator, Param, StageParam, Transformer,
                    TypeConverters as TC, UDFParam)
from ..core.contracts import HasInputCol, HasInputCols, HasOutputCol
from ..core.dataframe import jittable_dtype, object_column, readable_dtype
from ..core.pipeline import cuda_devices as _cuda_devices


class DropColumns(Transformer):
    cols = Param("cols", "columns to drop", TC.toListString, default=[],
                 has_default=True)

    def _transform(self, df):
        present = [c for c in self.getCols() if c in df.columns]
        return df.drop(*present) if present else df

    def _trace_ok(self, schema, n_rows):
        # a dropped host-carried column would survive the segment
        return all(jittable_dtype(schema[c][0])
                   for c in self.getCols() if c in schema)

    def _trace(self, cols):
        drop = set(self.getCols())
        return {c: v for c, v in cols.items() if c not in drop}


class SelectColumns(Transformer):
    cols = Param("cols", "columns to keep", TC.toListString)

    def _transform(self, df):
        return df.select(*self.getCols())

    def _trace_ok(self, schema, n_rows):
        # selecting implicitly drops the rest — every column must be in
        # the traced dict for the effect to be complete
        return all(jittable_dtype(dt) for dt, _ in schema.values()) \
            and all(c in schema for c in self.getCols())

    def _trace(self, cols):
        return {c: cols[c] for c in self.getCols()}


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    def _transform(self, df):
        return df.with_column_renamed(self.getInputCol(), self.getOutputCol())

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        return ic in schema and jittable_dtype(schema[ic][0])

    def _trace(self, cols):
        old, new = self.getInputCol(), self.getOutputCol()
        return {(new if c == old else c): v for c, v in cols.items()}


class UDFTransformer(Transformer, HasInputCol, HasInputCols, HasOutputCol):
    """Apply a user function to one or more columns (reference
    ``stages/UDFTransformer.scala``). The function receives numpy arrays
    (whole-column, not per-row — columnar by design).

    ``jitSafe=True`` declares the function pure array math with static
    output shapes, letting the pipeline compiler fuse this stage into a
    segment: the udf then receives torch tensors on the segment's device
    (operators and methods numpy and torch share work on both)."""

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

    def _in_cols(self):
        return self.getInputCols() if self.isSet("inputCols") \
            else [self.getInputCol()]

    def _trace_ok(self, schema, n_rows):
        return self.get("jitSafe") and all(
            c in schema and readable_dtype(schema[c][0])
            for c in self._in_cols())

    def _trace(self, cols):
        out = dict(cols)
        out[self.getOutputCol()] = self.get("udf")(
            *[cols[c] for c in self._in_cols()])
        return out


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

    def _trace(self, cols):
        return cols  # partition count is host metadata, not tensor data

    def _post_host(self, df):
        return df if self.getDisable() else df.repartition(self.getN())


class Cacher(Transformer):
    disable = Param("disable", "no-op passthrough", TC.toBoolean,
                    default=False)

    def _transform(self, df):
        return df if self.getDisable() else df.cache()

    def _trace(self, cols):
        return cols  # cache() is a host-side no-op on materialized data


class Explode(Transformer, HasInputCol, HasOutputCol):
    """Explode a list column into one row per element (reference
    ``stages/Explode.scala``).

    Output length is the SUM of per-row list lengths — data-dependent,
    so no static-shape ``_trace`` exists and the pipeline compiler splits
    fused segments around it."""

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

    Measurement runs through the obs
    :class:`~mmlspark_torch.obs.profile.StepProfiler`, as in the JAX
    package, so a timed stage also lands in the ``profile_step_seconds``
    host-dispatch vs device-execute split and emits dispatch/device child
    spans under the ambient trace. ``lastDuration`` is the seconds from the
    call to the wrapped stage's device work being done: after the stage
    returns (``lastDispatch``, the host's share) the profiler waits with
    ``torch.cuda.synchronize`` on every CUDA device the stage and the
    stages inside it run on (``lastDevice``, with ``lastSynced`` True), as
    the JAX package's timer waits with ``block_until_ready``; a host-only
    stage waits for nothing. The numbers go to the telemetry log.
    """

    stage = StageParam("stage", "stage to time")
    logToScala = Param("logToScala", "kept for API parity; logs to telemetry",
                       TC.toBoolean, default=True)

    lastDuration: float | None = None
    lastDispatch: float | None = None
    lastDevice: float | None = None
    lastSynced: bool | None = None

    def _transform(self, df):
        from ..obs.profile import step_profiler
        inner = self.get("stage")
        with step_profiler.step(type(inner).__name__) as h:
            if isinstance(inner, Estimator):
                fitted = inner.fit(df)
                out = fitted.transform(df)
                devices = _cuda_devices(inner) | _cuda_devices(fitted)
            else:
                out = inner.transform(df)
                devices = _cuda_devices(inner)
            h.done(out, devices)
        self.lastDispatch = h.dispatch_seconds
        self.lastDevice = h.device_seconds
        self.lastDuration = h.seconds
        self.lastSynced = h.synced
        self._log_event("timer", stage=type(inner).__name__,
                        seconds=self.lastDuration,
                        dispatch_seconds=self.lastDispatch,
                        device_seconds=self.lastDevice, synced=h.synced)
        return out
