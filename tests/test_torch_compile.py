"""The port's pipeline compiler (``mmlspark_torch/core/compile.py`` and the
stages' traced forms) against the JAX package's, on the CPU.

Every scenario of ``test_pipeline_compile.py`` that needs no traceability
report (the JAX package's, item 11) runs against the port (the serving
DSL's fused path included) (``torch_obs_port`` with ``mmlspark_tpu.core``
and ``mmlspark_tpu.featurize`` pointed at the port too), on the same
inputs and with the same assertions. Those scenarios build their stages
at their default device; the fixture ``cpu_default`` points the port's
``resolve_device`` at the CPU while they run (the entry points' own
CUDA default is held in ``TestDevice`` and ``test_torch_isolation.py``).

Then both packages run the reference's 20 stage cases on the same seeded
frames: the port's fused output equals its eager output and the JAX
package's compiled output, and the ``describe()`` plans are equal, on
those cases and on mixed host/numeric pipelines. Held: integers, bools and
the bookkeeping exactly, dtypes exactly, floats within 1e-6 relative.
The JAX package runs with 64-bit types off, so its fused segments narrow
int64/float64 columns to 32 bits where its eager transform keeps them;
the port keeps every column's eager dtype, so at each narrowing
(``NARROWED``, checked to be exactly where the JAX package narrows) the
port's fused output is held to the JAX package's EAGER output.
"""

import contextlib

import numpy as np
import pytest
import torch

import mmlspark_torch.device as tdevice
# modules that bind ``resolve_device`` at import: imported here, before
# ``cpu_default`` ever runs, so they keep the real one
import mmlspark_torch.dl  # noqa: F401
import mmlspark_torch.lightgbm  # noqa: F401
import mmlspark_torch.serving  # noqa: F401
import test_pipeline_compile as jref
from mmlspark_tpu.core import compile_pipeline as jcompile
from mmlspark_torch.core import DataFrame, PipelineModel, compile_pipeline
from mmlspark_torch.core.compile import (FusedSegment, download,
                                         is_device_error, upload)
from mmlspark_torch.core.dataframe import object_column
from mmlspark_torch.native.loader import KernelBuildError
from mmlspark_torch.obs.metrics import registry
from torch_obs_port import port_reference_tests

FLOAT_RTOL = 1e-6
_resolve = tdevice.resolve_device


def _cpu_resolve(device=None):
    if device is None or torch.device(device).type == "cuda":
        return torch.device("cpu")
    return _resolve(device)


@contextlib.contextmanager
def cpu_default():
    """The port's default device pointed at the CPU (stages resolve
    their ``device`` Param, and compile its ``device=``, through
    ``mmlspark_torch.device.resolve_device`` at call time)."""
    tdevice.resolve_device = _cpu_resolve
    try:
        yield
    finally:
        tdevice.resolve_device = _resolve


@pytest.fixture(autouse=True)
def _cpu_default_fixture():
    with cpu_default():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


with cpu_default():
    globals().update(port_reference_tests("test_pipeline_compile.py", (
        # jax arrays into _trace: the port's version (tensors) is below
        "TestFusedEagerEquivalence.test_trace_matches_transform",
        # numpy into _trace: the port's version (a tensor) is below
        "TestFitExactness.test_class_balancer_trace_unseen_label_is_nan",
        # the JAX package's traceability report (item 11)
        "TestTraceableRatchet"), rewrites=(
        # TestServingFusedPath serves through the port's DSL
        ("mmlspark_tpu.serving", "mmlspark_torch.serving"),
        ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
        ("mmlspark_tpu.core", "mmlspark_torch.core"),
        ("mmlspark_tpu.featurize", "mmlspark_torch.featurize"))))
    PORT_CASES = {name: (stage, df) for name, stage, df in _stage_cases()}
JAX_CASES = {name: (stage, df) for name, stage, df in jref._stage_cases()}
CASE_NAMES = sorted(PORT_CASES)


def _dense(col):
    """Eager object-cell columns (mini-batchers) → one stacked array in
    the cells' own dtype."""
    if col.dtype == object:
        return np.stack([np.asarray(v) for v in col])
    return np.asarray(col)


def hold(got, want, what):
    """``got`` equals ``want``: dtype and shape exactly, integers and
    bools exactly, floats within 1e-6 relative (NaN where NaN)."""
    got, want = _dense(got), _dense(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# FlattenBatch's eager transform leaves a numeric 2-D column as it is,
# its traced form merges the two leading axes (the reference's semantics;
# its own scenario compares the two flattened)
ROW_LAYOUT = {"FlattenBatch"}


class TestTracedForms:
    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_trace_matches_transform(self, name):
        """The reference scenario on tensors: each stage's traced form
        on the frame's columns equals its eager transform."""
        stage, df = PORT_CASES[name]
        assert stage.supports_trace(df.schema, df.num_rows), \
            f"{name} must accept this schema"
        cols = {c: torch.as_tensor(df[c]) for c in df.columns}
        traced = stage._trace(dict(cols))
        eager = stage._transform(df)
        for c in traced:
            if c in eager.columns:
                np.testing.assert_allclose(
                    jref._as_dense(eager[c]).reshape(-1),
                    np.asarray(traced[c], np.float32).reshape(-1),
                    atol=1e-6, err_msg=f"{name} column {c!r}")

    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_traced_forms_never_synchronise(self, name):
        """A traced form must not read a value back: on meta tensors
        (shapes without data) ``.item()``, ``.cpu()``, ``.tolist()`` and
        data-dependent shapes (``nonzero``, boolean masks) raise. The
        card's own check is ``chip_smoke.py`` phase 35
        (``torch.cuda.set_sync_debug_mode("error")``)."""
        stage, df = PORT_CASES[name]
        cols = {c: torch.as_tensor(df[c]) for c in df.columns}
        out = stage._trace({c: v.to("meta") for c, v in cols.items()})
        ref = stage._trace(cols)
        assert sorted(out) == sorted(ref)
        for c, v in out.items():
            assert v.device.type == "meta", (name, c)
            assert (v.shape, v.dtype) == (ref[c].shape, ref[c].dtype)


# the columns where the JAX package's fused segment narrows to 32 bits
# while its eager transform keeps 64: the int64 column ``c`` of
# ``num_df`` (or ``i`` of the index frame) passing through a segment, the
# float64 values of IndexToValue and the float64 weights of
# ClassBalancerModel
NARROWED = {(name, "c") for name in (
    "Cacher", "ClassBalancerModel", "CleanMissingDataModel",
    "CountSelectorModel", "DropColumns", "DynamicMiniBatchTransformer",
    "FeaturizeModel", "FixedMiniBatchTransformer", "PartitionConsolidator",
    "RenameColumn", "Repartition", "SelectColumns",
    "TimeIntervalMiniBatchTransformer", "UDFTransformer",
    "ValueIndexerModel", "VectorAssembler")} | {
    ("IndexToValue", "i"), ("IndexToValue", "v"),
    ("OneHotEncoderModel", "i"), ("ClassBalancerModel", "w")}


class TestAgainstJax:
    @pytest.fixture(scope="class")
    def outputs(self):
        out = {}
        with cpu_default():
            for name in CASE_NAMES:
                pstage, pdf = PORT_CASES[name]
                jstage, jdf = JAX_CASES[name]
                pcp = compile_pipeline([pstage], pdf)
                jcp = jcompile([jstage], jdf)
                out[name] = {
                    "port_fused": pcp.transform(pdf),
                    "port_eager": pstage.transform(pdf),
                    "jax_fused": jcp.transform(jdf),
                    "jax_eager": jstage.transform(jdf),
                    "plans": (pcp.describe(), jcp.describe())}
        return out

    def test_narrowed_is_exactly_where_jax_narrows(self, outputs):
        found = set()
        for name, o in outputs.items():
            for c in o["jax_fused"].columns:
                if _dense(o["jax_fused"][c]).dtype != \
                        _dense(o["jax_eager"][c]).dtype:
                    found.add((name, c))
        assert found == NARROWED

    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_fused_equals_eager_and_jax(self, outputs, name):
        o = outputs[name]
        fused, eager = o["port_fused"], o["port_eager"]
        assert fused.columns == o["jax_fused"].columns
        assert fused.num_partitions == o["jax_fused"].num_partitions
        for c in fused.columns:
            # the port's fused against its own eager (mini-batchers:
            # numeric batches against the eager object cells)
            if name in ROW_LAYOUT:
                hold(fused[c].reshape(-1), _dense(eager[c]).reshape(-1),
                     f"{name}.{c} fused/eager")
            else:
                hold(fused[c], eager[c], f"{name}.{c} fused/eager")
            want = o["jax_eager"] if (name, c) in NARROWED \
                else o["jax_fused"]
            hold(fused[c], want[c], f"{name}.{c} against JAX")

    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_plans_equal(self, outputs, name):
        port, jax = outputs[name]["plans"]
        assert port == jax

    def test_featurize_slot_names_reattached(self, outputs):
        from mmlspark_torch.core import ColumnMetadata
        from mmlspark_tpu.core import ColumnMetadata as JColumnMetadata
        o = outputs["FeaturizeModel"]
        assert ColumnMetadata.get(o["port_fused"], "f") == \
            JColumnMetadata.get(o["jax_fused"], "f")


def _mixed_pipelines(pkg):
    """Three host/numeric pipelines, built alike in either package
    (``pkg`` is ``mmlspark_tpu`` or ``mmlspark_torch``; the port's fits
    run on the CPU): jit stages around a host tokenizer stage; the
    featurize chain with a string column (its one-hot is host work);
    a string ValueIndexer feeding a fused one-hot."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    dfm = importlib.import_module(f"{pkg}.core.dataframe")
    fz = importlib.import_module(f"{pkg}.featurize")
    st = importlib.import_module(f"{pkg}.stages")
    vec = importlib.import_module(f"{pkg}.featurize.vector")
    rng = np.random.default_rng(11)
    n = 12
    x = rng.normal(size=(n, 2)).astype(np.float32)
    x[::4, 0] = np.nan
    df = core.DataFrame({
        "t": dfm.object_column([f"W{i % 3}" for i in range(n)]),
        "v": rng.normal(size=n).astype(np.float32),
        "x0": x[:, 0], "x1": x[:, 1],
        "k": (np.arange(n) % 4).astype(np.int64)})
    jit1 = st.UDFTransformer(inputCol="v", outputCol="d1", jitSafe=True,
                             udf=lambda v: v * 2.0)
    jit2 = st.UDFTransformer(inputCol="v", outputCol="d2", jitSafe=True,
                             udf=lambda v: v + 1.0)
    host = st.TextPreprocessor(inputCol="t", outputCol="t2",
                               normFunc="lower")
    clean = fz.CleanMissingData(inputCols=["x0", "x1"]).fit(df)
    feat = fz.Featurize(inputCols=["x0", "x1", "t"], outputCol="f").fit(
        clean.transform(df))
    vi = fz.ValueIndexer(inputCol="t", outputCol="ti").fit(df)
    return df, {
        "host_between": [jit1, host, jit2],
        "featurize_strings": [clean, feat, jit1,
                              st.DropColumns(cols=["k"])],
        "indexer_onehot": [vi, vec.OneHotEncoderModel(
            inputCol="ti", outputCol="oh", categorySize=3,
            handleInvalid="keep"), jit2, st.SelectColumns(
            cols=["oh", "d2", "k"])],
    }


class TestMixedPipelines:
    @pytest.mark.parametrize("which", ["host_between", "featurize_strings",
                                       "indexer_onehot"])
    def test_plans_and_outputs_equal(self, which):
        jdf, jpipes = _mixed_pipelines("mmlspark_tpu")
        pdf, ppipes = _mixed_pipelines("mmlspark_torch")
        jcp = jcompile(jpipes[which], jdf)
        pcp = compile_pipeline(ppipes[which], pdf)
        assert pcp.describe() == jcp.describe()
        assert pcp.compiled_segments >= 1 and pcp.eager_stages >= 1
        got = pcp.transform(pdf)
        eager = PipelineModel(ppipes[which]).transform(pdf)
        jeager = PipelineModel_j(jpipes[which]).transform(jdf)
        assert got.columns == eager.columns == jeager.columns
        for c in got.columns:
            hold(got[c], eager[c], f"{which}.{c} fused/eager")
            if got[c].dtype == object:
                assert list(got[c]) == list(jeager[c])
            else:
                hold(got[c], jeager[c], f"{which}.{c} against JAX eager")


def PipelineModel_j(stages):
    from mmlspark_tpu.core import PipelineModel as JPipelineModel
    return JPipelineModel(stages)


class TestFitExactnessTensors:
    def test_class_balancer_trace_unseen_label_is_nan(self):
        """The reference scenario on a tensor: seen labels keep their
        exact weights, an unseen label gets NaN."""
        from mmlspark_torch.stages import ClassBalancer
        df = DataFrame({"y": np.asarray([0.0, 0.0, 1.0], np.float32)})
        m = ClassBalancer(inputCol="y").fit(df)
        out = m._trace({"y": torch.as_tensor(
            np.asarray([0.0, 1.0, 2.0], np.float32))})
        w = np.asarray(out["weight"])
        assert w.dtype == np.float64     # the eager lookup's Python floats
        assert w[0] == 1.0 and w[1] == 2.0 and np.isnan(w[2])


class TestUnsignedColumns:
    def test_unsigned_carried_exactly_and_read_eagerly(self):
        """uint16, uint32 and uint64 columns pass through a segment with
        their values and dtype (uint64 at and above 2**63 too), and a
        stage that would read one stays eager."""
        from mmlspark_torch.featurize import CleanMissingData
        from mmlspark_torch.stages import DropColumns
        big = np.asarray([0, 2 ** 63, 2 ** 64 - 1, 5], np.uint64)
        df = DataFrame({"u16": np.asarray([1, 65535, 7, 0], np.uint16),
                        "u32": np.asarray([0, 2 ** 32 - 1, 2 ** 31, 9],
                                          np.uint32),
                        "u64": big, "f": np.asarray([1, np.nan, 2, 3],
                                                    np.float32),
                        "drop": np.zeros(4, np.float32)})
        clean = CleanMissingData(inputCols=["f"]).fit(df)
        cp = compile_pipeline([clean, DropColumns(cols=["drop"])], df)
        assert cp.describe()[0]["kind"] == "fused"
        got = cp.transform(df)
        want = DropColumns(cols=["drop"]).transform(clean.transform(df))
        assert got.columns == want.columns
        for c in got.columns:
            hold(got[c], want[c], c)
        for c in ("u16", "u32", "u64"):
            assert not CleanMissingData(inputCols=[c]).fit(df) \
                .supports_trace(df.schema, 4), c
        # views of an unsigned upload go back to the host dtype
        for c in ("u16", "u64"):
            dev, origin = upload({c: df[c]}, torch.device("cpu"))
            back = download({c: dev[c][None]}, origin, torch.device("cpu"))
            hold(back[c], df[c][None], f"{c} view")

    @pytest.mark.parametrize("to", ["integer", "long", "double"])
    def test_conversion_of_unsigned_matches_eager(self, to):
        """A cast of a uint16 column to a type torch carries it as must
        not hand back the uint16 host array: the compiled pipeline gives
        the eager dtype and values."""
        from mmlspark_torch.featurize import DataConversion
        from mmlspark_torch.stages import DropColumns, UDFTransformer
        df = DataFrame({"u16": np.asarray([1, 65535, 7, 0], np.uint16),
                        "drop": np.zeros(4, np.float32)})
        stages = [DataConversion(inputCols=["u16"], convertTo=to),
                  DropColumns(cols=["drop"])]
        cp = compile_pipeline(stages, df)
        want = PipelineModel(stages).transform(df)
        got = cp.transform(df)
        assert got.columns == want.columns
        for c in got.columns:
            hold(got[c], want[c], c)
        assert np.asarray(got["u16"]).dtype != np.uint16
        udf = UDFTransformer(inputCol="u16", outputCol="u16",
                             udf=lambda x: x.to(torch.int32)
                             if isinstance(x, torch.Tensor)
                             else x.astype(np.int32), jitSafe=True)
        assert not udf.supports_trace(df.schema, 4)
        got = compile_pipeline([udf], df).transform(df)
        want = udf.transform(df)
        hold(got["u16"], want["u16"], "udf")


class TestDevice:
    def test_default_device_is_cuda_and_raises_without_gpu(
            self, monkeypatch):
        from mmlspark_torch.stages import DropColumns
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        df = DataFrame({"v": np.arange(4, dtype=np.float32)})
        tdevice.resolve_device = _resolve       # the real default here
        try:
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                compile_pipeline([DropColumns(cols=["v"])], df)
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                PipelineModel([DropColumns(cols=["v"])]).compile(df)
        finally:
            tdevice.resolve_device = _cpu_resolve
        cp = PipelineModel([DropColumns(cols=["v"])]).compile(
            df, device="cpu")
        assert cp.plan[0].device == torch.device("cpu")
        assert cp.transform(df).columns == []

    def test_mesh_and_rules_raise_naming_item_10(self):
        from mmlspark_torch.stages import DropColumns
        df = DataFrame({"v": np.arange(4, dtype=np.float32)})
        for kw in ({"mesh": object()}, {"rules": [("v", None)]}):
            with pytest.raises(NotImplementedError, match="item 10"):
                compile_pipeline([DropColumns(cols=["v"])], df, **kw)
            with pytest.raises(NotImplementedError, match="item 10"):
                FusedSegment([DropColumns(cols=["v"])], "s", device="cpu",
                             **kw)

    def test_run_sharded_without_mesh_runs_on_device_tensors(self):
        from mmlspark_torch.stages import UDFTransformer
        df = DataFrame({"v": np.arange(4, dtype=np.float32)})
        cp = compile_pipeline([UDFTransformer(
            inputCol="v", outputCol="o", jitSafe=True,
            udf=lambda v: v * 3)], df, service="sharded")
        t = torch.arange(4, dtype=torch.float32)
        out = cp.plan[0].run_sharded({"v": t})
        assert isinstance(out["o"], torch.Tensor)
        assert out["o"].tolist() == [0.0, 3.0, 6.0, 9.0]
        assert out["v"] is t


class TestDeviceErrorsRaise:
    """A CUDA error or a failed kernel build inside a segment is raised,
    never absorbed into the eager fallback."""

    def _armed(self, exc):
        from mmlspark_torch.stages import UDFTransformer
        armed = {"on": False}

        def udf(v):
            if armed["on"]:
                raise exc
            return v + 1
        df = DataFrame({"v": np.arange(4, dtype=np.float32)})
        cp = compile_pipeline([UDFTransformer(
            inputCol="v", outputCol="o", jitSafe=True, udf=udf)], df,
            service="device-error")
        armed["on"] = True
        return cp, df

    @pytest.mark.parametrize("exc", [
        RuntimeError("CUDA error: an illegal memory access was "
                     "encountered"),
        KernelBuildError("nvcc failed building mmlspark_hist"),
        ValueError("wrapped")], ids=["cuda", "build", "wrapped"])
    def test_raised_not_absorbed(self, exc):
        if isinstance(exc, ValueError):
            # a CUDA error anywhere in the chain counts
            exc.__cause__ = RuntimeError("CUDA error: device-side assert")
        cp, df = self._armed(exc)
        key = 'pipeline_fused_fallback_total{segment="device-error:seg0"}'
        before = registry.snapshot().get(key, 0)
        with pytest.raises(type(exc)):
            cp.transform(df)
        assert registry.snapshot().get(key, 0) == before
        assert is_device_error(exc)

    def test_accelerator_error_is_a_device_error(self):
        accel = getattr(torch, "AcceleratorError", None)
        if accel is not None:
            assert is_device_error(accel.__new__(accel))
        assert not is_device_error(ValueError("shape"))

    def test_other_errors_fall_back(self):
        cp, df = self._armed(TypeError("a host op in a traced form"))
        key = 'pipeline_fused_fallback_total{segment="device-error:seg0"}'
        before = registry.snapshot().get(key, 0)
        with pytest.raises(TypeError):
            cp.transform(df)   # the eager udf raises the same way
        assert registry.snapshot().get(key, 0) == before + 1


class TestOneCopyBack:
    def test_outputs_fetched_in_one_copy(self):
        """``download`` packs every computed output into one buffer, so
        the segment's outputs cross in one copy: each computed column is
        a view of the same host buffer. A column passed through unchanged
        is its host array, not a copy."""
        host = {"a": np.arange(6, dtype=np.float32),
                "b": np.arange(6, dtype=np.int64)}
        dev, origin = upload(host, torch.device("cpu"))
        out = {"a": dev["a"], "b2": dev["b"] * 2, "f": dev["a"][:, None] > 2,
               "g": dev["a"].to(torch.float64)}
        back = download(out, origin, torch.device("cpu"))

        def root(a):
            while isinstance(a, np.ndarray) and a.base is not None:
                a = a.base
            return a
        assert root(back["b2"]) is root(back["f"]) is root(back["g"])
        assert back["a"] is host["a"]
        hold(back["b2"], host["b"] * 2, "b2")
        hold(back["f"], host["a"][:, None] > 2, "f")
        hold(back["g"], host["a"].astype(np.float64), "g")


class TestGbdtChainPlan:
    def test_numeric_chain_fuses_featurize_and_runs_gbdt_eagerly(self):
        """The main path's plan (SURVEY §7.3, numeric columns): one
        segment of the two featurize models, then the GBDT model eagerly;
        the compiled transform equals the eager one."""
        from mmlspark_torch.core import Pipeline
        from mmlspark_torch.featurize import CleanMissingData, Featurize
        from mmlspark_torch.lightgbm import LightGBMClassifier
        rng = np.random.default_rng(3)
        n, k = 300, 4
        x = rng.normal(size=(n, k)).astype(np.float32)
        x[rng.random((n, k)) < 0.05] = np.nan
        cols = [f"x{i}" for i in range(k)]
        df = DataFrame({**{c: x[:, i] for i, c in enumerate(cols)},
                        "label": (np.nan_to_num(x[:, 0]) > 0)
                        .astype(np.float32)})
        pm = Pipeline(stages=[
            CleanMissingData(inputCols=cols, cleaningMode="Mean"),
            Featurize(inputCols=cols, outputCol="features"),
            LightGBMClassifier(numIterations=3, numLeaves=7,
                               minDataInLeaf=5, device="cpu")]).fit(df)
        cp = pm.compile(df.take(list(range(64))))
        assert cp.describe() == [
            {"kind": "fused", "segment": "pipeline:seg0",
             "stages": ["CleanMissingDataModel", "FeaturizeModel"]},
            {"kind": "eager", "stage": "LightGBMClassificationModel"}]
        got, want = cp.transform(df), pm.transform(df)
        assert got.columns == want.columns
        for c in got.columns:
            hold(got[c], want[c], c)
