"""The port's core (DataFrame, Params, Pipeline, save/load) and
ComputeModelStatistics against the JAX package's on the same inputs.
Metrics must match to 1e-12 (the same numpy code on the same columns)."""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.train.statistics import \
    ComputeModelStatistics as JComputeModelStatistics
from mmlspark_torch.core import DataFrame, Pipeline, PipelineModel, \
    load_stage
from mmlspark_torch.lightgbm import LightGBMClassifier
from mmlspark_torch.train import ComputeModelStatistics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this module: tier-1 runs in several
    worker processes at once, and torch's intra-op threads in each of
    them oversubscribe the cores (small ops then wait on spinning
    threads, ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dataframe_tensor_column():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    df = DataFrame({"features": x, "label": np.array([0, 1, 0, 1])})
    t = df.tensor("features", device="cpu")
    assert t.dtype == torch.float32 and t.shape == (4, 3)
    np.testing.assert_array_equal(t.numpy(), x)
    assert df.tensor("label", device="cpu",
                     dtype=torch.float32).dtype == torch.float32
    # tensors go back into columns as host numpy arrays
    out = df.with_column("double", t * 2)
    np.testing.assert_array_equal(out["double"], x * 2)


def test_params_accessors_and_defaults():
    clf = LightGBMClassifier(numLeaves=7, device="cpu")
    assert clf.getNumLeaves() == 7 and clf.getDevice() == "cpu"
    assert clf.getLearningRate() == 0.1 and not clf.isSet("learningRate")
    clf.setLearningRate(0.3)
    assert clf.getLearningRate() == 0.3
    with pytest.raises(TypeError):
        clf.setNumLeaves("many")
    with pytest.raises(AttributeError):
        clf.setNoSuchParam(1)


def test_pipeline_fit_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    df = DataFrame({"features": x, "label": y})
    model = Pipeline(stages=[LightGBMClassifier(
        device="cpu", numIterations=3, numLeaves=4)]).fit(df)
    assert isinstance(model, PipelineModel)
    path = str(tmp_path / "pipe")
    model.save(path)
    loaded = load_stage(path)
    np.testing.assert_allclose(
        np.asarray(loaded.transform(df)["probability"]),
        np.asarray(model.transform(df)["probability"]), atol=1e-6)


@pytest.mark.parametrize("kind", ["classification", "regression"])
def test_compute_model_statistics_matches_reference(kind):
    rng = np.random.default_rng(1)
    n = 400
    if kind == "classification":
        y = (rng.random(n) > 0.4).astype(np.float64)
        p = np.clip(y * 0.6 + rng.random(n) * 0.5, 0, 1)
        cols = {"label": y, "prediction": (p > 0.5).astype(np.float64),
                "probability": np.stack([1 - p, p], axis=1)}
    else:
        y = rng.normal(size=n)
        cols = {"label": y, "prediction": y + rng.normal(0, 0.3, n)}
    want = JComputeModelStatistics(labelCol="label").transform(
        JDataFrame(cols))
    got = ComputeModelStatistics(labelCol="label").transform(DataFrame(cols))
    assert got.columns == want.columns
    for c in want.columns:
        assert float(got[c][0]) == pytest.approx(float(want[c][0]),
                                                 rel=1e-12, abs=1e-12), c


def test_cuda_loader_keys_builds_by_the_headers_too(tmp_path):
    """A header the kernel sources include (``flash_common.cuh``, the
    forward's body ``flash_fwd.cuh`` and the dense forward's source and
    launcher ``flash_dense.cuh``) changes the library's build key as the
    sources do, so an edit to it rebuilds every library that includes
    it."""
    from mmlspark_torch.dl import flash_attention, paged_attention
    from mmlspark_torch.native.loader import CudaLoader
    src, hdr = tmp_path / "k.cu", tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n')
    hdr.write_text("// one\n")
    loader = CudaLoader("keyed", [str(src)], headers=(str(hdr),))
    first = loader.so_path()
    assert CudaLoader("keyed", [str(src)]).so_path() != first
    hdr.write_text("// two\n")
    assert loader.so_path() != first
    both = ["flash_common.cuh", "flash_fwd.cuh"]
    dense = [*both, "flash_dense.cuh"]
    for lib, want in ((flash_attention._LOADER, dense),
                      (flash_attention._LOADER_TUNED, dense),
                      (flash_attention._LOADER_BWD, ["flash_common.cuh"]),
                      (paged_attention._LOADER, both),
                      (paged_attention._LOADER_DECODE, ["flash_common.cuh"])):
        assert [h.rsplit("/", 1)[-1] for h in lib.headers] == want


# ------------------------------------------------ the featurize slice's core

def test_host_boundary_helpers_match_jax():
    import warnings

    import jax.numpy as jnp
    from mmlspark_tpu.core import dataframe as jdf
    from mmlspark_torch.core import dataframe as tdf

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    np.testing.assert_array_equal(tdf.to_host(t), t.numpy())
    assert tdf.to_host_list(t) == t.tolist()
    x = np.asarray([0.1, np.nan, 0.1, 2 ** 40, 3.0])
    for drop in (False, True):
        np.testing.assert_array_equal(tdf.unique_host(x, drop_nan=drop),
                                      jdf.unique_host(x, drop_nan=drop))
        for a, b in zip(tdf.unique_host(x, True, drop),
                        jdf.unique_host(x, True, drop)):
            np.testing.assert_array_equal(a, b)
    ts = np.asarray([2 ** 33, 5, 2 ** 33, -1], np.int64)
    np.testing.assert_array_equal(tdf.argsort_host(ts), jdf.argsort_host(ts))
    np.testing.assert_array_equal(tdf.concat_host([ts, ts[:2]]),
                                  jdf.concat_host([ts, ts[:2]]))
    np.testing.assert_array_equal(tdf.repeat_rows(ts, [1, 0, 2, 1]),
                                  jdf.repeat_rows(ts, [1, 0, 2, 1]))
    assert [tdf.f32_exact(v) for v in (0.1, 2 ** 24 + 1, 0.5)] == \
        [jdf.f32_exact(v) for v in (0.1, 2 ** 24 + 1, 0.5)]
    assert tdf.quantile_host(x[~np.isnan(x)], 0.3) == \
        jdf.quantile_host(x[~np.isnan(x)], 0.3)
    cells = tdf.object_column([np.zeros(2), np.ones(2)])
    assert cells.dtype == object and cells.shape == (2,)
    assert [tdf.jittable_dtype(np.dtype(c)) for c in "bifUOM"] == \
        [jdf.jittable_dtype(np.dtype(c)) for c in "bifUOM"]
    # device_lattice: the dtype and values jnp.asarray gives a column
    for col in (np.asarray([2 ** 31 + 5, -2 ** 33 - 7, 3], np.int64),
                np.asarray([2 ** 63 + 5, 7], np.uint64),
                np.asarray([0.1, 1e300, np.nan]), np.arange(3, dtype=np.int16),
                np.asarray([True, False])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = np.asarray(jnp.asarray(col))
        got = tdf.device_lattice(col)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_core_utils_match_jax():
    from mmlspark_tpu.core import utils as jutils
    from mmlspark_torch.core import utils as tutils

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    def always_fails():
        raise OSError("always")

    assert tutils.retry_with_timeout(flaky, backoffs_ms=(0, 1, 1)) == "ok"
    with pytest.raises(OSError, match="always"):
        tutils.retry_with_timeout(always_fails, timeout_s=5,
                                  backoffs_ms=(0, 1))
    with pytest.raises(ValueError):
        tutils.retry_with_timeout(flaky, backoffs_ms=())
    watch = tutils.StopWatch()
    assert watch.measure(lambda: 7) == 7 and watch.elapsed_ns > 0
    df = DataFrame({"a": [1], "a_1": [2]})
    assert tutils.find_unused_column_name("a", df) == \
        jutils.find_unused_column_name("a", JDataFrame({"a": [1],
                                                        "a_1": [2]})) \
        == "a_2"

    class Res:
        closed = False

        def close(self):
            self.closed = True

    r = Res()
    assert tutils.using([r], lambda x: 5) == 5 and r.closed
    cu = tutils.ClusterUtil
    assert cu.get_num_local_devices() == torch.cuda.device_count()
    assert cu.get_num_hosts() == 1 and cu.get_host_index() == 0
    assert cu.get_num_devices() == torch.cuda.device_count()
    assert cu.get_jvm_cpus() == jutils.ClusterUtil.get_jvm_cpus()
    with pytest.raises(RuntimeError, match="process group"):
        cu.default_mesh()


def test_cluster_util_reads_an_initialized_group(tmp_path):
    import torch.distributed as dist
    from mmlspark_torch.core import ClusterUtil

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        assert ClusterUtil.get_num_hosts() == 1
        assert ClusterUtil.get_host_index() == 0
        assert ClusterUtil.get_num_devices() == 1     # a rank per device
        mesh = ClusterUtil.default_mesh("rows")
        assert mesh.device_type == "cpu"           # gloo serves the CPU
        assert mesh.mesh_dim_names == ("rows",)
        assert mesh.size() == 1
    finally:
        dist.destroy_process_group()


def test_dataclass_bindings_match_jax():
    import dataclasses
    from typing import Optional

    from mmlspark_tpu.core.bindings import bindings as jbindings
    from mmlspark_torch.core.bindings import bindings

    @dataclasses.dataclass
    class Inner:
        x: int
        tags: list[str]

    @dataclasses.dataclass
    class Outer:
        name: str
        inner: Inner
        score: Optional[float] = None
        extra: list = dataclasses.field(default_factory=list)

    items = [Outer("a", Inner(1, ["p", "q"]), 0.5),
             Outer("b", Inner(2, []), None, [3])]
    df, jdf = bindings(Outer).to_df(items), jbindings(Outer).to_df(items)
    assert df.columns == jdf.columns
    for c in df.columns:
        assert list(df[c]) == list(jdf[c])
    assert bindings(Outer).from_df(df) == items
    assert bindings(Outer).from_df(df.drop("extra", "score")) == [
        Outer("a", Inner(1, ["p", "q"])), Outer("b", Inner(2, []))]
    with pytest.raises(KeyError, match="absent"):
        bindings(Outer).from_df(df.drop("name"))
    with pytest.raises(TypeError):
        bindings(int)


def test_arrow_round_trip_matches_jax():
    import pyarrow as pa

    from mmlspark_torch.core import ColumnMetadata

    x = np.asarray([1.5, 2.5, 3.5], np.float32)
    v = np.arange(6, dtype=np.float64).reshape(3, 2)
    s = np.asarray(["a", None, "c"], object)
    cat = np.asarray([0.0, 1.0, 0.0], np.float32)
    df = ColumnMetadata.set_categorical(
        DataFrame({"x": x, "v": v, "s": s, "cat": cat}), "cat", ["lo", "hi"])
    table = df.to_arrow()
    from mmlspark_tpu.core import ColumnMetadata as JColumnMetadata
    jdf = JColumnMetadata.set_categorical(
        JDataFrame({"x": x, "v": v, "s": s, "cat": cat}), "cat",
        ["lo", "hi"])
    assert table.equals(jdf.to_arrow())
    back = DataFrame.from_arrow(table)
    for c in df.columns:
        np.testing.assert_array_equal(back[c], df[c])
    assert ColumnMetadata.categorical_levels(back, "cat") == ["lo", "hi"]
    jback = JDataFrame.from_arrow(table)
    assert JColumnMetadata.categorical_levels(jback, "cat") == ["lo", "hi"]
    dict_arr = pa.DictionaryArray.from_arrays(pa.array([1, 0, None]),
                                              pa.array(["x", "y"]))
    nulls = pa.array([1, None, 3], pa.int64())
    batches = [pa.record_batch([dict_arr, nulls], names=["d", "n"])] * 2
    got = DataFrame.from_arrow_batches(batches)
    want = JDataFrame.from_arrow_batches(batches)
    for c in ("d", "n"):
        np.testing.assert_array_equal(got[c], want[c])
    assert ColumnMetadata.categorical_levels(got, "d") == ["x", "y"]
