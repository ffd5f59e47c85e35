"""The port's featurization stages against the JAX package's, on the CPU.

The same seeded numpy frames go through both packages, stage by stage:
``Featurize``, ``CleanMissingData`` (Mean, Median, Custom),
``ValueIndexer``/``IndexToValue``, ``DataConversion``, ``CountSelector``,
``VectorAssembler`` (error, keep, skip) and ``OneHotEncoder``. Held:

- integer, index, string, one-hot, hash and datetime outputs, the encoding
  plans and the column metadata (``slot_names``) exactly; output dtypes
  exactly (float32 features, int32 indices);
- fitted fills within 1e-6 relative (both are float32 sums of the column,
  in different orders: the port sums in float64 and rounds once), and so
  imputed cells within atol 1e-6; every other float cell exactly;
- an int64 column beyond 2**31 as the JAX package encodes it: fills from
  the float32 of the full values, cells from the 32-bit wrap of ``jnp``'s
  demotion (recorded below);
- the whole chain on ``load_breast_cancer`` (30 numeric columns with planted
  NaN and a derived string column) → ``Featurize`` → ``LightGBMClassifier``
  → AUC: within 1e-4 of the JAX package's chain and inside
  ``benchmarks_ReferenceParity.csv``'s gbdt band.
"""

import os
import warnings

import numpy as np
import pytest
import torch
from sklearn.datasets import load_breast_cancer

import mmlspark_tpu.featurize as jf
from mmlspark_tpu.core import ColumnMetadata as JColumnMetadata
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core import Pipeline as JPipeline
from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
from mmlspark_tpu.train.statistics import \
    ComputeModelStatistics as JComputeModelStatistics
import mmlspark_torch.featurize as tf
from mmlspark_torch.core import ColumnMetadata, DataFrame, Pipeline
from mmlspark_torch.lightgbm import LightGBMClassifier
from mmlspark_torch.train import ComputeModelStatistics

HERE = os.path.dirname(__file__)
PARITY_CSV = os.path.join(HERE, "resources", "benchmarks",
                          "benchmarks_ReferenceParity.csv")
FILL_RTOL = 1e-6
FLOAT_ATOL = 1e-6
AUC_ATOL = 1e-4
BIG = 2 ** 31 + 5          # beyond the JAX package's 32-bit lattice


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(n=240, seed=0):
    """Every column kind Featurize plans for: float32 and float64 with NaN,
    int64 (one value beyond 2**31), uint8, bool, a 7-level string with a
    None, a ~150-level string, 2-D float64 and object-cell vectors, and
    datetime64[s]."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(3.0, 1.0, n).astype(np.float32)
    f32[rng.random(n) < 0.1] = np.nan
    f64 = rng.normal(-2.0, 4.0, n)
    f64[rng.random(n) < 0.05] = np.nan
    i64 = rng.integers(-50, 50, n).astype(np.int64)
    i64[0] = BIG
    cat = np.asarray([f"lvl{v}" for v in rng.integers(0, 7, n)], object)
    cat[3] = None
    high = np.asarray([f"w{v}" for v in rng.integers(0, 150, n)], object)
    cells = np.empty(n, object)
    cells[:] = [rng.normal(size=4).astype(np.float32) for _ in range(n)]
    return {
        "f32": f32, "f64": f64, "i64": i64,
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "flag": rng.random(n) > 0.5, "cat": cat, "high": high,
        "vec": rng.normal(size=(n, 3)), "cells": cells,
        "when": np.datetime64("2021-03-04T05:06:07")
        + rng.integers(0, 10 ** 9, n).astype("timedelta64[s]"),
    }


def _both(data):
    return JDataFrame(dict(data)), DataFrame(dict(data))


def _jax(values):
    with warnings.catch_warnings():  # jnp's int64 → int32 demotion warns
        warnings.simplefilter("ignore")
        return np.asarray(values)


def _assert_plans(jplan, tplan):
    assert len(jplan) == len(tplan)
    for js, ts in zip(jplan, tplan):
        assert set(js) == set(ts), (js, ts)
        for k in js:
            if k == "fill":
                assert ts[k] == pytest.approx(js[k], rel=FILL_RTOL,
                                              abs=1e-30), js["col"]
            else:
                assert ts[k] == js[k], (k, js, ts)


FEATURIZE_CASES = {
    "default": {},
    "hash_categoricals": dict(oneHotEncodeCategoricals=False,
                              numFeatures=48),
    "low_cardinality_cap": dict(maxOneHotCardinality=3),
    "no_impute": dict(imputeMissing=False),
}


@pytest.mark.parametrize("case", sorted(FEATURIZE_CASES))
def test_featurize_matches_jax(case):
    data = _frame()
    kw = dict(FEATURIZE_CASES[case], inputCols=list(data))
    jdf, tdf = _both(data)
    jmodel = jf.Featurize(**kw).fit(jdf)
    tmodel = tf.Featurize(**kw, device="cpu").fit(tdf)
    _assert_plans(jmodel.getEncodingPlan(), tmodel.getEncodingPlan())
    assert tmodel.slot_names() == jmodel.slot_names()
    assert tmodel.feature_dim == jmodel.feature_dim

    jout, tout = jmodel.transform(jdf), tmodel.transform(tdf)
    want, got = _jax(jout["features"]), tout["features"]
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert ColumnMetadata.get(tout, "features") == \
        JColumnMetadata.get(jout, "features")
    # exact everywhere but the imputed cells, which hold the fills
    imputed = np.zeros_like(want, bool)
    slot = 0
    for spec in tmodel.getEncodingPlan():
        if spec["kind"] == "numeric" and data[spec["col"]].dtype.kind == "f":
            imputed[:, slot] = np.isnan(data[spec["col"]])
        slot += spec["width"]
    np.testing.assert_array_equal(got[~imputed], want[~imputed])
    np.testing.assert_allclose(got[imputed], want[imputed], rtol=0,
                               atol=FLOAT_ATOL)
    # the int64 cell beyond 2**31: jnp's demotion wraps it to int32
    i64 = tmodel.slot_names().index("i64")
    assert got[0, i64] == want[0, i64] == np.float32(np.int32(
        np.int64(BIG).astype(np.int32)))


def test_featurize_unseen_levels_and_vector_width():
    data = _frame()
    kw = dict(inputCols=["cat", "vec"])
    jmodel = jf.Featurize(**kw).fit(JDataFrame(data))
    tmodel = tf.Featurize(**kw, device="cpu").fit(DataFrame(data))
    other = dict(data, cat=np.asarray(["new"] * len(data["cat"]), object))
    np.testing.assert_array_equal(
        tmodel.transform(DataFrame(other))["features"],
        _jax(jmodel.transform(JDataFrame(other))["features"]))
    narrow = dict(data, vec=data["vec"][:, :2])
    for model, frame in ((jmodel, JDataFrame), (tmodel, DataFrame)):
        with pytest.raises(ValueError, match="width 2 != fitted width 3"):
            model.transform(frame(narrow))


@pytest.mark.parametrize("mode", ["Mean", "Median", "Custom"])
@pytest.mark.parametrize("n", [239, 240])
def test_clean_missing_data_matches_jax(mode, n):
    data = _frame(n, seed=n)
    kw = dict(inputCols=["f32", "f64", "i64"], cleaningMode=mode,
              customValue=-7.25)
    jdf, tdf = _both(data)
    jmodel = jf.CleanMissingData(**kw).fit(jdf)
    tmodel = tf.CleanMissingData(**kw, device="cpu").fit(tdf)
    jfill, tfill = jmodel.getFillValues(), tmodel.getFillValues()
    assert set(jfill) == set(tfill)
    for col in jfill:
        assert tfill[col] == pytest.approx(jfill[col], rel=FILL_RTOL), col
    if mode == "Median":      # sorted middle values: exact
        assert tfill == jfill
    jout, tout = jmodel.transform(jdf), tmodel.transform(tdf)
    for col in kw["inputCols"]:
        got, want = tout[col], _jax(jout[col])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
        assert not np.isnan(got).any()


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_mean_fill_of_a_float32_overflow_matches_jax(sign):
    """9,999 values of ±1e35 and one NaN: the float32 sum overflows, so
    the JAX package's mean (and with it the fill) is ±inf in both
    stages."""
    x = np.full(10_000, sign * 1e35, np.float32)
    x[17] = np.nan
    data = {"x": x}
    jdf, tdf = _both(data)
    kw = dict(inputCols=["x"], cleaningMode="Mean")
    jfill = jf.CleanMissingData(**kw).fit(jdf).getFillValues()["x"]
    tmodel = tf.CleanMissingData(**kw, device="cpu").fit(tdf)
    assert jfill == sign * np.inf
    assert tmodel.getFillValues()["x"] == jfill
    out = tmodel.transform(tdf)["x"]
    assert out[17] == sign * np.inf and (out[:17] == x[:17]).all()
    jplan = jf.Featurize(inputCols=["x"]).fit(jdf).getEncodingPlan()
    tmodel = tf.Featurize(inputCols=["x"], device="cpu").fit(tdf)
    assert tmodel.getEncodingPlan()[0]["fill"] == jplan[0]["fill"] \
        == sign * np.inf
    assert tmodel.transform(tdf)["features"][17, 0] == sign * np.inf


def test_clean_missing_data_output_cols_and_even_median():
    x = np.asarray([4.0, np.nan, 1.0, 3.0, 2.0], np.float32)
    kw = dict(inputCols=["x"], outputCols=["x_clean"], cleaningMode="Median")
    jmodel = jf.CleanMissingData(**kw).fit(JDataFrame({"x": x}))
    tmodel = tf.CleanMissingData(**kw, device="cpu").fit(DataFrame({"x": x}))
    # the mean of the two middle values, as jnp.median (torch.median: 2.0)
    assert tmodel.getFillValues() == jmodel.getFillValues() == {"x": 2.5}
    out = tmodel.transform(DataFrame({"x": x}))
    np.testing.assert_array_equal(out["x"], x)
    np.testing.assert_array_equal(
        out["x_clean"],
        _jax(jmodel.transform(JDataFrame({"x": x}))["x_clean"]))


VALUE_COLUMNS = {
    "strings": np.asarray(["b", "a", None, "c", "a", "b"], object),
    "float64": np.asarray([0.1, 0.2, np.nan, 0.1, 1e-30, 0.2]),
    "int64_beyond_2_31": np.asarray([2 ** 40, 7, -2 ** 33, 7, 2 ** 40, 0]),
    "int32": np.asarray([5, 3, 5, 9, 3, 3], np.int32),
}


@pytest.mark.parametrize("name", sorted(VALUE_COLUMNS))
def test_value_indexer_and_index_to_value_match_jax(name):
    col = VALUE_COLUMNS[name]
    kw = dict(inputCol="v", outputCol="idx")
    jmodel = jf.ValueIndexer(**kw).fit(JDataFrame({"v": col}))
    tmodel = tf.ValueIndexer(**kw).fit(DataFrame({"v": col}))
    assert tmodel.getLevels() == jmodel.getLevels()
    seen = np.asarray([v for v in col if v is not None and v == v],
                      col.dtype)
    jout = jmodel.transform(JDataFrame({"v": seen}))
    tout = tmodel.transform(DataFrame({"v": seen}))
    assert tout["idx"].dtype == np.int32
    np.testing.assert_array_equal(tout["idx"], _jax(jout["idx"]))
    back = tf.IndexToValue(inputCol="idx", outputCol="back",
                           levels=tmodel.getLevels()).transform(tout)
    jback = jf.IndexToValue(inputCol="idx", outputCol="back",
                            levels=jmodel.getLevels()).transform(jout)
    assert back["back"].dtype == jback["back"].dtype
    np.testing.assert_array_equal(back["back"], jback["back"])
    np.testing.assert_array_equal(back["back"], seen)
    unseen = np.asarray([seen[0]] * 2, seen.dtype)
    unseen[1] = {"strings": "zz", "float64": 0.3,
                 "int64_beyond_2_31": 2 ** 41, "int32": 11}[name]
    for model, frame in ((jmodel, JDataFrame), (tmodel, DataFrame)):
        with pytest.raises(ValueError, match="unseen value"):
            model.transform(frame({"v": unseen}))
    jmodel.setUnknownIndex(99)
    tmodel.setUnknownIndex(99)
    np.testing.assert_array_equal(
        tmodel.transform(DataFrame({"v": unseen}))["idx"],
        _jax(jmodel.transform(JDataFrame({"v": unseen}))["idx"]))


CONVERSIONS = ["boolean", "byte", "short", "integer", "long", "float",
               "double", "string", "date"]


@pytest.mark.parametrize("target", CONVERSIONS)
def test_data_conversion_matches_jax(target):
    if target == "date":
        data = {"a": np.asarray(["2021-01-02 03:04:05",
                                 "1999-12-31 23:59:59"], object)}
    else:
        data = {"a": np.asarray([1.9, -2.5, 0.0, 300.25]),
                "b": np.asarray([1, 0, 7, 2 ** 40], np.int64)}
    kw = dict(inputCols=list(data), convertTo=target)
    jout = jf.DataConversion(**kw).transform(JDataFrame(data))
    tout = tf.DataConversion(**kw).transform(DataFrame(data))
    for col in data:
        assert tout[col].dtype == jout[col].dtype
        np.testing.assert_array_equal(tout[col], jout[col])


def test_count_selector_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 9)).astype(np.float32)
    x[:, [0, 4, 8]] = 0.0
    x[7, 4] = -0.5                       # one nonzero keeps a slot
    kw = dict(inputCol="x", outputCol="kept")
    jmodel = jf.CountSelector(**kw).fit(JDataFrame({"x": x}))
    tmodel = tf.CountSelector(**kw, device="cpu").fit(DataFrame({"x": x}))
    assert tmodel.getIndices() == jmodel.getIndices() == \
        [1, 2, 3, 4, 5, 6, 7]
    got = tmodel.transform(DataFrame({"x": x}))["kept"]
    want = _jax(jmodel.transform(JDataFrame({"x": x}))["kept"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _assembler_frame():
    rng = np.random.default_rng(5)
    a = rng.normal(size=20)
    a[[2, 11]] = np.nan
    cells = np.empty(20, object)
    cells[:] = [rng.normal(size=2) for _ in range(20)]
    return {"a": a, "b": rng.integers(0, 9, 20),
            "v": rng.normal(size=(20, 3)).astype(np.float32), "c": cells,
            "tag": np.asarray([f"r{i}" for i in range(20)], object)}


@pytest.mark.parametrize("mode", ["error", "keep", "skip"])
def test_vector_assembler_matches_jax(mode):
    data = _assembler_frame()
    kw = dict(inputCols=["a", "b", "v", "c"], handleInvalid=mode)
    jstage, tstage = jf.VectorAssembler(**kw), \
        tf.VectorAssembler(**kw, device="cpu")
    if mode == "error":
        for stage, frame in ((jstage, JDataFrame), (tstage, DataFrame)):
            with pytest.raises(ValueError, match="2 rows contain NaN"):
                stage.transform(frame(data))
        clean = {k: v[3:11] for k, v in data.items()}
        data = clean
    jout = jstage.transform(JDataFrame(data))
    tout = tstage.transform(DataFrame(data))
    got, want = tout["features"], _jax(jout["features"])
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (
        {"error": 8, "keep": 20, "skip": 18}[mode], 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tout["tag"], jout["tag"])


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("invalid", ["error", "keep"])
def test_one_hot_encoder_matches_jax(drop_last, invalid):
    idx = np.asarray([0, 3, 1, 3, 2, 0], np.int64)
    kw = dict(inputCol="i", outputCol="oh", dropLast=drop_last,
              handleInvalid=invalid)
    jmodel = jf.OneHotEncoder(**kw).fit(JDataFrame({"i": idx}))
    tmodel = tf.OneHotEncoder(**kw, device="cpu").fit(DataFrame({"i": idx}))
    assert tmodel.get("categorySize") == jmodel.get("categorySize") == 4
    test = np.asarray([3, 0, 5, -1, 2], np.int64)
    if invalid == "error":
        for model, frame in ((jmodel, JDataFrame), (tmodel, DataFrame)):
            with pytest.raises(ValueError, match="2 indices outside"):
                model.transform(frame({"i": test}))
        test = test[[0, 1, 4]]
    got = tmodel.transform(DataFrame({"i": test}))["oh"]
    want = _jax(jmodel.transform(JDataFrame({"i": test}))["oh"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for stage in (jf.OneHotEncoder(inputCol="i"),
                  tf.OneHotEncoder(inputCol="i", device="cpu")):
        with pytest.raises(ValueError, match="non-negative"):
            stage.fit((JDataFrame if stage.__module__.startswith(
                "mmlspark_tpu") else DataFrame)({"i": np.asarray([1, -1])}))


# ------------------------------------------------- the SURVEY §7.3 chain

def _cancer_frame():
    """load_breast_cancer as 30 float64 columns, 3 % NaN planted in six of
    them (seeded), and a string column derived from two features."""
    data = load_breast_cancer()
    x, y = data.data, data.target.astype(np.float32)
    rng = np.random.default_rng(17)
    cols = {f"f{i}": x[:, i].copy() for i in range(x.shape[1])}
    for i in (0, 3, 7, 12, 21, 27):
        cols[f"f{i}"][rng.random(len(y)) < 0.03] = np.nan
    size = np.digitize(x[:, 3], np.quantile(x[:, 3], [0.25, 0.5, 0.75]))
    smooth = x[:, 4] > np.median(x[:, 4])
    cols["band"] = np.asarray([f"size{s}-{'s' if m else 'r'}"
                               for s, m in zip(size, smooth)], object)
    cols["label"] = y
    return cols


def _auc(stats_cls, scored):
    return float(stats_cls(labelCol="label").transform(scored)["AUC"][0])


def test_breast_cancer_chain_matches_jax_and_parity_band():
    data = _cancer_frame()
    inputs = [c for c in data if c != "label"]
    gbdt = dict(numIterations=10, numLeaves=5)   # the parity row's settings
    jdf, tdf = _both(data)
    jmodel = JPipeline(stages=[
        jf.Featurize(inputCols=inputs),
        JClassifier(**gbdt)]).fit(jdf)
    tmodel = Pipeline(stages=[
        tf.Featurize(inputCols=inputs, device="cpu"),
        LightGBMClassifier(**gbdt, device="cpu")]).fit(tdf)
    jfeat, tfeat = jmodel.getStages()[0], tmodel.getStages()[0]
    _assert_plans(jfeat.getEncodingPlan(), tfeat.getEncodingPlan())
    assert [s["kind"] for s in tfeat.getEncodingPlan()].count("onehot") == 1
    jauc = _auc(JComputeModelStatistics, jmodel.transform(jdf))
    tauc = _auc(ComputeModelStatistics, tmodel.transform(tdf))
    assert abs(tauc - jauc) <= AUC_ATOL, (tauc, jauc)
    rows = {}
    with open(PARITY_CSV) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                name, value, tol = line.strip().split(",")
                rows[name] = (float(value), float(tol))
    value, tol = rows["LightGBMClassifier_breast-cancer_gbdt_AUROC"]
    assert abs(tauc - value) <= tol, (tauc, value, tol)
