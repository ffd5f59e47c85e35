"""The whole slice against the JAX package on load_breast_cancer:
DataFrame → LightGBMClassifier.fit → transform → ComputeModelStatistics.

Held (no bagging, no feature fraction, one shard on the JAX side):
- every tree: feature, threshold, children, leaves and node count exactly,
  leaf values within 1e-5 — or, where a split differs, the reference's top
  two gains tie within f32 noise (the engine test's rule);
- probabilities within 1e-5 and |ΔAUC| <= 1e-4 (f32 sums in another order);
- the AUC inside the ``benchmarks_ReferenceParity.csv`` gbdt band;
- ``booster_from_arrays`` and the LightGBM text format carry models across
  in both directions with the same raw scores (1e-5);
- the upstream text fixture scores the same in both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import load_breast_cancer

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import Booster as JBooster
from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_tpu.train.statistics import \
    ComputeModelStatistics as JComputeModelStatistics
from mmlspark_torch.core import DataFrame, load_stage
from mmlspark_torch.lightgbm import (Booster, LightGBMClassificationModel,
                                     LightGBMClassifier)
from mmlspark_torch.lightgbm.convert import booster_from_arrays
from mmlspark_torch.train import ComputeModelStatistics
from test_torch_engine import assert_tie, split_sequence

HERE = os.path.dirname(__file__)
PARITY_CSV = os.path.join(HERE, "resources", "benchmarks",
                          "benchmarks_ReferenceParity.csv")
FIXTURE = os.path.join(HERE, "fixtures", "upstream_lgbm_binary.txt")
PROB_ATOL = 1e-5
AUC_ATOL = 1e-4
RAW_ATOL = 1e-5

CASES = {
    # the parity CSV's gbdt row: numLeaves=5, numIterations=10
    "parity_band": dict(numIterations=10, numLeaves=5, seed=0),
    "l2_mindata": dict(numIterations=20, numLeaves=5, lambdaL2=1.0,
                       minDataInLeaf=10),
    "7leaves_63bins": dict(numIterations=15, numLeaves=7, learningRate=0.2,
                           maxBin=63),
}
# wider trees on 569 rows meet near-ties (gains equal within f32 noise)
# that the two packages' summation orders break differently: held to the
# tree rule only, since scores part ways after the first tie
TIE_CASES = {
    "15leaves": dict(numIterations=20, numLeaves=15, learningRate=0.2),
    "31leaves": dict(numIterations=20, numLeaves=31, minDataInLeaf=5,
                     lambdaL2=1.0),
}


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


@pytest.fixture(scope="module")
def breast_cancer():
    d = load_breast_cancer()
    return d.data.astype(np.float32), d.target.astype(np.float32)


@pytest.fixture(scope="module")
def fits(breast_cancer):
    """case name → both packages' models and scored frames (cached)."""
    cache = {}

    def get(case):
        if case not in cache:
            x, y = breast_cancer
            kw = {**CASES, **TIE_CASES}[case]
            jmodel = JClassifier(numShards=1, **kw).fit(
                JDataFrame({"features": x, "label": y}))
            tmodel = LightGBMClassifier(device="cpu", **kw).fit(
                DataFrame({"features": x, "label": y}))
            jout = jmodel.transform(JDataFrame({"features": x, "label": y}))
            tout = tmodel.transform(DataFrame({"features": x, "label": y}))
            cache[case] = dict(case=case, kw=kw, x=x, y=y, jmodel=jmodel,
                               tmodel=tmodel, jout=jout, tout=tout)
        return cache[case]
    return get


@pytest.fixture(params=sorted(CASES))
def fitted(request, fits):
    return fits(request.param)


def _split_bins(arrays, t, boundaries):
    """A booster tree's splits as (parent, feature, bin), recovering each
    bin from its threshold (threshold = boundaries[f][bin - 1])."""
    class T:
        pass
    tree = T()
    tree.left = arrays["left"][t]
    tree.num_nodes = arrays["num_nodes"][t]
    tree.feature = arrays["feature"][t]
    tree.split_bin = np.array([
        int(np.searchsorted(boundaries[f], thr)) + 1
        for f, thr in zip(arrays["feature"][t], arrays["threshold"][t])])
    return split_sequence(tree)


def test_trees_match(fitted):
    assert_trees_match_or_tie(fitted)


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_wider_trees_match_up_to_a_tie(case, fits):
    assert_trees_match_or_tie(fits(case))


def assert_trees_match_or_tie(fitted):
    ja = fitted["jmodel"].booster.arrays
    ta = fitted["tmodel"].booster.arrays
    assert ja["feature"].shape == ta["feature"].shape
    for t in range(ja["feature"].shape[0]):
        same = all(np.array_equal(ja[k][t], ta[k][t]) for k in
                   ("feature", "threshold", "left", "right", "is_leaf",
                    "num_nodes"))
        if not same:
            _assert_divergence_is_a_tie(fitted, t)
            return      # later trees follow from different scores
        np.testing.assert_allclose(ta["leaf_value"][t], ja["leaf_value"][t],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ta["node_value"][t], ja["node_value"][t],
                                   rtol=1e-5, atol=1e-5)


def _assert_divergence_is_a_tie(fitted, t):
    """Tree t differs: rebuild the reference's gradients at iteration t
    and show that its top two gains tie at the first differing split."""
    x, y, kw = fitted["x"], fitted["y"], fitted["kw"]
    jb = fitted["jmodel"].booster
    max_bin = kw.get("maxBin", 255)
    bounds = jbin.compute_bin_boundaries(x, max_bin, seed=kw.get("seed", 0))
    bins = np.array(jbin.bin_features(jnp.asarray(x), jnp.asarray(bounds)))
    s = jb.raw_scores(x, num_iteration=t).astype(np.float32)
    p = (1.0 / (1.0 + np.exp(-s))).astype(np.float32)
    g, h = (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)
    ref = _split_bins(jb.arrays, t, bounds)
    got = _split_bins(fitted["tmodel"].booster.arrays, t, bounds)
    k = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
             min(len(ref), len(got)))
    params = dict(num_leaves=kw["numLeaves"], max_bin=max_bin,
                  min_data_in_leaf=kw.get("minDataInLeaf", 20),
                  lambda_l1=kw.get("lambdaL1", 0.0),
                  lambda_l2=kw.get("lambdaL2", 0.0))
    assert_tie(bins, g, h, params, k, ref[k] if k < len(ref) else None,
               got[k] if k < len(got) else None)


def test_probabilities_and_auc_match(fitted):
    jp = np.asarray(fitted["jout"]["probability"])
    tp = np.asarray(fitted["tout"]["probability"])
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(fitted["tout"]["prediction"],
                                  fitted["jout"]["prediction"])
    jm = JComputeModelStatistics(labelCol="label").transform(fitted["jout"])
    tm = ComputeModelStatistics(labelCol="label").transform(fitted["tout"])
    assert abs(float(tm["AUC"][0]) - float(jm["AUC"][0])) <= AUC_ATOL
    for k in ("accuracy", "precision", "recall"):
        assert float(tm[k][0]) == pytest.approx(float(jm[k][0]), abs=1e-12)


def test_auc_inside_reference_parity_band(fits):
    fitted = fits("parity_band")
    rows = {}
    with open(PARITY_CSV) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                name, value, tol = line.strip().split(",")
                rows[name] = (float(value), float(tol))
    value, tol = rows["LightGBMClassifier_breast-cancer_gbdt_AUROC"]
    auc = float(ComputeModelStatistics(labelCol="label")
                .transform(fitted["tout"])["AUC"][0])
    assert abs(auc - value) <= tol


def test_booster_from_arrays_same_raw_scores(fitted):
    jb = fitted["jmodel"].booster
    tb = booster_from_arrays(
        jb.arrays, num_class=jb.num_class, objective=jb.objective,
        sigmoid=jb.sigmoid, init_score=jb.init_score,
        feature_names=jb.feature_names, max_depth_bound=jb.max_depth_bound,
        tree_weights=jb.tree_weights)
    np.testing.assert_allclose(tb.raw_scores(fitted["x"], device="cpu"),
                               jb.raw_scores(fitted["x"]), rtol=0,
                               atol=RAW_ATOL)


def test_text_models_cross_both_ways(fitted):
    x = fitted["x"]
    jb, tb = fitted["jmodel"].booster, fitted["tmodel"].booster
    tb_raw = tb.raw_scores(x, device="cpu")
    jb_raw = jb.raw_scores(x)
    # port → JAX
    np.testing.assert_allclose(JBooster.load_native(tb.save_native())
                               .raw_scores(x), tb_raw, rtol=0,
                               atol=RAW_ATOL)
    # JAX → port
    np.testing.assert_allclose(Booster.load_native(jb.save_native())
                               .raw_scores(x, device="cpu"), jb_raw, rtol=0,
                               atol=RAW_ATOL)
    # port → port
    np.testing.assert_allclose(Booster.load_native(tb.save_native())
                               .raw_scores(x, device="cpu"), tb_raw, rtol=0,
                               atol=RAW_ATOL)


def test_stage_save_load_round_trip(fitted, tmp_path):
    path = str(tmp_path / "model")
    fitted["tmodel"].save(path)
    loaded = load_stage(path)
    assert isinstance(loaded, LightGBMClassificationModel)
    assert loaded.getDevice() == "cpu"
    out = loaded.transform(DataFrame({"features": fitted["x"]}))
    np.testing.assert_allclose(np.asarray(out["probability"]),
                               np.asarray(fitted["tout"]["probability"]),
                               rtol=0, atol=PROB_ATOL)


def test_upstream_fixture_scores_same_in_both_packages():
    with open(FIXTURE) as f:
        text = f.read()
    nan = float("nan")
    rows = np.array([[100.0, 0.0, 0.0], [200.0, -2.0, 1.0],
                     [150.0, -1.0, 3.0], [nan, nan, nan],
                     [nan, 5.0, 2.0]], np.float32)
    expected = np.array([0.37, 0.35, 0.02, 0.15, 0.57])   # hand-computed
    jraw = JBooster.load_native(text).raw_scores(rows)
    tmodel = LightGBMClassificationModel.load_native_model_from_string(
        text, device="cpu")
    traw = tmodel.booster.raw_scores(rows, device="cpu")
    np.testing.assert_allclose(traw, expected, atol=1e-6)
    np.testing.assert_allclose(traw, jraw, atol=1e-6)
    out = tmodel.transform(DataFrame({"features": rows}))
    np.testing.assert_allclose(out["probability"][:, 1],
                               1.0 / (1.0 + np.exp(-expected)), atol=1e-6)
    assert tmodel.booster.feature_names == ["age", "income", "region"]
    np.testing.assert_array_equal(tmodel.booster.feature_importances(),
                                  JBooster.load_native(text)
                                  .feature_importances())


def test_leaf_prediction_column_matches(breast_cancer):
    x, y = breast_cancer
    kw = dict(numIterations=3, numLeaves=7)
    jm = JClassifier(numShards=1, **kw) \
        .fit(JDataFrame({"features": x, "label": y}))
    tm = LightGBMClassifier(device="cpu", **kw) \
        .fit(DataFrame({"features": x, "label": y}))
    tm.setLeafPredictionCol("leaves")
    jm.setLeafPredictionCol("leaves")
    np.testing.assert_array_equal(
        tm.transform(DataFrame({"features": x}))["leaves"],
        jm.transform(JDataFrame({"features": x}))["leaves"])


# name → (Params, the error, its words): categorical slots and
# maxBinByFeature raise the JAX package's own refusals of a frame they
# cannot take (breast cancer's slot 0 holds no category ids; 30 features
# need 30 budgets)
OUTSIDE_SLICE = {
    "categorical": (dict(categoricalSlotIndexes=[0]), ValueError,
                    "non-negative integer category ids"),
    "max_bin_by_feature": (dict(maxBinByFeature=[16] * 29), ValueError,
                           "maxBinByFeature has 29 entries for 30"),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE_SLICE))
def test_configs_outside_the_slice_raise(name, breast_cancer):
    x, y = breast_cancer
    df = DataFrame({"features": x[:200], "label": y[:200],
                    "is_val": np.zeros(200, bool),
                    "s": np.zeros(200, np.float32)})
    kw, exc, words = OUTSIDE_SLICE[name]
    with pytest.raises(exc, match=words):
        LightGBMClassifier(device="cpu", numIterations=2, **kw).fit(df)


def _prior_model_string(x, y):
    """A 2-iteration model of the JAX package, as LightGBM text."""
    return JClassifier(numShards=1, numIterations=2, numLeaves=5).fit(
        JDataFrame({"features": x, "label": y})).booster.save_native()


# name → Params of the settings that once raised here, now fitted in both
# packages on the same rows: the same trees and probabilities within
# 1e-5. Rows are weighted: unweighted, batch 1's 285 rows meet a tie that
# the two packages' summation orders break differently. numShards=2 with
# no process group is one shard (the JAX package's clamp to its devices),
# so it is held against a one-shard fit
CONTINUATION = {
    "num_batches": lambda x, y: dict(numBatches=2),
    "shards": lambda x, y: dict(numShards=2),
    "continuation": lambda x, y: dict(modelString=_prior_model_string(x,
                                                                     y)),
    "init_score": lambda x, y: dict(initScoreCol="s"),
}


@pytest.mark.parametrize("name", sorted(CONTINUATION))
def test_continuation_and_shard_settings_match_jax(name, breast_cancer):
    x, y = breast_cancer
    s = np.random.default_rng(3).normal(scale=0.5, size=len(y)) \
        .astype(np.float32)
    cols = {"features": x, "label": y, "s": s, "w": np.random.default_rng(
        1).uniform(0.5, 2.0, len(y)).astype(np.float32)}
    kw = dict(numIterations=3, numLeaves=5, weightCol="w",
              **CONTINUATION[name](x, y))
    tm = LightGBMClassifier(device="cpu", **kw).fit(DataFrame(dict(cols)))
    if name == "shards":
        jm = JClassifier(numIterations=3, numLeaves=5, weightCol="w",
                         numShards=1).fit(JDataFrame(dict(cols)))
    else:
        jm = JClassifier(**kw).fit(JDataFrame(dict(cols)))
    ja, ta = jm.booster.arrays, tm.booster.arrays
    assert tm.booster.num_trees == jm.booster.num_trees
    for k in ("feature", "threshold", "left", "right", "is_leaf",
              "num_nodes"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_allclose(ta["leaf_value"], ja["leaf_value"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tm.transform(DataFrame({"features": x}))["probability"],
        jm.transform(JDataFrame({"features": x}))["probability"],
        rtol=0, atol=PROB_ATOL)


def test_sparse_input_raises():
    """Sparse input fits now; the one configuration of it that raises is
    the JAX package's own refusal, in its words: maxBinByFeature, which
    the sparse binning cannot truncate."""
    frame = {"features_indices": np.zeros((4, 2), np.int32),
             "features_values": np.ones((4, 2), np.float32),
             "label": np.array([0, 1, 0, 1], np.float32)}
    with pytest.raises(NotImplementedError) as jerr:
        JClassifier(numShards=1, maxBinByFeature=[4]).fit(
            JDataFrame(dict(frame)))
    with pytest.raises(NotImplementedError) as terr:
        LightGBMClassifier(device="cpu", maxBinByFeature=[4]).fit(
            DataFrame(dict(frame)))
    assert str(terr.value) == str(jerr.value)
    assert "dense-only" in str(terr.value)


def test_shap_column_raises(fits):
    """SHAP values are ported; on padded-COO input the port keeps the JAX
    package's refusal, in its words."""
    model = fits("parity_band")["tmodel"].copy()
    model.setFeaturesShapCol("shap")
    jmodel = fits("parity_band")["jmodel"].copy()
    jmodel.setFeaturesShapCol("shap")
    coo = {"features_indices": np.zeros((3, 2), np.int32),
           "features_values": np.ones((3, 2), np.float32)}
    with pytest.raises(NotImplementedError) as jerr:
        jmodel.transform(JDataFrame(dict(coo)))
    with pytest.raises(NotImplementedError) as terr:
        model.transform(DataFrame(dict(coo)))
    assert str(terr.value) == str(jerr.value)
    assert "item" not in str(terr.value)


def test_xgboost_dart_mode_raises_the_jax_message(breast_cancer):
    x, y = breast_cancer
    df = {"features": x[:100], "label": y[:100]}
    kw = dict(boostingType="dart", xgboostDartMode=True, numIterations=2)
    with pytest.raises(NotImplementedError) as jerr:
        JClassifier(numShards=1, **kw).fit(JDataFrame(dict(df)))
    with pytest.raises(NotImplementedError) as terr:
        LightGBMClassifier(device="cpu", **kw).fit(DataFrame(dict(df)))
    assert str(terr.value) == str(jerr.value)
    assert "item" not in str(terr.value)
    # inert without dart, as in the JAX package
    LightGBMClassifier(device="cpu", xgboostDartMode=True,
                       numIterations=1).fit(DataFrame(dict(df)))


def test_weighted_fit_matches(breast_cancer):
    x, y = breast_cancer
    w = np.random.default_rng(0).uniform(0.5, 2.0, len(y)).astype(np.float32)
    kw = dict(numIterations=5, numLeaves=7, weightCol="w",
              isUnbalance=True)
    jp = JClassifier(numShards=1, **kw).fit(
        JDataFrame({"features": x, "label": y, "w": w})).transform(
        JDataFrame({"features": x}))["probability"]
    tp = LightGBMClassifier(device="cpu", **kw).fit(
        DataFrame({"features": x, "label": y, "w": w})).transform(
        DataFrame({"features": x}))["probability"]
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_ATOL)


def test_transform_accepts_tensor_columns(fitted):
    x = torch.from_numpy(fitted["x"])
    out = fitted["tmodel"].transform(DataFrame({"features": x}))
    np.testing.assert_allclose(np.asarray(out["probability"]),
                               np.asarray(fitted["tout"]["probability"]),
                               rtol=0, atol=0)
