"""``LightGBMRanker`` (lambdarank) and TreeSHAP against the JAX package.

Held:
- ``build_group_index``: exactly JAX's, truncation included;
- lambdarank gradients and hessians at iteration 0 (every score of a group
  ties, so the stable rank sort decides each document's discount) and at
  a later iteration: within 1e-5 of JAX's;
- ``ndcg_at_k``: JAX's value;
- ``LightGBMRanker`` fits on ``test_benchmarks.py``'s MSLR-shaped frame:
  trees equal JAX's (values within 1e-5), NDCG@k equal to JAX's within
  1e-6, the ``mslr_shaped`` ndcg@1-10 rows of
  ``benchmarks_LightGBMRanker.csv`` (band 0.02); validation NDCG with
  early stopping as JAX's; a categorical slot; save/load and the text
  format;
- ``featuresShapCol``: JAX's ``booster_shap_values`` within 1e-5 and
  summing to the raw score (1e-5), for numeric and categorical trees,
  binary and multiclass.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.lightgbm as jl
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import ranker_objective as jro
import mmlspark_tpu.lightgbm.estimators as jax_est
from mmlspark_tpu.lightgbm.shap import booster_shap_values as jshap
import mmlspark_torch.lightgbm as tl
import mmlspark_torch.lightgbm.estimators as port_est
from mmlspark_torch.core import DataFrame, load_stage
from mmlspark_torch.lightgbm import ranker_objective as tro
from mmlspark_torch.lightgbm.shap import booster_shap_values as tshap
import test_benchmarks

BENCH = os.path.join(os.path.dirname(__file__), "resources", "benchmarks")
GRAD_ATOL = 1e-5
SHAP_ATOL = 1e-5
NDCG_ATOL = 1e-6
RANK_KW = dict(groupCol="query", numIterations=40, numLeaves=15,
               minDataInLeaf=5, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mslr():
    return test_benchmarks.TestRankerBenchmarks.msl_shaped()


_FITS: dict = {}


def rank_both(name, x, rel, qid, **kw):
    """Both packages' rankers on one frame (cached per name)."""
    if name not in _FITS:
        cols = {"features": x, "label": rel, "query": qid}
        jm = jl.LightGBMRanker(numShards=1, **kw).fit(JDataFrame(dict(cols)))
        tm = tl.LightGBMRanker(device="cpu", **kw).fit(DataFrame(dict(cols)))
        _FITS[name] = (jm, tm)
    return _FITS[name]


# ------------------------------------------------------------- objective
@pytest.mark.parametrize("max_size", [None, 12])
def test_build_group_index_matches_jax(max_size):
    rng = np.random.default_rng(0)
    gids = rng.permutation(np.repeat(np.arange(9), rng.integers(1, 20, 9)))
    np.testing.assert_array_equal(
        tro.build_group_index(gids, max_size),
        jro.build_group_index(gids, max_size))


@pytest.mark.parametrize("trunc", [30, 4])
@pytest.mark.parametrize("at", ["iteration0", "later"])
def test_lambdarank_grad_hess_match_jax(at, trunc):
    x, rel, qid = mslr()
    gidx = jro.build_group_index(qid)
    scores = np.zeros(len(rel), np.float32) if at == "iteration0" else \
        (x[:, :4].sum(1) * 0.3).astype(np.float32)
    jg, jh = jro.make_lambdarank_grad_hess(rel, gidx, truncation_level=trunc,
                                           chunk=32)(jnp.asarray(scores))
    tg, th = tro.make_lambdarank_grad_hess(rel, gidx, truncation_level=trunc,
                                           chunk=32)(torch.from_numpy(scores))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=GRAD_ATOL)
    assert np.abs(np.asarray(jg)).max() > 1e-3      # a nontrivial case


def test_ndcg_matches_jax():
    x, rel, qid = mslr()
    s = np.random.default_rng(3).normal(size=len(rel))
    for k in (1, 3, 10, 50):
        assert tro.ndcg_at_k(s, rel, qid, k) == jro.ndcg_at_k(s, rel, qid, k)


# ---------------------------------------------------------------- ranker
def test_ranker_fit_matches_jax_and_its_bands():
    x, rel, qid = mslr()
    jm, tm = rank_both("mslr", x, rel, qid, **RANK_KW)
    ja, ta = jm.booster.arrays, tm.booster.arrays
    for k in ("feature", "threshold", "left", "right", "is_leaf",
              "num_nodes"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_allclose(ta["leaf_value"], ja["leaf_value"],
                               rtol=1e-5, atol=1e-5)
    rows = {}
    with open(os.path.join(BENCH, "benchmarks_LightGBMRanker.csv")) as fh:
        for line in fh:
            name, value, tol = line.strip().split(",")
            rows[name] = (float(value), float(tol))
    df = DataFrame({"features": x, "label": rel, "query": qid})
    jdf = JDataFrame({"features": x, "label": rel, "query": qid})
    for k in (1, 3, 5, 10):
        got = tm.evaluate_ndcg(df, k=k)
        assert got == pytest.approx(jm.evaluate_ndcg(jdf, k=k),
                                    abs=NDCG_ATOL)
        value, tol = rows[f"mslr_shaped.ndcg@{k}"]
        assert abs(got - value) <= tol, (k, got, value)


def test_ranker_surface_and_round_trips(tmp_path):
    x, rel, qid = mslr()
    jm, tm = rank_both("mslr", x, rel, qid, **RANK_KW)
    df = DataFrame({"features": x, "label": rel, "query": qid})
    pred = np.asarray(tm.transform(df)["prediction"])
    np.testing.assert_allclose(pred, np.asarray(jm.transform(JDataFrame(
        {"features": x}))["prediction"]), rtol=0, atol=1e-5)
    assert isinstance(tm, tl.LightGBMRankerModel)
    assert tm.getGroupCol() == "query"
    # the text format, both ways, and the stage
    back = tl.LightGBMRankerModel.loadNativeModelFromString(
        tm.get_native_model_string(), device="cpu")
    np.testing.assert_allclose(back.booster.raw_scores(x, device="cpu"),
                               pred, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        jl.Booster.load_native(tm.get_native_model_string()).raw_scores(x),
        pred, rtol=0, atol=1e-6)
    tm.save(str(tmp_path / "r"))
    loaded = load_stage(str(tmp_path / "r"))
    assert type(loaded) is tl.LightGBMRankerModel
    assert loaded.evaluate_ndcg(df, k=10) == tm.evaluate_ndcg(df, k=10)
    # group ids may be strings, and frames need not arrive sorted
    shuffled = np.random.default_rng(1).permutation(len(rel))
    sdf = DataFrame({"features": x[shuffled], "label": rel[shuffled],
                     "query": np.asarray([f"q{v}" for v in qid[shuffled]],
                                         object)})
    small = tl.LightGBMRanker(device="cpu", groupCol="query",
                              numIterations=3, numLeaves=7).fit(sdf)
    assert 0.0 < small.evaluate_ndcg(sdf, k=10) <= 1.0
    # fit_stream continues one booster over batches of whole query groups;
    # a group seen again in a later batch raises
    b1, b2 = df.filter(qid < 64), df.filter(qid >= 64)
    streamed = tl.LightGBMRanker(device="cpu", groupCol="query",
                                 numIterations=2, numLeaves=7) \
        .fit_stream(iter([b1, b2]))
    assert streamed.booster.num_trees == 4
    with pytest.raises(ValueError, match="span multiple stream batches"):
        tl.LightGBMRanker(device="cpu", groupCol="query",
                          numIterations=1).fit_stream(iter([b1, df]))


def test_ranker_validation_ndcg_and_early_stopping_match_jax(monkeypatch):
    x, rel, qid = mslr()
    flag = qid >= 64
    kw = dict(RANK_KW, numIterations=15, validationIndicatorCol="val",
              earlyStoppingRound=3, maxPosition=5)
    seen = {}
    for mod, key in ((jax_est, "jax"), (port_est, "port")):
        real = mod.train

        def spy(*a, _real=real, _key=key, **k):
            seen[_key] = _real(*a, **k)
            return seen[_key]
        monkeypatch.setattr(mod, "train", spy)
    cols = {"features": x, "label": rel, "query": qid, "val": flag}
    jm = jl.LightGBMRanker(numShards=1, **kw).fit(JDataFrame(dict(cols)))
    tm = tl.LightGBMRanker(device="cpu", **kw).fit(DataFrame(dict(cols)))
    je, te = seen["jax"].evals, seen["port"].evals
    assert [e["iteration"] for e in te] == [e["iteration"] for e in je]
    for a, b in zip(te, je):
        assert a["ndcg"] == pytest.approx(b["ndcg"], abs=NDCG_ATOL)
    assert tm.booster.best_iteration == jm.booster.best_iteration


def test_ranker_with_a_categorical_slot_matches_jax():
    rng = np.random.default_rng(11)
    n_q, docs = 40, 8
    n = n_q * docs
    cat = rng.integers(0, 8, size=n).astype(np.float32)
    num = rng.normal(size=(n, 2)).astype(np.float32)
    rel = (np.isin(cat, [2, 5]) * 2 + (num[:, 0] > 0)).astype(np.float32)
    qid = np.repeat(np.arange(n_q), docs)
    x = np.concatenate([cat[:, None], num], 1)
    jm, tm = rank_both("cat", x, rel, qid, groupCol="query",
                       numIterations=20, numLeaves=7, minDataInLeaf=3,
                       categoricalSlotIndexes=[0])
    assert tm.booster.arrays["cat_flag"].any()
    np.testing.assert_allclose(tm.booster.raw_scores(x, device="cpu"),
                               jm.booster.raw_scores(x), rtol=0, atol=1e-5)


# ------------------------------------------------------------------ SHAP
def _shap_case(kind):
    x, rel, qid = mslr()
    if kind == "ranker":
        return rank_both("mslr", x, rel, qid, **RANK_KW), x[:24]
    rng = np.random.default_rng(4)
    cats = rng.integers(0, 10, size=800).astype(np.float32)
    num = rng.normal(size=(800, 3)).astype(np.float32)
    num[rng.random(800) < 0.05, 1] = np.nan
    xx = np.concatenate([cats[:, None], num], 1)
    if kind == "multiclass":
        y = np.digitize(num[:, 0] + np.isin(cats, [1, 3]), [-0.5, 0.7]
                        ).astype(np.float32)
        kw = dict(objective="multiclass", numIterations=4, numLeaves=7)
    else:
        y = (np.isin(cats, [2, 3, 7]) * 1.5 + num[:, 0] > 0.6).astype(
            np.float32)
        kw = dict(numIterations=6, numLeaves=7, categoricalSlotIndexes=[0])
    jm = jl.LightGBMClassifier(numShards=1, **kw).fit(
        JDataFrame({"features": xx, "label": y}))
    tm = tl.LightGBMClassifier(device="cpu", **kw).fit(
        DataFrame({"features": xx, "label": y}))
    return (jm, tm), xx[:60]


@pytest.mark.parametrize("kind", ["ranker", "categorical", "multiclass"])
def test_shap_values_match_jax_and_sum_to_the_raw_score(kind):
    (jm, tm), rows = _shap_case(kind)
    if kind == "categorical":
        assert tm.booster.arrays["cat_flag"].any()
    F = rows.shape[1]
    got = tshap(tm.booster, rows, F)
    # the JAX function on the port's own booster, and on JAX's
    np.testing.assert_allclose(got, jshap(tm.booster, rows, F), rtol=0,
                               atol=SHAP_ATOL)
    np.testing.assert_allclose(got, jshap(jm.booster, rows, F), rtol=0,
                               atol=SHAP_ATOL)
    raw = tm.booster.raw_scores(rows, device="cpu")
    K = tm.booster.num_class
    sums = got.reshape(len(rows), K, F + 1).sum(-1)
    np.testing.assert_allclose(sums, raw.reshape(len(rows), K), rtol=0,
                               atol=SHAP_ATOL)
    # the featuresShapCol column is the same matrix
    model = tm.copy()
    model.setFeaturesShapCol("shap")
    col = model.transform(DataFrame({"features": rows}))["shap"]
    np.testing.assert_allclose(np.asarray(col), got, rtol=0, atol=0)
