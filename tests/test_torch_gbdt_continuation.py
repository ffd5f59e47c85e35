"""Model continuation against the JAX package: ``numBatches``,
``fit_stream``, ``modelString`` and ``initScoreCol``.

Held, on the same frames in both packages:
- trees by the tree rule: structure (features, thresholds, children,
  category sets) exactly and leaf values within 1e-5, tree weights within
  1e-6; or, on the JAX package's own small frames, where the two
  packages' summation orders break near-ties differently, a proven tie at
  the first differing split: the reference's gains (float64, categorical
  columns in ratio order, ``test_torch_gbdt_categorical.py``'s landscape)
  over that batch's rows at the scores of the reference's earlier trees,
  prior batches' included, whose top two and both choices agree within
  1e-5. The other frames weight their rows and are held exactly;
- the JAX package's own frames and asserts: ``tests/test_lightgbm.py:
  211-217`` (two batches, 40 trees, AUC > 0.9), ``tests/
  test_out_of_core.py:59-82, 155-190`` (four batches streamed against
  ``numBatches``, an empty stream, the model's parent, the ranker's
  straddling groups and whole-group stream), ``tests/
  test_lightgbm_categorical.py:282-302`` (slot names through metadata over
  two batches, accuracy > 0.95);
- a ``modelString`` saved by the JAX package, continued in both;
- ``initScoreCol`` on training and validation rows with early stopping,
  and ``best_iteration`` offset by the prior iterations;
- continuation across every objective family, boosting mode and input
  form the port trains: multiclass and OVA, the regressor's
  objectives, DART, rf, categorical slots, padded-COO rows and the
  ranker; GOSS, whose rows the JAX package draws from ``jax.random``, by
  the trees' count and AUC within 5e-3;
- ``merge_boosters`` against the JAX package's on arrays with and
  without categorical splits, of different node counts and bin widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import load_breast_cancer, load_wine, make_classification

import mmlspark_tpu.lightgbm as jl
from mmlspark_tpu.core import ColumnMetadata as JColumnMetadata
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_tpu.lightgbm import engine as jeng
from mmlspark_tpu.lightgbm import objectives as jobj
from mmlspark_tpu.lightgbm import ranker_objective as jro
from mmlspark_tpu.lightgbm.booster import merge_boosters as jmerge
import mmlspark_torch.lightgbm as tl
from mmlspark_torch.core import ColumnMetadata, DataFrame
from mmlspark_torch.lightgbm.booster import Booster, merge_boosters
from mmlspark_torch.lightgbm.trainer import roc_auc
from test_lightgbm_sparse import dense_to_coo
from test_torch_gbdt_categorical import (STRUCTURE, TIE_RTOL, _boundaries,
                                         _gain64, _splits, gain_landscape,
                                         set_gain)

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
PROB_ATOL = 1e-5
GOSS_AUC_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_trees(jb, tb):
    """The tree rule, tree by tree, with the init score and weights."""
    ja, ta = jb.arrays, tb.arrays
    assert ta["feature"].shape == ja["feature"].shape
    for k in ("feature", "threshold", "left", "right", "is_leaf",
              "num_nodes", "cat_flag", "cat_left"):
        assert (k in ta) == (k in ja), k
        if k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_allclose(ta["leaf_value"], ja["leaf_value"],
                               **VALUE_TOL)
    np.testing.assert_allclose(tb.tree_weights, jb.tree_weights, rtol=1e-6)
    np.testing.assert_allclose(tb.init_score, jb.init_score, rtol=1e-6)
    assert tb.best_iteration == jb.best_iteration


def trees_match_or_tie(jb, tb, batches, p, grads, iters, K=1):
    """Every tree equal (the tree rule), or at the first tree that
    differs a proven tie at its first differing split. ``batches`` holds
    each batch's feature rows in order, ``iters`` its iterations;
    ``grads(s, b)`` gives the f32 (grad, hess) of batch b's rows at
    scores ``s`` ([n] or [n, K]). The tie's scale is the larger of the top
    gain and the parent's term, so that a split of a pure node, whose
    gains are rounding noise, counts. Returns the tree that tied, or
    None."""
    ja, ta = jb.arrays, tb.arrays
    assert ja["feature"].shape == ta["feature"].shape
    for t in range(ja["feature"].shape[0]):
        if all(np.array_equal(ja[k][t], ta[k][t]) for k in STRUCTURE
               if k in ja):
            np.testing.assert_allclose(ta["leaf_value"][t],
                                       ja["leaf_value"][t], **VALUE_TOL)
            continue
        it = t // K
        x = batches[it // iters]
        g, h = grads(jb.raw_scores(x, num_iteration=it).astype(np.float32),
                     it // iters)
        if K > 1:
            g, h = g[:, t % K], h[:, t % K]
        bounds = _boundaries(x, p.max_bin, p.cat_features)
        bins = np.array(jbin.bin_features(jnp.asarray(x),
                                          jnp.asarray(bounds)))
        ref, got = _splits(ja, t, bounds), _splits(ta, t, bounds)
        k = next(i for i, (u, v) in enumerate(zip(ref + [None],
                                                  got + [None])) if u != v)
        land, leaf = gain_landscape(bins, g, h, p, k)
        best = max(land, key=land.get)
        top2 = sorted(land.values())[-2:]
        for choice in [best] + ref[k:k + 1] + got[k:k + 1]:
            rows = leaf == choice[0]
            scale = max(abs(top2[1]), _gain64(
                g[rows].astype(np.float64).sum(),
                h[rows].astype(np.float64).sum(), p))
            gi = set_gain(bins, g, h, p, leaf, choice)
            assert top2[1] - gi <= TIE_RTOL * scale, (
                f"tree {t} split {k} differs ({ref[k:k + 1]} vs "
                f"{got[k:k + 1]}) but {choice}'s gain {gi} does not tie "
                f"the top {top2[1]}")
        assert top2[1] - top2[0] <= TIE_RTOL * scale
        return t
    return None


def objective_grads(obj, labels, weights=None):
    """``grads`` for ``trees_match_or_tie`` from a JAX objective and each
    batch's labels (and weights)."""
    def grads(s, b):
        w = np.ones(len(labels[b]), np.float32) if weights is None \
            else weights[b]
        g, h = obj.grad_hess(jnp.asarray(s), jnp.asarray(labels[b]),
                             jnp.asarray(w))
        return np.asarray(g, np.float32), np.asarray(h, np.float32)
    return grads


def fit_both(est, cols, **kw):
    jm = getattr(jl, est)(numShards=1, **kw).fit(JDataFrame(dict(cols)))
    tm = getattr(tl, est)(device="cpu", **kw).fit(DataFrame(dict(cols)))
    assert_same_trees(jm.booster, tm.booster)
    return jm, tm


def _weights(n):
    return np.random.default_rng(1).uniform(0.5, 2.0, n).astype(np.float32)


def _cancer():
    d = load_breast_cancer()
    return {"features": d.data.astype(np.float32),
            "label": d.target.astype(np.float32),
            "w": _weights(len(d.target))}


# ------------------------------------------------- the JAX package's frames
def classification_cols(n=400, seed=0):
    """``tests/test_lightgbm.py``'s ``classification_df``."""
    x, y = make_classification(n_samples=n, n_features=10, n_informative=5,
                               random_state=seed)
    return {"features": x.astype(np.float32), "label": y.astype(np.float32)}


def out_of_core_cols(n=4000, seed=0):
    """``tests/test_out_of_core.py``'s ``make_df``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    y = ((x[:, 0] * 2 - x[:, 1] + 0.5 * x[:, 2]
          + rng.normal(scale=0.4, size=n)) > 0).astype(np.float64)
    return {"features": x, "label": y}


def test_two_batches_match_jax():
    cols = classification_cols()
    kw = dict(numIterations=20, numLeaves=7, minDataInLeaf=5,
              learningRate=0.2, numBatches=2)
    jm = jl.LightGBMClassifier(numShards=1, **kw).fit(JDataFrame(cols))
    tm = tl.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    assert tm.booster.num_trees == 40
    halves = (slice(0, 200), slice(200, 400))
    trees_match_or_tie(
        jm.booster, tm.booster, [cols["features"][s] for s in halves],
        jeng.TreeParams(num_leaves=7, min_data_in_leaf=5),
        objective_grads(jobj.get_objective("binary"),
                        [cols["label"][s] for s in halves]), 20)
    out = tm.transform(DataFrame(cols))
    assert roc_auc(cols["label"], out["probability"][:, 1]) > 0.9


def test_four_batches_and_their_stream_match_jax():
    cols = out_of_core_cols()
    kw = dict(numIterations=10, numLeaves=15, minDataInLeaf=5, seed=0)
    _, batched = fit_both("LightGBMClassifier", cols, numBatches=4, **kw)
    est = tl.LightGBMClassifier(device="cpu", **kw)
    streamed = est.fit_stream(iter(DataFrame(cols).repartition(4)
                                   .partitions()))
    assert streamed.parent is est
    assert streamed.booster.num_trees == 40
    assert streamed.get_native_model_string() == \
        batched.get_native_model_string()
    auc = roc_auc(cols["label"], streamed.transform(DataFrame(cols))[
        "probability"][:, 1])
    assert auc > 0.9


def test_continuation_paths_agree():
    """numBatches and fit_stream give the same model text; a modelString
    continuation of batch 1's saved text grows the same trees (the text
    folds the init score into the first tree's leaves, so its scores
    differ from the model's in the last bits, as the JAX package's do),
    and an initScoreCol fit from batch 1's raw scores grows the
    continuation's trees (only its init score differs). Trees are held by
    structure exactly and leaf values within 1e-5."""
    cols = out_of_core_cols(2000)
    df = DataFrame(cols)
    parts = df.repartition(2).partitions()

    def make(**kw):
        return tl.LightGBMClassifier(device="cpu", numIterations=5,
                                     numLeaves=15, **kw)
    batched = make(numBatches=2).fit(df)
    streamed = make().fit_stream(iter(parts))
    assert batched.get_native_model_string() == \
        streamed.get_native_model_string()
    first = make().fit(parts[0]).booster
    text1 = first.save_native()
    cont = make(modelString=text1).fit(parts[1])
    x2 = parts[1]["features"]
    init = first.raw_scores(x2, device="cpu")
    np.testing.assert_allclose(
        Booster.load_native(text1).raw_scores(x2, device="cpu"), init,
        rtol=0, atol=1e-6)
    warm = make(initScoreCol="s").fit(parts[1].with_column("s", init))
    # the first pair through their texts, which share one node layout
    for got, want, lo in ((Booster.load_native(
            cont.get_native_model_string()), Booster.load_native(
            batched.get_native_model_string()), 0),
            (warm.booster, cont.booster, 5)):
        for k in ("feature", "threshold", "left", "right", "is_leaf",
                  "num_nodes"):
            np.testing.assert_array_equal(got.arrays[k], want.arrays[k][lo:],
                                          k)
        np.testing.assert_allclose(got.arrays["leaf_value"],
                                   want.arrays["leaf_value"][lo:],
                                   **VALUE_TOL)


def test_empty_stream_raises():
    with pytest.raises(ValueError, match="empty"):
        tl.LightGBMClassifier(device="cpu").fit_stream(iter([]))


def test_ranker_stream_guard_and_whole_groups_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    rel = rng.integers(0, 3, size=60).astype(np.float32)
    qid = np.repeat(np.arange(6), 10)
    parts = [DataFrame({"features": x[s], "label": rel[s], "query": qid[s]})
             for s in (slice(0, 35), slice(35, 60))]   # group 3 straddles
    r = tl.LightGBMRanker(device="cpu", groupCol="query", numIterations=3,
                          numLeaves=7, minDataInLeaf=2)
    with pytest.raises(ValueError, match="span"):
        r.fit_stream(iter(parts))

    rng = np.random.default_rng(1)
    x = rng.normal(size=(80, 4)).astype(np.float32)
    rel = np.clip((x[:, 0] * 2).round(), 0, 3).astype(np.float32)
    qid = np.repeat(np.arange(8), 10)
    kw = dict(groupCol="query", numIterations=5, numLeaves=7,
              minDataInLeaf=2)
    halves = (slice(0, 40), slice(40, 80))
    jm = jl.LightGBMRanker(**kw).fit_stream(iter(
        JDataFrame({"features": x[s], "label": rel[s], "query": qid[s]})
        for s in halves))
    tm = tl.LightGBMRanker(device="cpu", **kw).fit_stream(iter(
        DataFrame({"features": x[s], "label": rel[s], "query": qid[s]})
        for s in halves))
    lambdarank = [jro.make_lambdarank_grad_hess(
        rel[s], jro.build_group_index(qid[s]))
        for s in halves]

    def grads(scores, b):
        g, h = lambdarank[b](jnp.asarray(scores))
        return np.asarray(g, np.float32), np.asarray(h, np.float32)
    trees_match_or_tie(jm.booster, tm.booster, [x[s] for s in halves],
                       jeng.TreeParams(num_leaves=7, min_data_in_leaf=2),
                       grads, 5)
    full = DataFrame({"features": x, "label": rel, "query": qid})
    assert tm.evaluate_ndcg(full, k=5) > 0.7


def test_categorical_slot_names_over_two_batches():
    rng = np.random.default_rng(7)
    n = 1200
    color = rng.choice(list("abcdefgh"), size=n)
    num = rng.normal(size=n).astype(np.float32)
    y = (np.isin(color, list("adf")) ^ (num > 1.0)).astype(np.float32)
    levels = sorted(set(color))
    idx = np.asarray([levels.index(c) for c in color], np.float32)
    feats = np.stack([idx, num], 1)
    kw = dict(numIterations=20, numLeaves=8, minDataInLeaf=5, numBatches=2,
              categoricalSlotNames=["color"])
    models = []
    for frame, meta, pkg in ((JDataFrame, JColumnMetadata, jl),
                             (DataFrame, ColumnMetadata, tl)):
        df = frame({"features": feats, "label": y})
        meta.attach(df, "features", {"slot_names": ["color", "num"]})
        df = df.filter(np.ones(n, bool)).repartition(3)
        extra = {} if pkg is jl else dict(device="cpu")
        models.append(pkg.LightGBMClassifier(**kw, **extra).fit(df))
    halves = [slice(0, 600), slice(600, 1200)]
    trees_match_or_tie(
        models[0].booster, models[1].booster, [feats[s] for s in halves],
        jeng.TreeParams(num_leaves=8, min_data_in_leaf=5, cat_features=(0,)),
        objective_grads(jobj.get_objective("binary"),
                        [y[s] for s in halves]), 20)
    pred = np.asarray(models[1].transform(DataFrame(
        {"features": feats}))["prediction"])
    assert float((pred == y).mean()) > 0.95


# ----------------------------------------------------- warm starts
def test_model_string_from_a_jax_model():
    cols = _cancer()
    half = {k: v[:300] for k, v in cols.items()}
    rest = {k: v[300:] for k, v in cols.items()}
    prior = jl.LightGBMClassifier(numShards=1, numIterations=4, numLeaves=5,
                                  weightCol="w").fit(JDataFrame(half))
    text = prior.booster.save_native()
    jm, tm = fit_both("LightGBMClassifier", rest, numIterations=4,
                      numLeaves=5, weightCol="w", modelString=text)
    assert tm.booster.num_trees == 8
    np.testing.assert_allclose(
        tm.transform(DataFrame(cols))["probability"],
        jm.transform(JDataFrame(cols))["probability"], rtol=0,
        atol=PROB_ATOL)


@pytest.mark.parametrize("prior", [False, True])
def test_init_score_column_and_best_iteration(prior):
    """initScoreCol on training and validation rows with early stopping;
    with a ``modelString`` too, ``best_iteration`` counts the prior
    model's iterations (``initScoreCol`` takes precedence for the
    scores, the prior's trees still lead the merged model)."""
    cols = _cancer()
    n = len(cols["label"])
    cols["s"] = np.random.default_rng(3).normal(scale=0.5, size=n) \
        .astype(np.float32)
    cols["val"] = np.random.default_rng(4).random(n) < 0.3
    kw = dict(numIterations=30, numLeaves=5, weightCol="w",
              initScoreCol="s", validationIndicatorCol="val",
              earlyStoppingRound=3, learningRate=0.3)
    if prior:
        kw["modelString"] = jl.LightGBMClassifier(
            numShards=1, numIterations=3, numLeaves=5).fit(JDataFrame(
                {"features": cols["features"],
                 "label": cols["label"]})).booster.save_native()
    jm, tm = fit_both("LightGBMClassifier", cols, **kw)
    assert tm.booster.best_iteration >= (3 if prior else 0)
    assert tm.booster.num_trees < (33 if prior else 30)


# name → (estimator, columns, Params): two batches of each kind
def _wine():
    """Wine in a seeded order, so each batch holds every class."""
    d = load_wine()
    order = np.random.default_rng(0).permutation(len(d.target))
    return {"features": d.data[order].astype(np.float32),
            "label": d.target[order].astype(np.float32),
            "w": _weights(len(d.target))}


def _diabetes(positive=False):
    from sklearn.datasets import load_diabetes
    d = load_diabetes()
    return {"features": d.data.astype(np.float32),
            "label": d.target.astype(np.float32)}


def _sparse():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 12)).astype(np.float32)
    x[rng.random(x.shape) > 0.4] = 0.0
    y = ((x[:, 0] * 2 - x[:, 1] + x[:, 2]
          + rng.normal(scale=0.3, size=600)) > 0).astype(np.float32)
    idx, val = dense_to_coo(x)
    return {"features_indices": idx, "features_values": val, "label": y,
            "w": _weights(600)}


def _categorical():
    rng = np.random.default_rng(11)
    n = 800
    cat = rng.integers(0, 12, size=n).astype(np.float32)
    num = rng.normal(size=n).astype(np.float32)
    y = ((np.isin(cat, [1, 4, 7, 9]) * 1.5 + num
          + rng.normal(scale=0.5, size=n)) > 0.7).astype(np.float32)
    return {"features": np.stack([cat, num], 1), "label": y,
            "w": _weights(n)}


def _ranking():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    util = x @ rng.normal(size=6) + rng.normal(scale=1.0, size=400)
    rel = np.digitize(util, np.quantile(util, [0.5, 0.8, 0.95]))
    return {"features": x, "label": rel.astype(np.float32),
            "query": np.repeat(np.arange(40), 10)}


BATCHED = {
    "multiclass": ("LightGBMClassifier", _wine,
                   dict(objective="multiclass", numLeaves=5, minDataInLeaf=5,
                        weightCol="w")),
    "ova": ("LightGBMClassifier", _wine,
            dict(objective="multiclassova", numLeaves=5, minDataInLeaf=5,
                 weightCol="w")),
    "dart": ("LightGBMClassifier", _cancer,
             dict(boostingType="dart", numLeaves=5, weightCol="w",
                  skipDrop=0.0)),
    "rf": ("LightGBMClassifier", _cancer,
           dict(boostingType="rf", numLeaves=5, weightCol="w",
                baggingFraction=0.8, baggingFreq=1)),
    "regression": ("LightGBMRegressor", _diabetes, dict(numLeaves=5)),
    "quantile": ("LightGBMRegressor", _diabetes,
                 dict(objective="quantile", numLeaves=5)),
    "huber": ("LightGBMRegressor", _diabetes,
              dict(objective="huber", alpha=20.0, numLeaves=5)),
    "categorical": ("LightGBMClassifier", _categorical,
                    dict(numLeaves=7, categoricalSlotIndexes=[0],
                         weightCol="w")),
    "sparse": ("LightGBMClassifier", _sparse,
               dict(numLeaves=7, minDataInLeaf=5, weightCol="w")),
    "ranker": ("LightGBMRanker", _ranking,
               dict(groupCol="query", numLeaves=7, minDataInLeaf=5)),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_two_batches_of_every_kind_match_jax(name):
    """Each kind over two batches; the multiclass kinds, whose first
    iteration gives every row of a class one gradient, by the tree rule
    with the tie proof (softmax or per-class sigmoid gradients of the
    reference's earlier trees)."""
    est, make, kw = BATCHED[name]
    cols = make()
    if name not in ("multiclass", "ova"):
        fit_both(est, cols, numIterations=5, numBatches=2, **kw)
        return
    kw = dict(kw, numIterations=5, numBatches=2)
    jm = jl.LightGBMClassifier(numShards=1, **kw).fit(JDataFrame(cols))
    tm = tl.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    n = len(cols["label"])
    halves = (slice(0, n - n // 2), slice(n - n // 2, n))
    trees_match_or_tie(
        jm.booster, tm.booster, [cols["features"][s] for s in halves],
        jeng.TreeParams(num_leaves=5, min_data_in_leaf=5),
        objective_grads(jobj.get_objective(kw["objective"], num_class=3),
                        [cols["label"][s] for s in halves],
                        [cols["w"][s] for s in halves]), 5, K=3)


def test_goss_continuation_by_auc():
    cols = _cancer()
    kw = dict(numIterations=8, numLeaves=5, boostingType="goss",
              numBatches=2)
    jm = jl.LightGBMClassifier(numShards=1, **kw).fit(JDataFrame(cols))
    tm = tl.LightGBMClassifier(device="cpu", **kw).fit(DataFrame(cols))
    assert tm.booster.num_trees == jm.booster.num_trees == 16
    auc = [roc_auc(cols["label"], np.asarray(m.transform(f(
        {"features": cols["features"]}))["probability"])[:, 1])
        for m, f in ((jm, JDataFrame), (tm, DataFrame))]
    assert abs(auc[0] - auc[1]) <= GOSS_AUC_ATOL, auc


# ----------------------------------------------------------- merge_boosters
def _arrays(T, NN, B=None, seed=0):
    rng = np.random.default_rng(seed)
    arr = {k: rng.normal(size=(T, NN)).astype(np.float32)
           for k in ("threshold", "leaf_value", "split_gain", "node_weight",
                     "node_count", "node_value")}
    arr.update(feature=rng.integers(0, 4, (T, NN)).astype(np.int32),
               left=rng.integers(-1, NN, (T, NN)).astype(np.int32),
               right=rng.integers(-1, NN, (T, NN)).astype(np.int32),
               is_leaf=rng.random((T, NN)) < 0.5,
               num_nodes=np.full(T, NN, np.int32))
    if B is not None:
        arr["cat_flag"] = rng.random((T, NN)) < 0.3
        arr["cat_left"] = rng.random((T, NN, B)) < 0.5
    return arr


@pytest.mark.parametrize("first, second", [
    ((2, 9, None), (3, 13, None)), ((2, 13, 8), (1, 9, None)),
    ((2, 9, None), (2, 9, 16)), ((1, 9, 16), (2, 13, 8))])
def test_merge_boosters_matches_jax(first, second):
    kw1 = dict(num_class=1, objective="binary", init_score=0.25,
               tree_weights=np.asarray([0.5] * first[0], np.float32),
               average_output=False, max_depth_bound=5)
    kw2 = dict(num_class=1, objective="regression", init_score=0.0,
               max_depth_bound=7)
    a, b = _arrays(*first, seed=1), _arrays(*second, seed=2)
    got = merge_boosters(Booster(dict(a), **kw1), Booster(dict(b), **kw2))
    want = jmerge(jl.Booster(dict(a), **kw1), jl.Booster(dict(b), **kw2))
    assert set(got.arrays) == set(want.arrays)
    for k, v in want.arrays.items():
        np.testing.assert_array_equal(got.arrays[k], v, err_msg=k)
    np.testing.assert_array_equal(got.tree_weights, want.tree_weights)
    assert (got.objective, float(got.init_score), got.max_depth_bound,
            got.average_output) == (want.objective, float(want.init_score),
                                    want.max_depth_bound,
                                    want.average_output)
