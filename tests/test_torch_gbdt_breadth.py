"""GBDT breadth against the JAX package: multiclass and OVA, the regressor
with every objective, validation sets and early stopping, bagging,
``featureFraction``, DART, rf and GOSS.

Held:
- trees by ``test_torch_lightgbm.py``'s rule: structure exact and leaf
  values within 1e-5, or, at the first tree that differs, a proven tie:
  the reference's inputs to that tree (scores, the bagging and feature
  masks and DART's drop set, replayed from the two host generators in the
  JAX package's order) give gains whose top two, and both packages'
  choices, agree within 1e-5 of the gains' scale (the parent's term, so
  that a split of a pure node, whose gains are rounding noise, counts);
- probabilities within 1e-5 where every tree matched, and regressor
  predictions within 1e-4 relative, for all nine regression objectives on
  ``load_diabetes`` and on ``test_benchmarks.tabular(seed=1)``;
- the breast-cancer gbdt, rf, dart and goss fits inside their
  ``benchmarks_ReferenceParity.csv`` bands (the synthetic benchmark bands
  and the sklearn oracle are in ``test_torch_gbdt_bands.py``);
- GOSS, whose rows the JAX package draws from ``jax.random``, by the
  parity band, |ΔAUC| <= 5e-3 against the JAX fit, and its mask's
  invariants (exactly ``top_n`` rows at 1 and ``other_n`` at
  (1 - top_rate)/other_rate);
- ``evals`` (the same entries, iterations and keys, metrics within 1e-5)
  and ``best_iteration`` for every device metric, early stopping included;
- ``delegate`` hooks and ``fobj`` against the JAX package.

Rows are weighted in the multiclass cases held to probabilities: at
iteration 0 every row of a class has the same gradient, so gains of
different thresholds with equal class counts tie exactly and the two
packages' summation orders break them differently; the unweighted cases
are held to the tree rule, which proves those ties.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import (load_breast_cancer, load_diabetes,
                              load_digits, load_wine)

import mmlspark_tpu.lightgbm as jl
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_tpu.lightgbm import objectives as jobj
from mmlspark_tpu.lightgbm import trainer as jtr
from mmlspark_tpu.train.statistics import \
    ComputeModelStatistics as JComputeModelStatistics
import mmlspark_torch.lightgbm as tl
from mmlspark_torch.core import DataFrame
from mmlspark_torch.lightgbm import trainer as ttr
from mmlspark_torch.train import ComputeModelStatistics
from test_benchmarks import tabular

HERE = os.path.dirname(__file__)
BENCH = os.path.join(HERE, "resources", "benchmarks")
PROB_ATOL = 1e-5
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_RTOL = 1e-5
METRIC_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(loader):
    d = loader()
    return d.data.astype(np.float32), d.target.astype(np.float32)


DATA = {"cancer": lambda: _data(load_breast_cancer),
        "digits": lambda: _data(load_digits),
        "wine": lambda: _data(load_wine),
        "diabetes": lambda: _data(load_diabetes),
        "tabular_reg": lambda: tabular(seed=1)[::2]}
_DATA_CACHE: dict = {}


def data(name):
    if name not in _DATA_CACHE:
        _DATA_CACHE[name] = DATA[name]()
    return _DATA_CACHE[name]


def _weights(n):
    return np.random.default_rng(1).uniform(0.5, 2.0, n).astype(np.float32)


# name → (estimator, data, Params, weighted); every fit runs in both
# packages once per module
FITS = {
    # breast cancer, the parity CSV's base model (5 leaves, 10 iterations)
    "bagging": ("LightGBMClassifier", "cancer",
                dict(numIterations=10, numLeaves=5, baggingFraction=0.8,
                     baggingFreq=1), False),
    "bagging_freq3": ("LightGBMClassifier", "cancer",
                      dict(numIterations=10, numLeaves=7,
                           baggingFraction=0.7, baggingFreq=3,
                           baggingSeed=11), False),
    "stratified": ("LightGBMClassifier", "cancer",
                   dict(numIterations=8, numLeaves=5, posBaggingFraction=0.7,
                        negBaggingFraction=0.9, baggingFreq=2), False),
    "feature_fraction": ("LightGBMClassifier", "cancer",
                         dict(numIterations=10, numLeaves=5,
                              featureFraction=0.6, seed=4), False),
    "dart": ("LightGBMClassifier", "cancer",
             dict(numIterations=10, numLeaves=5, boostingType="dart"),
             False),
    "dart_ff": ("LightGBMClassifier", "cancer",
                dict(numIterations=10, numLeaves=5, boostingType="dart",
                     featureFraction=0.7, dropRate=0.3, skipDrop=0.2),
                False),
    "dart_bagging": ("LightGBMClassifier", "cancer",
                     dict(numIterations=10, numLeaves=5, boostingType="dart",
                          baggingFraction=0.8, baggingFreq=2,
                          skipDrop=0.0), False),
    "rf": ("LightGBMClassifier", "cancer",
           dict(numIterations=5, numLeaves=5, boostingType="rf",
                baggingFraction=0.9, baggingFreq=1), False),
    "rf_band": ("LightGBMClassifier", "cancer",
                dict(numIterations=10, numLeaves=5, boostingType="rf",
                     baggingFraction=0.9, baggingFreq=1, seed=0), False),
    "dart_band": ("LightGBMClassifier", "cancer",
                  dict(numIterations=10, numLeaves=5, boostingType="dart",
                       seed=0), False),
    "gbdt_band": ("LightGBMClassifier", "cancer",
                  dict(numIterations=10, numLeaves=5, seed=0), False),
    "goss_band": ("LightGBMClassifier", "cancer",
                  dict(numIterations=10, numLeaves=5, boostingType="goss",
                       seed=0), False),
    # multiclass and one-vs-all
    "multiclass_wine": ("LightGBMClassifier", "wine",
                        dict(numIterations=8, numLeaves=5, minDataInLeaf=5,
                             objective="multiclass", weightCol="w"), True),
    "ova_wine": ("LightGBMClassifier", "wine",
                 dict(numIterations=8, numLeaves=5, minDataInLeaf=5,
                      objective="multiclassova", weightCol="w"), True),
    "multiclass_digits": ("LightGBMClassifier", "digits",
                          dict(numIterations=3, numLeaves=5,
                               objective="multiclass", weightCol="w"), True),
    "ova_digits_bagging": ("LightGBMClassifier", "digits",
                           dict(numIterations=2, numLeaves=5,
                                objective="multiclassova",
                                baggingFraction=0.8, baggingFreq=1,
                                featureFraction=0.8, weightCol="w"), True),
    "multiclass_wine_ties": ("LightGBMClassifier", "wine",
                             dict(numIterations=3, numLeaves=5,
                                  objective="multiclass"), False),
    "ova_wine_ties": ("LightGBMClassifier", "wine",
                      dict(numIterations=3, numLeaves=5,
                           objective="multiclassova"), False),
}
REGRESSION_OBJECTIVES = ("regression", "regression_l1", "huber", "fair",
                         "poisson", "gamma", "tweedie", "quantile", "mape")
for _o in REGRESSION_OBJECTIVES:
    # fair's hessians c²/(|r| + c)² at the diabetes targets' scale (std
    # 77) are ~1e-5 at c = 1, so each leaf -Σg/Σh amplifies an ulp of the
    # scores a thousandfold from tree to tree: fairC matches the scale
    extra = dict(fairC=50.0) if _o == "fair" else {}
    FITS[f"reg_{_o}"] = ("LightGBMRegressor", "diabetes",
                         dict(numIterations=8, numLeaves=5, objective=_o,
                              **extra), False)
    FITS[f"tab_{_o}"] = ("LightGBMRegressor", "tabular_reg",
                         dict(numIterations=8, numLeaves=7, objective=_o),
                         False)
_FIT_CACHE: dict = {}


def _positive_targets(name):
    """poisson, gamma and tweedie need y > 0: shift the targets."""
    return name.split("_", 1)[1] in ("poisson", "gamma", "tweedie")


def fit(name):
    """name → both packages' models (cached for the module)."""
    if name not in _FIT_CACHE:
        est, dname, kw, weighted = FITS[name]
        x, y = data(dname)
        if est == "LightGBMRegressor" and _positive_targets(name):
            y = y - y.min() + 1.0 if dname == "tabular_reg" else y
        cols = {"features": x, "label": y}
        if weighted:
            cols["w"] = _weights(len(y))
        jest = getattr(jl, est)(numShards=1, **kw)
        jm = jest.fit(JDataFrame(dict(cols)))
        tm = getattr(tl, est)(device="cpu", **kw).fit(DataFrame(dict(cols)))
        _FIT_CACHE[name] = dict(name=name, est=est, kw=kw, x=x, y=y,
                                w=cols.get("w"), jest=jest, jm=jm, tm=tm)
    return _FIT_CACHE[name]


# ----------------------------------------------------- the tie proof
def _replay(f, it):
    """The reference's host draws up to iteration ``it``: (dropped, the
    tree weights at the start of ``it``, feature mask, row mask)."""
    jm, jest = f["jm"], f["jest"]
    cfg = jtr.TrainConfig(**jest._train_config_kwargs(),
                          **jest._objective_config(f["y"]))
    n, F = f["x"].shape
    K = jm.booster.num_class if cfg.objective.startswith("multiclass") \
        else 1
    rng = np.random.default_rng(cfg.seed)
    bag_rng = np.random.default_rng(cfg.bagging_seed)
    strat = (cfg.pos_bagging_fraction != 1.0
             or cfg.neg_bagging_fraction != 1.0)
    active = cfg.bagging_fraction < 1.0 or strat
    dart, rf = cfg.boosting_type == "dart", cfg.boosting_type == "rf"

    def draw():
        u = bag_rng.random(n)
        if strat:
            thr = np.where(f["y"] > 0, np.float32(cfg.pos_bagging_fraction),
                           np.float32(cfg.neg_bagging_fraction))
            return (u < thr).astype(np.float32)
        return (u < cfg.bagging_fraction).astype(np.float32)

    weights: list = []
    bag = np.ones(n, np.float32)
    for i in range(it + 1):
        dropped = jtr._dart_drop_set(rng, cfg, len(weights)) if dart \
            else []
        fm = np.ones(F, bool)
        if cfg.feature_fraction < 1.0:
            fm = np.zeros(F, bool)
            fm[rng.choice(F, size=max(1, int(round(
                cfg.feature_fraction * F))), replace=False)] = True
        if dart:
            if cfg.bagging_freq > 0 and active and \
                    i % max(cfg.bagging_freq, 1) == 0:
                bag = draw()
        elif (rf or cfg.bagging_freq > 0) and active:
            if rf or i % max(cfg.bagging_freq, 1) == 0:
                bag = draw()
        if i == it:
            return cfg, K, dropped, list(weights), fm, bag
        if dropped:
            factor = np.float32(len(dropped) / (len(dropped) + 1.0))
            for d in dropped:
                weights[d] = np.float32(weights[d] * factor)
            weights += [np.float32(1.0 / (len(dropped) + 1))] * K
        else:
            weights += [np.float32(1.0)] * K


def _inputs(f, t):
    """The reference's (g, h, row mask, feature mask, K) for tree t, from
    its trees' per-row outputs (float64 sums of float32 values)."""
    jb = f["jm"].booster
    it = t // max(jb.num_class, 1)
    cfg, K, dropped, weights, fm, rm = _replay(f, it)
    x, y = f["x"], f["y"]
    n = len(y)
    w = np.ones(n, np.float32) if f["w"] is None else f["w"]
    base = np.asarray(jb.init_score, np.float64).reshape(-1)
    scores = np.zeros((n, K)) + base[:K]
    if cfg.boosting_type != "rf" and it > 0:
        nodes = np.asarray(jb._leaf_nodes(x, it * K))
        lv = jb.arrays["leaf_value"]
        for s in range(it * K):
            coeff = weights[s] if cfg.boosting_type == "dart" else 1.0
            if s in dropped:
                coeff = 0.0
            scores[:, s % K] += coeff * lv[s, nodes[:, s]].astype(np.float64)
    pos_weight = cfg.scale_pos_weight
    obj = jobj.get_objective(
        cfg.objective, num_class=cfg.num_class, alpha=cfg.alpha,
        fair_c=cfg.fair_c,
        tweedie_variance_power=cfg.tweedie_variance_power,
        sigmoid=cfg.sigmoid, pos_weight=pos_weight,
        boost_from_average=cfg.boost_from_average)
    s32 = scores.astype(np.float32)
    g, h = obj.grad_hess(jnp.asarray(s32 if K > 1 else s32[:, 0]),
                         jnp.asarray(y), jnp.asarray(w))
    g, h = np.asarray(g, np.float64), np.asarray(h, np.float64)
    if K > 1:
        g, h = g[:, t % K], h[:, t % K]
    return cfg, g, h, rm.astype(np.float64), fm


def _split_bins(arrays, t, boundaries):
    """A booster tree's splits as [(parent, feature, bin)] in creation
    order, each bin recovered from its threshold."""
    left = arrays["left"][t]
    out = []
    for k in range((int(arrays["num_nodes"][t]) - 1) // 2):
        parent = int(np.flatnonzero(left == 2 * k + 1)[0])
        f = int(arrays["feature"][t, parent])
        b = int(np.searchsorted(boundaries[f],
                                arrays["threshold"][t, parent])) + 1
        out.append((parent, f, b))
    return out


def _route(bins, splits, k):
    """Each row's leaf node after the first k splits."""
    node = np.zeros(len(bins), int)
    for j, (parent, f, b) in enumerate(splits[:k]):
        at = node == parent
        right = at & (bins[:, f] > b)
        node[at & ~right] = 2 * j + 1
        node[right] = 2 * j + 2
    return node


def _landscape(bins, g, h, rm, fm, cfg, node, B):
    """Gains in float64 of every valid (leaf, feature, bin) candidate and
    each one's scale (the parent's term)."""
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2

    def leaf_gain(gs, hs):
        tt = np.sign(gs) * np.maximum(np.abs(gs) - l1, 0.0)
        return tt * tt / (hs + l2 + 1e-35)
    gains, scales, cands = [], [], []
    for leaf in np.unique(node):
        rows = node == leaf
        for f in np.flatnonzero(fm):
            hg = np.bincount(bins[rows, f], (g * rm)[rows], B)
            hh = np.bincount(bins[rows, f], (h * rm)[rows], B)
            hc = np.bincount(bins[rows, f], rm[rows], B)
            gl, hl, cl = np.cumsum(hg), np.cumsum(hh), np.cumsum(hc)
            gr, hr, cr = gl[-1] - gl, hl[-1] - hl, cl[-1] - cl
            parent = leaf_gain(gl[-1], hl[-1])
            gain = leaf_gain(gl, hl) + leaf_gain(gr, hr) - parent
            ok = ((cl >= cfg.min_data_in_leaf)
                  & (cr >= cfg.min_data_in_leaf)
                  & (hl >= cfg.min_sum_hessian_in_leaf)
                  & (hr >= cfg.min_sum_hessian_in_leaf))
            for b in np.flatnonzero(ok):
                gains.append(gain[b])
                scales.append(max(abs(parent), abs(gain[b])))
                cands.append((int(leaf), int(f), int(b)))
    return np.asarray(gains), np.asarray(scales), cands


def assert_tie(f, t):
    """Tree t differs: its first differing split is a tie of the
    reference's gains."""
    cfg, g, h, rm, fm = _inputs(f, t)
    x = f["x"]
    bounds = jbin.compute_bin_boundaries(x, cfg.max_bin, seed=cfg.seed)
    bins = np.array(jbin.bin_features(jnp.asarray(x), jnp.asarray(bounds)))
    ref = _split_bins(f["jm"].booster.arrays, t, bounds)
    got = _split_bins(f["tm"].booster.arrays, t, bounds)
    k = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
             min(len(ref), len(got)))
    node = _route(bins, ref, k)
    gains, scales, cands = _landscape(bins, g, h, rm, fm, cfg, node,
                                      cfg.max_bin + 1)
    order = np.argsort(-gains, kind="stable")
    top = gains[order[0]]
    tol = TIE_RTOL * max(scales[order[0]], scales[order[1]])
    assert top - gains[order[1]] <= tol, (
        f"{f['name']} tree {t} split {k} differs ({ref[k:k + 1]} vs "
        f"{got[k:k + 1]}) but the top two gains {top}, "
        f"{gains[order[1]]} do not tie")
    for choice in (ref[k] if k < len(ref) else None,
                   got[k] if k < len(got) else None):
        if choice is not None:
            i = cands.index(choice)
            assert top - gains[i] <= TIE_RTOL * max(scales[order[0]],
                                                    scales[i]), choice


def trees_match_or_tie(f) -> bool:
    """The tree rule; True when every tree matched."""
    ja, ta = f["jm"].booster.arrays, f["tm"].booster.arrays
    assert ja["feature"].shape == ta["feature"].shape
    np.testing.assert_allclose(f["tm"].booster.tree_weights,
                               f["jm"].booster.tree_weights, rtol=1e-6)
    for t in range(ja["feature"].shape[0]):
        same = all(np.array_equal(ja[k][t], ta[k][t]) for k in
                   ("feature", "threshold", "left", "right", "is_leaf",
                    "num_nodes"))
        if not same:
            assert_tie(f, t)
            return False
        np.testing.assert_allclose(ta["leaf_value"][t], ja["leaf_value"][t],
                                   **VALUE_TOL)
    return True


def _outputs(f):
    x = f["x"]
    col = "probability" if f["est"] == "LightGBMClassifier" \
        else "prediction"
    jo = np.asarray(f["jm"].transform(JDataFrame({"features": x}))[col])
    to = np.asarray(f["tm"].transform(DataFrame({"features": x}))[col])
    return jo, to


EXACT = ["bagging", "stratified", "feature_fraction",
         "dart", "dart_ff", "dart_bagging", "rf", "multiclass_wine",
         "ova_wine", "multiclass_digits", "ova_digits_bagging"]
TIES = ["bagging_freq3", "rf_band", "dart_band", "multiclass_wine_ties",
        "ova_wine_ties"]


@pytest.mark.parametrize("name", EXACT)
def test_trees_and_probabilities_match(name):
    f = fit(name)
    assert trees_match_or_tie(f), "a tie: this case is held exactly"
    jo, to = _outputs(f)
    np.testing.assert_allclose(to, jo, rtol=0, atol=PROB_ATOL)
    if jo.ndim == 2 and f["kw"].get("objective") == "multiclass":
        np.testing.assert_allclose(to.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", TIES)
def test_trees_match_up_to_a_tie(name):
    trees_match_or_tie(fit(name))


@pytest.mark.parametrize("name", [f"{p}_{o}" for p in ("reg", "tab")
                                  for o in REGRESSION_OBJECTIVES])
def test_regressor_matches_jax(name):
    f = fit(name)
    assert trees_match_or_tie(f), "a tie: this case is held exactly"
    jo, to = _outputs(f)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=0)


def _bands(csv):
    rows = {}
    with open(os.path.join(BENCH, csv)) as fh:
        for line in fh:
            if line.strip() and not line.startswith("#"):
                name, value, tol = line.strip().split(",")
                rows[name] = (float(value), float(tol))
    return rows


def _auc(model, x, y, frame=DataFrame):
    scored = model.transform(frame({"features": x, "label": y}))
    stats = ComputeModelStatistics if frame is DataFrame else \
        JComputeModelStatistics
    return float(stats(labelCol="label").transform(scored)["AUC"][0])


@pytest.mark.parametrize("mode", ["gbdt", "rf", "dart", "goss"])
def test_breast_cancer_modes_inside_reference_parity_band(mode):
    f = fit(f"{mode}_band")
    value, tol = _bands("benchmarks_ReferenceParity.csv")[
        f"LightGBMClassifier_breast-cancer_{mode}_AUROC"]
    assert abs(_auc(f["tm"], f["x"], f["y"]) - value) <= tol


def test_goss_auc_against_jax():
    f = fit("goss_band")
    t_auc = _auc(f["tm"], f["x"], f["y"])
    j_auc = _auc(f["jm"], f["x"], f["y"], JDataFrame)
    assert abs(t_auc - j_auc) <= 5e-3, (t_auc, j_auc)


def test_goss_mask_invariants():
    """Iteration 0 of a binary fit: |g| takes two values, so the top set
    is decided by the stable tie order alone."""
    n, top_rate, other_rate = 1000, 0.2, 0.1
    y = (np.arange(n) % 3 == 0).astype(np.float32)
    p0 = y.mean()
    gmag = torch.from_numpy(np.abs(p0 - y).astype(np.float32))
    gen = torch.Generator().manual_seed(3)
    amplify = (1.0 - top_rate) / other_rate
    m = ttr.goss_mask(gmag, torch.ones(n), gen, top_n=int(top_rate * n),
                      other_n=int(other_rate * n), amplify=amplify)
    m = m.numpy()
    assert (m == 1.0).sum() == 200
    assert (m == np.float32(amplify)).sum() == 100
    assert ((m == 0) | (m == 1) | (m == np.float32(amplify))).all()
    # the stable descending rank: the largest |g| (the positives, rows
    # 0, 3, 6, ...) in row order
    np.testing.assert_array_equal(np.flatnonzero(m == 1.0),
                                  np.arange(0, 600, 3))
    # rows already excluded by the mask are never drawn
    valid = torch.from_numpy((np.arange(n) < 900).astype(np.float32))
    m2 = ttr.goss_mask(gmag, valid, torch.Generator().manual_seed(3),
                       top_n=200, other_n=100, amplify=amplify).numpy()
    assert (m2[900:] == 0).all() and (m2 == np.float32(amplify)).sum() == 100


# ----------------------------------------------- validation, early stopping
def _valid_flag(n, every=4):
    return (np.arange(n) % every == 0)


EVAL_CASES = {
    # name → (estimator, data, Params, weighted)
    "auc": ("LightGBMClassifier", "cancer",
            dict(numIterations=25, numLeaves=5, earlyStoppingRound=3,
                 isProvideTrainingMetric=True), False),
    "binary_logloss": ("LightGBMClassifier", "cancer",
                       dict(numIterations=12, numLeaves=5,
                            metric="binary_logloss", evalFreq=2,
                            isProvideTrainingMetric=True,
                            baggingFraction=0.8, baggingFreq=1,
                            weightCol="w"), True),
    "multi_logloss": ("LightGBMClassifier", "wine",
                      dict(numIterations=30, numLeaves=4, minDataInLeaf=5,
                           learningRate=0.5, objective="multiclass",
                           earlyStoppingRound=2,
                           isProvideTrainingMetric=True, weightCol="w"),
                      True),
    "ova_logloss": ("LightGBMClassifier", "wine",
                    dict(numIterations=8, numLeaves=4, minDataInLeaf=5,
                         objective="multiclassova",
                         isProvideTrainingMetric=True, weightCol="w"),
                    True),
    "rmse": ("LightGBMRegressor", "diabetes",
             dict(numIterations=40, numLeaves=5, earlyStoppingRound=2,
                  improvementTolerance=1.0, learningRate=0.3,
                  isProvideTrainingMetric=True), False),
    "mae": ("LightGBMRegressor", "diabetes",
            dict(numIterations=10, numLeaves=5, objective="regression_l1",
                 isProvideTrainingMetric=True, boostingType="dart"), False),
    "xentlambda_loss": ("LightGBMRegressor", "cancer",
                        dict(numIterations=8, numLeaves=5,
                             objective="cross_entropy_lambda",
                             isProvideTrainingMetric=True), False),
}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_evals_and_best_iteration_match(name):
    est, dname, kw, weighted = EVAL_CASES[name]
    x, y = data(dname)
    cols = {"features": x, "label": y, "is_val": _valid_flag(len(y))}
    if weighted:
        cols["w"] = _weights(len(y))
    kw = dict(kw, validationIndicatorCol="is_val")
    jr = getattr(jl, est)(numShards=1, **kw)
    tr = getattr(tl, est)(device="cpu", **kw)
    jm, tm = jr.fit(JDataFrame(dict(cols))), tr.fit(DataFrame(dict(cols)))
    # the same evals: entries, iterations and keys; metrics within 1e-5
    je = _evals(jr, cols)
    te = _evals(tr, cols)
    assert [sorted(e) for e in te] == [sorted(e) for e in je]
    assert [e["iteration"] for e in te] == [e["iteration"] for e in je]
    metric = kw.get("metric") or name
    assert any(metric in e for e in je)
    for a, b in zip(te, je):
        for k in b:
            if k not in ("iteration", "dataset"):
                assert a[k] == pytest.approx(b[k], rel=METRIC_RTOL,
                                             abs=1e-7), (a, b)
            else:
                assert a[k] == b[k]
    assert tm.booster.best_iteration == jm.booster.best_iteration
    if kw.get("earlyStoppingRound"):
        last = je[-1]["iteration"]
        assert last < kw["numIterations"] - 1, "early stopping never fired"
        assert last == jm.booster.best_iteration + kw["earlyStoppingRound"]
    # the booster scores best_iteration + 1 iterations
    xs = x[:50]
    np.testing.assert_allclose(
        tm.booster.raw_scores(xs, device="cpu"),
        tm.booster.raw_scores(
            xs, num_iteration=tm.booster.best_iteration + 1, device="cpu"))
    np.testing.assert_allclose(tm.booster.raw_scores(xs, device="cpu"),
                               jm.booster.raw_scores(xs), rtol=1e-5,
                               atol=1e-5)


def _evals(est, cols):
    """Re-run the estimator's training call to read its ``evals`` (the
    models do not keep them)."""
    mod = jtr if est.__module__.startswith("mmlspark_tpu") else ttr
    frame = JDataFrame if mod is jtr else DataFrame
    seen = {}
    orig = mod.train

    def spy(*a, **kw):
        seen["r"] = orig(*a, **kw)
        return seen["r"]
    import importlib
    emod = importlib.import_module(est.__module__)
    emod.train = spy
    try:
        est.fit(frame(dict(cols)))
    finally:
        emod.train = orig
    return seen["r"].evals


# ------------------------------------------------------ delegate and fobj
class _Delegate:
    def __init__(self):
        self.calls = []

    def get_learning_rate(self, it):
        self.calls.append(("lr", it))
        return 0.2 * 0.8 ** it

    def before_train_iteration(self, it):
        self.calls.append(("before", it))

    def after_train_iteration(self, it):
        self.calls.append(("after", it))


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_delegate_hooks_match_jax(boosting):
    x, y = data("cancer")
    kw = dict(objective="binary", num_iterations=5, num_leaves=5,
              boosting_type=boosting)
    if boosting == "rf":
        kw.update(bagging_fraction=0.9, bagging_freq=1)
    jd, td = _Delegate(), _Delegate()
    jres = jtr.train(x, y, None, jtr.TrainConfig(**kw), delegate=jd)
    tres = ttr.train(x, y, None, ttr.TrainConfig(**kw), delegate=td,
                     device="cpu")
    assert td.calls == jd.calls
    if boosting == "rf":      # rf takes no learning-rate schedule
        assert ("lr", 0) not in td.calls
    np.testing.assert_allclose(tres.booster.raw_scores(x, device="cpu"),
                               jres.booster.raw_scores(x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tres.booster.arrays["feature"],
                                  jres.booster.arrays["feature"])


def test_fobj_matches_jax():
    """A custom logistic objective: init 0, the booster's transform is the
    estimator objective's (binary: sigmoid)."""
    import jax

    def jfobj(s, y, w):
        p = jax.nn.sigmoid(s)
        return (p - y) * w, p * (1.0 - p) * w

    def tfobj(s, y, w):
        p = torch.sigmoid(s)
        return (p - y) * w, p * (1.0 - p) * w

    x, y = data("cancer")
    kw = dict(numIterations=6, numLeaves=5)
    jm = jl.LightGBMClassifier(numShards=1, fobj=jfobj, **kw).fit(
        JDataFrame({"features": x, "label": y}))
    tm = tl.LightGBMClassifier(device="cpu", fobj=tfobj, **kw).fit(
        DataFrame({"features": x, "label": y}))
    assert float(tm.booster.init_score) == 0.0
    jp = jm.transform(JDataFrame({"features": x}))["probability"]
    tp = tm.transform(DataFrame({"features": x}))["probability"]
    np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("name", ["dart_ff", "dart_bagging"])
def test_dart_running_scores_match_jax(name):
    """DART's running scores, after every drop, new-tree add and rescale:
    the JAX update is one FMA, the port's a multiply and an add, so they
    agree within 1e-5, not to the bit."""
    est, dname, kw, _ = FITS[name]
    x, y = data(dname)
    captured = []
    for mod, pkg, frame, extra in ((jtr, jl, JDataFrame, dict(numShards=1)),
                                   (ttr, tl, DataFrame,
                                    dict(device="cpu"))):
        mod._debug_capture = {}
        try:
            getattr(pkg, est)(**extra, **kw).fit(
                frame({"features": x, "label": y}))
            captured.append(np.asarray(mod._debug_capture["scores"]))
        finally:
            mod._debug_capture = None
    np.testing.assert_allclose(captured[1], captured[0], rtol=1e-5,
                               atol=1e-5)
