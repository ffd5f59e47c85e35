"""Categorical slots and ``maxBinByFeature`` against the JAX package.

Held:
- ``_split_stats_with_cat`` (both its ``cat_idx`` and ``cat_mask`` forms)
  on seeded histograms with tied ratios and empty bins: the sort order
  exactly JAX's (both sorts are stable), the stats within 1e-6;
- ``categorical_go_left`` on NaN, negative, non-integer and out-of-range
  values: exactly JAX's;
- the categorical frame of ``test_benchmarks.py:53-63`` (40 iterations,
  15 leaves): trees equal JAX's, category sets included, or a proven tie
  (the reference's top two gains at the first differing split, category
  sets scanned in ratio order as the engine scans them, agree within 1e-5
  relative); probabilities within 1e-5; the ``categorical.set_split`` and
  ``categorical.ordinal`` rows of ``benchmarks_LightGBMCategorical.csv``;
- ``categoricalSlotNames`` through ``slotNames`` and through the features
  column's ``slot_names`` metadata;
- ``maxBinByFeature``'s boundaries exactly JAX's, and its ``ValueError``s
  and the over-budget category id's in JAX's words;
- unseen, negative and non-integer ids route right (as missing ones);
- text models with category sets cross both ways (scores within 1e-6),
  a native-LightGBM-shaped bitset loads, and ``convert.py`` carries
  categorical boosters and engine trees.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.lightgbm as jl
from mmlspark_tpu.core import ColumnMetadata as JColumnMetadata
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_tpu.lightgbm import engine as jeng
from mmlspark_tpu.lightgbm import trainer as jtr
import mmlspark_torch.lightgbm as tl
from mmlspark_torch.core import ColumnMetadata, DataFrame, load_stage
from mmlspark_torch.lightgbm import engine as teng
from mmlspark_torch.lightgbm import trainer as ttr
from mmlspark_torch.lightgbm.convert import (booster_from_arrays,
                                             tree_from_arrays)

BENCH = os.path.join(os.path.dirname(__file__), "resources", "benchmarks")
PROB_ATOL = 1e-5
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
RAW_ATOL = 1e-6
TIE_RTOL = 1e-5
STRUCTURE = ("feature", "threshold", "left", "right", "is_leaf",
             "num_nodes", "cat_flag", "cat_left")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_frame():
    """``test_benchmarks.py``'s categorical frame: slot 0 holds 16
    categories, the label a non-contiguous set of 4 of them."""
    rng = np.random.default_rng(5)
    n = 2500
    cats = rng.integers(0, 16, size=n).astype(np.float32)
    num = rng.normal(size=(n, 3)).astype(np.float32)
    margin = (np.isin(cats, [1, 4, 7, 12]) * 2.0 - 1.0
              + num[:, 0] + 0.3 * rng.normal(size=n))
    y = (margin > 0).astype(np.float32)
    return np.concatenate([cats[:, None], num], axis=1), y


def cat_frame(n=800, seed=0):
    """Slot 0: 12 categories, the label an interleaved set of 4."""
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, 12, size=n).astype(np.float32)
    other = rng.normal(size=n).astype(np.float32)
    y = np.isin(cats, [1, 4, 6, 9]).astype(np.float32)
    flip = rng.random(n) < 0.05
    return np.stack([cats, other], 1), np.where(flip, 1 - y, y)


def _bands(csv):
    rows = {}
    with open(os.path.join(BENCH, csv)) as fh:
        for line in fh:
            if line.strip() and not line.startswith("#"):
                name, value, tol = line.strip().split(",")
                rows[name] = (float(value), float(tol))
    return rows


_FITS: dict = {}


def fit_both(name, x, y, **kw):
    """Both packages' classifiers on one frame (cached per name)."""
    if name not in _FITS:
        jm = jl.LightGBMClassifier(numShards=1, **kw).fit(
            JDataFrame({"features": x, "label": y}))
        tm = tl.LightGBMClassifier(device="cpu", **kw).fit(
            DataFrame({"features": x, "label": y}))
        _FITS[name] = (jm, tm)
    return _FITS[name]


# ------------------------------------------------------------- split stats
def _histograms(seed, L=3, F=5, B=17):
    """Seeded [L, F, B, 3] histograms whose sums are exact in f32 (grads
    and hessians are multiples of 1/8): empty bins, a missing bin with
    rows, and bins with equal (g, h) so their ratios tie exactly."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-40, 40, size=(L, F, B)) / 8.0
    h = rng.integers(1, 40, size=(L, F, B)) / 8.0
    c = rng.integers(1, 30, size=(L, F, B)).astype(np.float64)
    empty = rng.random((L, F, B)) < 0.25
    g[empty], h[empty], c[empty] = 0.0, 0.0, 0.0
    g[:, :, 5], h[:, :, 5], c[:, :, 5] = g[:, :, 3], h[:, :, 3], 7.0
    g[:, :, 11], h[:, :, 11] = g[:, :, 3], h[:, :, 3]
    return np.stack([g, h, c], -1).astype(np.float32)


SPLIT_PARAMS = {
    "default": dict(num_leaves=7, max_bin=16),
    "cap3_smooth1": dict(num_leaves=7, max_bin=16, cat_smooth=1.0,
                         max_cat_threshold=3, lambda_l2=0.5),
}


@pytest.mark.parametrize("case", sorted(SPLIT_PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_split_stats_with_cat_matches_jax(case, seed):
    hist = _histograms(seed)
    kw = SPLIT_PARAMS[case]
    jp, tp = jeng.TreeParams(**kw), teng.TreeParams(**kw)
    ht = torch.from_numpy(hist)
    cat_idx = [1, 3]
    mask = np.zeros(hist.shape[1], bool)
    mask[cat_idx] = True
    forms = [
        (dict(cat_idx=jnp.asarray(cat_idx, jnp.int32)),
         dict(cat_idx=torch.tensor(cat_idx))),
        (dict(cat_mask=jnp.asarray(mask)),
         dict(cat_mask=torch.from_numpy(mask))),
    ]
    for jkw, tkw in forms:
        jstats, jorder = jeng._split_stats_with_cat(jnp.asarray(hist), jp,
                                                    **jkw)
        tstats, torder = teng._split_stats_with_cat(ht, tp, **tkw)
        np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
        for j, t in zip(jstats, tstats):
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       **STATS_TOL)
    # no categorical column: the plain stats and no order
    stats, order = teng._split_stats_with_cat(ht, tp)
    assert order is None
    for a, b in zip(stats, teng._split_stats(ht, tp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_categorical_go_left_matches_jax():
    B = 9
    rng = np.random.default_rng(3)
    left = rng.random((6, B)) < 0.5
    left[:, 0] = False
    xv = np.array([0.0, 3.0, np.nan, -1.0, 2.5, 7.0, 8.0, 400.0, 1.0, -0.0,
                   6.9999, np.inf], np.float32)
    rows = left[np.arange(xv.size) % 6]
    want = np.asarray(jeng.categorical_go_left(
        jnp.asarray(xv), jnp.isnan(jnp.asarray(xv)), jnp.asarray(rows)))
    t = torch.from_numpy(xv)
    got = teng.categorical_go_left(t, torch.isnan(t), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    # NaN, negative, non-integer and out-of-range (7 is bin 8, the last;
    # 8 would need bin 9) values are in no left set
    assert not got[[2, 3, 4, 6, 7, 10, 11]].any()


# ------------------------------------------------------- trees and the tie
def _boundaries(x, max_bin, cats):
    bounds = jbin.compute_bin_boundaries(x, max_bin, seed=0)
    for f in cats:
        bounds[f] = np.arange(bounds.shape[1]) + 0.5
    return bounds


def _splits(arrays, t, bounds):
    """A booster tree's splits in creation order as (parent, feature,
    rule): ("set", left category bins) or ("bin", split bin recovered
    from the threshold)."""
    left = arrays["left"][t]
    out = []
    for k in range((int(arrays["num_nodes"][t]) - 1) // 2):
        parent = int(np.flatnonzero(left == 2 * k + 1)[0])
        f = int(arrays["feature"][t, parent])
        if "cat_flag" in arrays and arrays["cat_flag"][t, parent]:
            rule = ("set", frozenset(np.flatnonzero(
                arrays["cat_left"][t, parent]).tolist()))
        else:
            rule = ("bin", int(np.searchsorted(
                bounds[f], arrays["threshold"][t, parent])) + 1)
        out.append((parent, f, rule))
    return out


def _gain64(g, h, p):
    t = np.sign(g) * np.maximum(np.abs(g) - p.lambda_l1, 0.0)
    return t * t / (h + p.lambda_l2 + 1e-35)


def gain_landscape(bins, g, h, p, k, leaf=None):
    """The reference's gains (float64) over every candidate at its k-th
    split, categorical columns scanned in ratio order as the engine scans
    them. ``leaf`` is each row's leaf after the reference's first k splits
    (default: from its dense grower). Returns ({(node, feature, rule):
    gain}, leaf)."""
    n, F = bins.shape
    if leaf is None:
        pk = p._replace(num_leaves=k + 1)
        tree, _ = jeng.grow_tree(jnp.asarray(bins), jnp.asarray(g),
                                 jnp.asarray(h), jnp.ones(F, bool),
                                 jnp.ones(n, jnp.float32), params=pk,
                                 num_features=F)
        leaf = np.asarray(jeng.tree_route_bins(tree, jnp.asarray(bins),
                                               max_depth=k + 1))
    B = p.max_bin + 1
    out = {}
    for node in np.unique(leaf):
        rows = leaf == node
        for f in range(F):
            hist = np.stack([
                np.bincount(bins[rows, f], g[rows].astype(np.float64), B),
                np.bincount(bins[rows, f], h[rows].astype(np.float64), B),
                np.bincount(bins[rows, f], minlength=B).astype(float)], 1)
            order = np.arange(B)
            if f in p.cat_features:
                ratio = np.where(hist[:, 2] > 0,
                                 hist[:, 0] / (hist[:, 1] + p.cat_smooth),
                                 np.inf)
                ratio[0] = np.inf
                order = np.argsort(ratio, kind="stable")
            cum = np.cumsum(hist[order], 0)
            tot = cum[-1]
            gl, hl, cl = cum[:, 0], cum[:, 1], cum[:, 2]
            gain = (_gain64(gl, hl, p) + _gain64(tot[0] - gl, tot[1] - hl, p)
                    - _gain64(tot[0], tot[1], p))
            ok = ((cl >= p.min_data_in_leaf)
                  & (tot[2] - cl >= p.min_data_in_leaf)
                  & (hl >= p.min_sum_hessian_in_leaf)
                  & (tot[1] - hl >= p.min_sum_hessian_in_leaf))
            if f in p.cat_features:
                ok &= np.arange(B) < p.max_cat_threshold
            for b in np.flatnonzero(ok):
                rule = ("set", frozenset(order[:b + 1].tolist())) \
                    if f in p.cat_features else ("bin", int(b))
                out[(int(node), f, rule)] = gain[b]
    return out, leaf


def set_gain(bins, g, h, p, leaf, choice):
    """The float64 gain of one (node, feature, rule) split of the rows in
    leaf ``node``, whatever order found it."""
    node, f, (kind, rule) = choice
    rows = leaf == node
    b = bins[rows, f]
    go = np.isin(b, list(rule)) if kind == "set" else b <= rule
    gs, hs = g[rows].astype(np.float64), h[rows].astype(np.float64)
    return (_gain64(gs[go].sum(), hs[go].sum(), p)
            + _gain64(gs[~go].sum(), hs[~go].sum(), p)
            - _gain64(gs.sum(), hs.sum(), p))


def assert_trees_match_or_tie(jb, tb, x, y, bounds, p):
    """Every tree equal (structure exactly, values within 1e-5), or at the
    first tree that differs a proven tie at its first differing split."""
    ja, ta = jb.arrays, tb.arrays
    assert ja["feature"].shape == ta["feature"].shape
    for t in range(ja["feature"].shape[0]):
        if all(np.array_equal(ja[k][t], ta[k][t]) for k in STRUCTURE):
            np.testing.assert_allclose(ta["leaf_value"][t],
                                       ja["leaf_value"][t], rtol=1e-5,
                                       atol=1e-5)
            continue
        s = jb.raw_scores(x, num_iteration=t).astype(np.float32)
        prob = (1.0 / (1.0 + np.exp(-s))).astype(np.float32)
        g = (prob - y).astype(np.float32)
        h = (prob * (1 - prob)).astype(np.float32)
        bins = np.array(jbin.bin_features(jnp.asarray(x),
                                          jnp.asarray(bounds)))
        ref, got = _splits(ja, t, bounds), _splits(ta, t, bounds)
        k = next(i for i, (a, b) in enumerate(zip(ref + [None],
                                                  got + [None])) if a != b)
        land, leaf = gain_landscape(bins, g, h, p, k)
        top2 = sorted(land.values())[-2:]
        assert top2[1] - top2[0] <= TIE_RTOL * abs(top2[1]), (
            f"tree {t} split {k} differs ({ref[k:k + 1]} vs "
            f"{got[k:k + 1]}) but the top two gains {top2} do not tie")
        for choice in (ref[k:k + 1] + got[k:k + 1]):
            gi = set_gain(bins, g, h, p, leaf, choice)
            assert top2[1] - gi <= TIE_RTOL * abs(top2[1]), (choice, gi)
        return t
    return None


BENCH_KW = dict(numIterations=40, numLeaves=15, seed=0)


def test_benchmark_frame_trees_match_or_tie():
    x, y = bench_frame()
    jm, tm = fit_both("bench_set", x, y, categoricalSlotIndexes=[0],
                      **BENCH_KW)
    assert tm.booster.arrays["cat_flag"].any()
    p = jeng.TreeParams(num_leaves=15, max_bin=255, cat_features=(0,))
    assert_trees_match_or_tie(jm.booster, tm.booster, x, y,
                              _boundaries(x, 255, [0]), p)
    jp = jm.transform(JDataFrame({"features": x}))["probability"]
    tp = tm.transform(DataFrame({"features": x}))["probability"]
    np.testing.assert_allclose(np.asarray(tp), np.asarray(jp), rtol=0,
                               atol=PROB_ATOL)


@pytest.mark.parametrize("mode", ["set_split", "ordinal"])
def test_categorical_benchmark_bands(mode):
    x, y = bench_frame()
    kw = dict(BENCH_KW, categoricalSlotIndexes=[0]) if mode == "set_split" \
        else BENCH_KW
    _, tm = fit_both(f"bench_{'set' if mode == 'set_split' else 'ord'}",
                     x, y, **kw)
    auc = ttr.roc_auc(y, tm.transform(DataFrame({"features": x}))[
        "probability"][:, 1])
    value, tol = _bands("benchmarks_LightGBMCategorical.csv")[
        f"categorical.{mode}"]
    assert abs(auc - value) <= tol, (mode, auc, value)


def test_set_split_isolates_the_set_in_one_split():
    x, y = cat_frame(2000)
    y = np.isin(x[:, 0], [1, 4, 6, 9]).astype(np.float32)
    kw = dict(numIterations=8, numLeaves=2, minDataInLeaf=5)
    df = DataFrame({"features": x, "label": y})
    cat = tl.LightGBMClassifier(device="cpu", categoricalSlotIndexes=[0],
                                **kw).fit(df)
    ordn = tl.LightGBMClassifier(device="cpu", **kw).fit(df)

    def acc(m):
        return float((np.asarray(m.transform(df)["prediction"]) == y).mean())
    assert acc(cat) > 0.99 and acc(ordn) < 0.9
    a = cat.booster.arrays
    assert a["cat_flag"][:, 0].all()
    np.testing.assert_array_equal(
        np.flatnonzero(a["cat_left"][0, 0]) - 1, [1, 4, 6, 9])


# ---------------------------------------------------------- slot names
def test_slot_names_resolve_through_params_and_metadata():
    x, y = cat_frame()
    kw = dict(numIterations=4, numLeaves=4, minDataInLeaf=5)
    by_index = tl.LightGBMClassifier(device="cpu", categoricalSlotIndexes=[0],
                                     **kw).fit(DataFrame({"features": x,
                                                          "label": y}))
    by_name = tl.LightGBMClassifier(
        device="cpu", slotNames=["color", "other"],
        categoricalSlotNames=["color"], **kw).fit(
        DataFrame({"features": x, "label": y}))
    df = DataFrame({"features": x, "label": y})
    ColumnMetadata.attach(df, "features", {"slot_names": ["color", "num"]})
    by_meta = tl.LightGBMClassifier(device="cpu",
                                    categoricalSlotNames=["color"],
                                    **kw).fit(df.filter(np.ones(len(y),
                                                                bool)))
    want = by_index.booster.save_native()
    assert by_meta.booster.save_native() == want
    assert by_name.booster.arrays["cat_flag"].any()
    np.testing.assert_array_equal(by_name.booster.arrays["cat_left"],
                                  by_index.booster.arrays["cat_left"])
    # the JAX package resolves the same name to the same slot
    jdf = JDataFrame({"features": x, "label": y})
    JColumnMetadata.attach(jdf, "features", {"slot_names": ["color", "n"]})
    jm = jl.LightGBMClassifier(numShards=1, categoricalSlotNames=["color"],
                               **kw).fit(jdf)
    np.testing.assert_array_equal(by_meta.booster.arrays["cat_left"],
                                  jm.booster.arrays["cat_left"])


@pytest.mark.parametrize("kw, words", [
    (dict(slotNames=["a", "b"], categoricalSlotNames=["zzz"]), "not found"),
    (dict(categoricalSlotNames=["a"]), "no slot names are available"),
    (dict(categoricalSlotIndexes=[0], maxCatThreshold=0), "maxCatThreshold"),
])
def test_slot_and_threshold_errors_match_jax(kw, words):
    x, y = cat_frame(200)
    with pytest.raises(ValueError) as jerr:
        jl.LightGBMClassifier(numShards=1, numIterations=2, **kw).fit(
            JDataFrame({"features": x, "label": y}))
    with pytest.raises(ValueError) as terr:
        tl.LightGBMClassifier(device="cpu", numIterations=2, **kw).fit(
            DataFrame({"features": x, "label": y}))
    assert str(terr.value) == str(jerr.value)
    assert words in str(terr.value)


# ------------------------------------------------------- maxBinByFeature
def _jax_boundaries(monkeypatch, x, cfg_kw):
    """The boundaries the JAX trainer bins with, read from its
    ``bin_features`` call."""
    seen = []
    real = jtr.bin_features

    def spy(xs, bounds):
        seen.append(np.asarray(bounds))
        return real(xs, bounds)
    monkeypatch.setattr(jtr, "bin_features", spy)
    jtr.train(x, np.zeros(len(x), np.float32), None,
              jtr.TrainConfig(num_iterations=1, **cfg_kw))
    return seen[0]


@pytest.mark.parametrize("cfg_kw", [
    dict(max_bin_by_feature=(16, 0, 3, 255)),
    dict(max_bin_by_feature=(0, 8, 2, 0), categorical_features=(0,),
         max_bin=63),
])
def test_max_bin_by_feature_boundaries_equal_jax(monkeypatch, cfg_kw):
    x, _ = bench_frame()
    want = _jax_boundaries(monkeypatch, x, cfg_kw)
    got = ttr._dense_boundaries(x, ttr.TrainConfig(**cfg_kw), x.shape[1])
    np.testing.assert_array_equal(got, want)


def test_max_bin_by_feature_fit_matches_jax():
    x, y = bench_frame()
    budgets = [0, 6, 0, 12]
    jm, tm = fit_both("budgets", x, y, numIterations=10, numLeaves=7,
                      maxBinByFeature=budgets, categoricalSlotIndexes=[0])
    bounds = _boundaries(x, 255, [0])
    for f, k in enumerate(budgets):
        if k:
            bounds[f, k - 1:] = np.inf
    p = jeng.TreeParams(num_leaves=7, max_bin=255, cat_features=(0,))
    assert_trees_match_or_tie(jm.booster, tm.booster, x, y, bounds, p)
    a = tm.booster.arrays
    for f, k in ((1, 6), (3, 12)):
        on = ~a["is_leaf"] & (a["left"] >= 0) & (a["feature"] == f)
        assert on.any()
        assert a["threshold"][on].max() <= bounds[f, k - 2]


@pytest.mark.parametrize("budgets, words", [
    ([16] * 3, "has 3 entries for 4 features"),
    ([0, 1, 0, 0], "unsplittable"),
    ([8, 0, 0, 0], "cannot cap categorical slot 0"),
])
def test_max_bin_by_feature_errors_match_jax(budgets, words):
    x, y = bench_frame()
    kw = dict(numIterations=1, maxBinByFeature=budgets,
              categoricalSlotIndexes=[0])
    with pytest.raises(ValueError) as jerr:
        jl.LightGBMClassifier(numShards=1, **kw).fit(
            JDataFrame({"features": x, "label": y}))
    with pytest.raises(ValueError) as terr:
        tl.LightGBMClassifier(device="cpu", **kw).fit(
            DataFrame({"features": x, "label": y}))
    assert str(terr.value) == str(jerr.value)
    assert words in str(terr.value)


@pytest.mark.parametrize("bad", [9999.0, 2.5, -1.0])
def test_category_ids_outside_the_budget_raise_as_jax(bad):
    rng = np.random.default_rng(1)
    cats = rng.integers(0, 10, size=300).astype(np.float32)
    cats[0] = bad
    x, y = cats[:, None], (cats % 2 > 0).astype(np.float32)
    kw = dict(numIterations=2, categoricalSlotIndexes=[0])
    with pytest.raises(ValueError) as jerr:
        jl.LightGBMClassifier(numShards=1, **kw).fit(
            JDataFrame({"features": x, "label": y}))
    with pytest.raises(ValueError) as terr:
        tl.LightGBMClassifier(device="cpu", **kw).fit(
            DataFrame({"features": x, "label": y}))
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------- routing
def test_unseen_and_missing_categories_route_right():
    x, y = cat_frame()
    y = np.isin(x[:, 0], [1, 4, 6, 9]).astype(np.float32)
    x[:100, 0] = np.nan
    y[:100] = 0.0
    m = tl.LightGBMClassifier(device="cpu", numIterations=4, numLeaves=2,
                              minDataInLeaf=5,
                              categoricalSlotIndexes=[0]).fit(
        DataFrame({"features": x, "label": y}))
    # training routing (missing rows) and predict routing agree
    acc = float((np.asarray(m.transform(DataFrame({"features": x}))[
        "prediction"]) == y).mean())
    assert acc > 0.98
    probe = np.asarray([[500.0, 0.0], [-3.0, 0.0], [2.5, 0.0],
                        [np.nan, 0.0], [12.0, 0.0]], np.float32)
    prob = m.booster.transform_scores(m.booster.raw_scores(probe,
                                                           device="cpu"))
    assert (prob < 0.5).all(), prob
    jb = jl.Booster.load_native(m.booster.save_native())
    np.testing.assert_allclose(m.booster.raw_scores(probe, device="cpu"),
                               jb.raw_scores(probe), rtol=0, atol=RAW_ATOL)


# ---------------------------------------------------- text format, convert
def test_text_models_cross_both_ways():
    x, y = bench_frame()
    jm, tm = fit_both("bench_set", x, y, categoricalSlotIndexes=[0],
                      **BENCH_KW)
    text = tm.get_native_model_string()
    assert "num_cat=" in text and "cat_threshold=" in text
    jraw, traw = jm.booster.raw_scores(x), tm.booster.raw_scores(
        x, device="cpu")
    # JAX → port, port → JAX, port → port
    np.testing.assert_allclose(tl.Booster.load_native(
        jm.booster.save_native()).raw_scores(x, device="cpu"), jraw,
        rtol=0, atol=RAW_ATOL)
    np.testing.assert_allclose(jl.Booster.load_native(text).raw_scores(x),
                               traw, rtol=0, atol=RAW_ATOL)
    back = tl.LightGBMClassificationModel.loadNativeModelFromString(
        text, device="cpu")
    np.testing.assert_allclose(back.booster.raw_scores(x, device="cpu"),
                               traw, rtol=0, atol=RAW_ATOL)
    # the loaded category sets are the trained ones (bit c = bin c+1)
    a, b = tm.booster.arrays, back.booster.arrays
    T, NN = a["cat_flag"].shape
    np.testing.assert_array_equal(b["cat_flag"][:, :NN].any(1),
                                  a["cat_flag"].any(1))
    # a bitset read one bin late scores differently: the round trip is
    # what holds the bit order
    late = dict(b, cat_left=np.roll(b["cat_left"], 1, axis=-1))
    shifted = tl.Booster(late, num_class=1, objective="binary",
                         max_depth_bound=back.booster.max_depth_bound)
    assert np.abs(shifted.raw_scores(x, device="cpu") - traw).max() > 1e-3


def test_native_lightgbm_bitset_loads():
    """A native-LightGBM-shaped model with one categorical split:
    categories {0, 3} go left (bitset word 0b1001 = 9)."""
    text = "\n".join([
        "tree", "version=v3", "num_class=1",
        "num_tree_per_iteration=1", "label_index=0",
        "max_feature_idx=0", "objective=regression",
        "feature_names=Column_0", "feature_infos=none", "",
        "Tree=0", "num_leaves=2", "num_cat=1",
        "split_feature=0", "split_gain=1", "threshold=0",
        "decision_type=1", "left_child=-1", "right_child=-2",
        "leaf_value=10 20", "leaf_weight=1 1", "leaf_count=1 1",
        "internal_value=0", "internal_weight=2", "internal_count=2",
        "cat_boundaries=0 1", "cat_threshold=9",
        "shrinkage=1", "", "end of trees", "",
        "parameters:", "end of parameters"])
    x = np.asarray([[0.0], [1.0], [2.0], [3.0], [4.0], [np.nan]],
                   np.float32)
    got = tl.Booster.load_native(text).raw_scores(x, device="cpu")
    np.testing.assert_allclose(got, [10, 20, 20, 10, 20, 20])
    np.testing.assert_allclose(got, jl.Booster.load_native(text)
                               .raw_scores(x))


def test_convert_carries_categorical_models_and_trees(tmp_path):
    x, y = bench_frame()
    jm, tm = fit_both("bench_set", x, y, categoricalSlotIndexes=[0],
                      **BENCH_KW)
    jb = jm.booster
    tb = booster_from_arrays(
        jb.arrays, num_class=jb.num_class, objective=jb.objective,
        sigmoid=jb.sigmoid, init_score=jb.init_score,
        feature_names=jb.feature_names, max_depth_bound=jb.max_depth_bound,
        tree_weights=jb.tree_weights)
    np.testing.assert_allclose(tb.raw_scores(x, device="cpu"),
                               jb.raw_scores(x), rtol=0, atol=RAW_ATOL)
    # one JAX engine tree with a category set, routed by both packages
    bounds = _boundaries(x, 63, [0])
    bins = np.array(jbin.bin_features(jnp.asarray(x), jnp.asarray(bounds)))
    prob = 1.0 / (1.0 + np.exp(-np.random.default_rng(2).normal(
        scale=0.5, size=len(y))))
    g = (prob - y).astype(np.float32)
    h = (prob * (1 - prob)).astype(np.float32)
    p = jeng.TreeParams(num_leaves=7, max_bin=63, cat_features=(0,))
    jtree, jleaf = jeng.grow_tree(jnp.asarray(bins), jnp.asarray(g),
                                  jnp.asarray(h), jnp.ones(4, bool),
                                  jnp.ones(len(y), jnp.float32), params=p,
                                  num_features=4)
    assert bool(np.asarray(jtree.cat_flag).any())
    ttree = tree_from_arrays({k: np.asarray(v) for k, v in
                              jtree._asdict().items()})
    got = teng.tree_route_bins(ttree, torch.from_numpy(bins), max_depth=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jleaf))
    # the port's own grower on the same inputs
    tt, tleaf = teng.grow_tree(torch.from_numpy(bins), torch.from_numpy(g),
                               torch.from_numpy(h),
                               torch.ones(4, dtype=torch.bool),
                               torch.ones(len(y)), params=teng.TreeParams(
                                   num_leaves=7, max_bin=63,
                                   cat_features=(0,)), num_features=4)
    for k in ("feature", "split_bin", "cat_flag", "cat_left", "left",
              "right"):
        np.testing.assert_array_equal(getattr(tt.to_numpy(), k),
                                      np.asarray(getattr(jtree, k)), k)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    # the stage round trip keeps the category sets
    tm.save(str(tmp_path / "m"))
    loaded = load_stage(str(tmp_path / "m"))
    np.testing.assert_allclose(loaded.booster.raw_scores(x, device="cpu"),
                               tm.booster.raw_scores(x, device="cpu"),
                               rtol=0, atol=RAW_ATOL)
