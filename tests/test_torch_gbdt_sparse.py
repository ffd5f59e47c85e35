"""The padded-COO (sparse) GBDT path against the JAX package.

Held:
- ``coalesce_coo``, ``compute_sparse_bin_boundaries`` (its sampling draw
  for draw), ``bin_sparse`` and ``pad_sparse``: exactly JAX's;
- ``_leaf_hist_sparse`` (a scatter-add over the present entries plus the
  zero-bin correction): exactly JAX's where every sum is exact in f32
  (gradients on a 2^-10 grid), else within 1e-6 of the leaf's absolute
  mass per channel (the zero bin is totals minus explicit sums, so f32
  summation order moves it by the rounding of the whole leaf's sum);
- ``grow_tree_sparse`` on the same binned inputs, with and without a
  categorical slot, gradients on the 2^-10 grid: trees equal JAX's
  (structure, category sets and values exactly) or a proven tie at the
  first differing split (``test_torch_gbdt_categorical.py``'s landscape
  over the densified bins), and ``sparse_route_bins`` equal to JAX's;
- fits through ``LightGBMClassifier`` on ``<col>_indices``/``_values``
  frames: trees equal JAX's or a proven tie, probabilities within 1e-5;
  COO scoring equal to the densified rows' scoring (1e-6); text models
  across both packages (1e-6); validation rows with early stopping (the
  same ``evals`` and ``best_iteration``); the ``sparse.single`` row of
  ``benchmarks_LightGBMSparse.csv``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.lightgbm as jl
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import engine as jeng
from mmlspark_tpu.lightgbm import sparse as jsp
import mmlspark_tpu.lightgbm.estimators as jax_est
import mmlspark_torch.lightgbm as tl
import mmlspark_torch.lightgbm.estimators as port_est
from mmlspark_torch.core import DataFrame, load_stage
from mmlspark_torch.lightgbm import engine as teng
from mmlspark_torch.lightgbm import sparse as tsp
from mmlspark_torch.lightgbm import trainer as ttr
from test_lightgbm_sparse import dense_to_coo
from test_torch_gbdt_categorical import gain_landscape, set_gain

BENCH = os.path.join(os.path.dirname(__file__), "resources", "benchmarks")
PROB_ATOL = 1e-5
HIST_RTOL = 1e-6
RAW_ATOL = 1e-6
TIE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sparse_rows(n=600, f=12, density=0.4, seed=0, cat=False):
    """Dense rows with ~60 % zeros, their padded COO form and labels;
    with ``cat``, slot 0 holds 8 category ids (0 rides the zero bin) and
    the label a non-contiguous set of them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random((n, f)) > density] = 0.0
    logit = x[:, 0] * 2 - x[:, 1] + x[:, 2]
    if cat:
        x[:, 0] = rng.integers(0, 8, size=n)
        logit = (np.isin(x[:, 0], [2, 5, 7]) * 2.0 - 1.0) + x[:, 1]
    y = (logit + rng.normal(scale=0.3, size=n) > 0).astype(np.float32)
    idx, val = dense_to_coo(x)
    return x, idx, val, y


def frame(idx, val, y=None, pkg=DataFrame, **cols):
    d = {"features_indices": idx, "features_values": val, **cols}
    if y is not None:
        d["label"] = y
    return pkg(d)


# ----------------------------------------------------------------- binning
def test_coalesce_coo_matches_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(-1, 6, size=(50, 7)).astype(np.int32)
    val = rng.normal(size=(50, 7)).astype(np.float32)
    got, want = tsp.coalesce_coo(idx, val), jsp.coalesce_coo(idx, val)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    clean_i = np.array([[0, 1, -1], [4, 2, 3]], np.int32)
    clean_v = np.ones((2, 3), np.float32)
    ri, rv = tsp.coalesce_coo(clean_i, clean_v)
    assert ri is clean_i and rv is clean_v


@pytest.mark.parametrize("max_bin, sample_cnt", [(16, 1_000_000), (8, 900),
                                                 (4, 50)])
def test_boundaries_and_bins_match_jax(max_bin, sample_cnt):
    x, idx, val, _ = sparse_rows(seed=3)
    x[:50, 3] = -np.abs(x[:50, 3])              # negatives beside zero
    val_nan = val.copy()
    val_nan[5, 0] = np.nan
    sd_t = tsp.SparseData(idx, val_nan, x.shape[1] + 2)   # 2 empty features
    sd_j = jsp.SparseData(idx, val_nan, x.shape[1] + 2)
    want = jsp.compute_sparse_bin_boundaries(sd_j, max_bin, sample_cnt,
                                             seed=7)
    got = tsp.compute_sparse_bin_boundaries(sd_t, max_bin, sample_cnt,
                                            seed=7)
    np.testing.assert_array_equal(got, want)
    jb, tb = jsp.bin_sparse(sd_j, want), tsp.bin_sparse(sd_t, got)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # pad_sparse: the same padded rows and mask
    (ps, pm), (qs, qm) = tsp.pad_sparse(sd_t, 7), jsp.pad_sparse(sd_j, 7)
    np.testing.assert_array_equal(ps.indices, qs.indices)
    np.testing.assert_array_equal(pm, qm)


def _binned(seed=0, max_bin=16, cat=False):
    x, idx, val, y = sparse_rows(seed=seed, cat=cat)
    sd = jsp.SparseData(idx, val, x.shape[1])
    bounds = jsp.compute_sparse_bin_boundaries(sd, max_bin)
    if cat:
        bounds[0] = np.arange(bounds.shape[1]) + 0.5
    return x, y, bounds, jsp.bin_sparse(sd, bounds), tsp.bin_sparse(
        tsp.SparseData(idx, val, x.shape[1]), bounds)


def on_grid(a):
    """Values on a 2^-10 grid: sums of a few thousand of them are exact
    in f32, whatever their order."""
    return (np.round(np.asarray(a, np.float64) * 1024) / 1024).astype(
        np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_leaf_hist_sparse_matches_jax(exact):
    x, y, bounds, jb, tb = _binned(seed=1)
    n, F, B = x.shape[0], x.shape[1], bounds.shape[1] + 2
    rng = np.random.default_rng(2)
    gh = rng.normal(size=(n, 3)).astype(np.float32)
    if exact:
        gh = on_grid(gh)
    sel = (rng.random(n) < 0.4).astype(np.float32)
    want = np.asarray(jsp._leaf_hist_sparse(jb, jnp.asarray(gh),
                                            jnp.asarray(sel), F, B))
    got = tsp._leaf_hist_sparse(tb, torch.from_numpy(gh),
                                torch.from_numpy(sel), F, B).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        mass = (np.abs(gh) * sel[:, None]).sum(0)        # [3]
        assert (np.abs(got - want) <= HIST_RTOL * mass).all()


# ------------------------------------------------------------------ growth
def _sequence(tree):
    """[(parent, feature, rule)] in creation order, rule ("bin", b) or
    ("set", left bins)."""
    left = np.asarray(tree.left)
    out = []
    for k in range((int(tree.num_nodes) - 1) // 2):
        parent = int(np.flatnonzero(left == 2 * k + 1)[0])
        f = int(np.asarray(tree.feature)[parent])
        if bool(np.asarray(tree.cat_flag)[parent]):
            rule = ("set", frozenset(np.flatnonzero(
                np.asarray(tree.cat_left)[parent]).tolist()))
        else:
            rule = ("bin", int(np.asarray(tree.split_bin)[parent]))
        out.append((parent, f, rule))
    return out


def _dense_bins(tb, F):
    """Each row's bin of every feature: its entry's, else the zero bin."""
    idx, eb, zb = (t.numpy() for t in tb)
    dense = np.broadcast_to(zb, (idx.shape[0], F)).copy()
    rows, cols = np.nonzero(idx >= 0)
    dense[rows, idx[rows, cols]] = eb[rows, cols]
    return dense


GROW_CASES = {
    "plain": dict(num_leaves=15, min_data_in_leaf=5),
    "depth_l2": dict(num_leaves=15, min_data_in_leaf=10, max_depth=3,
                     lambda_l2=1.0),
    "categorical": dict(num_leaves=15, min_data_in_leaf=5,
                        cat_features=(0,), max_cat_threshold=3),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_tree_sparse_matches_jax_or_ties(case):
    kw = GROW_CASES[case]
    x, y, bounds, jb, tb = _binned(seed=5, cat="cat_features" in kw)
    n, F, B = x.shape[0], x.shape[1], bounds.shape[1] + 2
    prob = 1.0 / (1.0 + np.exp(-np.random.default_rng(6).normal(
        scale=0.3, size=n)))
    g, h = on_grid(prob - y), on_grid(prob * (1 - prob))
    jp = jeng.TreeParams(max_bin=B - 1, **kw)
    jtree, jleaf = jsp.grow_tree_sparse(
        *jb, jnp.asarray(g), jnp.asarray(h), jnp.ones(F, bool),
        jnp.ones(n, jnp.float32), params=jp, num_features=F, num_bins=B)
    ttree, tleaf = tsp.grow_tree_sparse(
        *tb, torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(F, dtype=torch.bool), torch.ones(n),
        params=teng.TreeParams(max_bin=B - 1, **kw), num_features=F,
        num_bins=B)
    ttree = ttree.to_numpy()
    if "cat_features" in kw:
        assert np.asarray(jtree.cat_flag).any()
    ref, got = _sequence(jtree), _sequence(ttree)
    if ref != got:
        k = next(i for i, (a, b) in enumerate(zip(ref + [None],
                                                  got + [None])) if a != b)
        pk = jp._replace(num_leaves=k + 1)
        t_k, _ = jsp.grow_tree_sparse(
            *jb, jnp.asarray(g), jnp.asarray(h), jnp.ones(F, bool),
            jnp.ones(n, jnp.float32), params=pk, num_features=F,
            num_bins=B)
        leaf = np.asarray(jsp.sparse_route_bins(t_k, *jb, max_depth=k + 1))
        bins = _dense_bins(tb, F)
        land, _ = gain_landscape(bins, g, h, jp, k, leaf=leaf)
        top2 = sorted(land.values())[-2:]
        assert top2[1] - top2[0] <= TIE_RTOL * abs(top2[1]), (ref[k:],
                                                              got[k:])
        for choice in ref[k:k + 1] + got[k:k + 1]:
            gi = set_gain(bins, g, h, jp, leaf, choice)
            assert top2[1] - gi <= TIE_RTOL * abs(top2[1]), (choice, gi)
        return
    for field in ("feature", "split_bin", "cat_flag", "cat_left", "left",
                  "right", "is_leaf"):
        np.testing.assert_array_equal(getattr(ttree, field),
                                      np.asarray(getattr(jtree, field)),
                                      err_msg=field)
    for field in ("leaf_value", "node_value", "node_weight", "node_count",
                  "split_gain"):
        np.testing.assert_array_equal(getattr(ttree, field),
                                      np.asarray(getattr(jtree, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    route = tsp.sparse_route_bins(
        teng.Tree(*(torch.as_tensor(np.asarray(a)) for a in ttree)), *tb,
        max_depth=15)
    np.testing.assert_array_equal(route.numpy(), np.asarray(
        jsp.sparse_route_bins(jtree, *jb, max_depth=15)))


def test_voting_without_a_shard_group_is_the_data_grower():
    """Voting needs a shard group to vote over; with none (one shard) the
    voting parameters grow the data-parallel tree, bit for bit."""
    x, y, bounds, jb, tb = _binned()
    (n, F), B = x.shape, bounds.shape[1] + 2
    g = torch.from_numpy(on_grid(y - 0.5))
    h = torch.full((n,), 0.25)
    trees = [tsp.grow_tree_sparse(
        *tb, g, h, torch.ones(F, dtype=torch.bool), torch.ones(n),
        params=teng.TreeParams(max_bin=B - 1, num_leaves=7,
                               parallelism=mode, top_k=2),
        num_features=F, num_bins=B)
        for mode in ("data", "voting")]
    for a, b in zip(trees[0][0], trees[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(trees[0][1], trees[1][1])


# -------------------------------------------------------------- estimators
_FITS: dict = {}


def fit_both(name, idx, val, y, **kw):
    if name not in _FITS:
        jm = jl.LightGBMClassifier(numShards=1, **kw).fit(
            frame(idx, val, y, JDataFrame))
        tm = tl.LightGBMClassifier(device="cpu", **kw).fit(
            frame(idx, val, y))
        _FITS[name] = (jm, tm)
    return _FITS[name]


def band_rows():
    """``test_benchmarks.py``'s sparse frame (1500 x 16, ~60 % zeros)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1500, 16)).astype(np.float32)
    x[rng.random(x.shape) > 0.4] = 0.0
    y = ((x[:, 0] * 2 - x[:, 1] + x[:, 2]
          + rng.normal(scale=0.3, size=1500)) > 0).astype(np.float32)
    return x, *dense_to_coo(x), y


BAND_KW = dict(numIterations=30, numLeaves=15, minDataInLeaf=5, seed=0)


def _trees_equal_or_first_tie(jb, tb):
    """The index of the first tree whose structure differs (None when all
    match, with values within 1e-5)."""
    ja, ta = jb.arrays, tb.arrays
    assert ja["feature"].shape == ta["feature"].shape
    for t in range(ja["feature"].shape[0]):
        keys = [k for k in ("feature", "threshold", "left", "right",
                            "is_leaf", "num_nodes", "cat_flag", "cat_left")
                if k in ja]
        if not all(np.array_equal(ja[k][t], ta[k][t]) for k in keys):
            return t
        np.testing.assert_allclose(ta["leaf_value"][t], ja["leaf_value"][t],
                                   rtol=1e-5, atol=1e-5)
    return None


def test_sparse_band_fit_matches_jax_and_its_band():
    x, idx, val, y = band_rows()
    jm, tm = fit_both("band", idx, val, y, **BAND_KW)
    # the engine-level test above proves ties; here every tree must match
    assert _trees_equal_or_first_tie(jm.booster, tm.booster) is None
    jp = jm.transform(frame(idx, val, pkg=JDataFrame))["probability"]
    tp = tm.transform(frame(idx, val))["probability"]
    np.testing.assert_allclose(np.asarray(tp), np.asarray(jp), rtol=0,
                               atol=PROB_ATOL)
    auc = ttr.roc_auc(y, np.asarray(tp)[:, 1])
    rows = {}
    with open(os.path.join(BENCH, "benchmarks_LightGBMSparse.csv")) as fh:
        for line in fh:
            name, value, tol = line.strip().split(",")
            rows[name] = (float(value), float(tol))
    value, tol = rows["sparse.single"]
    assert abs(auc - value) <= tol, (auc, value)


def test_coo_scoring_equals_densified_and_crosses_packages(tmp_path):
    x, idx, val, y = band_rows()
    jm, tm = fit_both("band", idx, val, y, **BAND_KW)
    sd = tsp.SparseData(idx, val, x.shape[1])
    coo = tm.booster.raw_scores(sd, device="cpu")
    np.testing.assert_allclose(tm.booster.raw_scores(x, device="cpu"), coo,
                               rtol=0, atol=RAW_ATOL)
    np.testing.assert_allclose(
        jm.booster.raw_scores(jsp.SparseData(idx, val, x.shape[1])),
        tm.booster.raw_scores(sd, device="cpu"), rtol=0, atol=PROB_ATOL)
    text = tm.get_native_model_string()
    np.testing.assert_allclose(
        jl.Booster.load_native(text).raw_scores(
            jsp.SparseData(idx, val, x.shape[1])), coo, rtol=0,
        atol=RAW_ATOL)
    np.testing.assert_allclose(
        tl.Booster.load_native(jm.booster.save_native()).raw_scores(
            sd, device="cpu"),
        jm.booster.raw_scores(jsp.SparseData(idx, val, x.shape[1])),
        rtol=0, atol=RAW_ATOL)
    # leaf indices from COO rows equal the densified rows'
    np.testing.assert_array_equal(
        tm.booster.predict_leaf(sd, device="cpu"),
        tm.booster.predict_leaf(x, device="cpu"))
    # the stage round trip; empty and all-padding frames score
    tm.save(str(tmp_path / "m"))
    back = load_stage(str(tmp_path / "m"))
    np.testing.assert_allclose(
        np.asarray(back.transform(frame(idx, val))["probability"]),
        np.asarray(tm.transform(frame(idx, val))["probability"]), rtol=0,
        atol=RAW_ATOL)
    assert tm.transform(frame(np.zeros((0, 4), np.int32), np.zeros(
        (0, 4), np.float32)))["prediction"].shape == (0,)
    pad = tm.transform(frame(np.full((3, 4), -1, np.int32),
                             np.zeros((3, 4), np.float32)))
    np.testing.assert_allclose(
        np.asarray(pad["probability"]),
        np.asarray(tm.transform(DataFrame({"features": np.zeros(
            (3, 16), np.float32)}))["probability"]), rtol=0, atol=RAW_ATOL)


def test_sparse_categorical_fit_matches_jax():
    x, idx, val, y = sparse_rows(n=1200, f=6, seed=9, cat=True)
    kw = dict(numIterations=15, numLeaves=15, minDataInLeaf=5, seed=0,
              categoricalSlotIndexes=[0])
    jm, tm = fit_both("cat", idx, val, y, **kw)
    assert tm.booster.arrays["cat_flag"].any()
    # the sparse path's bins: 16 budgeted, the reserved cut, missing
    assert tm.booster.arrays["cat_left"].shape[-1] == 19
    first = _trees_equal_or_first_tie(jm.booster, tm.booster)
    assert first is None, f"tree {first} differs"
    tp = tm.transform(frame(idx, val))["probability"]
    jp = jm.transform(frame(idx, val, pkg=JDataFrame))["probability"]
    np.testing.assert_allclose(np.asarray(tp), np.asarray(jp), rtol=0,
                               atol=PROB_ATOL)
    # the COO predictor's category routing equals the dense predictor's
    np.testing.assert_allclose(
        tm.booster.raw_scores(x, device="cpu"),
        tm.booster.raw_scores(tsp.SparseData(idx, val, 6), device="cpu"),
        rtol=0, atol=RAW_ATOL)
    text = tm.get_native_model_string()
    np.testing.assert_allclose(jl.Booster.load_native(text).raw_scores(x),
                               tm.booster.raw_scores(x, device="cpu"),
                               rtol=0, atol=RAW_ATOL)


@pytest.mark.parametrize("bad, words", [(40.0, "effective sparse bin"),
                                        (1.5, "non-negative integer")])
def test_sparse_category_errors_match_jax(bad, words):
    x, idx, val, y = sparse_rows(n=200, f=4, seed=2, cat=True)
    val = val.copy()
    val[idx == 0] = np.where(val[idx == 0] > 0, val[idx == 0], 1.0)
    val[np.flatnonzero((idx == 0).any(1))[0], 0] = bad
    kw = dict(numIterations=1, categoricalSlotIndexes=[0])
    with pytest.raises(ValueError) as jerr:
        jl.LightGBMClassifier(numShards=1, **kw).fit(
            frame(idx, val, y, JDataFrame))
    with pytest.raises(ValueError) as terr:
        tl.LightGBMClassifier(device="cpu", **kw).fit(frame(idx, val, y))
    assert str(terr.value) == str(jerr.value)
    assert words in str(terr.value)


def test_validation_and_early_stopping_match_jax(monkeypatch):
    x, idx, val, y = sparse_rows(n=700, seed=7)
    flag = np.arange(700) >= 560
    y = y.copy()
    y[flag] = np.random.default_rng(8).permutation(y[flag])
    kw = dict(numIterations=30, numLeaves=7, minDataInLeaf=5,
              validationIndicatorCol="isVal", earlyStoppingRound=3,
              isProvideTrainingMetric=True)
    seen = {}

    def spy(mod, key):
        real = mod.train

        def wrapped(*a, **k):
            seen[key] = real(*a, **k)
            return seen[key]
        monkeypatch.setattr(mod, "train", wrapped)
    spy(jax_est, "jax")
    spy(port_est, "port")
    jm = jl.LightGBMClassifier(numShards=1, **kw).fit(
        frame(idx, val, y, JDataFrame, isVal=flag))
    tm = tl.LightGBMClassifier(device="cpu", **kw).fit(
        frame(idx, val, y, isVal=flag))
    je, te = seen["jax"].evals, seen["port"].evals
    assert [sorted(e) for e in te] == [sorted(e) for e in je]
    for a, b in zip(te, je):
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-6), (k, a, b)
    assert tm.booster.best_iteration == jm.booster.best_iteration >= 0
    assert tm.booster.num_trees == jm.booster.num_trees < 30
    # a dense validation frame beside sparse training rows raises
    with pytest.raises(TypeError, match="SparseData"):
        ttr.train(tsp.SparseData(idx, val, 12), y, None,
                  ttr.TrainConfig(objective="binary", num_iterations=1),
                  valid=(x, y, None), device="cpu")
