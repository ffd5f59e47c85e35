"""GBDT training over more than one rank: data and voting parallel over
``torch.distributed`` (gloo ranks on the CPU, spawned by
``torch_shard_ranks.py``, one spawn per scenario).

Held:
- ``comm_elements_per_split`` equal to the JAX package's, and smaller
  under voting in the wide-feature regime;
- the dense and sparse growers over 2 and 4 ranks (1,203 rows, so the
  blocks are padded unevenly), and over the two-level 2 x 2 mesh, give
  the single grower's tree and per-row leaves exactly, on gradients on a
  2^-10 grid where every f32 sum is exact in any order; a categorical
  slot rides along;
- voting over a group of one rank equals data parallel exactly;
- the 2- and 4-rank and two-level dense and sparse voting trees (top_k
  2 of 10 features, so the vote selects) against the JAX package's
  ``grow_tree``/``grow_tree_sparse`` under ``shard_map`` on the same
  padded blocks, exactly;
- a bagged data-parallel fit and a sparse voting fit over 2 ranks
  against the JAX package's ``numShards=2`` fit by the tree rule
  (structure exactly, leaf values within 1e-5); the dense voting fit on
  the 40-feature frame by the same rule up to its first differing tree,
  which must be the tree the JAX package's own voting grower gives at
  that iteration's gradients once they lie on the 2^-10 grid: on
  unrounded gradients the reference's rank-local nominations move with
  its summation rounding;
- each tree's all-reduce calls and bytes: the root's totals and
  histogram (or votes and candidate columns), then
  ``comm_elements_per_split`` per split;
- sharded fits against the same fit on one rank, within the JAX
  package's tolerances (``tests/test_lightgbm_distributed.py:40-44``:
  probabilities within 5e-3, AUC within 0.02): binary data parallel,
  bagging with feature sampling, GOSS, DART, a custom objective, two
  batches with an init-score column, multiclass, the ranker, 1,203 rows over 4 ranks,
  the two-level mesh and two blocks of 2 ranks against the flat group;
- voting at ``topK=8`` on the 40-feature frame within 0.02 AUC of data
  parallel, and the ``sparse.data_parallel`` and
  ``sparse.voting_parallel`` bands of ``benchmarks_LightGBMSparse.csv``
  on ``tests/test_benchmarks.py:261-281``'s frame over 2 ranks;
- ``numShards=0`` shards from 4,096 rows;
- ``allreduce`` sums over a flat group, and over the 2 x 2 mesh in one
  call per dim.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import mmlspark_tpu.lightgbm as jl
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_tpu.lightgbm import engine as jeng
from mmlspark_tpu.lightgbm import objectives as jobj
from mmlspark_tpu.lightgbm import sparse as jsp
from mmlspark_tpu.parallel.compat import shard_map
from mmlspark_torch.lightgbm import engine as teng
from mmlspark_torch.parallel.sharding import pad_rows
from mmlspark_torch.lightgbm.trainer import roc_auc
import torch_shard_ranks as ranks

BENCH = os.path.join(os.path.dirname(__file__), "resources", "benchmarks")
PROB_ATOL = 5e-3
AUC_ATOL = 0.02
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
STRUCTURE = ("feature", "threshold", "left", "right", "is_leaf",
             "num_nodes")
_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(scenario: str) -> dict:
    """One spawn per scenario per module."""
    if scenario not in _RUNS:
        world, env = {"one_rank": (1, None), "two_ranks": (2, None),
                      "four_ranks": (4, {"LOCAL_WORLD_SIZE": "2"})}[scenario]
        _RUNS[scenario] = ranks.spawn(scenario, world, env)
    return _RUNS[scenario]


_SINGLE: dict = {}


def single_growth(kind: str):
    """The grid problem's tree and leaves from the single grower."""
    if kind not in _SINGLE:
        bins, g, h = ranks.grid_problem()
        grow = ranks.grow_dense if kind == "dense" else ranks.grow_sparse
        tree, leaf = grow(bins, g, h, np.ones(len(g), np.float32), None)
        _SINGLE[kind] = tree, leaf.numpy()
    return _SINGLE[kind]


def assert_same_tree(got: dict, kind: str):
    tree, leaf = single_growth(kind)
    for name, a, b in zip(tree._fields, got["tree"], tree):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(got["leaf"], leaf)


@pytest.mark.parametrize("F, B, k", [(28, 256, 6), (2000, 256, 20),
                                     (12, 64, 20)])
def test_comm_elements_per_split_matches_jax(F, B, k):
    for mode in ("data", "voting"):
        assert teng.comm_elements_per_split(F, B, k, mode) == \
            jeng.comm_elements_per_split(F, B, k, mode)
    data = teng.comm_elements_per_split(2000, 256, 20, "data")
    assert teng.comm_elements_per_split(2000, 256, 20, "voting") < data / 10


@pytest.mark.parametrize("scenario, key", [
    ("two_ranks", "growth"), ("four_ranks", "growth"),
    ("four_ranks", "mesh_growth")])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sharded_growers_give_the_single_tree_exactly(scenario, key, kind):
    assert_same_tree(run(scenario)[key][kind, "data"], kind)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_voting_on_one_rank_equals_data_parallel(kind):
    out = run("one_rank")
    assert_same_tree(out[kind, "voting"], kind)
    assert_same_tree(out[kind, "data"], kind)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("mode", ["data", "voting"])
def test_all_reduce_calls_and_bytes_per_tree(kind, mode):
    bins, _, _ = ranks.grid_problem()
    F, B, L, k = bins.shape[1], 16, 15, 2
    C = min(2 * k, F)
    calls, nbytes = run("two_ranks")["growth"][kind, mode]["comm"]
    per_split = teng.comm_elements_per_split(F, B, k, mode)
    if mode == "data":
        # the totals, then the root's histogram and one per split (the
        # sparse grower reduces both children: no subtraction there)
        splits = (L - 1) * (2 if kind == "sparse" else 1)
        want = (1 + 1 + splits, 3 + F * B * 3 + splits * F * B * 3)
    else:
        # the totals, the root's votes and candidates, then both
        # children's votes and candidates per split (stacked into one
        # call each by the dense grower)
        want = (1 + 2 + (L - 1) * (4 if kind == "sparse" else 2),
                3 + F + C * B * 3 + (L - 1) * per_split)
    assert (calls, nbytes) == (want[0], 4 * want[1])
    data_bytes = run("two_ranks")["growth"][kind, "data"]["comm"][1]
    if mode == "voting":
        assert nbytes < data_bytes


def test_allreduce_sums_over_two_ranks():
    """Rank r holds (r + 1) x [1, -2, 3]: the sum comes back as a new
    tensor, and no reduction runs without a group."""
    from mmlspark_torch.parallel.collectives import allreduce
    out = run("two_ranks")
    assert out["sum"] == [3.0, -6.0, 9.0]
    assert out["sum_left"] == [1.0, -2.0, 3.0]
    x = torch.ones(2)
    assert allreduce(x, None) is x


def test_allreduce_over_the_two_level_mesh():
    """Four ranks as 2 x 2: every rank counted once, in one all_reduce
    per mesh dim."""
    assert run("four_ranks")["mesh_sum"] == ([10.0, -20.0, 30.0], 2)


def test_two_level_mesh_and_auto_shards():
    out = run("four_ranks")
    assert out["mesh_shape"] == (2, 2)
    np.testing.assert_allclose(out["two_level"], out["flat"], rtol=0,
                               atol=PROB_ATOL)
    assert run("two_ranks")["auto"] == (None, True)


def test_two_shard_blocks_over_four_ranks():
    """numShards=2 on 4 ranks: two groups of 2, each training the whole
    frame on its own; rank 0's model matches the 4-rank one."""
    out = run("four_ranks")
    np.testing.assert_allclose(out["blocks"], out["flat"], rtol=0,
                               atol=PROB_ATOL)


def _single(est, cols, **kw):
    return ranks.outputs(ranks.fit(est, cols, **kw), cols)


def _binary_single(name):
    x, y = ranks.make_binary()
    cols = {"features": x, "label": y}
    kw = dict(numIterations=30, numLeaves=15)
    short = dict(kw, numIterations=10)
    if name == "data":
        return _single("LightGBMClassifier", cols, **kw), y
    if name == "bagging":
        return _single("LightGBMClassifier", cols, baggingFraction=0.8,
                       baggingFreq=1, featureFraction=0.7, **short), y
    if name in ("goss", "dart"):
        return _single("LightGBMClassifier", cols, boostingType=name,
                       **short), y
    if name == "fobj":
        return _single("LightGBMClassifier", cols,
                       fobj=ranks.logistic_fobj, **short), y
    s = np.random.default_rng(3).normal(scale=0.5, size=len(y)) \
        .astype(np.float32)
    return ranks.outputs(ranks.fit(
        "LightGBMClassifier", dict(cols, s=s), numBatches=2,
        initScoreCol="s", **dict(short, numIterations=5)), cols), y


@pytest.mark.parametrize("name", ["data", "bagging", "goss", "dart",
                                  "fobj", "batches_init"])
def test_sharded_binary_fits_match_one_rank(name):
    want, y = _binary_single(name)
    got = run("two_ranks")["binary"][name]
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    assert abs(roc_auc(y, got[:, 1]) - roc_auc(y, want[:, 1])) < AUC_ATOL
    assert roc_auc(y, got[:, 1]) > 0.9


def test_sharded_multiclass_and_ranker_match_one_rank():
    out = run("two_ranks")["breadth"]
    xm, ym = ranks.make_multiclass()
    mc = _single("LightGBMClassifier", {"features": xm, "label": ym},
                 objective="multiclass", numIterations=10, numLeaves=7)
    np.testing.assert_allclose(out["multiclass"], mc, rtol=0,
                               atol=PROB_ATOL)
    xr, rel, qid = ranks.make_ranking()
    rk = _single("LightGBMRanker", {"features": xr, "label": rel,
                                    "query": qid},
                 groupCol="query", numIterations=10, numLeaves=7,
                 minDataInLeaf=5)
    np.testing.assert_allclose(out["ranker"], rk, rtol=0, atol=PROB_ATOL)


def test_uneven_padding_over_four_ranks():
    x, y = ranks.make_binary(n=1203)
    got = run("four_ranks")["flat"]
    assert got.shape == (1203, 2)
    assert roc_auc(y, got[:, 1]) > 0.85
    want = _single("LightGBMClassifier", {"features": x, "label": y},
                   numIterations=15, numLeaves=15)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_voting_auc_near_data_parallel():
    _, y = ranks.make_binary(n=1600, f=40, seed=5)
    out = run("two_ranks")["binary"]
    auc_d = roc_auc(y, out["data_wide"][:, 1])
    auc_v = roc_auc(y, out["voting_wide"][:, 1])
    assert auc_d > 0.9
    assert abs(auc_d - auc_v) < AUC_ATOL, (auc_d, auc_v)


@pytest.mark.parametrize("mode", ["data", "voting"])
def test_sparse_bands_over_two_ranks(mode):
    rows = {}
    with open(os.path.join(BENCH, "benchmarks_LightGBMSparse.csv")) as fh:
        for line in fh:
            name, value, tol = line.strip().split(",")
            rows[name] = (float(value), float(tol))
    _, _, y = ranks.sparse_bench_frame()
    auc = roc_auc(y, run("two_ranks")["breadth"][f"sparse_{mode}"][:, 1])
    value, tol = rows[f"sparse.{mode}_parallel"]
    assert abs(auc - value) <= tol, (mode, auc, value)


# ------------------------------------------------ against the JAX package
def jax_grow_sharded(grow, shape, data, sharded, g, h, rm):
    """The JAX package's grower ``grow(*data, g, h, feature_mask,
    row_mask, psum_axis=...)`` (its static arguments bound) under
    ``shard_map``, rows over ``shape`` CPU devices: one axis, or the
    2 x 2 ``("slice", "dp")`` mesh. ``sharded`` says which of ``data``
    split by rows. Returns (tree, per-row leaf)."""
    world = int(np.prod(shape))
    axes = ("dp",) if len(shape) == 1 else ("slice", "dp")
    ax = axes[0] if len(axes) == 1 else axes
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(shape), axes)
    fn = shard_map(lambda *a: grow(*a, psum_axis=ax), mesh=mesh,
                   in_specs=(*(P(ax) if r else P() for r in sharded),
                             P(ax), P(ax), P(), P(ax)),
                   out_specs=(P(), P(ax)), check_vma=False)
    F = grow.keywords["num_features"]
    tree, leaf = jax.jit(fn)(*data, jnp.asarray(g), jnp.asarray(h),
                             jnp.ones(F, bool), jnp.asarray(rm))
    return tree, np.asarray(leaf)


def jax_sharded_growth(kind: str, mode: str, shape: tuple):
    """The grid problem's tree and leaves from the JAX package's grower
    over ``shape`` devices, rows padded and blocked as the port's ranks
    hold them."""
    bins, g, h = ranks.grid_problem()
    (bp, gp, hp), mask = pad_rows([bins, g, h], int(np.prod(shape)))
    F = bins.shape[1]
    tp = jeng.TreeParams(num_leaves=15, max_bin=15, min_data_in_leaf=5,
                         cat_features=(1,), parallelism=mode, top_k=2)
    if kind == "dense":
        grow = functools.partial(jeng.grow_tree, params=tp, num_features=F)
        data, sharded = (jnp.asarray(bp),), (True,)
    else:
        grow = functools.partial(jsp.grow_tree_sparse, params=tp,
                                 num_features=F, num_bins=16)
        data = tuple(jnp.asarray(a.numpy().astype(np.int32))
                     for a in ranks.sparse_binned(bp))
        sharded = (True, True, False)
    tree, leaf = jax_grow_sharded(grow, shape, data, sharded, gp, hp, mask)
    return tree, leaf[:len(g)]


@pytest.mark.parametrize("scenario, key, shape", [
    ("two_ranks", "growth", (2,)), ("four_ranks", "growth", (4,)),
    ("four_ranks", "mesh_growth", (2, 2))])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_voting_growers_match_jax_under_shard_map(scenario, key, shape,
                                                  kind):
    out = run(scenario)[key]
    got = out[kind, "voting"]
    jtree, jleaf = jax_sharded_growth(kind, "voting", shape)
    for name, a, b in zip(jtree._fields, got["tree"], jtree):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(got["leaf"], jleaf)
    # the vote selects: voting grows another tree than data parallel
    assert not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b
                   in zip(got["tree"], out[kind, "data"]["tree"]))


def _jax_fit(cols, **kw):
    return jl.LightGBMClassifier(numShards=2, **kw).fit(JDataFrame(cols))


def _assert_trees(jb, tb, trees=None):
    """The tree rule over the first ``trees`` trees (all by default)."""
    ja, ta = jb.arrays, tb.arrays
    sl = slice(0, trees)
    assert ta["feature"].shape == ja["feature"].shape
    for k in STRUCTURE:
        np.testing.assert_array_equal(ta[k][sl], ja[k][sl], err_msg=k)
    np.testing.assert_allclose(ta["leaf_value"][sl], ja["leaf_value"][sl],
                               **VALUE_TOL)
    np.testing.assert_allclose(tb.init_score, jb.init_score,
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["bagging", "sparse_voting"])
def test_sharded_fits_match_jax_num_shards(name):
    if name == "bagging":
        x, y = ranks.make_binary()
        jm = _jax_fit({"features": x, "label": y}, numIterations=10,
                      numLeaves=15, baggingFraction=0.8, baggingFreq=1,
                      featureFraction=0.7)
        tb = run("two_ranks")["binary"]["bagging_booster"]
    else:
        idx, val, y = ranks.sparse_bench_frame()
        jm = _jax_fit({"features_indices": idx, "features_values": val,
                       "label": y}, numIterations=30, numLeaves=15,
                      minDataInLeaf=5, seed=0, **ranks.VOTE_KW)
        tb = run("two_ranks")["breadth"]["sparse_voting_booster"]
    _assert_trees(jm.booster, tb)


def test_dense_voting_fit_matches_jax_up_to_its_rounding():
    """The 40-feature voting fit (topK=8 over 2 ranks) against the JAX
    package's: trees equal by the tree rule up to the first that
    differs; that tree is the one the JAX package's own voting grower
    gives at the same iteration once the gradients lie on the 2^-10 grid
    (every sum exact), so the difference is the reference's rounding."""
    x, y = ranks.make_binary(n=1600, f=40, seed=5)
    jm = _jax_fit({"features": x, "label": y}, numIterations=15,
                  numLeaves=15, parallelism="voting_parallel", topK=8)
    jb = jm.booster
    tb = run("two_ranks")["binary"]["voting_wide_booster"]
    ja, ta = jb.arrays, tb.arrays
    T = ja["feature"].shape[0]
    t = next((t for t in range(T) if not all(
        np.array_equal(ja[k][t], ta[k][t]) for k in STRUCTURE)), T)
    _assert_trees(jb, tb, t)
    auc_j = roc_auc(y, np.asarray(jm.transform(JDataFrame(
        {"features": x}))["probability"])[:, 1])
    auc_t = roc_auc(y, run("two_ranks")["binary"]["voting_wide"][:, 1])
    assert abs(auc_j - auc_t) < AUC_ATOL
    if t == T:
        return
    s = jb.raw_scores(x, num_iteration=t).astype(np.float32)
    g, h = jobj.get_objective("binary").grad_hess(
        jnp.asarray(s), jnp.asarray(y), jnp.ones(len(y), jnp.float32))
    g, h = ranks.on_grid(np.asarray(g)), ranks.on_grid(np.asarray(h))
    bounds = jbin.compute_bin_boundaries(x, 255, seed=0)
    bins = np.array(jbin.bin_features(jnp.asarray(x), jnp.asarray(bounds)))
    tp = jeng.TreeParams(num_leaves=15, max_bin=255,
                         parallelism="voting", top_k=8)
    grow = functools.partial(jeng.grow_tree, params=tp,
                             num_features=x.shape[1])
    tree, _ = jax_grow_sharded(grow, (2,), (jnp.asarray(bins),), (True,),
                               g, h, np.ones(len(y), np.float32))
    internal = ~np.asarray(tree.is_leaf)
    internal[int(tree.num_nodes):] = False
    for k in ("feature", "left", "right", "is_leaf"):
        np.testing.assert_array_equal(np.asarray(getattr(tree, k)),
                                      ta[k][t], err_msg=k)
    feat = np.asarray(tree.feature)[internal]
    thr = bounds[feat, np.asarray(tree.split_bin)[internal] - 1]
    np.testing.assert_array_equal(thr, ta["threshold"][t][internal])
