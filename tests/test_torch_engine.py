"""grow_tree in the port against the JAX engine on the same bins, grad and
hess (about 2000 x 8, 15 leaves).

Held: feature, split_bin, left, right, is_leaf and num_nodes exactly; leaf
and node values within 1e-5 (f32 sums taken in another order); routing
(tree_route_bins) exactly. Where a split differs, the test must show that
the reference's top two gains at that split tie within f32 noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_tpu.lightgbm import engine as jeng
from mmlspark_torch.lightgbm import engine as teng

VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
TIE_RTOL = 1e-5          # f32 noise on a gain: a few ulps of its inputs


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


def make_problem(seed, n=2000, F=8, max_bin=255, dup_feature=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    x[rng.random(n) < 0.03, 2] = np.nan
    if dup_feature:
        x[:, 1] = x[:, 0]
    logit = x[:, 0] + 0.5 * x[:, 1] - x[:, 3] * x[:, 4]
    y = (logit + rng.normal(size=n) > 0).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-rng.normal(scale=0.3, size=n)))
    g = (p - y).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32)
    bounds = jbin.compute_bin_boundaries(x, max_bin)
    bins = np.array(jbin.bin_features(jnp.asarray(x), jnp.asarray(bounds)))
    return bins, g, h


def grow_both(bins, g, h, params: dict):
    n, F = bins.shape
    jp = jeng.TreeParams(**params)
    jtree, jleaf = jeng.grow_tree(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.ones(F, bool), jnp.ones(n, jnp.float32), params=jp,
        num_features=F)
    ttree, tleaf = teng.grow_tree(
        torch.from_numpy(bins), torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(F, dtype=torch.bool), torch.ones(n),
        params=teng.TreeParams(**params), num_features=F)
    return jtree, np.asarray(jleaf), ttree.to_numpy(), tleaf.numpy()


def split_sequence(tree):
    """[(parent, feature, split_bin)] in creation order: split k made
    nodes 2k+1 and 2k+2."""
    left = np.asarray(tree.left)
    out = []
    for k in range((int(tree.num_nodes) - 1) // 2):
        parent = int(np.flatnonzero(left == 2 * k + 1)[0])
        out.append((parent, int(tree.feature[parent]),
                    int(tree.split_bin[parent])))
    return out


def gain_landscape(bins, g, h, params: dict, k: int):
    """The reference's gains (float64) over every (leaf, feature, bin)
    candidate at its k-th split, with the engine's validity rules.
    Returns (gains [M], candidates [(leaf node, feature, bin)])."""
    n, F = bins.shape
    p = jeng.TreeParams(**params)._replace(num_leaves=k + 1)
    tree, _ = jeng.grow_tree(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
        jnp.ones(F, bool), jnp.ones(n, jnp.float32), params=p,
        num_features=F)
    leaf = np.asarray(jeng.tree_route_bins(tree, jnp.asarray(bins),
                                           max_depth=k + 1))
    B = p.max_bin + 1
    depth = np.zeros(len(tree.left), int)
    for i in range(int(tree.num_nodes)):
        for c in (int(tree.left[i]), int(tree.right[i])):
            if c >= 0:
                depth[c] = depth[i] + 1
    max_depth = p.max_depth if p.max_depth > 0 else 10 ** 9

    def leaf_gain(gs, hs):
        t = np.sign(gs) * np.maximum(np.abs(gs) - p.lambda_l1, 0.0)
        return t * t / (hs + p.lambda_l2 + 1e-35)
    gains, cands = [], []
    for node in np.unique(leaf):
        if depth[node] >= max_depth:
            continue
        rows = leaf == node
        for f in range(F):
            hg = np.bincount(bins[rows, f], g[rows].astype(np.float64), B)
            hh = np.bincount(bins[rows, f], h[rows].astype(np.float64), B)
            hc = np.bincount(bins[rows, f], minlength=B).astype(np.float64)
            gl, hl, cl = np.cumsum(hg), np.cumsum(hh), np.cumsum(hc)
            gr, hr, cr = gl[-1] - gl, hl[-1] - hl, cl[-1] - cl
            gain = (leaf_gain(gl, hl) + leaf_gain(gr, hr)
                    - leaf_gain(gl[-1], hl[-1]))
            ok = ((cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
                  & (hl >= p.min_sum_hessian_in_leaf)
                  & (hr >= p.min_sum_hessian_in_leaf))
            for b in np.flatnonzero(ok):
                gains.append(gain[b])
                cands.append((int(node), f, int(b)))
    return np.asarray(gains), cands


def assert_tie(bins, g, h, params, k, ref_split, port_split):
    """Split k differs: both choices must be among the reference's
    top gains, and its top two must tie within f32 noise."""
    gains, cands = gain_landscape(bins, g, h, params, k)
    order = np.argsort(-gains, kind="stable")
    top, second = gains[order[0]], gains[order[1]]
    assert top - second <= TIE_RTOL * abs(top), (
        f"split {k} differs ({ref_split} vs {port_split}) but the "
        f"reference's top two gains {top} and {second} do not tie")
    for choice in (ref_split, port_split):
        if choice is None:        # that side stopped: no split was valid
            continue
        gi = gains[cands.index(choice)]
        assert top - gi <= TIE_RTOL * abs(top), (choice, gi, top)


CASES = {
    "default": dict(num_leaves=15, learning_rate=1.0),
    "l2_mindata": dict(num_leaves=15, learning_rate=1.0, lambda_l2=1.0,
                       min_data_in_leaf=40),
    "depth_l1_64bins": dict(num_leaves=15, learning_rate=0.5, max_depth=4,
                            lambda_l1=0.5, max_bin=63),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_grow_tree_matches_reference(case, seed):
    params = CASES[case]
    bins, g, h = make_problem(seed, max_bin=params.get("max_bin", 255))
    jtree, jleaf, ttree, tleaf = grow_both(bins, g, h, params)
    ref, got = split_sequence(jtree), split_sequence(ttree)
    first_diff = next((k for k, (a, b) in enumerate(zip(ref, got))
                       if a != b), None)
    if first_diff is not None or len(ref) != len(got):
        k = first_diff if first_diff is not None else min(len(ref),
                                                          len(got))
        ref_split = ref[k] if k < len(ref) else None
        port_split = got[k] if k < len(got) else None
        assert_tie(bins, g, h, params, k, ref_split, port_split)
        return          # past a tie the trees legitimately diverge
    for field in ("feature", "split_bin", "left", "right", "is_leaf"):
        np.testing.assert_array_equal(getattr(ttree, field),
                                      np.asarray(getattr(jtree, field)),
                                      err_msg=field)
    assert int(ttree.num_nodes) == int(jtree.num_nodes)
    for field in ("leaf_value", "node_value", "node_weight", "node_count",
                  "split_gain"):
        np.testing.assert_allclose(getattr(ttree, field),
                                   np.asarray(getattr(jtree, field)),
                                   err_msg=field, **VALUE_TOL)
    np.testing.assert_array_equal(tleaf, jleaf)
    # routing binned rows through the grown tree gives the same leaves
    max_depth = params["num_leaves"]
    jroute = np.asarray(jeng.tree_route_bins(jtree, jnp.asarray(bins),
                                             max_depth=max_depth))
    troute = teng.tree_route_bins(
        teng.Tree(*(torch.as_tensor(np.asarray(a)) for a in ttree)),
        torch.from_numpy(bins), max_depth=max_depth).numpy()
    np.testing.assert_array_equal(troute, jroute)
    np.testing.assert_array_equal(troute, tleaf)


def test_tie_check_sees_a_duplicated_feature():
    """The tie rule itself: with feature 1 a copy of feature 0, the root's
    best split exists on both with the same gain, so choosing either one
    passes assert_tie, and the reference's top two gains tie."""
    params = CASES["default"]
    bins, g, h = make_problem(5, dup_feature=True)
    np.testing.assert_array_equal(bins[:, 0], bins[:, 1])
    gains, cands = gain_landscape(bins, g, h, params, 0)
    best = cands[int(np.argmax(gains))]
    assert best[1] == 0
    twin = (best[0], 1, best[2])
    assert_tie(bins, g, h, params, 0, best, twin)
    with pytest.raises(AssertionError):
        worst = cands[int(np.argmin(gains))]
        assert_tie(bins, g, h, params, 0, best, worst)
