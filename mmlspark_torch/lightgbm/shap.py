"""TreeSHAP feature contributions.

Reference ``featuresShap`` (``lightgbm/booster/LightGBMBooster.scala:357`` →
native ``LGBM_BoosterPredictForMatSingle`` with predict_contrib): per-row
per-feature Shapley values plus a bias term (expected value).

The port's own copy of ``mmlspark_tpu/lightgbm/shap.py`` (host numpy, no
framework): the path-dependent TreeSHAP algorithm (Lundberg et al. 2018),
exact Shapley values in O(leaves · depth²) per tree per row, categorical
nodes included. Scoring stays on the device; SHAP is an explainability
call, as in the reference, where it is a separate prediction mode too.
"""

from __future__ import annotations

import numpy as np


class _Path:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, depth_cap: int):
        self.feature_index = np.zeros(depth_cap, dtype=np.int64)
        self.zero_fraction = np.zeros(depth_cap, dtype=np.float64)
        self.one_fraction = np.zeros(depth_cap, dtype=np.float64)
        self.pweight = np.zeros(depth_cap, dtype=np.float64)

    def copy(self, length: int) -> "_Path":
        p = _Path(len(self.pweight))
        for a in ("feature_index", "zero_fraction", "one_fraction",
                  "pweight"):
            getattr(p, a)[:length + 1] = getattr(self, a)[:length + 1]
        return p


def _extend(p: _Path, length: int, zero_frac, one_frac, feat):
    p.feature_index[length] = feat
    p.zero_fraction[length] = zero_frac
    p.one_fraction[length] = one_frac
    p.pweight[length] = 1.0 if length == 0 else 0.0
    for i in range(length - 1, -1, -1):
        p.pweight[i + 1] += one_frac * p.pweight[i] * (i + 1) / (length + 1)
        p.pweight[i] = zero_frac * p.pweight[i] * (length - i) / (length + 1)


def _unwind(p: _Path, length: int, idx: int):
    one = p.one_fraction[idx]
    zero = p.zero_fraction[idx]
    nxt = p.pweight[length]
    for i in range(length - 1, -1, -1):
        if one != 0:
            tmp = p.pweight[i]
            p.pweight[i] = nxt * (length + 1) / ((i + 1) * one)
            nxt = tmp - p.pweight[i] * zero * (length - i) / (length + 1)
        else:
            p.pweight[i] = p.pweight[i] * (length + 1) / (zero * (length - i))
    for i in range(idx, length):
        p.feature_index[i] = p.feature_index[i + 1]
        p.zero_fraction[i] = p.zero_fraction[i + 1]
        p.one_fraction[i] = p.one_fraction[i + 1]


def _unwound_sum(p: _Path, length: int, idx: int) -> float:
    one = p.one_fraction[idx]
    zero = p.zero_fraction[idx]
    total = 0.0
    nxt = p.pweight[length]
    for i in range(length - 1, -1, -1):
        if one != 0:
            tmp = nxt * (length + 1) / ((i + 1) * one)
            total += tmp
            nxt = p.pweight[i] - tmp * zero * (length - i) / (length + 1)
        else:
            total += p.pweight[i] / (zero * (length - i) / (length + 1))
    return total


def tree_shap_values(arrays: dict, t: int, x: np.ndarray,
                     num_features: int, depth_cap: int = 64) -> np.ndarray:
    """SHAP values of tree ``t`` for rows ``x`` → [n, F+1] (last = bias)."""
    feature = arrays["feature"][t]
    threshold = arrays["threshold"][t]
    cat_flag = arrays["cat_flag"][t] if "cat_flag" in arrays else None
    cat_left = arrays["cat_left"][t] if "cat_left" in arrays else None
    left = arrays["left"][t]
    right = arrays["right"][t]
    leaf_value = arrays["leaf_value"][t].astype(np.float64)
    is_leaf = arrays["is_leaf"][t]
    count = arrays["node_count"][t].astype(np.float64)
    default_left = arrays["default_left"][t] if "default_left" in arrays \
        else np.ones_like(is_leaf)

    n = x.shape[0]
    phi = np.zeros((n, num_features + 1), dtype=np.float64)

    # expected value (bias): weighted mean of leaves
    def node_mean(node):
        if is_leaf[node]:
            return leaf_value[node]
        cl, cr = count[left[node]], count[right[node]]
        tot = max(cl + cr, 1e-12)
        return (node_mean(left[node]) * cl + node_mean(right[node]) * cr) \
            / tot

    bias = node_mean(0)

    for r in range(n):
        row = x[r]

        def recurse(node, path: _Path, length: int, zero_frac, one_frac,
                    feat):
            path = path.copy(length)
            _extend(path, length, zero_frac, one_frac, feat)
            length += 1
            if is_leaf[node]:
                for i in range(1, length):
                    w = _unwound_sum(path, length - 1, i)
                    f = path.feature_index[i]
                    phi[r, f] += w * (path.one_fraction[i]
                                      - path.zero_fraction[i]) \
                        * leaf_value[node]
                return
            f = int(feature[node])
            xv = row[f]
            if cat_flag is not None and cat_flag[node]:
                # categorical: membership of the raw category's bin
                # (identity binning: category c -> bin c+1); mirrors
                # _predict_leaf_nodes exactly — non-integer, negative,
                # out-of-range, and missing all go right
                if (not np.isfinite(xv)) or xv < 0 \
                        or xv != np.floor(xv):
                    goes_left = False
                else:
                    b = int(xv) + 1
                    goes_left = bool(cat_left[node, b]) \
                        if 0 <= b < cat_left.shape[1] else False
            else:
                goes_left = bool(default_left[node]) if np.isnan(xv) \
                    else xv <= threshold[node]
            hot, cold = (left[node], right[node]) if goes_left \
                else (right[node], left[node])
            tot = max(count[node], 1e-12)
            hot_frac = count[hot] / tot
            cold_frac = count[cold] / tot
            incoming_zero, incoming_one = 1.0, 1.0
            path_idx = -1
            for i in range(1, length):
                if path.feature_index[i] == f:
                    path_idx = i
                    break
            if path_idx >= 0:
                incoming_zero = path.zero_fraction[path_idx]
                incoming_one = path.one_fraction[path_idx]
                _unwind(path, length - 1, path_idx)
                length -= 1
            recurse(hot, path, length, incoming_zero * hot_frac,
                    incoming_one, f)
            recurse(cold, path, length, incoming_zero * cold_frac, 0.0, f)

        recurse(0, _Path(depth_cap), 0, 1.0, 1.0, -1)
        phi[r, num_features] += bias
    return phi


def booster_shap_values(booster, x: np.ndarray,
                        num_features: int,
                        start_iteration: int = 0,
                        num_iteration: int | None = None) -> np.ndarray:
    """Per-class SHAP values: [n, K*(F+1)] with each class's block ending
    in its bias slot — the reference's contract for multiclass
    ``featuresShap`` (K=1 collapses to [n, F+1]). Trees are interleaved by
    class (tree t explains class t % K). ``start_iteration`` skips the
    leading iterations' trees, matching ``raw_scores`` so the SHAP sum
    tracks the same margin."""
    x = np.asarray(x, dtype=np.float64)
    K = max(booster.num_class, 1)
    blk = num_features + 1
    out = np.zeros((x.shape[0], K * blk), dtype=np.float64)
    t_end = booster._effective_trees(num_iteration)
    t_start = max(int(start_iteration), 0) * K
    depth_cap = booster.max_depth_bound + 2
    for t in range(t_start, t_end):
        k = t % K
        out[:, k * blk:(k + 1) * blk] += tree_shap_values(
            booster.arrays, t, x, num_features, depth_cap=depth_cap) \
            * float(booster.tree_weights[t])
    if booster.average_output:
        # rf: raw_scores divides the tree sum by the iteration count —
        # the SHAP sum must track the same margin
        out /= max((t_end - t_start) // K, 1)
    init = np.asarray(booster.init_score).reshape(-1)
    for k in range(K):
        if init.size:
            out[:, k * blk + num_features] += float(
                init[k] if init.size > k else init[0])
    return out
