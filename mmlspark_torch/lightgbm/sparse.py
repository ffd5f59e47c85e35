"""Sparse (padded-COO) training path for the histogram GBDT engine.

The port of ``mmlspark_tpu/lightgbm/sparse.py`` on one device (the role of
the reference's CSR dataset path, ``lightgbm/TrainUtils.scala:33-92``):
high-dimensional hashed feature vectors, e.g. the VW featurizer's output,
train without a dense [n, F] matrix.

- Data stays padded-COO: ``indices`` [n, W] int32 with -1 padding,
  ``values`` [n, W] float32. Training memory is O(nnz) for the data plus
  an O(F·B) scratch histogram (B is small, ``sparseMaxBin`` 16 by
  default), never O(L·F·B) per-leaf state.
- Implicit zeros fall in a per-feature *zero bin*: a leaf's histogram is
  one scatter-add (``index_add_``) over the present entries, then each
  feature's zero bin receives ``leaf totals - explicit sums``, an O(F)
  correction instead of an O(n·F) densification. The JAX package's
  version is an XLA segment-sum too (no Pallas kernel), so no kernel runs
  here; on CUDA ``index_add_`` adds atomically, so sums may change in the
  last bits from run to run.
- Per-leaf histograms are replaced by per-leaf *best-split records*
  (O(L) memory): when a leaf is born its histogram is built once, its best
  split recorded (the winning category set included), and the scratch
  dropped.
- Every split step runs on the device with ``found``/``done`` masking the
  updates, as the dense grower does, so growing a tree never waits on the
  host. More than one shard (``psum_axis``: data or voting parallel)
  raises, naming the later entry that brings it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .engine import (Tree, TreeParams, _leaf_output, _split_stats_with_cat,
                     categorical_go_left_at)
from .objectives import LATER_SLICE


class SparseData(NamedTuple):
    """Host-side padded-COO feature matrix.

    indices: int32 [n, W], -1 = pad; values: float32 [n, W];
    num_features: logical width F (e.g. 2^numBits for hashed features).

    INVARIANT: indices are unique within each row (one entry per (row,
    feature)); build instances through ``coalesce_coo`` (or
    ``estimators.extract_features``, which calls it) when the source may
    carry duplicates.
    """
    indices: np.ndarray
    values: np.ndarray
    num_features: int

    @property
    def n_rows(self) -> int:
        return self.indices.shape[0]


def coalesce_coo(indices: np.ndarray, values: np.ndarray):
    """Merge duplicate feature indices within each row by summing their
    values (VW's collision semantics) → padded-COO with unique per-row
    indices. No-op (no copy) when already unique."""
    n, W = indices.shape
    srt = np.argsort(indices, axis=1, kind="stable")
    idx_s = np.take_along_axis(indices, srt, axis=1)
    dup = (idx_s[:, 1:] == idx_s[:, :-1]) & (idx_s[:, 1:] >= 0)
    if not dup.any():
        return indices, values
    val_s = np.take_along_axis(values, srt, axis=1)
    out_i = np.full((n, W), -1, np.int32)
    out_v = np.zeros((n, W), np.float32)
    for r in np.flatnonzero(dup.any(axis=1)).tolist():
        keep = idx_s[r] >= 0
        uniq, inv = np.unique(idx_s[r][keep], return_inverse=True)
        sums = np.zeros(uniq.size, np.float32)
        np.add.at(sums, inv, val_s[r][keep])
        out_i[r, :uniq.size] = uniq
        out_v[r, :uniq.size] = sums
    clean = ~dup.any(axis=1)
    out_i[clean] = indices[clean]
    out_v[clean] = values[clean]
    return out_i, out_v


class SparseBinned(NamedTuple):
    """Device-side binned COO: per-entry bin ids + per-feature zero bin."""
    indices: torch.Tensor    # i64 [n, W] (-1 pad)
    ebins: torch.Tensor      # i64 [n, W] bin of each explicit entry
    zero_bin: torch.Tensor   # i64 [F] bin implicit zeros fall in


def compute_sparse_bin_boundaries(sd: SparseData, max_bin: int = 16,
                                  sample_cnt: int = 1_000_000,
                                  seed: int = 2) -> np.ndarray:
    """Per-feature upper bin boundaries [F, max_bin+1] (+inf padded) from
    the *explicit* (nonzero) values; the zero mass is handled by the
    zero-bin correction. Two columns are reserved zero-separators (a cut at
    0.0 and one at the midpoint between the largest negative value and 0)
    so implicit zeros always occupy their own bin, as in LightGBM's
    ``ZeroAsOneBin``. The JAX package's numpy code, draw for draw."""
    F = sd.num_features
    B1 = max_bin - 1
    idx = sd.indices.ravel()
    val = sd.values.ravel().astype(np.float64)
    keep = (idx >= 0) & ~np.isnan(val)
    idx, val = idx[keep], val[keep]
    if idx.size > sample_cnt:
        rng = np.random.default_rng(seed)
        pick = rng.choice(idx.size, sample_cnt, replace=False)
        idx, val = idx[pick], val[pick]
    bounds = np.full((F, B1 + 2), np.inf, dtype=np.float64)
    bounds[:, B1] = 0.0  # zero/positive separator for every feature
    if idx.size == 0:
        bounds.sort(axis=1)
        return bounds.astype(np.float32)

    # distinct (feature, value) pairs, sorted by (feature, value)
    order = np.lexsort((val, idx))
    idx_s, val_s = idx[order], val[order]
    first = np.ones(idx_s.size, bool)
    first[1:] = (idx_s[1:] != idx_s[:-1]) | (val_s[1:] != val_s[:-1])
    idx_u, val_u = idx_s[first], val_s[first]

    starts = np.flatnonzero(np.r_[True, idx_u[1:] != idx_u[:-1]])
    counts = np.diff(np.r_[starts, idx_u.size])
    feats = idx_u[starts]

    # midpoints between consecutive distinct values within a feature
    mids = np.full(idx_u.size, np.inf)
    same_feat = idx_u[:-1] == idx_u[1:]
    mids[:-1][same_feat] = (val_u[:-1][same_feat] + val_u[1:][same_feat]) / 2

    # boundary j of feature f = midpoint after distinct-value position
    # round((j+1) * cnt_f / max_bin); features with <= B1 distinct values
    # get a cut after every distinct value (the dense path's rule)
    for j in range(B1):
        pos = np.where(
            counts <= B1, j,
            np.round((j + 1) * counts / max_bin).astype(np.int64) - 1)
        ok = (counts >= 2) & (pos >= 0) & (pos <= counts - 2)
        src = np.clip(starts + np.clip(pos, 0, None), 0, mids.size - 1)
        bounds[feats, j] = np.where(ok, mids[src], np.inf)

    # negative/zero separator: midpoint between each feature's largest
    # negative value and 0 (so negatives never share the zero bin)
    neg_max = np.maximum.reduceat(
        np.where(val_u < 0, val_u, -np.inf), starts)
    has_neg = np.isfinite(neg_max)
    bounds[feats[has_neg], B1 + 1] = neg_max[has_neg] / 2.0
    bounds.sort(axis=1)  # duplicate cuts just leave empty bins
    return bounds.astype(np.float32)


def bin_sparse(sd: SparseData, boundaries: np.ndarray,
               device: str | torch.device = "cpu") -> SparseBinned:
    """Map explicit entries to bin ids on the host, column by column (peak
    memory O(n · (max_bin-1)) whatever W), and move them to ``device``.
    The dense path's rule: bin = #(bounds < v) + 1; bin 0 = missing."""
    n, W = sd.indices.shape
    ebins = np.zeros((n, W), np.int32)
    for wcol in range(W):
        col_idx = sd.indices[:, wcol]
        col_val = sd.values[:, wcol]
        safe = np.clip(col_idx, 0, boundaries.shape[0] - 1)
        b = boundaries[safe]                      # [n, B1]
        ids = (b < col_val[:, None]).sum(axis=1) + 1
        ids = np.where(np.isnan(col_val), 0, ids)
        ebins[:, wcol] = np.where(col_idx >= 0, ids, 0)
    zero_bin = (boundaries < 0.0).sum(axis=1).astype(np.int32) + 1

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)
    return SparseBinned(indices=dev(sd.indices), ebins=dev(ebins),
                        zero_bin=dev(zero_bin))


def pad_sparse(sd: SparseData, multiple: int):
    """Row-pad a SparseData up to a multiple (for sharding); pad rows have
    no entries (indices -1), the COO analogue of padding dense rows."""
    n = sd.n_rows
    n_pad = (-n) % multiple
    if n_pad == 0:
        return sd, np.ones(n, np.float32)
    idx = np.pad(sd.indices, [(0, n_pad), (0, 0)], constant_values=-1)
    val = np.pad(sd.values, [(0, n_pad), (0, 0)])
    mask = np.ones(n + n_pad, np.float32)
    mask[n:] = 0.0
    return SparseData(idx, val, sd.num_features), mask


# ----------------------------------------------------------------- training
def _leaf_hist_sparse(binned: SparseBinned, gh1: torch.Tensor,
                      sel: torch.Tensor, F: int, B: int) -> torch.Tensor:
    """[F, B, 3] histogram of the rows selected by ``sel`` (f32 weights):
    one ``index_add_`` over the present entries, then the zero-bin
    correction (rows with no explicit entry for feature f add at
    ``zero_bin[f]``: leaf totals minus explicit sums)."""
    idx, ebins, zero_bin = binned
    n, W = idx.shape
    key = torch.where(idx >= 0, idx * B + ebins, F * B)
    entry = gh1 * sel[:, None]                             # [n, 3]
    vals = entry[:, None, :].expand(n, W, 3)
    flat = torch.zeros(F * B + 1, 3, dtype=torch.float32, device=idx.device)
    flat.index_add_(0, key.reshape(-1), vals.reshape(-1, 3))
    hist = flat[:F * B].reshape(F, B, 3)
    explicit = hist.sum(dim=1)                             # [F, 3]
    totals = entry.sum(dim=0)                              # [3]
    cells = torch.arange(F, device=idx.device) * B + zero_bin
    return hist.reshape(F * B, 3).index_add(
        0, cells, totals[None, :] - explicit).reshape(F, B, 3)


def _best_split_of_hist(hist: torch.Tensor, p: TreeParams,
                        feature_mask: torch.Tensor,
                        cat_idx: torch.Tensor | None = None):
    """[F, B, 3] histogram → best-split record (gain, feat, bin, lg, lh,
    lc, is_cat, cat_left[B]), all device tensors. The dense engine's
    validity rules; ``cat_idx`` ([Fc] i64, sorted) marks the categorical
    columns, the only ones re-scanned in ratio order. The winning
    category set is part of the record: this engine keeps no per-leaf
    histogram to re-derive the sort from later."""
    B = hist.shape[-2]
    (gl, hl, cl, gr, hr, cr, gain), order = _split_stats_with_cat(
        hist, p, cat_idx=cat_idx)
    valid = (feature_mask[:, None]
             & (cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
             & (hl >= p.min_sum_hessian_in_leaf)
             & (hr >= p.min_sum_hessian_in_leaf))
    gain = torch.where(valid, gain, float("-inf")).reshape(-1)
    flat = torch.argmax(gain)               # first max, as jnp.argmax
    j = flat // B
    b = flat % B
    if cat_idx is not None:
        # the winning feature's compact categorical column (the dense
        # engine's searchsorted); guarded by is_cat
        f_c = torch.clamp(torch.searchsorted(cat_idx, j.reshape(1)), 0,
                          cat_idx.shape[0] - 1).reshape(())
        is_cat = _take(cat_idx, f_c) == j
        order_j = _take(order, f_c)                         # [B]
        ar = torch.arange(B, device=hist.device)
        rank = torch.empty_like(ar).scatter_(0, order_j, ar)
        left_set = is_cat & (rank <= b)
    else:
        is_cat = torch.zeros((), dtype=torch.bool, device=hist.device)
        left_set = torch.zeros(B, dtype=torch.bool, device=hist.device)
    return (_take(gain, flat), j, b, _take(gl.reshape(-1), flat),
            _take(hl.reshape(-1), flat), _take(cl.reshape(-1), flat),
            is_cat, left_set)


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d index tensor, without a host sync."""
    return t.index_select(0, i.reshape(1)).reshape(t.shape[1:])


def grow_tree_sparse(indices: torch.Tensor, ebins: torch.Tensor,
                     zero_bin: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, feature_mask: torch.Tensor,
                     row_mask: torch.Tensor, *, params: TreeParams,
                     num_features: int, num_bins: int,
                     psum_axis: str | None = None):
    """Grow one tree on binned COO data (the JAX ``grow_tree_sparse`` on
    one shard). Returns (Tree, per-row leaf node id [n] i64) on the data's
    device. ``num_bins`` is B, the zero/missing bin included. Memory:
    O(nnz) data + O(F·B) scratch + O(L) split records. ``psum_axis``
    (rows sharded over a mesh axis, data or voting parallel) raises."""
    if psum_axis is not None:
        raise NotImplementedError(
            "sparse growth over more than one shard (data or voting "
            f"parallel) is not ported yet; it comes with {LATER_SLICE}")
    p = params
    dev = indices.device
    binned = SparseBinned(indices, ebins, zero_bin)
    n, W = indices.shape
    F, B = num_features, num_bins
    L = p.num_leaves
    NN = 2 * L - 1
    max_depth = p.max_depth if p.max_depth and p.max_depth > 0 else 10 ** 9
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    cat_idx = (torch.tensor(sorted(set(p.cat_features)), dtype=i64,
                            device=dev) if p.cat_features else None)
    feature_mask = feature_mask.to(dev)

    g = grad * row_mask
    h = hess * row_mask
    gh1 = torch.stack([g, h, row_mask], dim=1)   # [n, 3]

    def record(sel):
        return _best_split_of_hist(_leaf_hist_sparse(binned, gh1, sel, F, B),
                                   p, feature_mask, cat_idx=cat_idx)

    total_g, total_h, total_c = g.sum(), h.sum(), row_mask.sum()
    root_out = _leaf_output(total_g, total_h, p)
    node_ids = torch.arange(NN, device=dev)
    at_root = node_ids == 0
    zeros_nn = torch.zeros(NN, dtype=f32, device=dev)
    feature = torch.zeros(NN, dtype=i32, device=dev)
    split_bin = torch.full((NN,), B, dtype=i32, device=dev)
    cat_flag = torch.zeros(NN, dtype=torch.bool, device=dev)
    cat_left = torch.zeros(NN, B, dtype=torch.bool, device=dev)
    left = torch.full((NN,), -1, dtype=i32, device=dev)
    right = torch.full((NN,), -1, dtype=i32, device=dev)
    leaf_value = torch.where(at_root, p.learning_rate * root_out, zeros_nn)
    is_leaf = at_root.clone()
    split_gain = zeros_nn.clone()
    node_value = torch.where(at_root, root_out, zeros_nn)
    node_weight = torch.where(at_root, total_h, zeros_nn)
    node_count = torch.where(at_root, total_c, zeros_nn)
    num_nodes = torch.ones((), dtype=i32, device=dev)

    root = record(row_mask)
    slot_ids = torch.arange(L, device=dev)
    first = slot_ids == 0
    # per-slot best-split records (the histogram pool's summary)
    rec_gain = torch.where(first, root[0], float("-inf"))
    rec_feat = torch.where(first, root[1], 0)
    rec_bin = torch.where(first, root[2], 0)
    rec_left = torch.where(first[:, None], torch.stack(root[3:6])[None, :],
                           0.0)
    rec_total = torch.where(first[:, None],
                            torch.stack([total_g, total_h, total_c])[None],
                            0.0)
    rec_cat = first & root[6]
    rec_cat_left = first[:, None] & root[7][None, :]

    slot = torch.zeros(n, dtype=i64, device=dev)
    slot_node = torch.zeros(L, dtype=i64, device=dev)
    slot_depth = torch.zeros(L, dtype=i32, device=dev)
    n_slots = torch.ones((), dtype=i64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    def row_bin_of(f_star):
        """Per-row bin of feature f_star: its explicit entry's bin if
        present, else the feature's zero bin. O(n·W)."""
        match = indices == f_star
        has = match.any(dim=1)
        eb = torch.where(match, ebins, 0).amax(dim=1)
        return torch.where(has, eb, _take(zero_bin, f_star))

    for _ in range(L - 1):
        active = slot_ids < n_slots
        ok = active & (slot_depth < max_depth) & (n_slots < L)
        gains = torch.where(ok, rec_gain, float("-inf"))
        s_star = torch.argmax(gains)
        best_gain = _take(gains, s_star)
        found = (best_gain > p.min_gain_to_split) & ~done

        f_star = _take(rec_feat, s_star)
        b_star = _take(rec_bin, s_star)
        lg, lh, lc = _take(rec_left, s_star).unbind(0)
        tg, th, tc = _take(rec_total, s_star).unbind(0)
        rg, rh, rc = tg - lg, th - lh, tc - lc

        # ---- route rows, then both children's records; when no split
        # applies the selections are all-zero and the updates are masked
        is_cat_star = _take(rec_cat, s_star)
        left_set_star = _take(rec_cat_left, s_star)          # bool [B]
        rb = row_bin_of(f_star)
        right_rule = torch.where(is_cat_star, ~left_set_star[rb],
                                 rb > b_star)
        in_parent = (slot == s_star) & found
        goes_right = in_parent & right_rule
        left_rec = record((in_parent & ~goes_right).to(f32))
        right_rec = record(goes_right.to(f32))

        # ---- apply (masked by found)
        parent = _take(slot_node, s_star)
        new_slot = n_slots
        nl = num_nodes.to(i64)
        nr = nl + 1
        is_p = (node_ids == parent) & found
        is_l = (node_ids == nl) & found
        is_r = (node_ids == nr) & found
        out_l = _leaf_output(lg, lh, p)
        out_r = _leaf_output(rg, rh, p)
        feature = torch.where(is_p, f_star.to(i32), feature)
        split_bin = torch.where(is_p, b_star.to(i32), split_bin)
        cat_flag = torch.where(is_p, is_cat_star, cat_flag)
        cat_left = torch.where(is_p[:, None], left_set_star[None, :],
                               cat_left)
        left = torch.where(is_p, nl.to(i32), left)
        right = torch.where(is_p, nr.to(i32), right)
        leaf_value = torch.where(is_l, p.learning_rate * out_l,
                                 torch.where(is_r, p.learning_rate * out_r,
                                             leaf_value))
        is_leaf = (is_leaf & ~is_p) | is_l | is_r
        split_gain = torch.where(is_p, best_gain, split_gain)
        node_value = torch.where(is_l, out_l,
                                 torch.where(is_r, out_r, node_value))
        node_weight = torch.where(is_l, lh,
                                  torch.where(is_r, rh, node_weight))
        node_count = torch.where(is_l, lc, torch.where(is_r, rc, node_count))
        num_nodes = num_nodes + 2 * found.to(i32)

        slot = torch.where(goes_right, new_slot, slot)
        depth = _take(slot_depth, s_star) + 1
        is_s = (slot_ids == s_star) & found
        is_n = (slot_ids == new_slot) & found

        def put(rec, l_val, r_val):
            if rec.dim() == 1:
                return torch.where(is_s, l_val, torch.where(is_n, r_val,
                                                            rec))
            return torch.where(is_s[:, None], l_val[None],
                               torch.where(is_n[:, None], r_val[None], rec))
        slot_node = put(slot_node, nl, nr)
        slot_depth = torch.where(is_s | is_n, depth, slot_depth)
        rec_gain = put(rec_gain, left_rec[0], right_rec[0])
        rec_feat = put(rec_feat, left_rec[1], right_rec[1])
        rec_bin = put(rec_bin, left_rec[2], right_rec[2])
        rec_left = put(rec_left, torch.stack(left_rec[3:6]),
                       torch.stack(right_rec[3:6]))
        rec_total = put(rec_total, torch.stack([lg, lh, lc]),
                        torch.stack([rg, rh, rc]))
        rec_cat = put(rec_cat, left_rec[6], right_rec[6])
        rec_cat_left = put(rec_cat_left, left_rec[7], right_rec[7])
        n_slots = n_slots + found.to(i64)
        done = ~found

    tree = Tree(feature=feature, split_bin=split_bin, cat_flag=cat_flag,
                cat_left=cat_left, left=left, right=right,
                leaf_value=leaf_value, is_leaf=is_leaf,
                split_gain=split_gain, node_value=node_value,
                node_weight=node_weight, node_count=node_count,
                num_nodes=num_nodes)
    return tree, slot_node[slot]


def sparse_route_bins(tree: Tree, indices: torch.Tensor, ebins: torch.Tensor,
                      zero_bin: torch.Tensor, *, max_depth: int
                      ) -> torch.Tensor:
    """Route binned COO rows through one tree → leaf node ids [n] (i64)
    (validation scoring; the sparse ``engine.tree_route_bins``)."""
    dev = indices.device
    feature = tree.feature.to(dev, torch.int64)
    split_bin = tree.split_bin.to(dev, torch.int64)
    left = tree.left.to(dev, torch.int64)
    right = tree.right.to(dev, torch.int64)
    is_leaf = tree.is_leaf.to(dev)
    cat_flag = tree.cat_flag.to(dev)
    B = tree.cat_left.shape[-1]
    cat_left = tree.cat_left.to(dev).reshape(-1)
    node = torch.zeros(indices.shape[0], dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        f = feature[node]                                   # [n]
        match = indices == f[:, None]
        has = match.any(dim=1)
        eb = torch.where(match, ebins, 0).amax(dim=1)
        rb = torch.where(has, eb, zero_bin[f])
        go_left = torch.where(cat_flag[node],
                              cat_left[node * B + torch.clamp(rb, max=B - 1)],
                              rb <= split_bin[node])
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node


# --------------------------------------------------------------- prediction
# rows per chunk of the COO predictor: its [rows, T, W] match tensor stays
# near 2^25 elements
_PREDICT_ELEMS = 1 << 25


def predict_leaf_nodes_sparse(tree_arrays, indices: torch.Tensor,
                              values: torch.Tensor, *, max_depth: int
                              ) -> torch.Tensor:
    """Per-(row, tree) leaf node ids [n, T] (i64) on raw COO features (the
    counterpart of ``booster._predict_leaf_nodes``); absent features read
    0.0. Rows go in chunks so the [rows, T, W] match stays bounded."""
    (feature, threshold, left, right, _, is_leaf, default_left, cat_flag,
     cat_left) = tree_arrays
    T = feature.shape[0]
    n, W = indices.shape
    chunk = max(1, _PREDICT_ELEMS // max(T * W, 1))
    out = []
    for s in range(0, n, chunk):
        idx, val = indices[s:s + chunk], values[s:s + chunk]
        m = idx.shape[0]
        node = torch.zeros((m, T), dtype=torch.int64, device=idx.device)
        t_idx = torch.arange(T, device=idx.device)[None, :]
        for _ in range(max_depth):
            f = feature[t_idx, node]                        # [m, T]
            thr = threshold[t_idx, node]
            match = idx[:, None, :] == f[:, :, None]        # [m, T, W]
            xv = torch.where(match, val[:, None, :], 0.0).sum(dim=-1)
            # NaN = missing: default_left, as the dense predictor
            missing = torch.isnan(xv)
            go_left = torch.where(missing, default_left[t_idx, node],
                                  xv <= thr)
            if cat_left is not None:
                go_left = torch.where(
                    cat_flag[t_idx, node],
                    categorical_go_left_at(xv, missing, cat_left, t_idx,
                                           node),
                    go_left)
            nxt = torch.where(go_left, left[t_idx, node],
                              right[t_idx, node])
            node = torch.where(is_leaf[t_idx, node], node, nxt)
        out.append(node)
    return torch.cat(out) if out else torch.zeros(
        (0, T), dtype=torch.int64, device=indices.device)
