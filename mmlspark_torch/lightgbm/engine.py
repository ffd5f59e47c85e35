"""Histogram-GBDT training engine: leaf-wise tree growth on device tensors.

The port of ``mmlspark_tpu/lightgbm/engine.py`` for one device and the
data-parallel histogram mode, with numerical and categorical features:

- binned features are uint8 (``binning.py``), so each histogram is one pass
  of (grad, hess, count) into a fixed ``[F, bins, 3]`` tensor — kernel K1
  (``hist.py``) on the GPU;
- split finding is a vectorized cumulative sum + argmax over the histograms
  of ALL current leaves at once (best-first, leaf-wise growth);
- the tree grows through ``num_leaves - 1`` split steps over fixed-capacity
  tensors. The JAX ``fori_loop`` skips a step's body once ``done`` is set
  (``engine.py:526-539``); here every step runs, and ``found``/``done``
  stay device tensors that mask each update (``torch.where`` mirrors of the
  JAX ``apply``/``no_split`` branches, ``engine.py:465-524``), so growing a
  tree never waits on the device;
- rows carry a leaf *slot* id in ``[0, num_leaves)``; each split builds the
  histogram of the smaller child with a masked full-row scan
  (``engine.py:297``) and derives the larger child by subtraction
  (``engine.py:449-457``);
- categorical columns (``TreeParams.cat_features``, identity-binned so
  category c lives in bin c+1) are re-scanned in gradient/hessian-ratio
  order (LightGBM's many-vs-many heuristic, ``_split_stats_with_cat``): a
  split at sorted position b sends the b+1 best-ratio categories left, and
  the tree keeps that set as a bin mask (``Tree.cat_left``). Every sort is
  stable, as ``jnp.argsort`` is, so ties (empty bins, the missing bin, all
  at +inf) order alike in both packages.

More than one shard (``group``, ``parallel/collectives.py``): each rank
holds a contiguous block of rows, and the histogram information is
all-reduced over the group, the reference's socket allreduce
(``TrainUtils.scala:609-625``). Two modes, as in the JAX package:

- data parallel: every new leaf's full ``[F, B, 3]`` histogram is reduced,
  so every rank holds the global histograms;
- voting parallel (PV-Tree): each rank nominates its local top-K features
  per new leaf, the votes are reduced, and only the global top-2K
  candidate columns ``[2K, B, 3]`` are reduced; the histogram state stays
  rank-local (``comm_elements_per_split`` counts what a split moves).

SPMD safety (the JAX ``engine.py:38-40``): every collective runs on every
rank in every step of the split loop, whatever the rank's rows hold; when
no split applies its inputs are zero-masked, never skipped, so the ranks
stay in lockstep. Every choice is made from reduced values, which are
bit-identical on every rank, so the ranks grow the same tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.collectives import allreduce
from .hist import hist


class TreeParams(NamedTuple):
    """Growth hyperparameters (the JAX ``TreeParams``, with the same
    fields and defaults)."""
    num_leaves: int = 31
    max_depth: int = -1          # <= 0 means unlimited (bounded by leaves)
    max_bin: int = 255
    learning_rate: float = 0.1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    parallelism: str = "data"    # data | voting (PV-Tree top-K)
    top_k: int = 20              # voting: local nominations per shard
    cat_features: tuple = ()     # feature indices with set-based splits
    cat_smooth: float = 10.0     # hessian smoothing in the g/h cat sort
    max_cat_threshold: int = 32  # max categories in a split's left set
    max_delta_step: float = 0.0  # cap on leaf outputs (0 = off)


class Tree(NamedTuple):
    """Fixed-capacity tree tensors; node ids are append-ordered. Trees
    grown without a categorical slot carry all-False ``cat_flag`` and
    ``cat_left``, so every tree has the same fields."""
    feature: torch.Tensor      # i32 [NN] split feature (internal nodes)
    split_bin: torch.Tensor    # i32 [NN] go left iff bin <= split_bin
                               #   (categorical: rank(bin) <= split_bin)
    cat_flag: torch.Tensor     # bool [NN] node splits on a category set
    cat_left: torch.Tensor     # bool [NN, B] bin ids routed left
    left: torch.Tensor         # i32 [NN]
    right: torch.Tensor        # i32 [NN]
    leaf_value: torch.Tensor   # f32 [NN] (shrunk by learning_rate)
    is_leaf: torch.Tensor      # bool [NN]
    split_gain: torch.Tensor   # f32 [NN]
    node_value: torch.Tensor   # f32 [NN] unshrunk output at node
    node_weight: torch.Tensor  # f32 [NN] sum of hessians under node
    node_count: torch.Tensor   # f32 [NN] row count under node
    num_nodes: torch.Tensor    # i32 scalar

    def to_numpy(self) -> "Tree":
        """The same tree as host numpy arrays, in two device→host copies
        (one for the integer and bool fields, one for the float fields)."""
        NN = self.feature.shape[0]
        ints = torch.cat([
            torch.stack([self.feature, self.split_bin, self.left,
                         self.right, self.is_leaf.to(torch.int32),
                         self.cat_flag.to(torch.int32),
                         self.num_nodes.to(torch.int32).expand_as(
                             self.feature)]).reshape(-1),
            self.cat_left.to(torch.int32).reshape(-1)]).cpu().numpy()
        rows = ints[:7 * NN].reshape(7, NN)
        floats = torch.stack([self.leaf_value, self.split_gain,
                              self.node_value, self.node_weight,
                              self.node_count]).cpu().numpy()
        return Tree(feature=rows[0], split_bin=rows[1],
                    cat_flag=rows[5].astype(bool),
                    cat_left=ints[7 * NN:].reshape(NN, -1).astype(bool),
                    left=rows[2], right=rows[3], leaf_value=floats[0],
                    is_leaf=rows[4].astype(bool), split_gain=floats[1],
                    node_value=floats[2], node_weight=floats[3],
                    node_count=floats[4], num_nodes=np.int32(rows[6][0]))


def _thresh_l1(g, l1: float):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def _leaf_output(g, h, p: TreeParams):
    out = -_thresh_l1(g, p.lambda_l1) / (h + p.lambda_l2 + 1e-35)
    if p.max_delta_step > 0:
        # LightGBM max_delta_step: cap the leaf output magnitude
        out = torch.clamp(out, -p.max_delta_step, p.max_delta_step)
    return out


def _leaf_gain(g, h, p: TreeParams):
    t = _thresh_l1(g, p.lambda_l1)
    if p.max_delta_step > 0:
        # gain at the CLIPPED output (LightGBM's GetLeafSplitGainGivenOutput)
        o = _leaf_output(g, h, p)
        return -(2.0 * t * o + (h + p.lambda_l2) * o * o)
    return t * t / (h + p.lambda_l2 + 1e-35)


def comm_elements_per_split(num_features: int, num_bins: int,
                            top_k: int, parallelism: str) -> int:
    """Histogram elements a rank all-reduces per split: the new leaf's
    full histogram in data parallel; one vote row plus 2K candidate
    columns for each of the two children in voting parallel (the JAX
    ``comm_elements_per_split``)."""
    if parallelism == "voting":
        cand = min(2 * top_k, num_features)
        return 2 * (num_features + cand * num_bins * 3)
    return num_features * num_bins * 3


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, ties to
    the lower index (``jax.lax.top_k``'s order): a stable descending
    sort, so every rank picks the same columns from the same values."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _split_stats(hist_t: torch.Tensor, p: TreeParams):
    """[..., B, 3] histogram(s) → per-bin split stats.

    Returns (gl, hl, cl, gr, hr, cr, gain), each [..., B]: left stats are
    cumulative (split = "bin <= b goes left"), right = totals - left.
    """
    cum = torch.cumsum(hist_t, dim=-2)
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    tot = cum[..., -1:, :]
    gr = tot[..., 0] - gl
    hr = tot[..., 1] - hl
    cr = tot[..., 2] - cl
    gain = (_leaf_gain(gl, hl, p) + _leaf_gain(gr, hr, p)
            - _leaf_gain(tot[..., 0], tot[..., 1], p))
    return gl, hl, cl, gr, hr, cr, gain


def _split_stats_with_cat(hist_t: torch.Tensor, p: TreeParams, *,
                          cat_idx: torch.Tensor | None = None,
                          cat_mask: torch.Tensor | None = None):
    """``_split_stats`` with categorical columns re-scanned in
    gradient/hessian-ratio-sorted order (the JAX
    ``_split_stats_with_cat``): position b then means "the b+1 best-ratio
    categories go left", and positions past ``max_cat_threshold`` get
    gain -inf.

    At most one of ``cat_idx`` (feature columns to gather, i64, for
    full-width ``[..., F, B, 3]`` layouts) or ``cat_mask`` (bool per
    column, for per-leaf candidate layouts whose columns vary, as the
    voting nomination's) may be given; neither gives the plain stats.
    Returns ``(stats7, order)``, ``order`` the stable ratio argsort
    (``[..., Fc | C, B]``, i64) or ``None``.
    """
    stats = _split_stats(hist_t, p)
    if cat_idx is None and cat_mask is None:
        return stats, None
    cat_hist = hist_t if cat_idx is None else hist_t.index_select(-3,
                                                                  cat_idx)
    inf = torch.tensor(float("inf"), dtype=hist_t.dtype,
                       device=hist_t.device)
    ratio = torch.where(cat_hist[..., 2] > 0,
                        cat_hist[..., 0] / (cat_hist[..., 1] + p.cat_smooth),
                        inf)                      # empty bins sort last
    # the missing bin (0) never enters a left set: predict and SHAP send
    # missing right unconditionally, so training must match
    ratio[..., 0] = inf
    order = torch.argsort(ratio, dim=-1, stable=True)
    sorted_hist = torch.gather(
        cat_hist, -2, order[..., None].expand(*order.shape, 3))
    cs = _split_stats(sorted_hist, p)
    B = cat_hist.shape[-2]
    cap = torch.arange(B, device=hist_t.device) < p.max_cat_threshold
    cs = cs[:6] + (torch.where(cap, cs[6], -inf),)
    if cat_mask is not None:
        m = cat_mask[..., None]
        stats = tuple(torch.where(m, c, s) for s, c in zip(stats, cs))
    else:
        stats = tuple(s.index_copy(-2, cat_idx, c) for s, c in zip(stats,
                                                                   cs))
    return stats, order


def category_bin(xv: torch.Tensor, missing: torch.Tensor, B: int):
    """The bin of raw category value ``xv`` under identity binning (value c
    in bin c+1) and whether it can be in a bitset at all: missing,
    negative, non-integer or out-of-range values are in none."""
    iv = torch.nan_to_num(xv).to(torch.int32)
    in_range = (~missing) & (xv >= 0) & (iv < B - 1) \
        & (xv == iv.to(xv.dtype))
    return torch.clamp(iv + 1, 0, B - 1).to(torch.int64), in_range


def categorical_go_left(xv: torch.Tensor, missing: torch.Tensor,
                        cat_left_rows: torch.Tensor) -> torch.Tensor:
    """Raw-value category routing (the JAX ``categorical_go_left``, one
    copy of the bitset rule): value c goes left iff bin c+1 is in the
    row's left set; missing, negative, non-integer and out-of-range values
    go right, LightGBM's NaN/unseen rule.

    cat_left_rows: bool [..., B], the cat_left row of each element of
    ``xv``."""
    cat_bin, in_range = category_bin(xv, missing, cat_left_rows.shape[-1])
    picked = torch.gather(cat_left_rows, -1, cat_bin[..., None])[..., 0]
    return picked & in_range


def categorical_go_left_at(xv: torch.Tensor, missing: torch.Tensor,
                           cat_left: torch.Tensor, t_idx: torch.Tensor,
                           node: torch.Tensor) -> torch.Tensor:
    """``categorical_go_left`` for every (row, tree) pair of the
    predictors: ``xv``, ``missing`` and ``node`` are [n, T], and the left
    set of node ``node`` of tree ``t_idx`` is read straight from the flat
    [T, NN, B] mask ``cat_left``, never gathered as [n, T, B] rows."""
    T, NN, B = cat_left.shape
    cat_bin, in_range = category_bin(xv, missing, B)
    flat = (t_idx * NN + node) * B + cat_bin
    return cat_left.reshape(-1)[flat] & in_range


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              feature_mask: torch.Tensor, row_mask: torch.Tensor, *,
              params: TreeParams, num_features: int,
              hist_impl: str | None = None, group=None):
    """Grow one tree on ``bins``' device. Returns (Tree, per-row leaf node
    id [n] i64), both on that device.

    bins: uint8 [n, F]; grad/hess: f32 [n]; feature_mask: bool [F]
    (feature_fraction sampling); row_mask: f32 [n] (0 = row excluded).
    ``hist_impl`` selects the histogram implementation (``None``: the K1
    kernel on CUDA, the plain version on the CPU; ``"torch"``: the plain
    version anywhere, the comparison path on the card). ``group`` is the
    shard group (``parallel/collectives.py``) whose ranks hold the other
    blocks of rows; ``None`` is one shard.
    """
    p = params
    dev = bins.device
    n, F = bins.shape
    if F != num_features:
        raise ValueError(f"bins have {F} features, expected {num_features}")
    L = p.num_leaves
    NN = 2 * L - 1
    B = p.max_bin + 1  # bin 0 = missing
    max_depth = p.max_depth if p.max_depth and p.max_depth > 0 else 10 ** 9
    i32, f32 = torch.int32, torch.float32
    voting = p.parallelism == "voting" and group is not None
    C = min(2 * p.top_k, F)  # global candidate features per leaf (voting)
    has_cat = len(p.cat_features) > 0
    cat_idx = None
    if has_cat:
        # sorted: a chosen feature maps back to its compact categorical
        # column by searchsorted
        cat_idx = torch.tensor(sorted(set(p.cat_features)), dtype=torch.int64,
                               device=dev)
        cat_feat_mask = torch.zeros(F, dtype=torch.bool, device=dev)
        cat_feat_mask[cat_idx] = True
        bin_ids = torch.arange(B, dtype=i32, device=dev)
    feature_mask = feature_mask.to(dev)

    def psum(x):
        return allreduce(x, group)

    g = grad * row_mask
    h = hess * row_mask
    cnt_w = row_mask  # counts honour the bagging mask

    # ---- root
    total_g, total_h, total_c = psum(torch.stack(
        [g.sum(), h.sum(), cnt_w.sum()])).unbind(0)
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

    gh1 = torch.stack([g, h, cnt_w], dim=1)  # [n, 3]

    def local_hist(row_sel: torch.Tensor | None) -> torch.Tensor:
        """Rank-local histogram of one row subset → [F, B, 3]: a masked
        full-row scan (the LightGBM single-leaf ConstructHistogram).
        Callers reduce it (or vote and gather) as the mode demands."""
        vals = gh1 if row_sel is None else gh1 * row_sel[:, None]
        return hist(bins, vals, num_bins=B, impl=hist_impl)

    def local_top_features(hs: torch.Tensor) -> torch.Tensor:
        """[M, F, B, 3] local histograms → f32 votes [M, F]: each rank
        nominates its top-K features by local best-bin gain (PV-Tree),
        honouring the feature mask; categorical columns by their
        ratio-sorted scan."""
        stats, _ = _split_stats_with_cat(hs, p, cat_idx=cat_idx)
        fgain = stats[6].amax(dim=-1)                      # [M, F]
        fgain = torch.where(feature_mask[None, :], fgain, float("-inf"))
        top = top_k_indices(fgain, min(p.top_k, F))
        return torch.zeros_like(fgain).scatter_(1, top, 1.0)

    def vote_and_gather(hs: torch.Tensor):
        """[M, F, B, 3] local histograms → (candidate features [M, C] i64,
        their globally reduced columns [M, C, B, 3]): voting's two
        collectives, run on every step."""
        votes = psum(local_top_features(hs))               # [M, F]
        cand = top_k_indices(votes, C)                     # [M, C]
        cols = torch.gather(hs, 1, cand[:, :, None, None].expand(
            -1, -1, B, 3))
        return cand, psum(cols)

    # ---- root histogram: every (unmasked) row is in slot 0. Later splits
    # scan only the smaller child and derive the larger by subtraction.
    # Data parallel keeps global histograms; voting keeps local ones
    # beside the global candidate columns.
    hists = torch.zeros(L, F, B, 3, dtype=f32, device=dev)
    h_root = local_hist(None)
    if voting:
        hists[0] = h_root
        cand0, glob0 = vote_and_gather(h_root[None])
        cand_feat = torch.zeros(L, C, dtype=torch.int64, device=dev)
        cand_feat[0] = cand0[0]
        cand_hist = torch.zeros(L, C, B, 3, dtype=f32, device=dev)
        cand_hist[0] = glob0[0]
    else:
        hists[0] = psum(h_root)

    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    slot_node = torch.zeros(L, dtype=torch.int64, device=dev)
    slot_depth = torch.zeros(L, dtype=i32, device=dev)
    n_slots = torch.ones((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    slot_ids = torch.arange(L, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)

    def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """t[i] for a 0-d index tensor, as a 0-d tensor, without a host
        sync (plain indexing with a tensor would read it back)."""
        return t.index_select(0, i.reshape(1)).reshape(t.shape[1:])

    for _ in range(L - 1):
        active = slot_ids < n_slots
        deep_ok = slot_depth < max_depth

        # ---- best (slot, feature, bin) over every current leaf, from
        # global histogram information; the categorical columns by their
        # ratio-sorted scan (under voting the candidate columns vary per
        # leaf, so they are picked by mask)
        if voting:
            search, n_search = cand_hist, C
            feat_ok = feature_mask[cand_feat][:, :, None]
            (gl, hl, cl, gr, hr, cr, gain), cat_order = \
                _split_stats_with_cat(
                    search, p,
                    cat_mask=cat_feat_mask[cand_feat] if has_cat else None)
        else:
            search, n_search = hists, F
            feat_ok = feature_mask[None, :, None]
            (gl, hl, cl, gr, hr, cr, gain), cat_order = \
                _split_stats_with_cat(search, p, cat_idx=cat_idx)
        valid = (active[:, None, None] & deep_ok[:, None, None] & feat_ok
                 & (cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
                 & (hl >= p.min_sum_hessian_in_leaf)
                 & (hr >= p.min_sum_hessian_in_leaf)
                 & (n_slots < L))
        gain = torch.where(valid, gain, neg_inf).reshape(-1)

        flat_best = torch.argmax(gain)         # first max, as jnp.argmax
        s_star = flat_best // (n_search * B)
        j_star = (flat_best // B) % n_search
        b_star = flat_best % B
        f_star = take(take(cand_feat, s_star), j_star) if voting else j_star
        best_gain = take(gain, flat_best)
        found = (best_gain > p.min_gain_to_split) & ~done

        # child stats of the chosen split (the JAX expression order)
        lg = take(gl.reshape(-1), flat_best)
        lh = take(hl.reshape(-1), flat_best)
        lc = take(cl.reshape(-1), flat_best)
        tg = lg + take(gr.reshape(-1), flat_best)
        th = lh + take(hr.reshape(-1), flat_best)
        tc = lc + take(cr.reshape(-1), flat_best)
        rg, rh, rc = tg - lg, th - lh, tc - lc

        # ---- row routing + the histogram of the smaller child. When no
        # split applies, sel is all-zero and every update below is masked;
        # the collectives run all the same (lockstep)
        new_slot = n_slots
        row_bin = bins.index_select(1, f_star.reshape(1)).reshape(-1)
        in_parent = (slot == s_star) & found
        if has_cat:
            # rank of each bin in the chosen (slot, feature)'s ratio sort;
            # left = the b_star+1 best-ratio categories. Under voting the
            # sort sits at the candidate column j_star; otherwise f_star
            # maps into its compact categorical column (0 when not
            # categorical: unused then, guarded by is_cat)
            is_cat = take(cat_feat_mask, f_star)
            if voting:
                order_star = take(take(cat_order, s_star), j_star)  # [B]
            else:
                f_star_c = torch.clamp(
                    torch.searchsorted(cat_idx, f_star.reshape(1)), 0,
                    cat_idx.shape[0] - 1).reshape(())
                order_star = take(take(cat_order, s_star), f_star_c)
            rank = torch.empty_like(bin_ids).scatter_(0, order_star,
                                                      bin_ids)
            left_set = is_cat & (rank <= b_star)                    # [B]
            rb = row_bin.to(torch.int64)
            right_rule = torch.where(is_cat, rank[rb] > b_star, rb > b_star)
        else:
            right_rule = row_bin.to(torch.int64) > b_star
        goes_right = in_parent & right_rule
        use_left = lc <= rc  # scan the smaller child, derive the sibling
        sel = torch.where(use_left, in_parent & ~goes_right, goes_right)
        h_small = local_hist(sel.to(f32))
        if not voting:
            h_small = psum(h_small)
        parent_h = take(hists, s_star)
        h_other = parent_h - h_small
        h_left = torch.where(use_left, h_small, h_other)
        h_right = torch.where(use_left, h_other, h_small)
        if voting:
            child_cand, child_glob = vote_and_gather(
                torch.stack([h_left, h_right]))

        # ---- apply (masked by found)
        parent = take(slot_node, s_star)
        nl = num_nodes.to(torch.int64)
        nr = nl + 1
        is_p = (node_ids == parent) & found
        is_l = (node_ids == nl) & found
        is_r = (node_ids == nr) & found
        out_l = _leaf_output(lg, lh, p)
        out_r = _leaf_output(rg, rh, p)
        feature = torch.where(is_p, f_star.to(i32), feature)
        split_bin = torch.where(is_p, b_star.to(i32), split_bin)
        if has_cat:
            cat_flag = torch.where(is_p, is_cat, cat_flag)
            cat_left = torch.where(is_p[:, None], left_set[None, :],
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
        # new_slot == L only when no split can apply (valid demands
        # n_slots < L); clamp keeps the masked write in bounds
        new_slot_c = torch.clamp(new_slot, max=L - 1)

        def put(t, at_s, at_n):
            """t with rows s_star and new_slot replaced where found."""
            t.index_copy_(0, s_star.reshape(1),
                          torch.where(found, at_s, take(t, s_star))[None])
            t.index_copy_(0, new_slot_c.reshape(1),
                          torch.where(found, at_n, take(t, new_slot_c))[None])

        put(hists, h_left, h_right)
        if voting:
            put(cand_feat, child_cand[0], child_cand[1])
            put(cand_hist, child_glob[0], child_glob[1])
        depth = take(slot_depth, s_star) + 1
        is_s = (slot_ids == s_star) & found
        is_n = (slot_ids == new_slot) & found
        slot_node = torch.where(is_s, nl, torch.where(is_n, nr, slot_node))
        slot_depth = torch.where(is_s | is_n, depth, slot_depth)
        n_slots = n_slots + found.to(torch.int64)
        done = ~found

    tree = Tree(feature=feature, split_bin=split_bin, cat_flag=cat_flag,
                cat_left=cat_left, left=left, right=right,
                leaf_value=leaf_value, is_leaf=is_leaf,
                split_gain=split_gain, node_value=node_value,
                node_weight=node_weight, node_count=node_count,
                num_nodes=num_nodes)
    return tree, slot_node[slot]


def tree_route_bins(tree: Tree, bins: torch.Tensor, *,
                    max_depth: int) -> torch.Tensor:
    """Route binned rows through one tree → leaf node ids [n] (i64)."""
    dev = bins.device
    feature = tree.feature.to(dev, torch.int64)
    split_bin = tree.split_bin.to(dev, torch.int64)
    left = tree.left.to(dev, torch.int64)
    right = tree.right.to(dev, torch.int64)
    is_leaf = tree.is_leaf.to(dev)
    cat_flag = tree.cat_flag.to(dev)
    B = tree.cat_left.shape[-1]
    cat_left = tree.cat_left.to(dev).reshape(-1)
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        f = feature[node]
        row_bin = bins.gather(1, f[:, None]).reshape(-1).to(torch.int64)
        cat_bin = torch.clamp(row_bin, max=B - 1)
        go_left = torch.where(cat_flag[node], cat_left[node * B + cat_bin],
                              row_bin <= split_bin[node])
        nxt = torch.where(go_left, left[node], right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node
