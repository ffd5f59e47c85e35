"""Histogram-GBDT training engine: leaf-wise tree growth on device tensors.

The port of ``mmlspark_tpu/lightgbm/engine.py`` for one device, the
data-parallel histogram mode and numerical features:

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
  (``engine.py:449-457``).

Categorical splits, voting-parallel and multi-device growth come with the
GBDT breadth slice (the trainer refuses their configurations until then).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hist import hist


class TreeParams(NamedTuple):
    """Growth hyperparameters (the JAX ``TreeParams`` fields this engine
    reads, with the same defaults; its voting and categorical fields come
    with the GBDT breadth slice)."""
    num_leaves: int = 31
    max_depth: int = -1          # <= 0 means unlimited (bounded by leaves)
    max_bin: int = 255
    learning_rate: float = 0.1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0  # cap on leaf outputs (0 = off)


class Tree(NamedTuple):
    """Fixed-capacity tree tensors; node ids are append-ordered. The
    JAX ``Tree`` also carries ``cat_flag``/``cat_left`` for categorical
    splits, which this slice does not grow."""
    feature: torch.Tensor      # i32 [NN] split feature (internal nodes)
    split_bin: torch.Tensor    # i32 [NN] go left iff bin <= split_bin
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
        (one for the integer fields, one for the float fields)."""
        ints = torch.stack([self.feature, self.split_bin, self.left,
                            self.right, self.is_leaf.to(torch.int32),
                            self.num_nodes.to(torch.int32).expand_as(
                                self.feature)]).cpu().numpy()
        floats = torch.stack([self.leaf_value, self.split_gain,
                              self.node_value, self.node_weight,
                              self.node_count]).cpu().numpy()
        return Tree(feature=ints[0], split_bin=ints[1], left=ints[2],
                    right=ints[3], leaf_value=floats[0],
                    is_leaf=ints[4].astype(bool), split_gain=floats[1],
                    node_value=floats[2], node_weight=floats[3],
                    node_count=floats[4], num_nodes=np.int32(ints[5][0]))


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


def grow_tree(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              feature_mask: torch.Tensor, row_mask: torch.Tensor, *,
              params: TreeParams, num_features: int,
              hist_impl: str | None = None):
    """Grow one tree on ``bins``' device. Returns (Tree, per-row leaf node
    id [n] i64), both on that device.

    bins: uint8 [n, F]; grad/hess: f32 [n]; feature_mask: bool [F]
    (feature_fraction sampling); row_mask: f32 [n] (0 = row excluded).
    ``hist_impl`` selects the histogram implementation (``None``: the K1
    kernel on CUDA, the plain version on the CPU; ``"torch"``: the plain
    version anywhere, the comparison path on the card).
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

    g = grad * row_mask
    h = hess * row_mask
    cnt_w = row_mask  # counts honour the bagging mask

    # ---- root
    total_g, total_h, total_c = g.sum(), h.sum(), cnt_w.sum()
    root_out = _leaf_output(total_g, total_h, p)
    node_ids = torch.arange(NN, device=dev)
    at_root = node_ids == 0
    zeros_nn = torch.zeros(NN, dtype=f32, device=dev)
    feature = torch.zeros(NN, dtype=i32, device=dev)
    split_bin = torch.full((NN,), B, dtype=i32, device=dev)
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
        """Histogram of one row subset → [F, B, 3]: a masked full-row scan
        (the LightGBM single-leaf ConstructHistogram)."""
        vals = gh1 if row_sel is None else gh1 * row_sel[:, None]
        return hist(bins, vals, num_bins=B, impl=hist_impl)

    # ---- root histogram: every (unmasked) row is in slot 0. Later splits
    # scan only the smaller child and derive the larger by subtraction.
    hists = torch.zeros(L, F, B, 3, dtype=f32, device=dev)
    hists[0] = local_hist(None)

    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    slot_node = torch.zeros(L, dtype=torch.int64, device=dev)
    slot_depth = torch.zeros(L, dtype=i32, device=dev)
    n_slots = torch.ones((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    slot_ids = torch.arange(L, device=dev)
    feat_ok = feature_mask.to(dev)[None, :, None]
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)

    def take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """t[i] for a 0-d index tensor, as a 0-d tensor, without a host
        sync (plain indexing with a tensor would read it back)."""
        return t.index_select(0, i.reshape(1)).reshape(t.shape[1:])

    for _ in range(L - 1):
        active = slot_ids < n_slots
        deep_ok = slot_depth < max_depth

        # ---- best (slot, feature, bin) over every current leaf
        gl, hl, cl, gr, hr, cr, gain = _split_stats(hists, p)
        valid = (active[:, None, None] & deep_ok[:, None, None] & feat_ok
                 & (cl >= p.min_data_in_leaf) & (cr >= p.min_data_in_leaf)
                 & (hl >= p.min_sum_hessian_in_leaf)
                 & (hr >= p.min_sum_hessian_in_leaf)
                 & (n_slots < L))
        gain = torch.where(valid, gain, neg_inf).reshape(-1)

        flat_best = torch.argmax(gain)         # first max, as jnp.argmax
        s_star = flat_best // (F * B)
        f_star = (flat_best // B) % F
        b_star = flat_best % B
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
        # split applies, sel is all-zero and every update below is masked.
        new_slot = n_slots
        row_bin = bins.index_select(1, f_star.reshape(1)).reshape(-1)
        in_parent = (slot == s_star) & found
        goes_right = in_parent & (row_bin.to(torch.int64) > b_star)
        use_left = lc <= rc  # scan the smaller child, derive the sibling
        sel = torch.where(use_left, in_parent & ~goes_right, goes_right)
        h_small = local_hist(sel.to(f32))
        parent_h = take(hists, s_star)
        h_other = parent_h - h_small
        h_left = torch.where(use_left, h_small, h_other)
        h_right = torch.where(use_left, h_other, h_small)

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
        hists.index_copy_(0, s_star.reshape(1),
                          torch.where(found, h_left, parent_h)[None])
        hists.index_copy_(0, new_slot_c.reshape(1),
                          torch.where(found, h_right,
                                      take(hists, new_slot_c))[None])
        depth = take(slot_depth, s_star) + 1
        is_s = (slot_ids == s_star) & found
        is_n = (slot_ids == new_slot) & found
        slot_node = torch.where(is_s, nl, torch.where(is_n, nr, slot_node))
        slot_depth = torch.where(is_s | is_n, depth, slot_depth)
        n_slots = n_slots + found.to(torch.int64)
        done = ~found

    tree = Tree(feature=feature, split_bin=split_bin, left=left, right=right,
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
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        f = feature[node]
        row_bin = bins.gather(1, f[:, None]).reshape(-1).to(torch.int64)
        nxt = torch.where(row_bin <= split_bin[node], left[node],
                          right[node])
        node = torch.where(is_leaf[node], node, nxt)
    return node
