"""The boosting loop: objective → tree → scores, on one device.

Role of the reference's ``trainCore`` iteration loop
(``lightgbm/TrainUtils.scala:360-427``). The port of
``mmlspark_tpu/lightgbm/trainer.py`` for gbdt boosting on dense features
with one model per iteration. Each iteration is a plain Python step:

1. gradients and hessians from the objective, at the running scores;
2. ``grow_tree`` at learning rate 1;
3. the shrinkage as one isolated multiply on the finished leaf values
   (as the JAX ``make_growers`` does, ``trainer.py:892-913``);
4. the score update from each row's leaf.

Trees stay on the device during the loop and come to the host once each,
after it. The JAX package's scan-chunk fusion and cross-fit trace cache are
XLA dispatch devices with no counterpart here. Every configuration outside
this slice raises ``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device, synchronize
from .binning import bin_features, bin_upper_value, compute_bin_boundaries
from .booster import Booster
from .engine import Tree, TreeParams, grow_tree
from .objectives import LATER_SLICE, canonical_objective, get_objective


@dataclasses.dataclass
class TrainConfig:
    """Training configuration (same field names and defaults as the JAX
    package's ``TrainConfig`` for the fields this slice reads)."""
    objective: str = "regression"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    boosting_type: str = "gbdt"
    num_class: int = 1
    sigmoid: float = 1.0
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    boost_from_average: bool = True
    seed: int = 0
    bin_sample_count: int = 200_000
    early_stopping_round: int = 0
    categorical_features: tuple = ()
    max_delta_step: float = 0.0
    max_bin_by_feature: tuple = ()

    def __post_init__(self):
        self.objective = canonical_objective(self.objective)
        later = []
        if self.boosting_type != "gbdt":
            later.append(f"boostingType={self.boosting_type!r}")
        if (self.bagging_fraction < 1.0 or self.pos_bagging_fraction != 1.0
                or self.neg_bagging_fraction != 1.0):
            later.append("bagging")
        if self.feature_fraction < 1.0:
            later.append("featureFraction < 1")
        if self.num_class > 1:
            later.append("multiclass")
        if self.categorical_features:
            later.append("categorical slots")
        if self.early_stopping_round > 0:
            later.append("early stopping")
        if self.max_bin_by_feature:
            later.append("maxBinByFeature")
        if later:
            raise NotImplementedError(
                f"{', '.join(later)} not ported yet; this comes with "
                f"{LATER_SLICE}")

    def tree_params(self) -> TreeParams:
        return TreeParams(
            num_leaves=self.num_leaves, max_depth=self.max_depth,
            max_bin=self.max_bin, learning_rate=self.learning_rate,
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step)


@dataclasses.dataclass
class TrainResult:
    booster: Booster
    trees: list[Tree]                 # host numpy trees, in order
    seconds: dict                     # wall time by phase (binning, boosting)


def train(x: np.ndarray, y: np.ndarray, w: np.ndarray | None,
          config: TrainConfig, *, feature_names: list[str] | None = None,
          device: str | torch.device | None = None,
          hist_impl: str | None = None) -> TrainResult:
    """Training loop. x [n, F] float32 (NaN = missing), y [n], on
    ``device`` (default CUDA). ``hist_impl`` is engine plumbing: ``None``
    takes K1 on CUDA and the plain histogram on the CPU, ``"torch"`` the
    plain histogram on any device."""
    cfg = config
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, F = x.shape
    w_np = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)

    pos_weight = cfg.scale_pos_weight
    if cfg.is_unbalance and cfg.objective == "binary":
        npos = float((y > 0).sum())
        pos_weight = (n - npos) / max(npos, 1.0)
    obj = get_objective(cfg.objective, num_class=cfg.num_class,
                        sigmoid=cfg.sigmoid, pos_weight=pos_weight,
                        boost_from_average=cfg.boost_from_average)
    tp = cfg.tree_params()

    # ---- binning (host boundaries, device mapping)
    t0 = time.perf_counter()
    boundaries = compute_bin_boundaries(x, cfg.max_bin,
                                        sample_cnt=cfg.bin_sample_count,
                                        seed=cfg.seed)
    bins = bin_features(torch.from_numpy(x).to(dev),
                        torch.from_numpy(boundaries))
    y_dev = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    w_dev = torch.as_tensor(w_np, device=dev)
    synchronize(dev)
    t1 = time.perf_counter()

    # ---- init scores
    base_score = np.float32(obj.init_score(np.asarray(y), w_np))
    scores = torch.full((n,), float(base_score), dtype=torch.float32,
                        device=dev)
    feat_mask = torch.ones(F, dtype=torch.bool, device=dev)
    row_mask = torch.ones(n, dtype=torch.float32, device=dev)
    lr = torch.tensor(tp.learning_rate, dtype=torch.float32, device=dev)
    grow_tp = tp._replace(learning_rate=1.0)

    dev_trees: list[Tree] = []
    for _ in range(cfg.num_iterations):
        g, h = obj.grad_hess(scores, y_dev, w_dev)
        tree, row_leaf = grow_tree(bins, g, h, feat_mask, row_mask,
                                   params=grow_tp, num_features=F,
                                   hist_impl=hist_impl)
        # growth ran at lr=1; the shrinkage is one isolated f32 multiply
        tree = tree._replace(leaf_value=tree.leaf_value * lr)
        scores = scores + tree.leaf_value[row_leaf]
        dev_trees.append(tree)
    trees = [t.to_numpy() for t in dev_trees]
    t2 = time.perf_counter()

    booster = build_booster(trees, boundaries, cfg, base_score,
                            feature_names)
    return TrainResult(booster=booster, trees=trees,
                       seconds={"binning": t1 - t0, "boosting": t2 - t1})


def build_booster(trees: list[Tree], boundaries: np.ndarray,
                  cfg: TrainConfig, base_score, feature_names,
                  tree_weights: np.ndarray | None = None) -> Booster:
    T = len(trees)
    NN = 2 * cfg.num_leaves - 1
    arr = {k: np.zeros((T, NN), dt) for k, dt in [
        ("feature", np.int32), ("threshold", np.float32),
        ("left", np.int32), ("right", np.int32),
        ("leaf_value", np.float32), ("is_leaf", bool),
        ("split_gain", np.float32), ("node_weight", np.float32),
        ("node_count", np.float32), ("node_value", np.float32)]}
    arr["num_nodes"] = np.zeros(T, np.int32)
    for t, tree in enumerate(trees):
        arr["feature"][t] = tree.feature
        arr["left"][t] = tree.left
        arr["right"][t] = tree.right
        arr["leaf_value"][t] = tree.leaf_value
        arr["is_leaf"][t] = tree.is_leaf
        arr["split_gain"][t] = tree.split_gain
        arr["node_weight"][t] = tree.node_weight
        arr["node_count"][t] = tree.node_count
        arr["node_value"][t] = tree.node_value
        arr["num_nodes"][t] = tree.num_nodes
        for i in range(int(tree.num_nodes)):
            if not tree.is_leaf[i] and tree.left[i] >= 0:
                arr["threshold"][t, i] = bin_upper_value(
                    boundaries, int(tree.feature[i]),
                    int(tree.split_bin[i]))
    return Booster(arr, num_class=cfg.num_class, objective=cfg.objective,
                   sigmoid=cfg.sigmoid, init_score=base_score,
                   feature_names=feature_names,
                   max_depth_bound=cfg.num_leaves,
                   tree_weights=tree_weights)


def roc_auc(y: np.ndarray, score: np.ndarray,
            w: np.ndarray | None = None) -> float:
    """Weighted ROC AUC via the rank formulation (no sklearn dependency in
    the hot path)."""
    w = np.ones(len(y)) if w is None else w
    order = np.argsort(score, kind="mergesort")
    y_s, w_s = y[order], w[order]
    pos = w_s * (y_s > 0)
    neg = w_s * (y_s <= 0)
    cum_neg = np.cumsum(neg)
    auc_sum = np.sum(pos * (cum_neg - 0.5 * neg))
    total = pos.sum() * neg.sum()
    return float(auc_sum / total) if total > 0 else 0.5
