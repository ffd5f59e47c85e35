"""The boosting loop: objectives → trees → scores, with all four boosting
modes, sampling, validation metrics and early stopping, on one device.

Role of the reference's ``trainCore`` iteration loop
(``lightgbm/TrainUtils.scala:360-427``). The port of
``mmlspark_tpu/lightgbm/trainer.py`` on dense numerical features and one
shard. Each iteration is one eager Python step that computes what the JAX
package computes on its default paths:

- gbdt, goss and rf: ``_fused_step_math`` (``trainer.py:308-345``):
  gradients (at the constant init score under rf), the GOSS row mask on
  the device, ``grow_tree`` once per class at learning rate 1, the
  shrinkage as one isolated multiply on the finished leaf values, and the
  train and validation score updates (rf keeps a running average);
- dart: the fused DART iteration (``_dart_step_math``, ``:480-541``): the
  dropped trees' cached deltas removed from the margin the gradients see,
  the new trees added at 1/(k+1), the dropped ones rescaled by k/(k+1).

The host draws come from two numpy generators in the JAX package's order:
``default_rng(seed)`` gives DART's drop set, then the ``featureFraction``
mask, every iteration; ``default_rng(bagging_seed)`` gives the bagging
masks (plain or class-stratified). GOSS draws from a ``torch.Generator``
seeded with ``bagging_seed`` on the fit's device (the JAX package draws
from ``jax.random``). Multiclass fits grow K trees per iteration, one
``grow_tree`` per class, stored class-interleaved.

Metrics are computed on the device; only the scalar crosses to the host,
at the ``eval_freq`` cadence. Trees stay on the device during the loop
and come to the host once each, after it. The JAX package's scan chunks,
cross-fit trace cache and closure builders are XLA dispatch devices with
no counterpart here. Categorical slots and ``maxBinByFeature`` raise
``NotImplementedError`` naming the item that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core.utils import stable_sigmoid
from ..device import resolve_device, synchronize
from .binning import bin_features, bin_upper_value, compute_bin_boundaries
from .booster import Booster
from .engine import Tree, TreeParams, grow_tree, tree_route_bins
from .objectives import (LATER_SLICE, canonical_objective, custom_objective,
                         get_objective, one_hot)


@dataclasses.dataclass
class TrainConfig:
    """Training configuration (same field names and defaults as the JAX
    package's ``TrainConfig`` for the fields this port reads)."""
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
    pos_bagging_fraction: float = 1.0  # class-stratified bagging (binary)
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    boosting_type: str = "gbdt"
    top_rate: float = 0.2          # goss
    other_rate: float = 0.1        # goss
    drop_rate: float = 0.1         # dart
    max_drop: int = 50             # dart
    skip_drop: float = 0.5         # dart
    uniform_drop: bool = False     # dart (parity; sampling is uniform)
    num_class: int = 1
    sigmoid: float = 1.0
    alpha: float = 0.9             # quantile / huber
    fair_c: float = 1.0
    tweedie_variance_power: float = 1.5
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    boost_from_average: bool = True
    seed: int = 0
    bagging_seed: int = 3
    bin_sample_count: int = 200_000
    early_stopping_round: int = 0
    metric: str = ""
    is_provide_training_metric: bool = False
    eval_freq: int = 1             # evaluate every k iterations
    categorical_features: tuple = ()
    max_delta_step: float = 0.0
    improvement_tolerance: float = 0.0  # early stopping must beat this
    max_bin_by_feature: tuple = ()
    xgboost_dart_mode: bool = False
    fobj: Callable | None = None   # (scores, y, w) tensors -> (grad, hess)

    def __post_init__(self):
        self.objective = canonical_objective(self.objective)
        later = []
        if self.categorical_features:
            later.append("categorical slots")
        if self.max_bin_by_feature:
            later.append("maxBinByFeature")
        if later:
            raise NotImplementedError(
                f"{', '.join(later)} not ported yet; this comes with "
                f"{LATER_SLICE}")
        if self.xgboost_dart_mode and self.boosting_type == "dart":
            raise NotImplementedError(
                "xgboostDartMode is not implemented; use the default "
                "DART normalization (new tree 1/(k+1), dropped k/(k+1))")
        if (self.pos_bagging_fraction != 1.0
                or self.neg_bagging_fraction != 1.0) \
                and self.objective != "binary":
            raise ValueError(
                "posBaggingFraction/negBaggingFraction require the "
                f"binary objective (got {self.objective!r})")

    def tree_params(self) -> TreeParams:
        # rf: trees are averaged, never shrunk
        lr = 1.0 if self.boosting_type == "rf" else self.learning_rate
        return TreeParams(
            num_leaves=self.num_leaves, max_depth=self.max_depth,
            max_bin=self.max_bin, learning_rate=lr,
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
    evals: list[dict] = dataclasses.field(default_factory=list)
    best_iteration: int = -1


def _dart_drop_set(rng, cfg: TrainConfig, n_flat: int) -> list[int]:
    """DART's host drop-set draw (LightGBM DartBooster::DroppingTrees), the
    JAX package's ``_dart_drop_set``: skip with probability skip_drop, else
    drop round(drop_rate·n) of the standing trees, capped at max_drop,
    uniformly without replacement."""
    if n_flat == 0 or rng.random() < cfg.skip_drop:
        return []
    k_drop = min(cfg.max_drop, max(1, int(round(cfg.drop_rate * n_flat))))
    return sorted(rng.choice(n_flat, size=min(k_drop, n_flat),
                             replace=False).tolist())


def goss_mask(gmag: torch.Tensor, valid_mask: torch.Tensor,
              gen: torch.Generator, *, top_n: int, other_n: int,
              amplify: float) -> torch.Tensor:
    """GOSS row weights on the device (the JAX ``_goss_mask``): the top_n
    rows by |gradient| at 1 (a stable descending rank, as ``jnp.argsort``
    ranks ties by row), and other_n of the rest drawn uniformly from
    ``gen``, amplified by (1 - top_rate)/other_rate."""
    n = gmag.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=gmag.device)
    gmag = gmag * valid_mask
    rank = torch.empty_like(ar)
    rank[torch.argsort(-gmag, stable=True)] = ar
    top = rank < top_n
    rest = ~top & (valid_mask > 0)
    u = torch.rand(n, generator=gen, device=gmag.device)
    r = torch.where(rest, u, -1.0)
    rrank = torch.empty_like(ar)
    rrank[torch.argsort(-r, stable=True)] = ar
    other = rest & (rrank < other_n)
    return top.to(torch.float32) + other.to(torch.float32) \
        * torch.tensor(amplify, dtype=torch.float32, device=gmag.device)


def _score_update(c: torch.Tensor, d: torch.Tensor, coeff, cls: int):
    """``c + coeff·d`` (into class column ``cls`` when c is [n, K]): the JAX
    ``_score_update``. XLA contracts it into one FMA; eager PyTorch rounds
    the multiply and the add apart, so DART scores may differ by an ulp."""
    upd = d * coeff
    if c.dim() == 1:
        return c + upd
    out = c.clone()
    out[:, cls] += upd
    return out


# test instrumentation: when set to a dict, train() stashes its final
# running scores there (the JAX package's ``_debug_capture``), and a GOSS
# fit its first row mask
_debug_capture: dict | None = None


def train(x: np.ndarray, y: np.ndarray, w: np.ndarray | None,
          config: TrainConfig,
          valid: tuple[np.ndarray, np.ndarray, np.ndarray | None]
          | None = None, *,
          feature_names: list[str] | None = None, delegate=None,
          device: str | torch.device | None = None,
          hist_impl: str | None = None) -> TrainResult:
    """Training loop. x [n, F] float32 (NaN = missing), y [n], on
    ``device`` (default CUDA). ``valid`` is (x, y, w) of the validation
    rows. ``delegate`` is the reference's delegate hooks
    (``get_learning_rate``, ``before_train_iteration``,
    ``after_train_iteration``). ``hist_impl`` is engine plumbing: ``None``
    takes K1 on CUDA and the plain histogram on the CPU, ``"torch"`` the
    plain histogram on any device."""
    cfg = config
    dev = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, F = x.shape
    rng = np.random.default_rng(cfg.seed)
    bag_rng = np.random.default_rng(cfg.bagging_seed)
    w_np = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)

    pos_weight = cfg.scale_pos_weight
    if cfg.is_unbalance and cfg.objective == "binary":
        npos = float((y > 0).sum())
        pos_weight = (n - npos) / max(npos, 1.0)
    if cfg.fobj is not None:
        obj = custom_objective(cfg.fobj)
    else:
        obj = get_objective(
            cfg.objective, num_class=cfg.num_class, alpha=cfg.alpha,
            fair_c=cfg.fair_c,
            tweedie_variance_power=cfg.tweedie_variance_power,
            sigmoid=cfg.sigmoid, pos_weight=pos_weight,
            boost_from_average=cfg.boost_from_average)
    K = max(obj.num_model_per_iter, 1)
    tp = cfg.tree_params()
    is_rf = cfg.boosting_type == "rf"
    is_dart = cfg.boosting_type == "dart"
    is_goss = cfg.boosting_type == "goss"

    # ---- binning (host boundaries, device mapping)
    t0 = time.perf_counter()
    boundaries = compute_bin_boundaries(x, cfg.max_bin,
                                        sample_cnt=cfg.bin_sample_count,
                                        seed=cfg.seed)
    bounds_t = torch.from_numpy(boundaries)
    bins = bin_features(torch.from_numpy(x).to(dev), bounds_t)
    y_dev = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    w_dev = torch.as_tensor(w_np, device=dev)
    if valid is not None:
        xv, yv, wv = valid
        vbins = bin_features(
            torch.from_numpy(np.ascontiguousarray(xv, np.float32)).to(dev),
            bounds_t)
        nv = vbins.shape[0]
        yv_dev = torch.as_tensor(np.asarray(yv, np.float32), device=dev)
        wv_dev = torch.ones(nv, dtype=torch.float32, device=dev) \
            if wv is None else torch.as_tensor(np.asarray(wv, np.float32),
                                               device=dev)
    synchronize(dev)
    t1 = time.perf_counter()

    # ---- init scores: float64 on the host, rounded to float32 once
    base_score = np.asarray(obj.init_score(np.asarray(y), w_np), np.float32)
    base = torch.as_tensor(base_score.reshape(-1), device=dev)
    if K == 1:
        base = base[0]

    def const_scores(rows):
        s = torch.zeros((rows, K), dtype=torch.float32, device=dev) + base
        return s[:, 0] if K == 1 else s

    scores = const_scores(n)
    vscores = const_scores(nv) if valid is not None else None

    bag_mask = np.ones(n, np.float32)
    stratified_bag = (cfg.pos_bagging_fraction != 1.0
                      or cfg.neg_bagging_fraction != 1.0)
    bagging_active = cfg.bagging_fraction < 1.0 or stratified_bag
    if stratified_bag:
        bag_thresh = np.where(np.asarray(y, np.float32) > 0,
                              np.float32(cfg.pos_bagging_fraction),
                              np.float32(cfg.neg_bagging_fraction))

    def draw_bag() -> np.ndarray:
        """One bagging draw from ``bag_rng`` (plain or stratified)."""
        u = bag_rng.random(n)
        if stratified_bag:
            return (u < bag_thresh).astype(np.float32)
        return (u < cfg.bagging_fraction).astype(np.float32)

    ones_n = torch.ones(n, dtype=torch.float32, device=dev)
    if is_goss:
        goss_gen = torch.Generator(device=dev)
        goss_gen.manual_seed(cfg.bagging_seed)
        goss_kw = dict(top_n=int(cfg.top_rate * n),
                       other_n=int(cfg.other_rate * n),
                       amplify=(1.0 - cfg.top_rate)
                       / max(cfg.other_rate, 1e-12))
    metric_name = cfg.metric or _default_metric(cfg.objective)
    eval_freq = max(int(cfg.eval_freq), 1)

    def lr_tensor(rate):
        return torch.tensor(rate, dtype=torch.float32, device=dev)

    lr = lr_tensor(tp.learning_rate)
    grow_tp = tp._replace(learning_rate=1.0)

    def grow_one(g, h, feat_mask_dev, row_mask_dev):
        """This iteration's K trees (leaf values shrunk) and their [n]
        train deltas, one ``grow_tree`` per class."""
        trees_k, deltas = [], []
        for k in range(K):
            gk = g if K == 1 else g[:, k].contiguous()
            hk = h if K == 1 else h[:, k].contiguous()
            tree, row_leaf = grow_tree(bins, gk, hk, feat_mask_dev,
                                       row_mask_dev, params=grow_tp,
                                       num_features=F, hist_impl=hist_impl)
            # growth ran at lr=1; the shrinkage is one isolated f32 multiply
            tree = tree._replace(leaf_value=tree.leaf_value * lr)
            trees_k.append(tree)
            deltas.append(tree.leaf_value[row_leaf])
        return trees_k, deltas

    def valid_deltas(trees_k):
        return [t.leaf_value[tree_route_bins(t, vbins,
                                             max_depth=cfg.num_leaves)]
                for t in trees_k]

    def as_scores(deltas):
        return deltas[0] if K == 1 else torch.stack(deltas, dim=1)

    dev_trees: list[Tree] = []
    tree_weights: list = []
    tree_deltas: list[torch.Tensor] = []   # dart: per-tree train deltas
    tree_vdeltas: list[torch.Tensor] = []  # dart: per-tree valid deltas
    evals: list[dict] = []
    best_iter, best_metric, rounds_no_improve = -1, None, 0

    for it in range(cfg.num_iterations):
        if delegate is not None:
            # rf averages unshrunk trees: no learning-rate schedule
            rate = None if is_rf else delegate.get_learning_rate(it)
            if rate is not None and rate != tp.learning_rate:
                tp = tp._replace(learning_rate=float(rate))
                lr = lr_tensor(tp.learning_rate)
            delegate.before_train_iteration(it)

        # ---- host draws from `rng`: the drop set (dart), then the
        # feature mask
        dropped: list[int] = []
        if is_dart:
            dropped = _dart_drop_set(rng, cfg, len(tree_weights))
        feat_mask = np.ones(F, bool)
        if cfg.feature_fraction < 1.0:
            k_f = max(1, int(round(cfg.feature_fraction * F)))
            feat_mask = np.zeros(F, bool)
            feat_mask[rng.choice(F, size=k_f, replace=False)] = True
        feat_mask_dev = torch.as_tensor(feat_mask, device=dev)

        # ---- row mask from `bag_rng` (GOSS draws on the device)
        if is_goss:
            row_mask_dev = ones_n
        elif (is_rf or cfg.bagging_freq > 0) and bagging_active:
            # rf re-bags every iteration, the others every bagging_freq
            if is_rf or it % max(cfg.bagging_freq, 1) == 0:
                bag_mask = draw_bag()
            row_mask_dev = torch.as_tensor(bag_mask, device=dev)
        else:
            row_mask_dev = ones_n

        if is_dart:
            new_w = np.float32(1.0 / (len(dropped) + 1)) if dropped \
                else np.float32(1.0)
            factor = np.float32(len(dropped) / (len(dropped) + 1.0)) \
                if dropped else np.float32(1.0)
            # 1) margin with the dropped trees removed
            eff = scores
            for d in dropped:
                eff = _score_update(eff, tree_deltas[d],
                                    np.float32(-tree_weights[d]), d % K)
            g, h = obj.grad_hess(eff, y_dev, w_dev)
            trees_k, deltas = grow_one(g, h, feat_mask_dev, row_mask_dev)
            vdeltas = valid_deltas(trees_k) if valid is not None else None
            # 2) the new trees enter at 1/(k+1), class-ascending
            for k in range(K):
                scores = _score_update(scores, deltas[k], new_w, k)
                if valid is not None:
                    vscores = _score_update(vscores, vdeltas[k], new_w, k)
            # 3) the dropped trees' standing contribution rescales by
            # k/(k+1), each coefficient rounded to f32 on its own
            fm1 = np.float32(factor - np.float32(1.0))
            for d in dropped:
                coeff = np.float32(np.float32(tree_weights[d]) * fm1)
                scores = _score_update(scores, tree_deltas[d], coeff, d % K)
                if valid is not None:
                    vscores = _score_update(vscores, tree_vdeltas[d], coeff,
                                            d % K)
            for d in dropped:
                tree_weights[d] = np.float32(tree_weights[d] * factor)
            tree_deltas.extend(deltas)
            if valid is not None:
                tree_vdeltas.extend(vdeltas)
            tree_weights.extend([new_w] * K)
        else:
            # gbdt / goss / rf: the JAX package's _fused_step_math
            sfg = const_scores(n) if is_rf else scores
            g, h = obj.grad_hess(sfg, y_dev, w_dev)
            if is_goss:
                gmag = torch.abs(g) if K == 1 else torch.linalg.vector_norm(
                    g, dim=1)
                row_mask_dev = goss_mask(gmag, row_mask_dev, goss_gen,
                                         **goss_kw)
                if it == 0 and _debug_capture is not None:
                    _debug_capture["goss_mask0"] = row_mask_dev
            trees_k, deltas = grow_one(g, h, feat_mask_dev, row_mask_dev)
            d = as_scores(deltas)
            m = torch.tensor(it + 1, dtype=torch.float32, device=dev)
            scores = scores + (d - (scores - base)) / m if is_rf \
                else scores + d
            if valid is not None:
                vd = as_scores(valid_deltas(trees_k))
                vscores = vscores + (vd - (vscores - base)) / m if is_rf \
                    else vscores + vd
            tree_weights.extend([1.0] * K)
        dev_trees.extend(trees_k)

        # ---- metrics and early stopping, at the eval_freq cadence
        do_eval = ((it + 1) % eval_freq == 0
                   or it == cfg.num_iterations - 1)
        if cfg.is_provide_training_metric and do_eval:
            train_metric = metric_name if metric_name != "ndcg" else "rmse"
            tm = _eval_metric(train_metric, scores, y_dev, w_dev, cfg)
            evals.append({"iteration": it, "dataset": "train",
                          train_metric: tm})
        if valid is not None and do_eval:
            m_val = _eval_metric(metric_name, vscores, yv_dev, wv_dev, cfg)
            evals.append({"iteration": it, metric_name: m_val})
            tol = cfg.improvement_tolerance
            better = (best_metric is None
                      or (m_val > best_metric + tol
                          if _higher_better(metric_name)
                          else m_val < best_metric - tol))
            if better:
                best_metric, best_iter, rounds_no_improve = m_val, it, 0
            else:
                rounds_no_improve += 1
            if (cfg.early_stopping_round > 0
                    and rounds_no_improve >= cfg.early_stopping_round):
                break
        if delegate is not None:
            delegate.after_train_iteration(it)

    trees = [t.to_numpy() for t in dev_trees]
    t2 = time.perf_counter()
    booster = build_booster(trees, boundaries, cfg, base_score,
                            feature_names,
                            np.asarray(tree_weights, np.float32),
                            average_output=is_rf)
    if best_iter >= 0:
        booster.best_iteration = best_iter
    if _debug_capture is not None:
        _debug_capture["scores"] = scores.cpu().numpy()
    return TrainResult(booster=booster, trees=trees,
                       seconds={"binning": t1 - t0, "boosting": t2 - t1},
                       evals=evals, best_iteration=best_iter)


def build_booster(trees: list[Tree], boundaries: np.ndarray,
                  cfg: TrainConfig, base_score, feature_names,
                  tree_weights: np.ndarray | None = None,
                  average_output: bool = False) -> Booster:
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
                   tree_weights=tree_weights, average_output=average_output)


# --------------------------------------------------------------- eval metrics
def _average(a, w):
    return (a * w).sum() / w.sum()


def _auc_dev(s, y, w):
    order = torch.argsort(s, stable=True)   # jnp.argsort is stable
    y_s, w_s = y[order], w[order]
    pos = w_s * (y_s > 0)
    neg = w_s * (y_s <= 0)
    cum_neg = torch.cumsum(neg, dim=0)
    auc_sum = (pos * (cum_neg - 0.5 * neg)).sum()
    total = pos.sum() * neg.sum()
    return torch.where(total > 0, auc_sum / total, 0.5)


def _clip_p(p):
    return torch.clamp(p, 1e-15, 1 - 1e-15)


def _binary_logloss_dev(s, y, w, sigmoid):
    p = _clip_p(torch.sigmoid(sigmoid * s))
    return -_average(y * torch.log(p) + (1 - y) * torch.log1p(-p), w)


def _multi_logloss_dev(s, y, w):
    logp = torch.log_softmax(s, dim=1)
    py = logp.gather(1, y.to(torch.int64)[:, None])[:, 0]
    return -_average(py, w)


def _ova_logloss_dev(s, y, w, sigmoid):
    """Mean per-class binary logloss with one-hot labels."""
    onehot = one_hot(y, s.shape[1])
    p = _clip_p(torch.sigmoid(sigmoid * s))
    ll = onehot * torch.log(p) + (1 - onehot) * torch.log1p(-p)
    return -_average(ll.sum(dim=1), w)


def _xentlambda_loss_dev(s, y, w):
    lam = torch.logaddexp(torch.zeros_like(s), s)
    p = _clip_p(1.0 - torch.exp(-lam))
    return -_average(y * torch.log(p) + (1 - y) * torch.log1p(-p), w)


_DEVICE_METRICS = {
    "rmse": lambda s, y, w, c: torch.sqrt(_average((s - y) ** 2, w)),
    "mae": lambda s, y, w, c: _average(torch.abs(s - y), w),
    "auc": lambda s, y, w, c: _auc_dev(s, y, w),
    "binary_logloss": lambda s, y, w, c: _binary_logloss_dev(s, y, w,
                                                             c.sigmoid),
    "multi_logloss": lambda s, y, w, c: _multi_logloss_dev(s, y, w),
    "ova_logloss": lambda s, y, w, c: _ova_logloss_dev(s, y, w, c.sigmoid),
    "xentlambda_loss": lambda s, y, w, c: _xentlambda_loss_dev(s, y, w),
}


def _eval_metric(name: str, scores, y, w, cfg: TrainConfig) -> float:
    """The metric on the device (one scalar crosses to the host); names
    with no device form go through the host ``eval_metric``."""
    fn = _DEVICE_METRICS.get(name)
    if fn is not None:
        return float(fn(scores, y, w, cfg))
    return eval_metric(name, scores.cpu().numpy(), y.cpu().numpy(),
                       w.cpu().numpy(), cfg)


def _default_metric(objective: str) -> str:
    return {"binary": "auc", "multiclass": "multi_logloss",
            "softmax": "multi_logloss",
            "multiclassova": "ova_logloss",
            "cross_entropy": "binary_logloss",
            "cross_entropy_lambda": "xentlambda_loss",
            "lambdarank": "ndcg",
            "regression_l1": "mae"}.get(objective, "rmse")


def _higher_better(metric: str) -> bool:
    return metric in ("auc", "ndcg", "map", "accuracy")


def eval_metric(name: str, raw_scores: np.ndarray, y: np.ndarray,
                w: np.ndarray | None, cfg: TrainConfig) -> float:
    """The JAX package's host metrics (``trainer.py:1581-1606``)."""
    w = np.ones(len(y)) if w is None else w
    if name == "rmse":
        return float(np.sqrt(np.average((raw_scores - y) ** 2, weights=w)))
    if name == "mae":
        return float(np.average(np.abs(raw_scores - y), weights=w))
    if name == "auc":
        return roc_auc(y, raw_scores, w)
    if name == "binary_logloss":
        p = stable_sigmoid(cfg.sigmoid * raw_scores)
        p = np.clip(p, 1e-15, 1 - 1e-15)
        return float(-np.average(y * np.log(p) + (1 - y) * np.log(1 - p),
                                 weights=w))
    if name == "multi_logloss":
        e = np.exp(raw_scores - raw_scores.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        py = np.clip(p[np.arange(len(y)), y.astype(int)], 1e-15, None)
        return float(-np.average(np.log(py), weights=w))
    if name.startswith("ndcg"):
        raise ValueError(
            "ndcg requires group information; the ranker supplies a "
            "group-aware valid_eval_fn")
    raise ValueError(f"unknown metric {name!r}")


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
