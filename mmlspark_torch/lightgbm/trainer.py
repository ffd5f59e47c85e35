"""The boosting loop: objectives → trees → scores, with all four boosting
modes, sampling, validation metrics, early stopping and warm starts, on
one device or over the ranks of a shard group.

Role of the reference's ``trainCore`` iteration loop
(``lightgbm/TrainUtils.scala:360-427``). The port of
``mmlspark_tpu/lightgbm/trainer.py``, for dense features
(numerical, categorical slots with identity binning, per-feature bin
budgets) and padded-COO ``SparseData`` (``sparse.py``'s grower). Each
iteration is one eager Python step that computes what the JAX package
computes on its default paths:

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
at the ``eval_freq`` cadence (a ranker's NDCG is a host function of the
validation scores, ``valid_eval_fn``). Trees stay on the device during
the loop and come to the host once each, after it. The JAX package's scan
chunks, cross-fit trace cache and closure builders are XLA dispatch
devices with no counterpart here. ``grad_hess_override`` replaces the
objective's gradients (the ranker's lambdarank).

Over a shard group each rank runs this loop on its block of rows, with
the engine's collectives inside ``grow_tree``; what the host reads whole
(the ranker's gradients, a custom objective's, GOSS's ranking, training
metrics, the final scores) is assembled on every rank by an all_reduce.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core.utils import stable_sigmoid
from ..device import resolve_device, synchronize
from ..parallel.collectives import allreduce, group_rank, group_size
from ..parallel.sharding import pad_rows
from .binning import bin_features, bin_upper_value, compute_bin_boundaries
from .booster import Booster, merge_boosters
from .engine import Tree, TreeParams, grow_tree, tree_route_bins
from .objectives import (canonical_objective, custom_objective,
                         get_objective, one_hot)
from .sparse import (SparseData, bin_sparse, compute_sparse_bin_boundaries,
                     grow_tree_sparse, pad_sparse, sparse_route_bins)


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
    sparse_max_bin: int = 16       # bin cap for the padded-COO path
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
    categorical_features: tuple = ()  # slot indexes with set-based splits
    cat_smooth: float = 10.0       # hessian smoothing in the cat sort
    max_cat_threshold: int = 32    # max categories in a split's left set
    max_delta_step: float = 0.0
    improvement_tolerance: float = 0.0  # early stopping must beat this
    max_bin_by_feature: tuple = ()  # per-feature bin budgets (dense only)
    parallelism: str = "data_parallel"  # | voting_parallel (PV-Tree)
    top_k: int = 20                # voting: local nominations per shard
    xgboost_dart_mode: bool = False
    fobj: Callable | None = None   # (scores, y, w) tensors -> (grad, hess)

    def __post_init__(self):
        self.objective = canonical_objective(self.objective)
        if self.categorical_features and self.max_cat_threshold <= 0:
            # all-False cap would silently disable every categorical
            # split (native LightGBM: CHECK_GT(max_cat_threshold, 0))
            raise ValueError(
                f"maxCatThreshold={self.max_cat_threshold} must be "
                "positive when categorical slots are declared")
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
            parallelism=("voting" if self.parallelism == "voting_parallel"
                         else "data"),
            top_k=self.top_k,
            cat_features=tuple(self.categorical_features),
            cat_smooth=self.cat_smooth,
            max_cat_threshold=self.max_cat_threshold,
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


def train(x, y: np.ndarray, w: np.ndarray | None,
          config: TrainConfig,
          valid: tuple | None = None, *,
          init_booster: Booster | None = None,
          init_scores: np.ndarray | None = None,
          valid_init_scores: np.ndarray | None = None,
          feature_names: list[str] | None = None,
          grad_hess_override: Callable | None = None,
          valid_eval_fn: Callable | None = None, delegate=None,
          device: str | torch.device | None = None,
          hist_impl: str | None = None, group=None) -> TrainResult:
    """Training loop on ``device`` (default CUDA). ``x`` is a dense [n, F]
    float32 matrix (NaN = missing) or a padded-COO ``SparseData``; y [n].
    ``valid`` is (x, y, w) of the validation rows, in the same form.

    Continuation (the JAX ``train``'s ``init_booster``/``init_scores``):
    rows given ``init_scores`` (the reference's ``initScoreCol``; [n], or
    [n, K], a 1-D column broadcast over the K classes) start from them
    with base score 0; otherwise rows of an ``init_booster`` with trees
    start from its raw scores, with its init score, and the booster
    returned is the two merged (``merge_boosters``), its
    ``best_iteration`` offset by the prior iterations. Validation rows
    follow the same rule, with ``valid_init_scores``.

    ``group`` (``parallel/collectives.py``) trains over the ranks of a
    shard group: every rank passes the whole frame, pads it to a multiple
    of the shard count with zero-weight rows, and grows on its contiguous
    block; host draws are made over the padded row count on every rank
    and sliced, so the ranks stay in step. Validation rows stay whole on
    every rank.

    ``grad_hess_override`` maps the running scores (a tensor over the
    real rows) to (grad, hess) in place of the objective's (the ranker's
    lambdarank); ``valid_eval_fn(scores, y, w)`` computes the validation
    metric on the host (the ranker's NDCG). ``delegate`` is the
    reference's delegate hooks (``get_learning_rate``,
    ``before_train_iteration``, ``after_train_iteration``). ``hist_impl``
    is engine plumbing: ``None`` takes K1 on CUDA and the plain histogram
    on the CPU, ``"torch"`` the plain histogram on any device."""
    cfg = config
    dev = resolve_device(device)
    sparse = isinstance(x, SparseData)
    if not sparse:
        x = np.ascontiguousarray(x, dtype=np.float32)
    n_real = x.n_rows if sparse else x.shape[0]
    shards, rank = group_size(group), group_rank(group)
    pad_mask = None
    if shards > 1:
        x = pad_sparse(x, shards)[0] if sparse else pad_rows(x, shards)[0]
        (y, w, init_scores), pad_mask = pad_rows(
            [np.asarray(y, np.float32),
             None if w is None else np.asarray(w, np.float32),
             None if init_scores is None
             else np.asarray(init_scores, np.float32)], shards)
    n = x.n_rows if sparse else x.shape[0]
    F = x.num_features if sparse else x.shape[1]
    n_loc = n // shards
    lo, hi = rank * n_loc, (rank + 1) * n_loc     # this rank's block
    rng = np.random.default_rng(cfg.seed)
    bag_rng = np.random.default_rng(cfg.bagging_seed)
    w_np = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
    if pad_mask is not None:
        w_np = w_np * pad_mask

    pos_weight = cfg.scale_pos_weight
    if cfg.is_unbalance and cfg.objective == "binary":
        npos = float((np.asarray(y)[:n_real] > 0).sum())
        pos_weight = (n_real - npos) / max(npos, 1.0)
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

    def block(a):
        """This rank's rows of a host array or ``SparseData``."""
        if isinstance(a, SparseData):
            return SparseData(a.indices[lo:hi], a.values[lo:hi],
                              a.num_features)
        return a[lo:hi]

    # ---- binning (host boundaries, device mapping): dense boundaries from
    # the real rows, sparse ones from the padded rows (pad rows hold no
    # entry, so they reach neither the sample nor its budget)
    t0 = time.perf_counter()
    if sparse:
        boundaries, B_s = _sparse_boundaries(x, cfg)
        binned = bin_sparse(block(x), boundaries, device=dev)
    else:
        boundaries = _dense_boundaries(x[:n_real], cfg, F)
        bounds_t = torch.from_numpy(boundaries)
        bins = bin_features(torch.from_numpy(block(x)).to(dev), bounds_t)
    y_dev = torch.as_tensor(block(np.asarray(y, np.float32)), device=dev)
    w_dev = torch.as_tensor(block(w_np), device=dev)
    if valid is not None:
        xv, yv, wv = valid
        if sparse:
            if not isinstance(xv, SparseData):
                raise TypeError("validation features must be SparseData "
                                "when training data is sparse")
            vbinned = bin_sparse(xv, boundaries, device=dev)
            nv = xv.n_rows
        else:
            vbins = bin_features(torch.from_numpy(
                np.ascontiguousarray(xv, np.float32)).to(dev), bounds_t)
            nv = vbins.shape[0]
        yv_dev = torch.as_tensor(np.asarray(yv, np.float32), device=dev)
        wv_dev = torch.ones(nv, dtype=torch.float32, device=dev) \
            if wv is None else torch.as_tensor(np.asarray(wv, np.float32),
                                               device=dev)
    synchronize(dev)
    t1 = time.perf_counter()

    # ---- init scores: float64 on the host, rounded to float32 once
    warm = init_booster is not None and init_booster.num_trees > 0

    def as_rows(s, rows):
        """Per-row warm-start scores as this fit's [rows] or [rows, K]."""
        s = torch.as_tensor(np.asarray(s, np.float32), device=dev)
        if K > 1:
            s = s.reshape(rows, K) if s.numel() == rows * K \
                else s.reshape(rows, 1).expand(rows, K).contiguous()
        return s

    if init_scores is not None:
        base_score = np.zeros(K, np.float32) if K > 1 else np.float32(0.0)
    elif warm:
        base_score = init_booster.init_score
    else:
        base_score = np.asarray(obj.init_score(np.asarray(y), w_np),
                                np.float32)
    base = torch.as_tensor(np.asarray(base_score, np.float32).reshape(-1),
                           device=dev)
    if K == 1:
        base = base[0]

    def const_scores(rows):
        s = torch.zeros((rows, K), dtype=torch.float32, device=dev) + base
        return s[:, 0] if K == 1 else s

    if init_scores is not None:
        scores = as_rows(block(np.asarray(init_scores, np.float32)), n_loc)
    elif warm:
        scores = as_rows(init_booster.raw_scores(block(x), device=dev), n_loc)
    else:
        scores = const_scores(n_loc)
    vscores = None
    if valid is not None:
        if valid_init_scores is not None:
            vscores = as_rows(valid_init_scores, nv)
        elif warm:
            vscores = as_rows(init_booster.raw_scores(xv, device=dev), nv)
        else:
            vscores = const_scores(nv)

    # ---- shards: rows the host reads whole are assembled on every rank
    # by an all_reduce of a zero-filled full-length buffer
    def assemble(t: torch.Tensor) -> torch.Tensor:
        if shards == 1:
            return t
        buf = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=dev)
        buf[lo:hi] = t
        return allreduce(buf, group)

    if shards > 1:
        y_full = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        w_full = torch.as_tensor(w_np, device=dev)
        valid_full = torch.as_tensor(pad_mask, device=dev)
    else:
        y_full, w_full = y_dev, w_dev
    row_ones = torch.ones(n_loc, dtype=torch.float32, device=dev) \
        if pad_mask is None else torch.as_tensor(block(pad_mask), device=dev)

    bag_mask = np.ones(n, np.float32)
    stratified_bag = (cfg.pos_bagging_fraction != 1.0
                      or cfg.neg_bagging_fraction != 1.0)
    bagging_active = cfg.bagging_fraction < 1.0 or stratified_bag
    if stratified_bag:
        bag_thresh = np.where(np.asarray(y, np.float32) > 0,
                              np.float32(cfg.pos_bagging_fraction),
                              np.float32(cfg.neg_bagging_fraction))

    def draw_bag() -> np.ndarray:
        """One bagging draw from ``bag_rng`` (plain or stratified) over
        every (padded) row; each rank keeps its block."""
        u = bag_rng.random(n)
        if stratified_bag:
            return (u < bag_thresh).astype(np.float32)
        return (u < cfg.bagging_fraction).astype(np.float32)

    def bag_rows(mask: np.ndarray) -> torch.Tensor:
        m = block(mask) if pad_mask is None else block(mask * pad_mask)
        return torch.as_tensor(m, device=dev)

    if is_goss:
        goss_gen = torch.Generator(device=dev)
        goss_gen.manual_seed(cfg.bagging_seed)
        goss_kw = dict(top_n=int(cfg.top_rate * n_real),
                       other_n=int(cfg.other_rate * n_real),
                       amplify=(1.0 - cfg.top_rate)
                       / max(cfg.other_rate, 1e-12))
    metric_name = cfg.metric or _default_metric(cfg.objective)
    eval_freq = max(int(cfg.eval_freq), 1)

    def lr_tensor(rate):
        return torch.tensor(rate, dtype=torch.float32, device=dev)

    lr = lr_tensor(tp.learning_rate)
    grow_tp = tp._replace(learning_rate=1.0)

    def gh_fn(s):
        """(grad, hess) of this rank's rows. The ranker's override and a
        custom objective see every real row (the scores assembled), the
        built-in objectives only this rank's."""
        if shards > 1 and grad_hess_override is not None:
            g0, h0 = grad_hess_override(assemble(s)[:n_real])
            pad = (0, 0) * (g0.dim() - 1) + (0, n - n_real)
            return (torch.nn.functional.pad(g0, pad)[lo:hi],
                    torch.nn.functional.pad(h0, pad)[lo:hi])
        if grad_hess_override is not None:
            return grad_hess_override(s)
        if shards > 1 and cfg.fobj is not None:
            g0, h0 = obj.grad_hess(assemble(s), y_full, w_full)
            return g0[lo:hi], h0[lo:hi]
        return obj.grad_hess(s, y_dev, w_dev)

    def grow_one(g, h, feat_mask_dev, row_mask_dev):
        """This iteration's K trees (leaf values shrunk) and their [n]
        train deltas, one ``grow_tree`` (or ``grow_tree_sparse``) per
        class."""
        trees_k, deltas = [], []
        for k in range(K):
            gk = g if K == 1 else g[:, k].contiguous()
            hk = h if K == 1 else h[:, k].contiguous()
            if sparse:
                tree, row_leaf = grow_tree_sparse(
                    binned.indices, binned.ebins, binned.zero_bin, gk, hk,
                    feat_mask_dev, row_mask_dev, params=grow_tp,
                    num_features=F, num_bins=B_s, group=group)
            else:
                tree, row_leaf = grow_tree(
                    bins, gk, hk, feat_mask_dev, row_mask_dev,
                    params=grow_tp, num_features=F, hist_impl=hist_impl,
                    group=group)
            # growth ran at lr=1; the shrinkage is one isolated f32 multiply
            tree = tree._replace(leaf_value=tree.leaf_value * lr)
            trees_k.append(tree)
            deltas.append(tree.leaf_value[row_leaf])
        return trees_k, deltas

    def valid_deltas(trees_k):
        if sparse:
            return [t.leaf_value[sparse_route_bins(
                t, vbinned.indices, vbinned.ebins, vbinned.zero_bin,
                max_depth=cfg.num_leaves)] for t in trees_k]
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

        # ---- host draws from `rng`: the drop set (dart; over this fit's
        # trees only, as the reference's), then the feature mask
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
            row_mask_dev = row_ones
        elif (is_rf or cfg.bagging_freq > 0) and bagging_active:
            # rf re-bags every iteration, the others every bagging_freq
            if is_rf or it % max(cfg.bagging_freq, 1) == 0:
                bag_mask = draw_bag()
            row_mask_dev = bag_rows(bag_mask)
        else:
            row_mask_dev = row_ones

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
            g, h = gh_fn(eff)
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
            sfg = const_scores(n_loc) if is_rf else scores
            g, h = gh_fn(sfg)
            if is_goss:
                # the top rows are ranked over every real row: each rank
                # makes the whole mask from the assembled magnitudes
                gmag = torch.abs(g) if K == 1 else torch.linalg.vector_norm(
                    g, dim=1)
                if shards > 1:
                    row_mask_dev = goss_mask(assemble(gmag), valid_full,
                                             goss_gen, **goss_kw)[lo:hi]
                else:
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

        # ---- metrics and early stopping, at the eval_freq cadence; every
        # rank computes each from the same values, so all stop together
        do_eval = ((it + 1) % eval_freq == 0
                   or it == cfg.num_iterations - 1)
        if cfg.is_provide_training_metric and do_eval:
            train_metric = metric_name if metric_name != "ndcg" else "rmse"
            tm = _eval_metric(train_metric, assemble(scores)[:n_real],
                              y_full[:n_real], w_full[:n_real], cfg)
            evals.append({"iteration": it, "dataset": "train",
                          train_metric: tm})
        if valid is not None and do_eval:
            if valid_eval_fn is not None:
                m_val = valid_eval_fn(vscores.cpu().numpy(), np.asarray(yv),
                                      None if wv is None
                                      else np.asarray(wv))
            else:
                m_val = _eval_metric(metric_name, vscores, yv_dev, wv_dev,
                                     cfg)
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
    prior_iters = 0
    if warm:
        booster = merge_boosters(init_booster, booster)
        prior_iters = init_booster.num_trees // K
    if best_iter >= 0:
        booster.best_iteration = best_iter + prior_iters
    if _debug_capture is not None:
        _debug_capture["scores"] = assemble(scores)[:n_real].cpu().numpy()
    return TrainResult(booster=booster, trees=trees,
                       seconds={"binning": t1 - t0, "boosting": t2 - t1},
                       evals=evals, best_iteration=best_iter)


def _dense_boundaries(x: np.ndarray, cfg: TrainConfig, F: int) -> np.ndarray:
    """Quantile boundaries [F, max_bin-1], with ``maxBinByFeature``'s
    per-feature budgets and identity binning for categorical slots (the
    JAX package's dense binning and its checks, word for word)."""
    boundaries = compute_bin_boundaries(x, cfg.max_bin,
                                        sample_cnt=cfg.bin_sample_count,
                                        seed=cfg.seed)
    if cfg.max_bin_by_feature:
        # LightGBM max_bin_by_feature: a budget of k bins keeps the first
        # k-1 cuts (the rest become +inf, i.e. empty bins)
        budgets = tuple(cfg.max_bin_by_feature)
        if len(budgets) != F:
            raise ValueError(
                f"maxBinByFeature has {len(budgets)} entries for "
                f"{F} features")
        for f, budget in enumerate(budgets):
            if not budget:
                continue
            if budget == 1:
                # all cuts at +inf would silently disable the feature
                raise ValueError(
                    f"maxBinByFeature[{f}]=1 would leave feature "
                    f"{f} unsplittable; use >= 2 (or 0 for the "
                    "default budget)")
            if f in cfg.categorical_features:
                # identity binning would overwrite the budget below
                raise ValueError(
                    f"maxBinByFeature cannot cap categorical slot "
                    f"{f}: categories bin by id (cap cardinality "
                    "by re-indexing instead)")
            if budget < cfg.max_bin:
                boundaries[f, budget - 1:] = np.inf
    for f in cfg.categorical_features:
        # identity binning: category c (an integer value) lands in bin c+1
        # exactly, so the per-bin histogram is the per-category one;
        # cardinality is bounded by the bin budget (uint8 bins)
        col = x[:, f]
        vals = col[~np.isnan(col)]
        if vals.size and (np.any(vals < 0)
                          or np.any(vals != np.floor(vals))):
            raise ValueError(
                f"categorical slot {f} must hold non-negative "
                "integer category ids (reference LightGBM "
                "requirement); index labels first (ValueIndexer)")
        if vals.size and vals.max() > cfg.max_bin - 2:
            raise ValueError(
                f"categorical slot {f} has category id "
                f"{int(vals.max())} > max_bin-2 = {cfg.max_bin - 2}; "
                "raise maxBin or re-index the categories")
        k = boundaries.shape[1]
        boundaries[f] = np.arange(k) + 0.5
    return boundaries


def _sparse_boundaries(x: SparseData, cfg: TrainConfig):
    """The padded-COO path's boundaries [F, B_s - 2] and its bin count B_s
    (values in bins 1..#cuts+1, bin 0 missing), with identity binning for
    categorical slots (the JAX package's sparse binning and its checks)."""
    if cfg.max_bin_by_feature:
        raise NotImplementedError(
            "maxBinByFeature is dense-only: the sparse binning's "
            "reserved zero-separator cuts cannot be truncated")
    sparse_b = min(cfg.sparse_max_bin, cfg.max_bin)
    # bin_sample_count is a ROW budget; the COO sampler works in entries,
    # so scale by the per-row entry capacity W
    entry_budget = cfg.bin_sample_count * max(x.indices.shape[1], 1)
    boundaries = compute_sparse_bin_boundaries(
        x, sparse_b, sample_cnt=entry_budget, seed=cfg.seed)
    for f in cfg.categorical_features:
        # identity binning (the sparse twin of the dense rule): category c
        # → bin c+1, and implicit zeros land in bin 1 = category 0
        ent = x.values[x.indices == f]
        vals = ent[~np.isnan(ent)]
        if vals.size and (np.any(vals < 0)
                          or np.any(vals != np.floor(vals))):
            raise ValueError(
                f"categorical slot {f} must hold non-negative "
                "integer category ids (reference LightGBM "
                "requirement); index labels first (ValueIndexer)")
        cap = boundaries.shape[1]
        if vals.size and vals.max() > cap:
            raise ValueError(
                f"categorical slot {f} has category id "
                f"{int(vals.max())} > {cap} (the effective sparse "
                "bin budget, min(sparseMaxBin, maxBin)); raise "
                "whichever is binding, or re-index the categories")
        boundaries[f] = np.arange(cap) + 0.5
    return boundaries, boundaries.shape[1] + 2


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
    if cfg.categorical_features:
        # the engine's bin width, not cfg.max_bin: the sparse path bins
        # into sparse_max_bin-sized histograms
        B = int(trees[0].cat_left.shape[-1]) if trees else cfg.max_bin + 1
        arr["cat_flag"] = np.zeros((T, NN), bool)
        arr["cat_left"] = np.zeros((T, NN, B), bool)
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
        if cfg.categorical_features:
            arr["cat_flag"][t] = tree.cat_flag
            arr["cat_left"][t] = tree.cat_left
        for i in range(int(tree.num_nodes)):
            if not tree.is_leaf[i] and tree.left[i] >= 0 \
                    and not (cfg.categorical_features
                             and tree.cat_flag[i]):
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
