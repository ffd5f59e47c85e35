"""Booster: the trained GBDT model — prediction, persistence, introspection.

Role of the reference's ``lightgbm/booster/LightGBMBooster.scala:196-517``:
score (raw/probability), predict leaf indices, feature importances (split /
gain), save to / load from the LightGBM *text model format* so models
interchange with native LightGBM and with the JAX package
(``saveNativeModel`` / ``loadNativeModelFromFile`` parity).

Trees live as stacked fixed-capacity numpy arrays [T, NN] on the host (the
same ``arrays`` dict as ``mmlspark_tpu/lightgbm/booster.py``, categorical
``cat_flag``/``cat_left`` included); prediction copies them to the device
once and advances every (row, tree) pair one level per step with tensor
gathers, on dense [n, F] rows or padded-COO ``SparseData``. Scoring uses no
kernel, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.utils import stable_sigmoid
from ..device import resolve_device
from .engine import categorical_go_left_at
from .sparse import SparseData, predict_leaf_nodes_sparse


class Booster:
    """Stacked-tree GBDT model.

    Arrays (numpy, host-resident; copied to the device lazily for predict):
      feature      i32 [T, NN]
      threshold    f32 [T, NN]  — raw-value threshold (go left iff x <= thr;
                                  NaN goes left unless default_left says
                                  otherwise)
      left/right   i32 [T, NN]
      leaf_value   f32 [T, NN]  — shrunk by learning_rate already
      is_leaf      bool[T, NN]
      split_gain, node_weight, node_count, node_value f32 [T, NN]
      num_nodes    i32 [T]
      default_left bool[T, NN]
      cat_flag     bool[T, NN]     — categorical split (only when a tree
      cat_left     bool[T, NN, B]    has one): bin c+1 in the left set
                                     means raw category c goes left
    """

    def __init__(self, arrays: dict, *, num_class: int = 1,
                 objective: str = "regression", sigmoid: float = 1.0,
                 init_score: float | np.ndarray = 0.0,
                 feature_names: list[str] | None = None,
                 max_depth_bound: int = 64,
                 tree_weights: np.ndarray | None = None,
                 average_output: bool = False):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        if "default_left" not in self.arrays and "feature" in self.arrays:
            # our trained trees always send missing (bin 0) left
            self.arrays["default_left"] = np.ones_like(
                self.arrays["feature"], bool)
        self.num_class = num_class
        self.objective = objective
        self.sigmoid = sigmoid
        self.init_score = np.asarray(init_score, dtype=np.float32)
        T = self.arrays["feature"].shape[0] if "feature" in arrays else 0
        self.feature_names = feature_names
        self.max_depth_bound = max_depth_bound
        self.tree_weights = (np.ones(T, np.float32) if tree_weights is None
                             else np.asarray(tree_weights, np.float32))
        self.average_output = average_output
        self.best_iteration = -1
        self._dev_cache = None

    # ------------------------------------------------------------ prediction
    @property
    def num_trees(self) -> int:
        return self.arrays["feature"].shape[0]

    @property
    def num_iterations(self) -> int:
        return self.num_trees // self.num_class

    def _effective_trees(self, num_iteration: int | None = None) -> int:
        """Trees scored for ``num_iteration`` iterations (default: up to
        the best iteration, where a validation set chose one)."""
        it = num_iteration
        if it is None and self.best_iteration >= 0:
            it = self.best_iteration + 1
        if it is None:
            return self.num_trees
        return min(self.num_trees, it * self.num_class)

    def raw_scores(self, x, num_iteration: int | None = None,
                   start_iteration: int = 0,
                   device: str | torch.device | None = None) -> np.ndarray:
        """Raw margin scores [n] or [n, K] for a dense [n, F] matrix (numpy
        or tensor) or a padded-COO ``SparseData`` (the reference's CSR
        predict path), computed on ``device`` (default CUDA).
        ``start_iteration`` skips the first k iterations' trees (reference
        ``setStartIteration``)."""
        dev = resolve_device(device)
        is_sparse = isinstance(x, SparseData)
        n_rows = x.n_rows if is_sparse else x.shape[0]
        width = x.num_features if is_sparse else x.shape[1]
        # sparse input has no fixed width: absent features read 0
        if self.num_trees and "feature" in self.arrays and not is_sparse:
            need = int(self.arrays["feature"].max()) + 1
            if width < need:
                raise ValueError(
                    f"model splits on feature {need - 1} but input has only "
                    f"{width} features")
        t_end = self._effective_trees(num_iteration)
        if t_end == 0:
            base = np.broadcast_to(
                self.init_score,
                (n_rows, self.num_class)).astype(np.float32)
            return base[:, 0] if self.num_class == 1 else base
        arrays = self._device_arrays(t_end, dev)
        leaves = self._leaf_nodes(x, t_end, dev)
        w = np.array(self.tree_weights[:t_end])
        t_start = max(int(start_iteration), 0) * self.num_class
        if t_start:
            w[:t_start] = 0.0      # skipped iterations contribute nothing
        avg_div = max((t_end - t_start) // self.num_class, 1) \
            if self.average_output else 1
        scores = _score_math(
            arrays[4], leaves, torch.as_tensor(w, device=dev),
            torch.as_tensor(self.init_score, device=dev).reshape(-1),
            num_class=self.num_class, avg_div=avg_div)
        out = scores.cpu().numpy()
        return out[:, 0] if self.num_class == 1 else out

    def predict_leaf(self, x, num_iteration: int | None = None,
                     start_iteration: int = 0,
                     device: str | torch.device | None = None) -> np.ndarray:
        """Leaf *index* per (row, tree) — reference ``predictLeaf``: leaf
        ordinals in node-creation order within each tree."""
        dev = resolve_device(device)
        t_end = self._effective_trees(num_iteration)
        t_start = max(int(start_iteration), 0) * self.num_class
        leaves = self._leaf_nodes(x, t_end, dev).cpu().numpy()
        is_leaf = self.arrays["is_leaf"][:t_end]
        out = np.zeros((leaves.shape[0], max(t_end - t_start, 0)),
                       leaves.dtype)
        for t in range(t_start, t_end):
            ordinal = np.cumsum(is_leaf[t]) - 1   # node id -> leaf ordinal
            out[:, t - t_start] = ordinal[leaves[:, t]]
        return out

    def _leaf_nodes(self, x, t_end: int, dev: torch.device) -> torch.Tensor:
        """Per-(row, tree) leaf node ids [n, T] on ``dev``, dense or
        padded-COO input."""
        arrays = self._device_arrays(t_end, dev)
        if isinstance(x, SparseData):
            return predict_leaf_nodes_sparse(
                arrays, torch.as_tensor(x.indices).to(dev, torch.int64),
                torch.as_tensor(x.values).to(dev, torch.float32),
                max_depth=self.max_depth_bound)
        xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
        return _predict_leaf_nodes(arrays, xt,
                                   max_depth=self.max_depth_bound)

    def transform_scores(self, raw: np.ndarray) -> np.ndarray:
        """Raw scores → the objective's output: a probability, a softmax
        over classes, an expectation, or the raw score."""
        if self.objective in ("binary", "multiclassova"):
            # multiclassova: per-class sigmoid, unnormalized (LightGBM)
            return stable_sigmoid(self.sigmoid * raw)
        if self.objective in ("multiclass", "softmax"):
            e = np.exp(raw - raw.max(axis=-1, keepdims=True))
            return e / e.sum(axis=-1, keepdims=True)
        if self.objective == "cross_entropy":
            return stable_sigmoid(raw)
        if self.objective == "cross_entropy_lambda":
            # the intensity log1p(exp(score)), not a probability
            return np.logaddexp(0.0, raw)
        if self.objective in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        return raw

    def _device_arrays(self, t_end: int, dev: torch.device):
        # cached per (arrays identity, t_end, device): re-uploading every
        # tree array on each predict would dominate small-batch scoring
        cache = self._dev_cache
        if cache is not None and cache[0] is self.arrays \
                and cache[1] == t_end and cache[2] == dev:
            return cache[3]
        a = self.arrays
        out = tuple(torch.as_tensor(a[k][:t_end], device=dev) for k in
                    ("feature", "threshold", "left", "right",
                     "leaf_value", "is_leaf", "default_left"))
        out = tuple(t.to(torch.int64) if t.dtype == torch.int32 else t
                    for t in out)
        # categorical masks only where a scored tree splits on a set: the
        # predictors skip the bitset rule when they are None
        if "cat_flag" in a and a["cat_flag"][:t_end].any():
            out += (torch.as_tensor(a["cat_flag"][:t_end], device=dev),
                    torch.as_tensor(a["cat_left"][:t_end], device=dev))
        else:
            out += (None, None)
        self._dev_cache = (self.arrays, t_end, dev, out)
        return out

    # ---------------------------------------------------------- importances
    def feature_importances(self, importance_type: str = "split",
                            num_features: int | None = None) -> np.ndarray:
        """Reference ``getFeatureImportances`` (split counts or total gain)."""
        a = self.arrays
        F = num_features or int(a["feature"].max() + 1 if a["feature"].size
                                else 0)
        out = np.zeros(F, dtype=np.float64)
        internal = ~a["is_leaf"] & (a["left"] >= 0)
        feats = a["feature"][internal]
        if importance_type == "split":
            np.add.at(out, feats, 1.0)
        elif importance_type == "gain":
            np.add.at(out, feats, a["split_gain"][internal])
        else:
            raise ValueError("importance_type must be 'split' or 'gain'")
        return out

    # ------------------------------------------------- LightGBM text format
    def save_native(self, num_features: int | None = None) -> str:
        """Serialize to the LightGBM text model format (model-string parity
        with reference ``saveToString`` / ``saveNativeModel``)."""
        a = self.arrays
        F = num_features or (len(self.feature_names)
                             if self.feature_names else
                             int(a["feature"].max() + 1))
        names = self.feature_names or [f"Column_{i}" for i in range(F)]
        obj = {"binary": f"binary sigmoid:{self.sigmoid:g}",
               "multiclass": f"multiclass num_class:{self.num_class}",
               "multiclassova": (f"multiclassova num_class:"
                                 f"{self.num_class} "
                                 f"sigmoid:{self.sigmoid:g}"),
               }.get(self.objective, self.objective)
        lines = [
            "tree", "version=v3", f"num_class={self.num_class}",
            f"num_tree_per_iteration={self.num_class}",
            "label_index=0", f"max_feature_idx={F - 1}",
            f"objective={obj}",
            "feature_names=" + " ".join(names),
            "feature_infos=" + " ".join(["none"] * F), "",
        ]
        if self.average_output:
            # real LightGBM rf models carry this header flag
            lines.insert(lines.index("feature_infos=" + " ".join(
                ["none"] * F)) + 1, "average_output")
        init = np.asarray(self.init_score, dtype=np.float64).reshape(-1)
        T = self.num_trees
        denom = max(T // self.num_class, 1) if self.average_output else 1
        for t in range(T):
            # LightGBM text models carry no separate init score: fold the
            # boost-from-average base into the first tree of each class
            fold = float(init[t % self.num_class]) * denom \
                if t < self.num_class and init.size else 0.0
            # tree weights are baked into leaf values so the text model is
            # self-contained (LightGBM does the same)
            lines.extend(self._tree_to_text(
                t, leaf_shift=fold, leaf_scale=float(self.tree_weights[t])))
            lines.append("")
        lines.append("end of trees")
        lines.append("")
        lines.append("parameters:")
        lines.append("end of parameters")
        return "\n".join(lines)

    def _tree_to_text(self, t: int, leaf_shift: float = 0.0,
                      leaf_scale: float = 1.0) -> list[str]:
        a = self.arrays
        nn = int(a["num_nodes"][t])
        is_leaf = a["is_leaf"][t]
        # internal nodes in creation order; leaves in creation order
        internal_ids = [i for i in range(nn) if not is_leaf[i]]
        leaf_ids = [i for i in range(nn) if is_leaf[i]]
        int_ord = {nid: i for i, nid in enumerate(internal_ids)}
        leaf_ord = {nid: i for i, nid in enumerate(leaf_ids)}

        def child_code(c):
            return leaf_ord[c] * -1 - 1 if is_leaf[c] else int_ord[c]

        dl = a["default_left"][t]
        cat_flag = a.get("cat_flag")
        cat_left = a.get("cat_left")
        # categorical internal nodes: decision_type bit 0 set; threshold
        # indexes into cat_boundaries/cat_threshold (LightGBM's 32-bit
        # bitset words over raw category ids: bit c means category c goes
        # left; identity binning keeps category c at bin c+1)
        cat_idx_of: dict[int, int] = {}
        cat_boundaries = [0]
        cat_words: list[int] = []
        if cat_flag is not None:
            for i in internal_ids:
                if not cat_flag[t, i]:
                    continue
                bits = np.flatnonzero(cat_left[t, i][1:])  # category ids
                n_words = max((int(bits.max()) // 32 + 1) if bits.size
                              else 1, 1)
                words = [0] * n_words
                for c in bits:
                    words[c // 32] |= 1 << (c % 32)
                cat_idx_of[i] = len(cat_boundaries) - 1
                cat_words.extend(words)
                cat_boundaries.append(len(cat_words))
        rows = {
            "split_feature": [int(a["feature"][t, i]) for i in internal_ids],
            "split_gain": [float(a["split_gain"][t, i])
                           for i in internal_ids],
            "threshold": [float(cat_idx_of[i]) if i in cat_idx_of
                          else float(a["threshold"][t, i])
                          for i in internal_ids],
            # 1: a category set (as the JAX package writes); 2: missing
            # goes left (trained trees); 8: NaN-missing, default right
            # (loaded models)
            "decision_type": [1 if i in cat_idx_of else 2 if dl[i] else 8
                              for i in internal_ids],
            "left_child": [child_code(int(a["left"][t, i]))
                           for i in internal_ids],
            "right_child": [child_code(int(a["right"][t, i]))
                            for i in internal_ids],
            "leaf_value": [float(a["leaf_value"][t, i]) * leaf_scale
                           + leaf_shift for i in leaf_ids],
            "leaf_weight": [float(a["node_weight"][t, i]) for i in leaf_ids],
            "leaf_count": [int(a["node_count"][t, i]) for i in leaf_ids],
            "internal_value": [float(a["node_value"][t, i])
                               for i in internal_ids],
            "internal_weight": [float(a["node_weight"][t, i])
                                for i in internal_ids],
            "internal_count": [int(a["node_count"][t, i])
                               for i in internal_ids],
        }
        out = [f"Tree={t}", f"num_leaves={len(leaf_ids)}",
               f"num_cat={len(cat_idx_of)}"]
        for key, vals in rows.items():
            out.append(f"{key}=" + " ".join(_fmt(v) for v in vals))
        if cat_idx_of:
            out.append("cat_boundaries=" + " ".join(
                str(v) for v in cat_boundaries))
            out.append("cat_threshold=" + " ".join(
                str(v) for v in cat_words))
        out.append("shrinkage=1")
        return out

    @staticmethod
    def load_native(model_str: str) -> "Booster":
        """Parse a LightGBM text model (either package's or native
        LightGBM's), categorical splits included."""
        header, trees = {}, []
        average_output = False
        cur: dict | None = None
        for line in model_str.splitlines():
            line = line.strip()
            if line.startswith("Tree="):
                cur = {}
                trees.append(cur)
                continue
            if line == "end of trees":
                cur = None
                continue
            if line == "average_output" and cur is None:
                average_output = True
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                (header if cur is None else cur)[k] = v
        num_class = int(header.get("num_class", 1))
        objective = header.get("objective", "regression").split()[0]
        sigmoid = 1.0
        for tokenised in header.get("objective", "").split():
            if tokenised.startswith("sigmoid:"):
                sigmoid = float(tokenised.split(":")[1])
        T = len(trees)
        max_leaves = max((int(t["num_leaves"]) for t in trees), default=1)
        NN = 2 * max_leaves - 1
        arr = {k: np.zeros((T, NN), dt) for k, dt in [
            ("feature", np.int32), ("threshold", np.float32),
            ("leaf_value", np.float32), ("is_leaf", bool),
            ("split_gain", np.float32), ("node_weight", np.float32),
            ("node_count", np.float32), ("node_value", np.float32)]}
        # unused padded slots must read "no child" (-1), not node 0 —
        # feature_importances treats left >= 0 as a real split
        arr["left"] = np.full((T, NN), -1, np.int32)
        arr["right"] = np.full((T, NN), -1, np.int32)
        arr["num_nodes"] = np.zeros(T, np.int32)
        arr["default_left"] = np.ones((T, NN), bool)
        for t, td in enumerate(trees):
            nl = int(td["num_leaves"])
            ni = nl - 1

            def parse(key, dtype=float):
                raw = td.get(key, "")
                return [dtype(v) for v in raw.split()] if raw else []
            dt = parse("decision_type", int)
            if int(td.get("num_cat", "0")) > 0 or any(d & 1 for d in dt):
                cat_bnd = parse("cat_boundaries", int)
                cat_thr = parse("cat_threshold", int)
                if "cat_flag" not in arr:
                    arr["cat_flag"] = np.zeros((T, NN), bool)
                    arr["cat_left"] = np.zeros((T, NN, 256), bool)
            sf = parse("split_feature", int)
            thr = parse("threshold", float)
            lc = parse("left_child", int)
            rc = parse("right_child", int)
            lv = parse("leaf_value", float)
            lw = parse("leaf_weight", float)
            lcnt = parse("leaf_count", float)
            sg = parse("split_gain", float)
            iv = parse("internal_value", float)
            iw = parse("internal_weight", float)
            icnt = parse("internal_count", float)
            arr["num_nodes"][t] = ni + nl

            # internal node i -> id i; leaf j -> id ni + j
            def to_id(code):
                return ni + (-code - 1) if code < 0 else code
            for i in range(ni):
                arr["feature"][t, i] = sf[i]
                arr["threshold"][t, i] = thr[i]
                arr["left"][t, i] = to_id(lc[i])
                arr["right"][t, i] = to_id(rc[i])
                # decision_type bit 1 = default-left for missing values
                arr["default_left"][t, i] = bool(dt[i] & 2) \
                    if i < len(dt) else True
                if i < len(dt) and dt[i] & 1:
                    # a category set: threshold indexes the bitset words;
                    # bit c set = raw category c goes left = bin c+1
                    ci = int(thr[i])
                    words = cat_thr[cat_bnd[ci]:cat_bnd[ci + 1]]
                    arr["cat_flag"][t, i] = True
                    for w_i, word in enumerate(words):
                        word = int(word) & 0xFFFFFFFF
                        for bit in range(32):
                            if word >> bit & 1:
                                c = w_i * 32 + bit
                                if c + 1 >= 256:
                                    raise NotImplementedError(
                                        "categorical model uses category "
                                        f"id {c} >= 255; unsupported")
                                arr["cat_left"][t, i, c + 1] = True
                arr["split_gain"][t, i] = sg[i] if i < len(sg) else 0
                arr["node_value"][t, i] = iv[i] if i < len(iv) else 0
                arr["node_weight"][t, i] = iw[i] if i < len(iw) else 0
                arr["node_count"][t, i] = icnt[i] if i < len(icnt) else 0
            for j in range(nl):
                nid = ni + j
                arr["is_leaf"][t, nid] = True
                arr["leaf_value"][t, nid] = lv[j] if j < len(lv) else 0
                arr["node_weight"][t, nid] = lw[j] if j < len(lw) else 0
                arr["node_count"][t, nid] = lcnt[j] if j < len(lcnt) else 0
            if nl == 1 and not lv:
                arr["is_leaf"][t, 0] = True
        names = header.get("feature_names", "").split()
        return Booster(arr, num_class=num_class, objective=objective,
                       sigmoid=sigmoid, feature_names=names or None,
                       max_depth_bound=max_leaves,
                       average_output=average_output)


def _fmt(v) -> str:
    if isinstance(v, int):
        return str(v)
    return np.format_float_scientific(v, unique=True).replace("e+0", "e+") \
        .replace("e-0", "e-") if abs(v) > 1e4 or (v != 0 and abs(v) < 1e-4) \
        else repr(float(v))


# ------------------------------------------------------------------ predict
def _score_math(leaf_value, leaves, w, init_score, *, num_class: int,
                avg_div: int):
    """Post-leaf scoring: gather each (row, tree) leaf value, weight it,
    reduce per class, add the init score."""
    n, T = leaves.shape
    t_idx = torch.arange(T, device=leaves.device)[None, :]
    weighted = leaf_value[t_idx, leaves] * w[None, :]
    scores = weighted.reshape(n, T // num_class, num_class).sum(dim=1)
    return scores / avg_div + init_score[None, :]


def _predict_leaf_nodes(tree_arrays, x, *, max_depth: int):
    """Route every (row, tree) pair ``max_depth`` levels → leaf node ids
    [n, T] (i64). Category sets (``cat_left`` not None) route by
    ``categorical_go_left``'s rule."""
    (feature, threshold, left, right, _, is_leaf, default_left, cat_flag,
     cat_left) = tree_arrays
    T = feature.shape[0]
    n = x.shape[0]
    node = torch.zeros((n, T), dtype=torch.int64, device=x.device)
    t_idx = torch.arange(T, device=x.device)[None, :]
    for _ in range(max_depth):
        f = feature[t_idx, node]                      # [n, T]
        thr = threshold[t_idx, node]
        xv = torch.gather(x, 1, f)
        missing = torch.isnan(xv)
        go_left = torch.where(missing, default_left[t_idx, node], xv <= thr)
        if cat_left is not None:
            go_left = torch.where(
                cat_flag[t_idx, node],
                categorical_go_left_at(xv, missing, cat_left, t_idx, node),
                go_left)
        nxt = torch.where(go_left, left[t_idx, node], right[t_idx, node])
        node = torch.where(is_leaf[t_idx, node], node, nxt)
    return node
