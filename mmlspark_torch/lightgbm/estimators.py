"""LightGBMClassifier / LightGBMRegressor / LightGBMRanker and their
models — the GBDT pipeline stages.

API parity with reference ``lightgbm/LightGBMClassifier.scala:26-208``,
``LightGBMRegressor.scala``, ``LightGBMRanker.scala:80-110`` and
``mmlspark_tpu/lightgbm/estimators.py``: the same Params, the same output
columns (rawPrediction, probability, prediction, SHAP values, leaf
indices), validation rows through ``validationIndicatorCol`` with early
stopping, categorical slots (``categoricalSlotIndexes``/``Names``),
padded-COO sparse features (``<col>_indices``/``<col>_values``), custom
objectives (``fobj``, a torch callable), the lambdarank ranker,
native-model export, and the reference's batch training
(``LightGBMBase.scala:24-293``): ``numBatches`` and ``fit_stream`` continue
one booster batch by batch, from ``modelString`` where it is set, with
``initScoreCol`` warm starts. Training and scoring run on the ``device``
Param's device (CUDA by default; ``device="cpu"`` runs on the CPU, and
nothing else does).

``numShards`` trains over the ranks of ``torch.distributed``'s default
process group (one process per device, e.g. under ``torchrun``): every
rank calls ``fit`` on the whole frame, and the shard group's ranks grow
the same trees from their blocks of rows (``parallelism`` data or voting,
``topK``; ``shardAxisName="slice,dp"`` reduces within each host, then
across hosts).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.contracts import (HasGroupCol, HasProbabilityCol,
                              HasRawPredictionCol)
from ..core.utils import as_2d_features
from ..parallel.collectives import shard_group, world_size
from .booster import Booster
from .params import LightGBMSharedParams
from .ranker_objective import (build_group_index, make_lambdarank_grad_hess,
                               ndcg_at_k)
from .shap import booster_shap_values
from .sparse import SparseData, coalesce_coo
from .trainer import TrainConfig, TrainResult, train


def extract_features(df, col: str, sparse_feature_count: int = 0):
    """Features from a DataFrame: the padded-COO pair
    (``<col>_indices``/``<col>_values``, e.g. the VW featurizer's output)
    becomes a ``SparseData`` for the sparse engine (reference
    ``TrainUtils.scala:33-92``); otherwise a dense [n, F] matrix."""
    icol, vcol = f"{col}_indices", f"{col}_values"
    if icol in df.columns and vcol in df.columns:
        idx = np.asarray(df[icol], np.int32)
        val = np.asarray(df[vcol], np.float32)
        # unique indices per row (featurizer output with
        # sumCollisions=False may carry duplicates: merge them)
        idx, val = coalesce_coo(idx, val)
        # keep F >= 1 for empty input or all-padding rows
        max_idx = int(idx.max()) if idx.size else -1
        F = max(sparse_feature_count, max_idx + 1, 1)
        return SparseData(idx, val, F)
    return as_2d_features(df, col)


class _LightGBMBase(Estimator, LightGBMSharedParams):
    """Template-method base (the JAX package's ``_LightGBMBase``): data
    extraction → validation split → objective config → ``train`` →
    model."""

    # engine plumbing, not a Param: "torch" runs the plain histogram on
    # any device (the card's comparison path); None picks by device
    _hist_impl: str | None = None

    def _objective_config(self, y: np.ndarray) -> dict:
        raise NotImplementedError

    def _make_model(self, booster: Booster) -> Model:
        raise NotImplementedError

    def _grad_override(self, df, y):
        return None

    def _valid_eval_fn(self, valid_df):
        return None

    def _preprocess(self, df):
        return df

    def _categorical_slots(self, df) -> tuple:
        """Resolve categoricalSlotIndexes/Names to slot indexes (names
        through slotNames or the features column's ``slot_names``
        metadata, as the JAX package resolves them)."""
        idx = list(self.getCategoricalSlotIndexes() or [])
        names = self.getCategoricalSlotNames() or []
        if names:
            slots = self.getSlotNames() or []
            if not slots:
                from ..core import ColumnMetadata
                meta = ColumnMetadata.get(df, self.getFeaturesCol()) or {}
                slots = meta.get("slot_names", [])
            if not slots:
                raise ValueError(
                    "categoricalSlotNames given but no slot names are "
                    "available: set slotNames (or attach 'slot_names' "
                    "column metadata), or use categoricalSlotIndexes")
            missing = [nm for nm in names if nm not in slots]
            if missing:
                raise ValueError(
                    f"categoricalSlotNames not found in slotNames: "
                    f"{missing}")
            idx.extend(slots.index(nm) for nm in names)
        return tuple(sorted(set(int(i) for i in idx)))

    def _check_params(self) -> None:
        """Raise for a ``parallelism`` neither mode takes (``TrainConfig``
        refuses the rest)."""
        if self.getParallelism() not in ("data_parallel", "voting_parallel"):
            raise ValueError(f"parallelism={self.getParallelism()!r}; "
                             "expected data_parallel | voting_parallel")

    def _fit(self, df):
        self._check_params()
        df = self._preprocess(df)
        # slots resolve from the whole frame's metadata, before batching
        cat_slots = self._categorical_slots(df)
        num_batches = self.getNumBatches()
        parts = df.repartition(num_batches).partitions() \
            if num_batches and num_batches > 1 else [df]
        return self._fit_batches(parts, cat_slots)

    def _fit_batches(self, batches, cat_slots=None):
        """The one continuation loop behind ``numBatches`` and
        ``fit_stream``: a warm start from ``modelString``, then each batch
        continues the previous batch's booster."""
        booster = Booster.load_native(self.getModelString()) \
            if self.getModelString() else None
        result = None
        for batch in batches:
            if cat_slots is None:
                cat_slots = self._categorical_slots(batch)
            result = self._fit_batch(batch, booster, cat_slots)
            booster = result.booster
        if result is None:
            raise ValueError("received an empty batch stream")
        model = self._make_model(booster)
        self._copy_params_to(model)
        return model

    def fit_stream(self, batches):
        """Out-of-core training: consume an iterable of DataFrames one at a
        time with booster continuation, the ``numBatches`` loop bounded by
        the largest batch instead of the dataset. Every batch carries the
        same columns; categorical slots resolve from the first batch."""
        self._check_params()
        model = self._fit_batches(self._preprocess(b) for b in batches)
        model._resolve_parent(self)
        return model

    def _fit_batch(self, df, init_booster: Booster | None,
                   cat_slots: tuple) -> TrainResult:
        """One batch: the validation split, ``initScoreCol`` for training
        and validation rows, the objective config, then ``train`` warm
        started from ``init_booster`` over this fit's shard group."""
        fcol = self.getFeaturesCol()
        train_df, valid_df = df, None
        if self.isSet("validationIndicatorCol"):
            flag = np.asarray(df[self.getValidationIndicatorCol()],
                              dtype=bool)
            train_df, valid_df = df.filter(~flag), df.filter(flag)
        x = extract_features(train_df, fcol, self.getSparseFeatureCount())
        sparse = isinstance(x, SparseData)
        scored = self.isSet("initScoreCol")
        valid = valid_eval_fn = valid_init = None
        if valid_df is not None:
            valid = (extract_features(valid_df, fcol,
                                      x.num_features if sparse else 0),
                     np.asarray(valid_df[self.getLabelCol()], np.float32),
                     np.asarray(valid_df[self.getWeightCol()], np.float32)
                     if self.isSet("weightCol") else None)
            valid_eval_fn = self._valid_eval_fn(valid_df)
            if scored:
                valid_init = np.asarray(valid_df[self.getInitScoreCol()],
                                        np.float32)
        y = np.asarray(train_df[self.getLabelCol()], np.float32)
        w = (np.asarray(train_df[self.getWeightCol()], np.float32)
             if self.isSet("weightCol") else None)
        init = (np.asarray(train_df[self.getInitScoreCol()], np.float32)
                if scored else None)
        cfg = TrainConfig(**self._train_config_kwargs(),
                          categorical_features=cat_slots,
                          **self._objective_config(y))
        names = self.getSlotNames() or (
            None if sparse else [f"Column_{i}" for i in range(x.shape[1])])
        n_rows = x.n_rows if sparse else x.shape[0]
        return train(x, y, w, cfg, valid, init_booster=init_booster,
                     init_scores=init, valid_init_scores=valid_init,
                     feature_names=names,
                     grad_hess_override=self._grad_override(train_df, y),
                     valid_eval_fn=valid_eval_fn, device=self.getDevice(),
                     hist_impl=self._hist_impl,
                     group=self._training_group(n_rows))

    def _shard_axes(self) -> tuple:
        """``shardAxisName`` parsed: two comma-separated names ask for the
        two-level shard mesh (``"slice,dp"``)."""
        axes = tuple(a.strip() for a in self.getShardAxisName().split(",")
                     if a.strip())
        if not axes:
            raise ValueError(
                "shardAxisName must name at least one mesh axis "
                f"(got {self.getShardAxisName()!r})")
        return axes

    def _training_group(self, n_rows: int):
        """The shard group for a fit of ``n_rows`` rows, or ``None`` for
        one shard (the JAX ``_training_mesh``, with the ranks of
        ``torch.distributed``'s default process group for its devices).
        numShards: 0 = auto (every rank once the data is big enough to be
        worth the collectives), N = min(N, world size); with no process
        group initialised the world is one rank."""
        world = world_size()
        ns = self.getNumShards()
        if ns == 0:
            ns = world if n_rows >= 4096 and world > 1 else 1
        ns = min(ns, world)
        if ns <= 1:
            return None
        return shard_group(ns, self._shard_axes(),
                           device_type=torch.device(self.getDevice()).type)


class _BoosterModelMixin:
    """Shared model surface: native export, importances, leaves."""

    leafPredictionCol = Param("leafPredictionCol",
                              "output column with per-tree leaf indices",
                              TC.toString)
    featuresShapCol = Param("featuresShapCol",
                            "output column with SHAP contributions",
                            TC.toString)
    numIterationsForPrediction = Param(
        "numIterationsForPrediction",
        "use only the first k iterations when predicting (0 = all/best)",
        TC.toInt, default=0)
    startIteration = Param(
        "startIteration",
        "skip the first k iterations when predicting (reference "
        "setStartIteration)", TC.toInt, default=0)

    booster: Booster

    def __init__(self, booster: Booster | None = None, **kwargs):
        super().__init__(**kwargs)
        if booster is not None:
            self.booster = booster

    def _num_iter(self):
        k = self.getNumIterationsForPrediction()
        return k if k and k > 0 else None

    def _raw(self, df):
        x = extract_features(df, self.getFeaturesCol(),
                             self.getSparseFeatureCount())
        return x, self.booster.raw_scores(
            x, self._num_iter(), start_iteration=self.getStartIteration(),
            device=self.getDevice())

    def _extra_columns(self, out, x):
        """The leaf-index and SHAP columns, where their Params are set."""
        start = self.getStartIteration()
        if self.isSet("leafPredictionCol"):
            leaves = self.booster.predict_leaf(
                x, self._num_iter(), start_iteration=start,
                device=self.getDevice())
            out = out.with_column(self.getLeafPredictionCol(),
                                  leaves.astype(np.float64))
        if self.isSet("featuresShapCol"):
            if isinstance(x, SparseData):
                raise NotImplementedError(
                    "featuresShapCol on padded-COO sparse input is not "
                    "supported (a dense [n, F] SHAP matrix at 2^18 "
                    "features would defeat the sparse path) — densify a "
                    "feature subset first")
            shap = booster_shap_values(self.booster, np.asarray(x),
                                       x.shape[1], start_iteration=start,
                                       num_iteration=self._num_iter())
            out = out.with_column(self.getFeaturesShapCol(), shap)
        return out

    # ---------------------------------------------------- native model I/O
    def get_booster(self) -> Booster:
        return self.booster

    def save_native_model(self, path: str) -> None:
        """Reference ``saveNativeModel`` — LightGBM text model format."""
        with open(path, "w") as f:
            f.write(self.booster.save_native())

    saveNativeModel = save_native_model

    def get_native_model_string(self) -> str:
        return self.booster.save_native()

    def get_feature_importances(self, importance_type: str = "split"):
        return self.booster.feature_importances(importance_type).tolist()

    getFeatureImportances = get_feature_importances

    def _save_extra(self, path: str) -> None:
        # The text model is self-contained (init score folded into tree 0).
        with open(os.path.join(path, "model.txt"), "w") as f:
            f.write(self.booster.save_native())

    def _load_extra(self, path: str) -> None:
        with open(os.path.join(path, "model.txt")) as f:
            self.booster = Booster.load_native(f.read())

    @classmethod
    def load_native_model_from_string(cls, model_str: str, **kwargs):
        return cls(booster=Booster.load_native(model_str), **kwargs)

    @classmethod
    def load_native_model_from_file(cls, path: str, **kwargs):
        with open(path) as f:
            return cls.load_native_model_from_string(f.read(), **kwargs)

    loadNativeModelFromString = load_native_model_from_string
    loadNativeModelFromFile = load_native_model_from_file


# ------------------------------------------------------------------ classifier
class LightGBMClassifier(_LightGBMBase, HasRawPredictionCol,
                         HasProbabilityCol):
    objective = Param("objective", "binary | multiclass | multiclassova "
                      "(with their aliases softmax, ova, ovr, "
                      "multiclass_ova)", TC.toString, default="binary")
    isUnbalance = Param("isUnbalance", "auto-weight positive class",
                        TC.toBoolean, default=False)
    scalePosWeight = Param("scalePosWeight", "positive class weight",
                           TC.toFloat, default=1.0)
    sigmoid = Param("sigmoid", "sigmoid sharpness", TC.toFloat, default=1.0)
    numClass = Param("numClass", "class count (multiclass)", TC.toInt,
                     default=1)
    thresholds = Param("thresholds", "per-class prediction thresholds",
                       TC.toListFloat, default=[])

    def _objective_config(self, y):
        objective = self.getObjective()
        n_classes = int(y.max()) + 1 if y.size else 2
        if objective == "binary" and n_classes > 2:
            objective = "multiclass"
        num_class = max(self.getNumClass(),
                        n_classes if objective != "binary" else 1)
        return dict(objective=objective, num_class=num_class,
                    sigmoid=self.getSigmoid(),
                    is_unbalance=self.getIsUnbalance(),
                    scale_pos_weight=self.getScalePosWeight())

    def _make_model(self, booster):
        return LightGBMClassificationModel(booster=booster)


class LightGBMClassificationModel(_BoosterModelMixin, Model,
                                  LightGBMSharedParams, HasRawPredictionCol,
                                  HasProbabilityCol):
    thresholds = Param("thresholds", "per-class prediction thresholds",
                       TC.toListFloat, default=[])

    @property
    def numClasses(self) -> int:
        return max(self.booster.num_class, 2)

    def _transform(self, df):
        x, raw = self._raw(df)
        prob = np.asarray(self.booster.transform_scores(raw))
        if raw.ndim == 1:  # binary: expand to 2-class columns
            raw2 = np.stack([-raw, raw], axis=1)
            prob2 = np.stack([1 - prob, prob], axis=1)
        else:
            raw2, prob2 = raw, prob
        thresholds = self.getThresholds()
        if thresholds:
            scaled = prob2 / np.asarray(thresholds)[None, :]
            pred = scaled.argmax(axis=1).astype(np.float64)
        else:
            pred = prob2.argmax(axis=1).astype(np.float64)
        out = (df.with_column(self.getRawPredictionCol(), raw2)
                 .with_column(self.getProbabilityCol(), prob2)
                 .with_column(self.getPredictionCol(), pred))
        return self._extra_columns(out, x)


# ------------------------------------------------------------------- regressor
class LightGBMRegressor(_LightGBMBase):
    objective = Param("objective",
                      "regression | regression_l1 | huber | fair | poisson | "
                      "quantile | mape | gamma | tweedie | cross_entropy | "
                      "cross_entropy_lambda", TC.toString,
                      default="regression")
    alpha = Param("alpha", "quantile level / huber delta", TC.toFloat,
                  default=0.9)
    fairC = Param("fairC", "fair-loss c", TC.toFloat, default=1.0)
    tweedieVariancePower = Param("tweedieVariancePower",
                                 "tweedie variance power in (1, 2)",
                                 TC.toFloat, default=1.5)

    def _objective_config(self, y):
        return dict(objective=self.getObjective(), alpha=self.getAlpha(),
                    fair_c=self.getFairC(),
                    tweedie_variance_power=self.getTweedieVariancePower())

    def _make_model(self, booster):
        return LightGBMRegressionModel(booster=booster)


class LightGBMRegressionModel(_BoosterModelMixin, Model,
                              LightGBMSharedParams):
    def _transform(self, df):
        x, raw = self._raw(df)
        pred = np.asarray(self.booster.transform_scores(raw))
        out = df.with_column(self.getPredictionCol(), pred)
        return self._extra_columns(out, x)


# --------------------------------------------------------------------- ranker
class LightGBMRanker(_LightGBMBase, HasGroupCol):
    objective = Param("objective", "lambdarank", TC.toString,
                      default="lambdarank")
    maxPosition = Param("maxPosition", "NDCG truncation for eval", TC.toInt,
                        default=20)
    truncationLevel = Param("truncationLevel",
                            "lambdarank pair truncation level", TC.toInt,
                            default=30)
    evalAt = Param("evalAt", "NDCG@k eval positions", TC.toListInt,
                   default=[1, 3, 5, 10])
    repartitionByGroupingColumn = Param(
        "repartitionByGroupingColumn",
        "keep query groups contiguous (reference :92-101)", TC.toBoolean,
        default=True)

    def _preprocess(self, df):
        # reference LightGBMRanker.preprocessData: each query's documents
        # contiguous
        if self.getRepartitionByGroupingColumn():
            return df.sort(self.getGroupCol())
        return df

    def _objective_config(self, y):
        return dict(objective="lambdarank")

    def _grad_override(self, df, y):
        gidx = build_group_index(_group_ids(df[self.getGroupCol()]))
        return make_lambdarank_grad_hess(
            np.asarray(y, np.float32), gidx,
            truncation_level=self.getTruncationLevel())

    def _valid_eval_fn(self, valid_df):
        vgroups = _group_ids(valid_df[self.getGroupCol()])
        k = self.getMaxPosition()

        def eval_ndcg(raw_scores, yv, wv):
            return ndcg_at_k(raw_scores, yv.astype(np.float64), vgroups, k=k)
        return eval_ndcg

    def _make_model(self, booster):
        return LightGBMRankerModel(booster=booster)

    def fit_stream(self, batches):
        """``fit_stream`` with the reference's group integrity
        (``LightGBMRanker.scala:92-101`` repartitions by the grouping
        column): each batch must hold whole query groups, so a group id
        seen again in a later batch raises instead of training as two
        queries with corrupted pairwise gradients."""
        gcol = self.getGroupCol()
        seen: set = set()

        def guarded():
            for batch in batches:
                gids = set(np.asarray(batch[gcol]).tolist())
                overlap = gids & seen
                if overlap:
                    raise ValueError(
                        f"query group(s) {sorted(overlap)[:5]} span "
                        "multiple stream batches; the ranker needs whole "
                        "groups per batch — repartition the stream by "
                        "the grouping column")
                seen.update(gids)
                yield batch
        return super().fit_stream(guarded())


class LightGBMRankerModel(_BoosterModelMixin, Model, LightGBMSharedParams,
                          HasGroupCol):
    def _transform(self, df):
        x, raw = self._raw(df)
        out = df.with_column(self.getPredictionCol(), np.asarray(raw))
        return self._extra_columns(out, x)

    def evaluate_ndcg(self, df, k: int = 10) -> float:
        scored = self.transform(df)
        return ndcg_at_k(np.asarray(scored[self.getPredictionCol()]),
                         np.asarray(scored[self.getLabelCol()], np.float64),
                         _group_ids(scored[self.getGroupCol()]), k=k)


def _group_ids(col) -> np.ndarray:
    """Group column (int or string, as the reference takes) → dense int
    ids."""
    _, ids = np.unique(np.asarray([str(v) for v in np.asarray(col).tolist()]),
                       return_inverse=True)
    return ids
