"""LightGBMClassifier / LightGBMRegressor and their models — the GBDT
pipeline stages.

API parity with reference ``lightgbm/LightGBMClassifier.scala:26-208``,
``LightGBMRegressor.scala`` and ``mmlspark_tpu/lightgbm/estimators.py``:
the same Params, the same output columns (rawPrediction, probability,
prediction), validation rows through ``validationIndicatorCol`` with early
stopping, custom objectives (``fobj``, a torch callable), native-model
export. Training and scoring run on the ``device`` Param's device (CUDA by
default; ``device="cpu"`` runs on the CPU, and nothing else does).

Still to come, each raising ``NotImplementedError`` naming its item:
categorical slots, sparse input, the ranker and SHAP values
(``featuresShapCol``), model continuation (``modelString``,
``initScoreCol``, ``numBatches > 1``) and more than one shard.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.contracts import HasProbabilityCol, HasRawPredictionCol
from ..core.utils import as_2d_features
from .booster import Booster
from .objectives import LATER_SLICE
from .params import LightGBMSharedParams
from .trainer import TrainConfig, train


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with {LATER_SLICE}")


def extract_features(df, col: str) -> np.ndarray:
    """Dense [n, F] float32 features from a DataFrame. The padded-COO
    ``<col>_indices``/``<col>_values`` pair (sparse input) raises."""
    if f"{col}_indices" in df.columns and f"{col}_values" in df.columns:
        raise _later("sparse (padded-COO) input")
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

    def _check_slice(self) -> None:
        """Raise for every setting whose configuration is still to come
        (``TrainConfig`` refuses the rest)."""
        if self.getNumBatches() and self.getNumBatches() > 1:
            raise _later("numBatches > 1")
        if self.getNumShards() > 1:
            raise _later("training on more than one shard or device")
        if self.getParallelism() not in ("data_parallel", "voting_parallel"):
            raise ValueError(f"parallelism={self.getParallelism()!r}; "
                             "expected data_parallel | voting_parallel")
        if self.isSet("initScoreCol"):
            raise _later("initScoreCol warm starts")
        if self.getModelString():
            raise _later("model continuation (modelString)")
        if self.getCategoricalSlotIndexes() or \
                self.getCategoricalSlotNames():
            raise _later("categorical slots")

    def _fit(self, df):
        self._check_slice()
        train_df, valid = df, None
        if self.isSet("validationIndicatorCol"):
            flag = np.asarray(df[self.getValidationIndicatorCol()],
                              dtype=bool)
            train_df, valid_df = df.filter(~flag), df.filter(flag)
            valid = (extract_features(valid_df, self.getFeaturesCol()),
                     np.asarray(valid_df[self.getLabelCol()], np.float32),
                     np.asarray(valid_df[self.getWeightCol()], np.float32)
                     if self.isSet("weightCol") else None)
        x = extract_features(train_df, self.getFeaturesCol())
        y = np.asarray(train_df[self.getLabelCol()], np.float32)
        w = (np.asarray(train_df[self.getWeightCol()], np.float32)
             if self.isSet("weightCol") else None)
        cfg = TrainConfig(**self._train_config_kwargs(),
                          **self._objective_config(y))
        names = self.getSlotNames() or [f"Column_{i}"
                                        for i in range(x.shape[1])]
        result = train(x, y, w, cfg, valid, feature_names=names,
                       device=self.getDevice(), hist_impl=self._hist_impl)
        model = self._make_model(result.booster)
        self._copy_params_to(model)
        return model


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
        if self.isSet("featuresShapCol"):
            raise _later("featuresShapCol (SHAP values)")
        x = extract_features(df, self.getFeaturesCol())
        return x, self.booster.raw_scores(
            x, self._num_iter(), start_iteration=self.getStartIteration(),
            device=self.getDevice())

    def _leaf_column(self, out, x):
        if self.isSet("leafPredictionCol"):
            leaves = self.booster.predict_leaf(
                x, self._num_iter(), start_iteration=self.getStartIteration(),
                device=self.getDevice())
            out = out.with_column(self.getLeafPredictionCol(),
                                  leaves.astype(np.float64))
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
        return self._leaf_column(out, x)


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
        return self._leaf_column(out, x)
