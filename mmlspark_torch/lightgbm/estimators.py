"""LightGBMClassifier and its model — the GBDT pipeline stages.

API parity with reference ``lightgbm/LightGBMClassifier.scala:26-208`` and
``mmlspark_tpu/lightgbm/estimators.py:327-412``: the same Params, the same
output columns (rawPrediction, probability, prediction), native-model
export. Training and scoring run on the ``device`` Param's device (CUDA by
default; ``device="cpu"`` runs on the CPU, and nothing else does).

The regressor, the ranker, sparse input, SHAP and every configuration
outside the slice come with the GBDT breadth slice and raise
``NotImplementedError`` until then.
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


class LightGBMClassifier(Estimator, LightGBMSharedParams,
                         HasRawPredictionCol, HasProbabilityCol):
    objective = Param("objective", "binary | multiclass | multiclassova",
                      TC.toString, default="binary")
    isUnbalance = Param("isUnbalance", "auto-weight positive class",
                        TC.toBoolean, default=False)
    scalePosWeight = Param("scalePosWeight", "positive class weight",
                           TC.toFloat, default=1.0)
    sigmoid = Param("sigmoid", "sigmoid sharpness", TC.toFloat, default=1.0)
    numClass = Param("numClass", "class count (multiclass)", TC.toInt,
                     default=1)
    thresholds = Param("thresholds", "per-class prediction thresholds",
                       TC.toListFloat, default=[])

    # engine plumbing, not a Param: "torch" runs the plain histogram on
    # any device (the card's comparison path); None picks by device
    _hist_impl: str | None = None

    def _check_slice(self) -> None:
        """Raise for every setting whose configuration this slice lacks
        (the rest are refused by ``TrainConfig``)."""
        if self.getNumBatches() and self.getNumBatches() > 1:
            raise _later("numBatches > 1")
        if self.getNumShards() > 1:
            raise _later("training on more than one shard or device")
        if self.getParallelism() not in ("data_parallel", "voting_parallel"):
            raise ValueError(f"parallelism={self.getParallelism()!r}; "
                             "expected data_parallel | voting_parallel")
        if self.getXgboostDartMode():
            raise _later("xgboost-style DART (xgboostDartMode)")
        for name, what in (("validationIndicatorCol", "validation sets"),
                           ("initScoreCol", "initScoreCol warm starts"),
                           ("fobj", "custom objectives (fobj)")):
            if self.isSet(name):
                raise _later(what)
        if self.getModelString():
            raise _later("model continuation (modelString)")
        if self.getIsProvideTrainingMetric():
            raise _later("training metrics")
        if self.getCategoricalSlotIndexes() or \
                self.getCategoricalSlotNames():
            raise _later("categorical slots")

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

    def _fit(self, df):
        self._check_slice()
        x = extract_features(df, self.getFeaturesCol())
        y = np.asarray(df[self.getLabelCol()], np.float32)
        w = (np.asarray(df[self.getWeightCol()], np.float32)
             if self.isSet("weightCol") else None)
        cfg = TrainConfig(**self._train_config_kwargs(),
                          **self._objective_config(y))
        names = self.getSlotNames() or [f"Column_{i}"
                                        for i in range(x.shape[1])]
        result = train(x, y, w, cfg, feature_names=names,
                       device=self.getDevice(), hist_impl=self._hist_impl)
        model = LightGBMClassificationModel(booster=result.booster)
        self._copy_params_to(model)
        return model


class LightGBMClassificationModel(Model, LightGBMSharedParams,
                                  HasRawPredictionCol, HasProbabilityCol):
    thresholds = Param("thresholds", "per-class prediction thresholds",
                       TC.toListFloat, default=[])
    leafPredictionCol = Param("leafPredictionCol",
                              "output column with per-tree leaf indices",
                              TC.toString)
    featuresShapCol = Param("featuresShapCol",
                            "output column with SHAP contributions",
                            TC.toString)
    numIterationsForPrediction = Param(
        "numIterationsForPrediction",
        "use only the first k iterations when predicting (0 = all)",
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

    @property
    def numClasses(self) -> int:
        return max(self.booster.num_class, 2)

    def _num_iter(self):
        k = self.getNumIterationsForPrediction()
        return k if k and k > 0 else None

    def _transform(self, df):
        if self.isSet("featuresShapCol"):
            raise _later("featuresShapCol (SHAP values)")
        x = extract_features(df, self.getFeaturesCol())
        start = self.getStartIteration()
        raw = self.booster.raw_scores(x, self._num_iter(),
                                      start_iteration=start,
                                      device=self.getDevice())
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
        if self.isSet("leafPredictionCol"):
            leaves = self.booster.predict_leaf(
                x, self._num_iter(), start_iteration=start,
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

    @staticmethod
    def load_native_model_from_string(model_str: str,
                                      **kwargs) -> "LightGBMClassificationModel":
        return LightGBMClassificationModel(
            booster=Booster.load_native(model_str), **kwargs)

    @staticmethod
    def load_native_model_from_file(path: str,
                                    **kwargs) -> "LightGBMClassificationModel":
        with open(path) as f:
            return LightGBMClassificationModel.load_native_model_from_string(
                f.read(), **kwargs)

    loadNativeModelFromString = load_native_model_from_string
    loadNativeModelFromFile = load_native_model_from_file
