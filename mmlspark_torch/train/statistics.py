"""ComputeModelStatistics.

Reference ``train/ComputeModelStatistics.scala:58-...``: classification
(accuracy, precision, recall, AUC, AUPR) and regression (mse, rmse, r2, mae)
metric DataFrames. A port of ``mmlspark_tpu/train/statistics.py``; the
metrics are host numpy over the scored columns, as there.
ComputePerInstanceStatistics comes with the learners slice.
"""

from __future__ import annotations

import numpy as np

from ..core import DataFrame, Transformer, Param, TypeConverters as TC
from ..core.contracts import HasLabelCol
from ..lightgbm.trainer import roc_auc


def confusion_matrix(y: np.ndarray, pred: np.ndarray,
                     n_classes: int | None = None) -> np.ndarray:
    k = n_classes or int(max(y.max(), pred.max())) + 1
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (y.astype(int), pred.astype(int)), 1)
    return cm


def classification_metrics(y, pred, scores=None) -> dict:
    cm = confusion_matrix(y, pred)
    acc = float((pred == y).mean())
    with np.errstate(divide="ignore", invalid="ignore"):
        # micro-averaged for multiclass; binary reduces to the usual defs
        tp = np.diag(cm).astype(float)
        prec = np.nansum(tp / np.maximum(cm.sum(axis=0), 1) *
                         cm.sum(axis=1) / cm.sum())
        rec = np.nansum(tp / np.maximum(cm.sum(axis=1), 1) *
                        cm.sum(axis=1) / cm.sum())
    out = {"accuracy": acc, "precision": float(prec), "recall": float(rec),
           "confusion_matrix": cm}
    if scores is not None and cm.shape[0] <= 2:
        out["AUC"] = roc_auc(y, scores)
        out["AUPR"] = pr_auc(y, scores)
    return out


def pr_auc(y, scores) -> float:
    """Area under the precision-recall curve (Spark's ``areaUnderPR``):
    trapezoid over recall at every ranked cut, anchored at (recall 0,
    precision 1) like Spark's curve."""
    order = np.argsort(-np.asarray(scores))
    y = np.asarray(y)[order]
    tp = np.cumsum(y)
    prec = np.r_[1.0, tp / np.arange(1, len(y) + 1)]
    rec = np.r_[0.0, tp / max(tp[-1], 1)]
    return float(np.sum(np.diff(rec) * (prec[1:] + prec[:-1]) / 2.0))


def regression_metrics(y, pred) -> dict:
    err = pred - y
    mse = float(np.mean(err ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    return {"mse": mse, "rmse": float(np.sqrt(mse)),
            "mae": float(np.mean(np.abs(err))),
            "r^2": 1.0 - float(np.sum(err ** 2)) / ss_tot
            if ss_tot > 0 else 0.0}


class MetricsLogger:
    """Structured metric logging (reference ``MetricsLogger``,
    ``ComputeModelStatistics.scala:473-494``): one JSON info line per
    metric set, tagged with the emitting stage uid."""

    def __init__(self, uid: str | None = None):
        import logging
        self.uid = uid
        self._logger = logging.getLogger("mmlspark_torch.metrics")

    def _log(self, kind: str, metrics: dict) -> None:
        import json
        self._logger.info(json.dumps(
            {"uid": self.uid, "kind": kind,
             "metrics": {k: float(v) for k, v in metrics.items()}}))

    def log_classification_metrics(self, accuracy: float,
                                   precision: float,
                                   recall: float) -> None:
        self._log("Classification Metrics",
                  {"accuracy": accuracy, "precision": precision,
                   "recall": recall})

    def log_regression_metrics(self, mse: float, rmse: float, r2: float,
                               mae: float) -> None:
        self._log("Regression Metrics",
                  {"mse": mse, "rmse": rmse, "r2": r2, "mae": mae})


class ComputeModelStatistics(Transformer, HasLabelCol):
    """Emits a one-row metrics DataFrame for scored data."""

    scoresCol = Param("scoresCol", "raw score / probability column",
                      TC.toString, default="probability")
    scoredLabelsCol = Param("scoredLabelsCol", "prediction column",
                            TC.toString, default="prediction")
    evaluationMetric = Param("evaluationMetric",
                             "classification | regression | all",
                             TC.toString, default="all")

    def _transform(self, df):
        y = np.asarray(df[self.getLabelCol()], np.float64)
        pred = np.asarray(df[self.get("scoredLabelsCol")], np.float64)
        kind = self.get("evaluationMetric")
        if kind == "all":
            is_cls = (np.allclose(y, np.round(y))
                      and len(np.unique(y)) <= max(20, int(y.max()) + 1)
                      and len(np.unique(y)) < max(20, len(y) // 10))
            kind = "classification" if is_cls else "regression"
        if kind == "classification":
            scores = None
            if self.get("scoresCol") in df.columns:
                s = df[self.get("scoresCol")]
                scores = np.asarray(s)[:, -1] if np.asarray(s).ndim == 2 \
                    else np.asarray(s, np.float64)
            m = classification_metrics(y, pred, scores)
            m.pop("confusion_matrix")
            MetricsLogger(getattr(self, "uid", None)) \
                .log_classification_metrics(m["accuracy"],
                                            m["precision"], m["recall"])
        else:
            m = regression_metrics(y, pred)
            MetricsLogger(getattr(self, "uid", None)) \
                .log_regression_metrics(m["mse"], m["rmse"], m["r^2"],
                                        m["mae"])
        return DataFrame({k: np.asarray([v]) for k, v in m.items()})
