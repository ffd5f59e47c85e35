"""Shared column-name param mixins.

Reference ``core/contracts/Params.scala`` (248 LoC): ``HasInputCol``,
``HasOutputCol``, ``HasLabelCol``, ``HasFeaturesCol``, ``HasWeightCol``,
``HasGroupCol`` — mixed into nearly every stage so column wiring is uniform.
"""

from __future__ import annotations

from .param import Param, TypeConverters as TC


class HasInputCol:
    inputCol = Param("inputCol", "name of the input column", TC.toString)


class HasInputCols:
    inputCols = Param("inputCols", "names of the input columns", TC.toListString)


class HasOutputCol:
    outputCol = Param("outputCol", "name of the output column", TC.toString)


class HasOutputCols:
    outputCols = Param("outputCols", "names of the output columns",
                       TC.toListString)


class HasLabelCol:
    labelCol = Param("labelCol", "name of the label column", TC.toString,
                     default="label")


class HasFeaturesCol:
    featuresCol = Param("featuresCol", "name of the features column",
                        TC.toString, default="features")


class HasWeightCol:
    weightCol = Param("weightCol", "name of the instance-weight column",
                      TC.toString)


class HasInitScoreCol:
    initScoreCol = Param("initScoreCol",
                         "column with initial scores (warm start / boosting "
                         "continuation)", TC.toString)


class HasGroupCol:
    groupCol = Param("groupCol", "name of the query-group column (ranking)",
                     TC.toString)


class HasValidationIndicatorCol:
    validationIndicatorCol = Param(
        "validationIndicatorCol",
        "boolean column marking rows held out for early-stopping validation",
        TC.toString)


class HasPredictionCol:
    predictionCol = Param("predictionCol", "name of the prediction column",
                          TC.toString, default="prediction")


class HasRawPredictionCol:
    rawPredictionCol = Param("rawPredictionCol",
                             "raw (margin) prediction column", TC.toString,
                             default="rawPrediction")


class HasProbabilityCol:
    probabilityCol = Param("probabilityCol",
                           "class-probability prediction column", TC.toString,
                           default="probability")


class HasSeed:
    seed = Param("seed", "random seed", TC.toInt, default=0, has_default=True)


class HasDevice:
    """The torch device a stage computes on: ``"cuda"`` (the default, and
    what a stage saved by the JAX package gets on load) or ``"cpu"`` when
    asked. Asking for CUDA without a GPU raises; nothing moves to the CPU
    on its own."""

    device = Param("device", "torch device: 'cuda' (default) or 'cpu'",
                   TC.toString, default="cuda")

    def _device(self):
        from ..device import resolve_device
        return resolve_device(self.get("device"))
