"""LightGBM-style parameters of the port's GBDT stages.

Every Param of ``mmlspark_tpu/lightgbm/params.py`` (reference
``lightgbm/params/LightGBMParams.scala``) with the same names and defaults,
plus ``device``, so a pipeline written for the JAX package constructs
unchanged. The boosting types, bagging, ``featureFraction``, the DART and
GOSS rates, ``baggingSeed``, ``metric``, ``evalFreq``,
``isProvideTrainingMetric``, ``earlyStoppingRound``,
``improvementTolerance``, the categorical slots
(``categoricalSlotIndexes``/``Names``, ``catSmooth``,
``maxCatThreshold``), ``maxBinByFeature`` and the sparse widths
(``maxBinSparse``, ``sparseFeatureCount``) all act as in the JAX package.
Some select configurations still to come (continuation, more than one
shard): the estimator raises ``NotImplementedError`` when one is set to
such a value, as it raises the JAX package's own refusals (xgboost-style
DART). The rest are inert here: the socket settings
(``useBarrierExecutionMode``, ``defaultListenPort``, ``timeout``), the
host knobs (``numThreads``, ``verbosity``, ``scanChunk``), and the mesh's
``shardAxisName`` and ``parallelism``/``topK`` (one shard: data and
voting parallelism are the same computation).
"""

from __future__ import annotations

from ..core import Param, TypeConverters as TC, UDFParam
from ..core.contracts import (HasFeaturesCol, HasInitScoreCol, HasLabelCol,
                              HasPredictionCol, HasValidationIndicatorCol,
                              HasWeightCol)


class LightGBMExecutionParams:
    """Execution topology params — reference ``LightGBMParams.scala``;
    ``device`` picks the torch device."""
    device = Param("device", "torch device: 'cuda' (default) or 'cpu'",
                   TC.toString, default="cuda")
    numShards = Param("numShards",
                      "device shards for training (0 = auto: one device "
                      "here; more than one is not ported yet)",
                      TC.toInt, default=0)
    numBatches = Param("numBatches",
                       "split training into sequential batches with model "
                       "continuation", TC.toInt, default=0)
    parallelism = Param("parallelism",
                        "data_parallel | voting_parallel (one shard: the "
                        "same computation)", TC.toString,
                        default="data_parallel")
    topK = Param("topK", "top-K features per shard in voting parallel",
                 TC.toInt, default=20)
    shardAxisName = Param("shardAxisName", "mesh axis to shard rows over "
                          "(inert: one shard)", TC.toString, default="dp")
    useBarrierExecutionMode = Param("useBarrierExecutionMode",
                                    "inert (no socket mesh)",
                                    TC.toBoolean, default=False)
    defaultListenPort = Param("defaultListenPort", "inert (no socket mesh)",
                              TC.toInt, default=12400)
    timeout = Param("timeout", "inert (no socket mesh)", TC.toFloat,
                    default=1200.0)
    numThreads = Param("numThreads", "host threads (inert: 0 = PyTorch's "
                       "default)", TC.toInt, default=0)


class LightGBMLearnerParams:
    numIterations = Param("numIterations", "boosting rounds", TC.toInt,
                          default=100)
    learningRate = Param("learningRate", "shrinkage rate", TC.toFloat,
                         default=0.1)
    numLeaves = Param("numLeaves", "max leaves per tree", TC.toInt,
                      default=31)
    maxDepth = Param("maxDepth", "max tree depth (<=0 unlimited)", TC.toInt,
                     default=-1)
    maxBin = Param("maxBin", "max feature bins", TC.toInt, default=255)
    maxBinSparse = Param("maxBinSparse",
                         "bin cap for padded-COO sparse features",
                         TC.toInt, default=16)
    sparseFeatureCount = Param("sparseFeatureCount",
                               "logical feature-space width for sparse "
                               "input (0 = max index + 1)", TC.toInt,
                               default=0)
    binSampleCount = Param("binSampleCount",
                           "rows sampled for bin boundaries", TC.toInt,
                           default=200000)
    lambdaL1 = Param("lambdaL1", "L1 regularization", TC.toFloat, default=0.0)
    lambdaL2 = Param("lambdaL2", "L2 regularization", TC.toFloat, default=0.0)
    minSumHessianInLeaf = Param("minSumHessianInLeaf",
                                "min hessian mass per leaf", TC.toFloat,
                                default=1e-3)
    minDataInLeaf = Param("minDataInLeaf", "min rows per leaf", TC.toInt,
                          default=20)
    minGainToSplit = Param("minGainToSplit", "min split gain", TC.toFloat,
                           default=0.0)
    featureFraction = Param("featureFraction", "feature subsample per tree",
                            TC.toFloat, default=1.0)
    baggingFraction = Param("baggingFraction", "row subsample fraction",
                            TC.toFloat, default=1.0)
    baggingFreq = Param("baggingFreq", "re-bag every k iterations", TC.toInt,
                        default=0)
    baggingSeed = Param("baggingSeed", "bagging seed", TC.toInt, default=3)
    boostingType = Param("boostingType", "gbdt | rf | dart | goss",
                         TC.toString, default="gbdt")
    topRate = Param("topRate", "GOSS top-gradient keep rate", TC.toFloat,
                    default=0.2)
    otherRate = Param("otherRate", "GOSS random keep rate", TC.toFloat,
                      default=0.1)
    dropRate = Param("dropRate", "DART tree dropout rate", TC.toFloat,
                     default=0.1)
    maxDrop = Param("maxDrop", "DART max dropped trees", TC.toInt, default=50)
    skipDrop = Param("skipDrop", "DART prob of skipping dropout", TC.toFloat,
                     default=0.5)
    uniformDrop = Param("uniformDrop", "DART uniform dropout", TC.toBoolean,
                        default=False)
    earlyStoppingRound = Param("earlyStoppingRound",
                               "stop after k rounds without val improvement",
                               TC.toInt, default=0)
    metric = Param("metric", "eval metric ('' = objective default)",
                   TC.toString, default="")
    boostFromAverage = Param("boostFromAverage",
                             "init score from label average", TC.toBoolean,
                             default=True)
    seed = Param("seed", "random seed", TC.toInt, default=0)
    verbosity = Param("verbosity", "log level (inert)", TC.toInt, default=-1)
    improvementTolerance = Param(
        "improvementTolerance", "early stopping requires the metric to "
        "improve by more than this", TC.toFloat, default=0.0)
    maxDeltaStep = Param("maxDeltaStep", "cap on leaf output magnitude "
                         "(0 = unconstrained)", TC.toFloat, default=0.0)
    maxBinByFeature = Param("maxBinByFeature",
                            "per-feature bin budgets (dense path)",
                            TC.toListInt, default=[])
    posBaggingFraction = Param("posBaggingFraction",
                               "bagging keep-rate for positive rows",
                               TC.toFloat, default=1.0)
    negBaggingFraction = Param("negBaggingFraction",
                               "bagging keep-rate for negative rows",
                               TC.toFloat, default=1.0)
    xgboostDartMode = Param("xgboostDartMode",
                            "xgboost-style dart normalization (raises with "
                            "dart, as in the JAX package)", TC.toBoolean,
                            default=False)
    catSmooth = Param("catSmooth", "hessian smoothing in the categorical "
                      "gradient/hessian ratio sort", TC.toFloat,
                      default=10.0)
    maxCatThreshold = Param("maxCatThreshold",
                            "max categories in one split's left set",
                            TC.toInt, default=32)
    categoricalSlotIndexes = Param("categoricalSlotIndexes",
                                   "feature slots treated as categorical",
                                   TC.toListInt, default=[])
    categoricalSlotNames = Param("categoricalSlotNames",
                                 "feature names treated as categorical",
                                 TC.toListString, default=[])
    slotNames = Param("slotNames", "feature names", TC.toListString,
                      default=[])
    modelString = Param("modelString",
                        "initial model string for continuation", TC.toString,
                        default="")
    fobj = UDFParam("fobj",
                    "custom objective: (scores, labels, weights) -> "
                    "(grad, hess)")
    isProvideTrainingMetric = Param("isProvideTrainingMetric",
                                    "record metrics on training data",
                                    TC.toBoolean, default=False)
    evalFreq = Param("evalFreq", "evaluate metrics every k iterations",
                     TC.toInt, default=1)
    scanChunk = Param("scanChunk", "boosting iterations the JAX package "
                      "fuses into one dispatch (inert: PyTorch runs "
                      "eagerly)", TC.toInt, default=8)


class LightGBMSharedParams(LightGBMExecutionParams, LightGBMLearnerParams,
                           HasFeaturesCol, HasLabelCol, HasWeightCol,
                           HasInitScoreCol, HasValidationIndicatorCol,
                           HasPredictionCol):
    """The estimators' params and their ``TrainConfig`` fields."""

    def _train_config_kwargs(self) -> dict:
        return dict(
            num_iterations=self.getNumIterations(),
            learning_rate=self.getLearningRate(),
            num_leaves=self.getNumLeaves(),
            max_depth=self.getMaxDepth(),
            max_bin=self.getMaxBin(),
            lambda_l1=self.getLambdaL1(),
            lambda_l2=self.getLambdaL2(),
            min_data_in_leaf=self.getMinDataInLeaf(),
            min_sum_hessian_in_leaf=self.getMinSumHessianInLeaf(),
            min_gain_to_split=self.getMinGainToSplit(),
            feature_fraction=self.getFeatureFraction(),
            bagging_fraction=self.getBaggingFraction(),
            bagging_freq=self.getBaggingFreq(),
            boosting_type=self.getBoostingType(),
            boost_from_average=self.getBoostFromAverage(),
            seed=self.getSeed(),
            bin_sample_count=self.getBinSampleCount(),
            early_stopping_round=self.getEarlyStoppingRound(),
            max_delta_step=self.getMaxDeltaStep(),
            max_bin_by_feature=tuple(self.getMaxBinByFeature() or ()),
            pos_bagging_fraction=self.getPosBaggingFraction(),
            neg_bagging_fraction=self.getNegBaggingFraction(),
            top_rate=self.getTopRate(),
            other_rate=self.getOtherRate(),
            drop_rate=self.getDropRate(),
            max_drop=self.getMaxDrop(),
            skip_drop=self.getSkipDrop(),
            uniform_drop=self.getUniformDrop(),
            bagging_seed=self.getBaggingSeed(),
            metric=self.getMetric(),
            is_provide_training_metric=self.getIsProvideTrainingMetric(),
            eval_freq=self.getEvalFreq(),
            improvement_tolerance=self.getImprovementTolerance(),
            xgboost_dart_mode=self.getXgboostDartMode(),
            sparse_max_bin=self.getMaxBinSparse(),
            cat_smooth=self.getCatSmooth(),
            max_cat_threshold=self.getMaxCatThreshold(),
            fobj=self.get("fobj"),
        )
