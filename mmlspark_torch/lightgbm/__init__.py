from .booster import Booster
from .estimators import (LightGBMClassificationModel, LightGBMClassifier,
                         LightGBMRanker, LightGBMRankerModel,
                         LightGBMRegressionModel, LightGBMRegressor)
from .hist import hist_cuda, hist_torch

__all__ = ["Booster", "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRanker", "LightGBMRankerModel",
           "LightGBMRegressor", "LightGBMRegressionModel",
           "hist_cuda", "hist_torch"]
