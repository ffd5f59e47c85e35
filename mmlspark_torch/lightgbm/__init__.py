from .booster import Booster
from .estimators import (LightGBMClassificationModel, LightGBMClassifier,
                         LightGBMRegressionModel, LightGBMRegressor)
from .hist import hist_cuda, hist_torch

__all__ = ["Booster", "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel",
           "hist_cuda", "hist_torch"]
