from .booster import Booster
from .estimators import LightGBMClassificationModel, LightGBMClassifier
from .hist import hist_cuda, hist_torch

__all__ = ["Booster", "LightGBMClassifier", "LightGBMClassificationModel",
           "hist_cuda", "hist_torch"]
