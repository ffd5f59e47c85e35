"""Missing-value imputation.

Reference ``featurize/CleanMissingData.scala``: per-column cleaning with
mean / median / custom replacement, fitted as a model so the replacement
values learned on train data apply to test data.

The port of ``mmlspark_tpu/featurize/clean_missing_data.py``: the fills are
fitted and applied in torch on the stage's ``device``, on float32 columns
as in the JAX package. Median is the mean of the two middle values for an
even count, as ``jnp.median`` gives it (``torch.median`` would return the
lower one).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.contracts import HasDevice, HasInputCols, HasOutputCols
from .featurize import _numeric_means

MEAN, MEDIAN, CUSTOM = "Mean", "Median", "Custom"


def _median(x: torch.Tensor) -> float:
    """NaN-skipping median of a float32 tensor: the middle value, or the
    float32 mean of the two middle values."""
    valid = x[~torch.isnan(x)]
    n = valid.numel()
    if not n:
        return 0.0
    s = torch.sort(valid).values
    mid = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) * 0.5
    return float(mid)


class CleanMissingData(Estimator, HasInputCols, HasOutputCols, HasDevice):
    cleaningMode = Param("cleaningMode", "Mean | Median | Custom",
                         TC.toString, default=MEAN)
    customValue = Param("customValue", "replacement for Custom mode",
                        TC.toFloat)

    def _fit(self, df):
        mode = self.getCleaningMode()
        if mode not in (MEAN, MEDIAN, CUSTOM):
            raise ValueError(f"unknown cleaningMode {mode!r}")
        dev = self._device()
        cols = self.getInputCols()
        if mode == CUSTOM:
            fills = {col: self.getCustomValue() for col in cols}
        elif mode == MEAN:
            host = [np.asarray(df[col], np.float32) for col in cols]
            fills = dict(zip(cols, _numeric_means(host, dev)))
        else:
            fills = {col: _median(torch.as_tensor(
                np.asarray(df[col], np.float32)).to(dev)) for col in cols}
        model = CleanMissingDataModel().setFillValues(fills)
        self._copy_params_to(model)
        return model


class CleanMissingDataModel(Model, HasInputCols, HasOutputCols, HasDevice):
    fillValues = Param("fillValues", "column → replacement value", TC.toDict)

    def _out_cols(self):
        return self.get("outputCols") or self.getInputCols()

    def _transform(self, df):
        dev = self._device()
        fills = self.getFillValues()
        cur = df
        for in_col, out_col in zip(self.getInputCols(), self._out_cols()):
            arr = torch.as_tensor(np.asarray(df[in_col], np.float32)).to(dev)
            fill = torch.tensor(np.float32(fills[in_col]), device=dev)
            cur = cur.with_column(out_col,
                                  torch.where(torch.isnan(arr), fill, arr))
        return cur
