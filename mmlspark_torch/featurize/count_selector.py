"""Feature-slot selection by nonzero count.

Reference ``featurize/CountSelector.scala``: drop feature-vector slots that
are zero for every row (dead features inflate histogram work on device).

The port of ``mmlspark_tpu/featurize/count_selector.py``: the fit's
any-nonzero reduction and the model's gather over the kept slots run in
torch on the stage's ``device``; the gather is also the model's traced
form inside a fused segment.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Estimator, Model, Param
from ..core.compile import device_constant, run_traced
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..core.dataframe import readable_dtype, to_host_list
from ..core.utils import as_2d_features


class CountSelector(Estimator, HasInputCol, HasOutputCol, HasDevice):
    def _fit(self, df):
        x = torch.as_tensor(as_2d_features(df, self.getInputCol())).to(
            self._device())
        keep = to_host_list(torch.nonzero((x != 0).any(dim=0)).flatten())
        model = CountSelectorModel().setIndices([int(i) for i in keep])
        self._copy_params_to(model)
        return model


class CountSelectorModel(Model, HasInputCol, HasOutputCol, HasDevice):
    indices = Param("indices", "kept feature-slot indices")

    def _transform(self, df):
        ic, oc = self.getInputCol(), self.getOutputCol()
        host = run_traced(self, {ic: as_2d_features(df, ic)},
                          self._device())
        return df.with_column(oc, host[oc])

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        if ic not in schema:
            return False
        dtype, shape = schema[ic]
        return readable_dtype(dtype) and len(shape) == 1

    def _trace(self, cols):
        x = cols[self.getInputCol()].to(torch.float32)
        idx = device_constant(self.getIndices(), np.int64, x.device)
        out = dict(cols)
        out[self.getOutputCol()] = x[:, idx]
        return out
