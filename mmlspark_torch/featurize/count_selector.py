"""Feature-slot selection by nonzero count.

Reference ``featurize/CountSelector.scala``: drop feature-vector slots that
are zero for every row (dead features inflate histogram work on device).

The port of ``mmlspark_tpu/featurize/count_selector.py``: the fit's
any-nonzero reduction and the model's gather over the kept slots run in
torch on the stage's ``device``.
"""

from __future__ import annotations

import torch

from ..core import Estimator, Model, Param
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..core.dataframe import to_host_list
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
        dev = self._device()
        x = torch.as_tensor(as_2d_features(df, self.getInputCol())).to(dev)
        idx = torch.as_tensor(self.getIndices(), dtype=torch.int64,
                              device=dev)
        return df.with_column(self.getOutputCol(), x[:, idx])
