"""Categorical value indexing.

Reference ``featurize/ValueIndexer.scala`` / ``IndexToValue.scala`` +
categorical metadata (``core/schema/Categoricals.scala``): map arbitrary
category values to dense integer indices (and back), recording the level
order on the model so downstream stages (one-hot, label decoding) agree.

The port of ``mmlspark_tpu/featurize/value_indexer.py``'s eager path: the
fit collects host-exact levels (``unique_host``) and the transform is a
host dict lookup (``:60-79`` there). The JAX package's fused-segment form
(a ``searchsorted`` gather) belongs to the compile slice.
"""

from __future__ import annotations

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.contracts import HasInputCol, HasOutputCol
from ..core.dataframe import (object_column, to_host, to_host_list,
                              unique_host)


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Fit: collect distinct values (sorted); transform: value → index."""

    def _fit(self, df):
        col = df[self.getInputCol()]
        if col.dtype == object:
            levels = sorted({v for v in col if v is not None},
                            key=lambda v: str(v))
        else:
            # fit-time uniqueness stays on host and EXACT: the fitted
            # levels must equal the values transform will look up
            # (unique_host's docstring has the 32-bit demotion story)
            levels = to_host_list(unique_host(col, drop_nan=True))
        model = ValueIndexerModel().setLevels(list(levels))
        self._copy_params_to(model)
        return model


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = Param("levels", "ordered category levels")
    unknownIndex = Param("unknownIndex",
                         "index assigned to unseen values (-1 = error)",
                         TC.toInt, default=-1)

    def _transform(self, df):
        levels = self.getLevels()
        lookup = {v: i for i, v in enumerate(levels)}
        col = df[self.getInputCol()]
        unknown = self.getUnknownIndex()
        out = []
        for v in col:
            if v in lookup:
                out.append(lookup[v])
            elif unknown >= 0:
                out.append(unknown)
            else:
                raise ValueError(f"unseen value {v!r} in column "
                                 f"{self.getInputCol()!r}")
        # the host lookup path: no device round trip for a dict lookup;
        # int32 is the JAX package's output dtype
        return df.with_column(self.getOutputCol(),
                              to_host(out).astype("int32"))


class IndexToValue(Model, HasInputCol, HasOutputCol):
    """Inverse mapping: index column → original values."""

    levels = Param("levels", "ordered category levels")

    def _transform(self, df):
        levels = self.getLevels()
        idx = df[self.getInputCol()].astype(int)
        values = object_column(levels[int(j)] for j in idx)
        try:
            arr = values.astype(type(levels[0])) if levels else values
        except (ValueError, TypeError):
            arr = values
        return df.with_column(self.getOutputCol(), arr)
