"""Categorical value indexing.

Reference ``featurize/ValueIndexer.scala`` / ``IndexToValue.scala`` +
categorical metadata (``core/schema/Categoricals.scala``): map arbitrary
category values to dense integer indices (and back), recording the level
order on the model so downstream stages (one-hot, label decoding) agree.

The port of ``mmlspark_tpu/featurize/value_indexer.py``: the fit collects
host-exact levels (``unique_host``) and the eager transform is a host dict
lookup (``:60-79`` there). Numeric level sets also index inside a fused
segment (``core/compile.py``) through a ``searchsorted`` gather on device
tensors, compared in float64 or int64 as the dict lookup compares values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.compile import device_constant
from ..core.contracts import HasInputCol, HasOutputCol
from ..core.dataframe import (object_column, readable_dtype, to_host,
                              to_host_list, unique_host)


def _numeric_levels(levels) -> bool:
    """Levels a traced lookup can take: ints and floats (no bools), the
    ints inside the 32-bit lattice the JAX package's traced table needs
    (the same veto keeps both packages' plans equal; the eager lookup
    stays exact for the rest)."""
    try:
        if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in levels):
            return False
    except TypeError:
        return False
    return all(-2 ** 31 <= v < 2 ** 31 for v in levels
               if isinstance(v, int))


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

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        # the traced form cannot raise on unseen values: it needs a
        # well-defined unknownIndex and numeric, sorted-comparable levels
        return ic in schema and readable_dtype(schema[ic][0]) \
            and self.getUnknownIndex() >= 0 \
            and _numeric_levels(self.getLevels())

    def _trace(self, cols):
        levels = list(self.getLevels())
        x = cols[self.getInputCol()]
        out = dict(cols)
        unknown = self.getUnknownIndex()
        if not levels:
            out[self.getOutputCol()] = torch.full(
                x.shape, unknown, dtype=torch.int32, device=x.device)
            return out
        # compare as the dict lookup does: by value, in float64 when
        # either side is a float, else in int64
        floating = x.is_floating_point() or \
            any(isinstance(v, float) for v in levels)
        srt = sorted(levels)
        lv = device_constant(srt, np.float64 if floating else np.int64,
                             x.device)
        xv = x.to(torch.float64 if floating else torch.int64)
        idx = torch.searchsorted(lv, xv).clamp(0, len(srt) - 1)
        hit = lv[idx] == xv
        # map the sorted position back to the DECLARED level order
        order = device_constant([levels.index(v) for v in srt], np.int64,
                                x.device)
        out[self.getOutputCol()] = torch.where(
            hit, order[idx], unknown).to(torch.int32)
        return out


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

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        levels = self.getLevels()
        return ic in schema and readable_dtype(schema[ic][0]) \
            and _numeric_levels(levels) and len(levels) > 0

    def _trace(self, cols):
        levels = list(self.getLevels())
        # the eager column's dtype: the object column cast to the first
        # level's type (int64 or float64)
        table = np.asarray(levels, dtype=object).astype(type(levels[0]))
        x = cols[self.getInputCol()]
        lv = device_constant(table, table.dtype, x.device)
        j = x.to(torch.int64)
        # negative indices count from the end, as the eager list lookup
        # does; an index past either end (the eager path raises there)
        # clamps, as the JAX package's traced gather does
        j = torch.where(j < 0, j + len(levels), j).clamp(0, len(levels) - 1)
        out = dict(cols)
        out[self.getOutputCol()] = lv[j]
        return out
