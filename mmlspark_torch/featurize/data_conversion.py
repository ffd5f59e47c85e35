"""Column type conversion.

Reference ``featurize/DataConversion.scala``: cast a set of columns to a
target type (boolean/byte/short/integer/long/float/double/string/date).

The port of ``mmlspark_tpu/featurize/data_conversion.py``'s eager path:
numeric targets are exact numpy dtype casts on the host (float64 stays
float64), string/date targets are host conversions (``date`` imports pandas
when it runs). Inside a fused segment a numeric target is a cast of the
device tensor to the same dtype (the JAX package's traced casts narrow
long/double to 32 bits; the port's do not).
"""

from __future__ import annotations

import numpy as np

from ..core import Transformer, Param, TypeConverters as TC
from ..core.contracts import HasInputCols
from ..core.dataframe import object_column, readable_dtype

_CONVERSIONS = {
    "boolean": np.bool_,
    "byte": np.int8,
    "short": np.int16,
    "integer": np.int32,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
    "string": object,
    "date": "datetime64[s]",
}

# targets a traced segment can produce (dtype casts on the device tensor)
_TRACEABLE_TARGETS = ("boolean", "byte", "short", "integer", "long",
                      "float", "double")


class DataConversion(Transformer, HasInputCols):
    convertTo = Param("convertTo", "target type: " + "|".join(_CONVERSIONS),
                      TC.toString)
    dateTimeFormat = Param("dateTimeFormat", "format for date parsing",
                           TC.toString, default="%Y-%m-%d %H:%M:%S")

    def _transform(self, df):
        target = self.getConvertTo()
        if target not in _CONVERSIONS:
            raise ValueError(f"unknown convertTo {target!r}; "
                             f"expected one of {sorted(_CONVERSIONS)}")
        cur = df
        for col in self.getInputCols():
            arr = df[col]
            if target == "string":
                out = object_column(None if v is None else str(v)
                                    for v in arr)
            elif target == "date":
                import pandas as pd
                out = pd.to_datetime(
                    pd.Series(list(arr)),
                    format=self.getDateTimeFormat()).to_numpy()
            else:
                if arr.dtype == object:
                    arr = arr.astype(np.float64)
                out = arr.astype(_CONVERSIONS[target])
            cur = cur.with_column(col, out)
        return cur

    def _trace_ok(self, schema, n_rows):
        return self.getConvertTo() in _TRACEABLE_TARGETS and all(
            c in schema and readable_dtype(schema[c][0])
            for c in self.getInputCols())

    def _trace(self, cols):
        import torch
        target = getattr(torch, str(np.dtype(
            _CONVERSIONS[self.getConvertTo()])))
        out = dict(cols)
        for col in self.getInputCols():
            out[col] = cols[col].to(target)
        return out
