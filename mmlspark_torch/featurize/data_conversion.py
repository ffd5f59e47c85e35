"""Column type conversion.

Reference ``featurize/DataConversion.scala``: cast a set of columns to a
target type (boolean/byte/short/integer/long/float/double/string/date).

The port of ``mmlspark_tpu/featurize/data_conversion.py``'s eager path:
numeric targets are exact numpy dtype casts on the host (float64 stays
float64), string/date targets are host conversions (``date`` imports pandas
when it runs).
"""

from __future__ import annotations

import numpy as np

from ..core import Transformer, Param, TypeConverters as TC
from ..core.contracts import HasInputCols
from ..core.dataframe import object_column

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
