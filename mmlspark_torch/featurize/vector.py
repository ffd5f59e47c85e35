"""Vector assembly and one-hot encoding stages.

Reference: the SparkML ``VectorAssembler``/``OneHotEncoder`` surface the
ecosystem leans on (tested at ``core/schema/VerifyFastVectorAssembler.scala``
and ``core/ml/OneHotEncoderSpec.scala``; ``Featurize`` composes the same
operations internally, ``featurize/Featurize.scala:36``). Standalone stages
so user pipelines can assemble/encode without the full auto-featurizer.

The port of ``mmlspark_tpu/featurize/vector.py``'s eager paths: the
concatenation, the NaN scan and the one-hot comparison run in torch on the
stage's ``device``; columns are cast to float32 (and category indices to
the JAX package's 32-bit lattice) on the host first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Estimator, Model, Transformer, Param, \
    TypeConverters as TC
from ..core.contracts import (HasDevice, HasInputCol, HasInputCols,
                              HasOutputCol)
from ..core.dataframe import device_lattice, to_host


def _as_matrix(arr, n: int, col: str) -> np.ndarray:
    """One column → host [n, w] float32 (scalars become w=1)."""
    if arr.dtype == object:
        try:
            return np.stack([np.asarray(to_host(v), np.float32).ravel()
                             for v in arr])
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"column {col!r} has ragged/non-numeric vector rows: "
                f"{e}") from e
    x = np.asarray(arr, np.float32)
    return x.reshape(n, 1) if x.ndim == 1 else x.reshape(n, -1)


class VectorAssembler(Transformer, HasInputCols, HasOutputCol, HasDevice):
    """Concatenate numeric scalar/vector columns into one vector column.

    ``handleInvalid``: "error" raises on NaN, "keep" propagates NaN,
    "skip" drops invalid rows (the SparkML contract).
    """

    handleInvalid = Param("handleInvalid", "error|keep|skip on NaN rows",
                          TC.toString, default="error", has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(outputCol="features")

    def _transform(self, df):
        dev = self._device()
        n = df.num_rows
        blocks = [torch.as_tensor(_as_matrix(df[c], n, c)).to(dev)
                  for c in self.getInputCols()]
        mat = torch.cat(blocks, dim=1) if blocks else \
            torch.zeros((n, 0), dtype=torch.float32, device=dev)
        bad = torch.isnan(mat).any(dim=1)
        mode = self.get("handleInvalid")
        if mode not in ("error", "keep", "skip"):
            raise ValueError(
                f"handleInvalid={mode!r} is not one of error|keep|skip")
        n_bad = int(bad.sum())
        if n_bad:
            if mode == "error":
                raise ValueError(
                    f"{n_bad} rows contain NaN; set "
                    "handleInvalid='keep' or 'skip'")
            if mode == "skip":
                keep = to_host(~bad)
                df = df.take(keep.nonzero()[0])
                mat = mat[~bad]
        return df.with_column(self.getOutputCol(), mat)


class OneHotEncoder(Estimator, HasInputCol, HasOutputCol, HasDevice):
    """Category indices → one-hot vectors (SparkML semantics:
    ``dropLast=True`` encodes the last category as the all-zeros vector,
    keeping the encoding linearly independent)."""

    dropLast = Param("dropLast", "last category encodes as all-zeros",
                     TC.toBoolean, default=True, has_default=True)
    handleInvalid = Param("handleInvalid",
                          "error|keep for out-of-range indices at "
                          "transform ('keep' adds a catch-all slot)",
                          TC.toString, default="error", has_default=True)

    def _fit(self, df):
        raw = df[self.getInputCol()]
        if raw.dtype.kind not in "iuf":
            raise TypeError("OneHotEncoder expects numeric category "
                            f"indices, got dtype {raw.dtype}")
        idx = torch.as_tensor(device_lattice(raw)).to(self._device())
        if idx.numel() and bool((idx < 0).any()):
            raise ValueError("category indices must be non-negative")
        size = int(idx.max()) + 1 if idx.numel() else 0
        model = OneHotEncoderModel().set("categorySize", size)
        self._copy_params_to(model)
        return model


class OneHotEncoderModel(Model, HasInputCol, HasOutputCol, HasDevice):
    categorySize = Param("categorySize", "number of fitted categories",
                         TC.toInt)
    dropLast = Param("dropLast", "last category encodes as all-zeros",
                     TC.toBoolean, default=True, has_default=True)
    handleInvalid = Param("handleInvalid",
                          "error|keep for out-of-range indices",
                          TC.toString, default="error", has_default=True)

    def _widths(self) -> tuple[int, int]:
        size = self.get("categorySize")
        keep_invalid = self.get("handleInvalid") == "keep"
        width = size + (1 if keep_invalid else 0)
        out_width = width - (1 if self.get("dropLast") else 0)
        return size, max(out_width, 0)

    def _transform(self, df):
        dev = self._device()
        size, out_width = self._widths()
        keep_invalid = self.get("handleInvalid") == "keep"
        idx = torch.as_tensor(device_lattice(
            to_host(df[self.getInputCol()]).astype(np.int64))).to(dev)
        oob = (idx < 0) | (idx >= size)
        n_oob = int(oob.sum())
        if n_oob:
            if not keep_invalid:
                raise ValueError(
                    f"{n_oob} indices outside the fitted "
                    f"[0, {size}) range; set handleInvalid='keep'")
            idx = torch.where(oob, size, idx)  # catch-all slot
        slots = torch.arange(out_width, dtype=idx.dtype, device=dev)
        return df.with_column(self.getOutputCol(),
                              (idx[:, None] == slots[None, :]).float())
