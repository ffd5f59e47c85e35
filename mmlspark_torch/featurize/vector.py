"""Vector assembly and one-hot encoding stages.

Reference: the SparkML ``VectorAssembler``/``OneHotEncoder`` surface the
ecosystem leans on (tested at ``core/schema/VerifyFastVectorAssembler.scala``
and ``core/ml/OneHotEncoderSpec.scala``; ``Featurize`` composes the same
operations internally, ``featurize/Featurize.scala:36``). Standalone stages
so user pipelines can assemble/encode without the full auto-featurizer.

The port of ``mmlspark_tpu/featurize/vector.py``'s eager paths: the
concatenation, the NaN scan and the one-hot comparison run in torch on the
stage's ``device``; columns are cast to float32 (and category indices to
the JAX package's 32-bit lattice) on the host first. Inside a fused segment
the assembler (``handleInvalid="keep"``) and the encoder model
(``handleInvalid="keep"``) run their traced forms on the device tensors,
with the same casts: "error" must raise on bad data and "skip" changes
the row count with the data, so neither has a static traced form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Estimator, Model, Transformer, Param, \
    TypeConverters as TC
from ..core.compile import run_traced
from ..core.contracts import (HasDevice, HasInputCol, HasInputCols,
                              HasOutputCol)
from ..core.dataframe import device_lattice, readable_dtype, to_host


def _matrixify(x, n: int):
    """[n] or [n, ...] → [n, w] (the traced-path reshape; no host)."""
    if x.ndim == 1:
        return x.reshape(n, 1)
    return x.reshape(n, -1)


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
    return _matrixify(np.asarray(arr, np.float32), n)


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
        mode = self.get("handleInvalid")
        if mode not in ("error", "keep", "skip"):
            raise ValueError(
                f"handleInvalid={mode!r} is not one of error|keep|skip")
        n, ics, oc = df.num_rows, self.getInputCols(), self.getOutputCol()
        # the assembly is the traced form's; error and skip act on its
        # result on the host
        mat = run_traced(self, {c: _as_matrix(df[c], n, c) for c in ics},
                         self._device())[oc] if ics else \
            np.zeros((n, 0), np.float32)
        bad = np.isnan(mat).any(axis=1)
        n_bad = int(bad.sum())
        if n_bad:
            if mode == "error":
                raise ValueError(
                    f"{n_bad} rows contain NaN; set "
                    "handleInvalid='keep' or 'skip'")
            if mode == "skip":
                df = df.take(np.flatnonzero(~bad))
                mat = mat[~bad]
        return df.with_column(oc, mat)

    def _trace_ok(self, schema, n_rows):
        # "skip" drops rows (data-dependent length); "error" must raise
        # on NaN — neither has a static traced form
        if self.get("handleInvalid") != "keep":
            return False
        return all(c in schema and readable_dtype(schema[c][0])
                   and len(schema[c][1]) <= 1
                   for c in self.getInputCols())

    def _trace(self, cols):
        first = cols[self.getInputCols()[0]] if self.getInputCols() \
            else next(iter(cols.values()))
        n = first.shape[0]
        blocks = [_matrixify(cols[c].to(torch.float32), n)
                  for c in self.getInputCols()]
        out = dict(cols)
        out[self.getOutputCol()] = torch.cat(blocks, dim=1) if blocks \
            else torch.zeros((n, 0), dtype=torch.float32,
                             device=first.device)
        return out


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
        size, _ = self._widths()
        ic, oc = self.getInputCol(), self.getOutputCol()
        idx = device_lattice(to_host(df[ic]).astype(np.int64))
        if self.get("handleInvalid") != "keep":
            n_oob = int(((idx < 0) | (idx >= size)).sum())
            if n_oob:
                raise ValueError(
                    f"{n_oob} indices outside the fitted "
                    f"[0, {size}) range; set handleInvalid='keep'")
        # the encoding is the traced form's (out-of-range indices, only
        # left under "keep", go to the catch-all slot)
        host = run_traced(self, {ic: idx}, self._device())
        return df.with_column(oc, host[oc])

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        # "error" must raise on out-of-range — host-bound by contract
        return ic in schema and readable_dtype(schema[ic][0]) \
            and self.get("handleInvalid") == "keep" \
            and len(schema[ic][1]) == 0

    def _trace(self, cols):
        size, out_width = self._widths()
        x = cols[self.getInputCol()]
        # the eager path's casts: int64 (truncating a float), then the
        # 32-bit lattice
        idx = x.to(torch.int64).to(torch.int32)
        idx = torch.where((idx < 0) | (idx >= size), size, idx)
        slots = torch.arange(out_width, dtype=idx.dtype, device=x.device)
        out = dict(cols)
        out[self.getOutputCol()] = (idx[:, None] == slots[None, :]).float()
        return out
