"""Auto-featurization: heterogeneous columns → one dense feature vector.

Reference ``featurize/Featurize.scala:36-121`` — the implicit featurization
under ``TrainClassifier``/``TrainRegressor``: numeric columns pass through,
missing values are imputed, string/categorical columns are one-hot encoded
(or hashed when cardinality exceeds the feature budget), vector columns are
flattened, everything is assembled into a single fixed-width float32 matrix.

The port of ``mmlspark_tpu/featurize/featurize.py``. Numeric imputation,
vector flattening and the final concatenation run in torch on the stage's
``device``; string one-hot and hash encodings are host work in
``_hostenc``. Every value lands on the JAX package's float32 lattice: host
columns are cast as its ``jnp.asarray`` casts them (``device_lattice``)
before they reach the device. A fitted model whose plan is numeric/vector
only carries a traced form (the same casts, on device tensors) and fuses
into segments of ``core/compile.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.contracts import HasDevice, HasInputCols, HasOutputCol
from ..core.compile import tensor_lattice
from ..core.dataframe import device_lattice, readable_dtype, to_host
from ._hostenc import encode_hash, encode_onehot, stable_hash

_ = stable_hash  # re-exported for callers that hashed through this module

# encodings a fused segment can run: no host string work
_TRACEABLE_KINDS = ("numeric", "vector")


def _numeric_means(cols: list[np.ndarray], dev) -> list[float]:
    """NaN-skipping means of float32 host columns, on ``dev``: one [n, k]
    transfer, sums in float64, rounded to float32 once. The JAX package's
    fill is a float32 sum in XLA's order; the two differ by its rounding
    only, and the card's and the CPU's agree. A sum beyond float32's
    finite range gives the float32 sum's ``inf`` (or ``-inf``), as the
    JAX package's ``valid.mean()`` does."""
    if not cols:
        return []
    x = torch.as_tensor(np.stack(cols, axis=1)).to(dev)
    valid = ~torch.isnan(x)
    sums = torch.where(valid, x, 0).sum(0, dtype=torch.float64)
    counts = valid.sum(0)
    means = torch.where(counts > 0, sums / counts.clamp(min=1), 0)
    f32_sums = sums.to(torch.float32).to(torch.float64)
    means = torch.where(torch.isinf(f32_sums), f32_sums, means)
    return [float(np.float32(m)) for m in to_host(means)]


class Featurize(Estimator, HasInputCols, HasOutputCol, HasDevice):
    numFeatures = Param("numFeatures",
                        "hash-space size for high-cardinality categoricals",
                        TC.toInt, default=262144)
    oneHotEncodeCategoricals = Param("oneHotEncodeCategoricals",
                                     "one-hot (true) or hash categoricals",
                                     TC.toBoolean, default=True)
    maxOneHotCardinality = Param(
        "maxOneHotCardinality",
        "categoricals above this cardinality are hashed instead of one-hot",
        TC.toInt, default=64)
    imputeMissing = Param("imputeMissing", "mean-impute numeric NaNs",
                          TC.toBoolean, default=True)

    outputCol = Param("outputCol", "assembled features column", TC.toString,
                      default="features")

    def _fit(self, df):
        dev = self._device()
        plan = []  # list of per-column encoding specs
        to_mean: list[tuple[dict, np.ndarray]] = []
        for col in self.getInputCols():
            arr = df[col]
            if arr.ndim > 1:  # vector column: flatten passthrough
                plan.append({"col": col, "kind": "vector",
                             "width": int(arr.shape[1])})
            elif arr.dtype == object:
                sample = next((v for v in arr if v is not None), None)
                # vector cells are ordered sequences (bytes, array, list,
                # tuple) — dict/set cells have __len__ too but belong on
                # the categorical path below
                if isinstance(sample, bytes) or (
                        sample is not None
                        and not isinstance(sample, (str, dict, set,
                                                    frozenset))
                        and hasattr(sample, "__len__")):
                    width = int(to_host(sample).ravel().size)
                    plan.append({"col": col, "kind": "vector",
                                 "width": width})
                    continue
                levels = sorted({str(v) for v in arr if v is not None})
                if (self.getOneHotEncodeCategoricals()
                        and len(levels) <= self.getMaxOneHotCardinality()):
                    plan.append({"col": col, "kind": "onehot",
                                 "levels": levels, "width": len(levels)})
                else:
                    width = min(self.getNumFeatures(), 1024)
                    plan.append({"col": col, "kind": "hash", "width": width})
            elif arr.dtype.kind == "b":
                plan.append({"col": col, "kind": "numeric", "width": 1,
                             "fill": 0.0})
            elif arr.dtype.kind in "iuf":
                spec = {"col": col, "kind": "numeric", "width": 1,
                        "fill": 0.0}
                plan.append(spec)
                if self.getImputeMissing():
                    to_mean.append((spec, np.asarray(arr, np.float32)))
            elif arr.dtype.kind == "M":  # datetime → epoch seconds
                plan.append({"col": col, "kind": "datetime", "width": 1})
            else:
                raise TypeError(f"cannot featurize column {col!r} "
                                f"of dtype {arr.dtype}")
        means = _numeric_means([a for _, a in to_mean], dev)
        for (spec, _), mean in zip(to_mean, means):
            spec["fill"] = mean
        model = FeaturizeModel().setEncodingPlan(plan)
        self._copy_params_to(model)
        return model


class FeaturizeModel(Model, HasInputCols, HasOutputCol, HasDevice):
    encodingPlan = Param("encodingPlan", "per-column encoding specs")
    outputCol = Param("outputCol", "assembled features column", TC.toString,
                      default="features")

    #: seconds the last transform spent in the host string encodings
    #: (one-hot and hash), the host's share of its time (not saved)
    host_encode_seconds: float | None = None

    @property
    def feature_dim(self) -> int:
        return sum(spec["width"] for spec in self.getEncodingPlan())

    def slot_names(self) -> list[str]:
        """Per-slot names of the assembled vector (reference: ML attribute
        names on the assembled column) — lets downstream consumers resolve
        names to slots (e.g. ``categoricalSlotNames``)."""
        names: list[str] = []
        for spec in self.getEncodingPlan():
            col, w = spec["col"], spec["width"]
            if spec["kind"] == "onehot":
                names.extend(f"{col}_{lvl}" for lvl in spec["levels"])
            elif w == 1:
                names.append(col)
            else:
                names.extend(f"{col}_{i}" for i in range(w))
        return names

    @staticmethod
    def _vector_block(arr: np.ndarray, n: int, spec: dict) -> np.ndarray:
        """A vector column → host [n, width] float32."""
        if arr.dtype == object:
            mat = np.stack([np.asarray(to_host(v), np.float32).ravel()
                            for v in arr]) if n else \
                np.zeros((0, spec["width"]), np.float32)
        else:
            mat = device_lattice(arr).astype(np.float32).reshape(n, -1)
        if mat.shape[1] != spec["width"]:
            raise ValueError(
                f"vector column {spec['col']!r} width {mat.shape[1]} "
                f"!= fitted width {spec['width']}")
        return mat

    def _transform(self, df):
        dev = self._device()
        n = df.num_rows
        blocks = []
        host_s = 0.0
        for spec in self.getEncodingPlan():
            arr = df[spec["col"]]
            kind = spec["kind"]
            if kind in _TRACEABLE_KINDS:
                # the traced form's block, on the host column as the JAX
                # package's jnp.asarray would give it
                host = device_lattice(arr).astype(np.float32) \
                    if kind == "numeric" else \
                    self._vector_block(arr, n, spec)
                blocks.append(self._device_block(
                    spec, torch.as_tensor(host).to(dev)))
                continue
            if kind == "onehot":
                t0 = time.perf_counter()
                host = encode_onehot(arr, spec["levels"], spec["width"])
                host_s += time.perf_counter() - t0
            elif kind == "hash":
                t0 = time.perf_counter()
                host = encode_hash(arr, spec["width"])
                host_s += time.perf_counter() - t0
            elif kind == "datetime":
                secs = arr.astype("datetime64[s]").astype("float64")
                host = secs.astype(np.float32).reshape(n, 1)
            else:  # pragma: no cover
                raise ValueError(f"unknown encoding kind {kind!r}")
            blocks.append(torch.as_tensor(host).to(dev))
        features = torch.cat(blocks, dim=1) if blocks else \
            torch.zeros((n, 0), dtype=torch.float32, device=dev)
        self.host_encode_seconds = host_s
        out = df.with_column(self.getOutputCol(), features)
        return self._attach_meta(out)

    def _attach_meta(self, df):
        from ..core import ColumnMetadata
        return ColumnMetadata.attach(df, self.getOutputCol(),
                                     {"slot_names": self.slot_names()})

    def _trace_ok(self, schema, n_rows):
        plan = self.getEncodingPlan() or []
        return bool(plan) and all(
            spec["kind"] in _TRACEABLE_KINDS
            and spec["col"] in schema
            and readable_dtype(schema[spec["col"]][0])
            for spec in plan)

    @staticmethod
    def _device_block(spec: dict, x):
        """One numeric or vector column's block of the features, on a
        device tensor: the eager transform's and the traced form's."""
        x = tensor_lattice(x).to(torch.float32)
        if spec["kind"] == "numeric":
            vals = x.reshape(-1, 1)
            return torch.where(torch.isnan(vals),
                               float(np.float32(spec["fill"])), vals)
        mat = x.reshape(x.shape[0], -1)
        if mat.shape[1] != spec["width"]:
            raise ValueError(
                f"vector column {spec['col']!r} width {mat.shape[1]} "
                f"!= fitted width {spec['width']}")
        return mat

    def _trace(self, cols):
        out = dict(cols)
        out[self.getOutputCol()] = torch.cat(
            [self._device_block(spec, cols[spec["col"]])
             for spec in self.getEncodingPlan()], dim=1)
        return out

    def _post_host(self, df):
        # fused segments rebuild the frame without column metadata;
        # re-attach the slot names the traced output carries implicitly
        return self._attach_meta(df)
