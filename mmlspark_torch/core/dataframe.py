"""Columnar DataFrame abstraction — the stand-in for Spark DataFrames.

The reference framework operates on Spark DataFrames flowing through
Estimator/Transformer pipeline stages (see reference
``core/schema/SparkBindings.scala:13-39`` for its typed row views). A
row-oriented JVM DataFrame is the wrong shape for a GPU: kernels want large,
fixed-shape, contiguous arrays. So this DataFrame is columnar from the start:

- every column is a NumPy array on the host (1-D for scalars, 2-D for
  fixed-width vector columns, object dtype for strings/bytes/ragged values);
- numeric columns become torch tensors on a chosen device via
  ``DataFrame.tensor(col, device=...)``;
- "partitions" — Spark's unit of data parallelism — are a lightweight metadata
  concept here (``num_partitions``) used by stages that mirror the reference's
  partition semantics.

pandas is imported lazily, only by the verbs that need it (``distinct``,
``join``, ``group_by``, ``to_pandas``).
"""

from __future__ import annotations

import numpy as np
from typing import Any, Callable, Iterable, Mapping, Sequence


def _normalize_column(values: Any, n_rows: int | None = None) -> np.ndarray:
    """Normalize arbitrary user input into a canonical column array."""
    if isinstance(values, np.ndarray):
        arr = values
    elif hasattr(values, "detach") and getattr(values, "shape", None):
        # torch tensors (possibly on the GPU): materializing at the
        # DataFrame boundary is the host sync point. 0-d tensors fall
        # through to the scalar broadcast below
        arr = values.detach().cpu().numpy()
    elif hasattr(values, "__array__") and getattr(values, "shape", None):
        arr = np.asarray(values)
    elif isinstance(values, (list, tuple)):
        has_seq = any(isinstance(v, (list, tuple, np.ndarray)) for v in values)
        if has_seq:
            # Potential vector column: only keep 2-D if rectangular & numeric.
            try:
                arr = np.asarray(values)
                if arr.dtype == object or arr.ndim == 1:
                    raise ValueError("ragged")
            except ValueError:
                arr = np.empty(len(values), dtype=object)
                arr[:] = [np.asarray(v) if isinstance(v, (list, tuple)) else v
                          for v in values]
        else:
            try:
                arr = np.asarray(values)
            except ValueError:
                arr = np.empty(len(values), dtype=object)
                arr[:] = list(values)
            if arr.dtype.kind == "U":
                arr = arr.astype(object)
    else:
        # scalar broadcast
        if n_rows is None:
            raise ValueError("cannot broadcast scalar column without row count")
        if isinstance(values, str) or values is None:
            arr = np.full(n_rows, values, dtype=object)
        else:
            arr = np.full(n_rows, values)
    if arr.dtype.kind == "U":
        arr = arr.astype(object)
    if n_rows is not None and arr.ndim == 0:
        arr = np.full(n_rows, arr[()])
    if n_rows is not None and arr.shape[0] != n_rows:
        raise ValueError(
            f"column length {arr.shape[0]} != DataFrame length {n_rows}")
    return arr


# ---------------------------------------------------------- host boundary
# The one place stage code materializes device values and builds object
# (string, ragged) columns; the port's copy of the JAX package's helpers
# (``mmlspark_tpu/core/dataframe.py:85-172``). Stages compute on their
# device and hand results back here as host arrays.

def jittable_dtype(dtype) -> bool:
    """Numeric or bool dtype: a column that can go to the device as one
    tensor. Object (string/ragged) and datetime columns stay on the host."""
    return getattr(dtype, "kind", "") in "biuf"


def readable_dtype(dtype) -> bool:
    """Can a traced form (``core/compile.py``) compute on the VALUES of a
    column of this dtype? Numeric and bool, less the unsigned types wider
    than a byte. torch has few operations on uint16/uint32/uint64, so a
    fused segment carries such a column as the bits of the signed type of
    its width: exact for a column passed through, but a traced form
    reading one would see another type than the eager transform does, so
    it stays eager."""
    dtype = np.dtype(dtype)
    return jittable_dtype(dtype) and \
        not (dtype.kind == "u" and dtype.itemsize > 1)


def to_host(values: Any) -> np.ndarray:
    """Materialize ``values`` on the host as numpy: a torch tensor on any
    device is copied back (the device→host sync); numpy is free."""
    if hasattr(values, "detach") and hasattr(values, "cpu"):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def to_host_list(values: Any) -> list:
    """Materialize as a plain Python list (param storage, level lists)."""
    return to_host(values).tolist()


def object_column(cells: Iterable) -> np.ndarray:
    """Build a 1-D object column from arbitrary per-row cells without
    numpy guessing at a rectangular layout (lists of arrays must stay
    one-cell-per-row)."""
    cells = list(cells)
    arr = np.empty(len(cells), dtype=object)
    arr[:] = cells
    return arr


def repeat_rows(values: np.ndarray, lengths: Iterable[int]) -> np.ndarray:
    """Repeat each row of ``values`` by the matching length (the
    FlattenBatch/Explode scalar-broadcast path)."""
    return np.repeat(values, np.asarray(list(lengths)), axis=0)


def unique_host(values, return_counts: bool = False,
                drop_nan: bool = False):
    """EXACT distinct values of a host column — the fit-time helper.
    Fitted params (category levels, class-weight keys) must hold the exact
    values ``transform`` will later look up; a float32 device round trip
    would turn float64 0.1 into 0.10000000149… and the fitted model would
    miss the very values it was fit on."""
    arr = to_host(values)
    if return_counts:
        vals, cnts = np.unique(arr, return_counts=True)
        if drop_nan and vals.dtype.kind == "f":
            keep = ~np.isnan(vals)
            vals, cnts = vals[keep], cnts[keep]
        return vals, cnts
    vals = np.unique(arr)
    if drop_nan and vals.dtype.kind == "f":
        vals = vals[~np.isnan(vals)]
    return vals


def argsort_host(values) -> np.ndarray:
    """EXACT stable argsort on host (epoch-millisecond int64 timestamps
    sort exactly)."""
    return np.argsort(to_host(values), kind="stable")


def concat_host(parts) -> np.ndarray:
    """EXACT concatenation of host arrays along axis 0, in their own
    dtype (int64 epoch millis and float64 stay as they are)."""
    return np.concatenate([to_host(p) for p in parts], axis=0)


def f32_exact(value) -> bool:
    """True if ``value`` survives a float32 round trip exactly (ints
    >= 2**24 and float64 dust do not)."""
    v = float(value)
    return float(np.float32(v)) == v


def quantile_host(values, q) -> float:
    """EXACT quantile of a host column in its own dtype (summary
    statistics are reporting output: float64 stays float64)."""
    return float(np.quantile(to_host(values), q))


def device_lattice(arr: np.ndarray) -> np.ndarray:
    """The dtype the JAX package's ``jnp.asarray`` gives a host column
    with 64-bit types off: int64 → int32 and uint64 → uint32 (wrapping,
    as numpy's ``astype`` does), float64 → float32 (round to nearest).
    Stages that mirror an implicit ``jnp.asarray(column)`` go through this
    before the column becomes a tensor, so the port sees the same values."""
    kind, size = arr.dtype.kind, arr.dtype.itemsize
    if kind == "i" and size == 8:
        return arr.astype(np.int32)
    if kind == "u" and size == 8:
        return arr.astype(np.uint32)
    if kind == "f" and size == 8:
        return arr.astype(np.float32)
    return arr


class Row(dict):
    """A materialized row: dict with attribute access (Spark Row analogue)."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(item) from e


class DataFrame:
    """Immutable columnar table. All mutating verbs return a new DataFrame."""

    def __init__(self, data: Mapping[str, Any] | None = None,
                 num_partitions: int = 1):
        data = dict(data or {})
        n: int | None = None
        for v in data.values():
            if isinstance(v, (np.ndarray, list, tuple)):
                n = len(v)
                break
        self._data: dict[str, np.ndarray] = {
            k: _normalize_column(v, n) for k, v in data.items()
        }
        if self._data:
            lengths = {k: v.shape[0] for k, v in self._data.items()}
            if len(set(lengths.values())) > 1:
                raise ValueError(f"ragged column lengths: {lengths}")
        self.num_partitions = max(1, int(num_partitions))

    # ------------------------------------------------------------------ basics
    @property
    def columns(self) -> list[str]:
        return list(self._data.keys())

    @property
    def num_rows(self) -> int:
        if not self._data:
            return 0
        return next(iter(self._data.values())).shape[0]

    def count(self) -> int:
        return self.num_rows

    def __len__(self) -> int:
        return self.num_rows

    def __contains__(self, col: str) -> bool:
        return col in self._data

    def __getitem__(self, col: str) -> np.ndarray:
        if col not in self._data:
            raise KeyError(f"column {col!r} not in {self.columns}")
        return self._data[col]

    def column(self, col: str) -> np.ndarray:
        return self[col]

    def tensor(self, col: str, *, device, dtype=None):
        """Column as a torch tensor on ``device`` (the port's counterpart
        of the JAX package's ``DataFrame.jnp``)."""
        import torch
        arr = self[col]
        if arr.dtype == object:
            arr = np.stack([np.asarray(v) for v in arr])
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                               device=device)

    @property
    def schema(self) -> dict[str, tuple]:
        """{name: (dtype, trailing_shape)} — trailing shape () for scalars."""
        return {k: (v.dtype, v.shape[1:]) for k, v in self._data.items()}

    def dtypes(self) -> dict[str, np.dtype]:
        return {k: v.dtype for k, v in self._data.items()}

    # ------------------------------------------------------------- projection
    def select(self, *cols: str) -> "DataFrame":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        missing = [c for c in cols if c not in self._data]
        if missing:
            raise KeyError(f"columns {missing} not in {self.columns}")
        return self._with_data({c: self._data[c] for c in cols})

    def drop(self, *cols: str) -> "DataFrame":
        if len(cols) == 1 and isinstance(cols[0], (list, tuple)):
            cols = tuple(cols[0])
        return self._with_data(
            {k: v for k, v in self._data.items() if k not in set(cols)})

    def with_column(self, name: str, values: Any) -> "DataFrame":
        if callable(values) and not isinstance(values, np.ndarray):
            values = values(self)
        replacing = name in self._data
        data = dict(self._data)
        data[name] = _normalize_column(
            values, self.num_rows if self._data else None)
        out = self._with_data(data)
        if replacing:
            # replaced values invalidate the column's metadata (e.g.
            # slot_names describing a rebuilt features matrix)
            from .bindings import ColumnMetadata
            ColumnMetadata.invalidate(out, name)
        return out

    withColumn = with_column

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        data = {}
        for k, v in self._data.items():
            data[new if k == old else k] = v
        return self._with_data(data)

    withColumnRenamed = with_column_renamed

    # -------------------------------------------------------------- selection
    def filter(self, cond: Any) -> "DataFrame":
        if callable(cond):
            cond = cond(self)
        mask = np.asarray(cond, dtype=bool)
        return self._with_data({k: v[mask] for k, v in self._data.items()})

    where = filter

    def limit(self, n: int) -> "DataFrame":
        return self._with_data({k: v[:n] for k, v in self._data.items()})

    def head(self, n: int = 5) -> list[Row]:
        return self.limit(n).collect()

    def take(self, indices) -> "DataFrame":
        idx = np.asarray(indices)
        if idx.dtype.kind not in "iub":
            # an empty Python list arrives float64; row indices are
            # integral by contract either way
            idx = idx.astype(np.int64)
        return self._with_data({k: v[idx] for k, v in self._data.items()})

    def sample(self, fraction: float, seed: int = 0,
               with_replacement: bool = False) -> "DataFrame":
        rng = np.random.default_rng(seed)
        n = self.num_rows
        if with_replacement:
            idx = rng.integers(0, n, size=int(round(n * fraction)))
        else:
            idx = np.flatnonzero(rng.random(n) < fraction)
        return self.take(idx)

    def distinct(self) -> "DataFrame":
        import pandas as pd
        keys = {}
        for k, v in self._data.items():
            if v.ndim > 1:
                keys[k] = [v[i].tobytes() for i in range(v.shape[0])]
            elif v.dtype == object:
                keys[k] = [x.tobytes() if isinstance(x, np.ndarray) else x
                           for x in v]
            else:
                keys[k] = v
        idx = pd.DataFrame(keys).drop_duplicates().index.to_numpy()
        return self.take(idx)

    def sort(self, *cols: str, ascending: bool = True) -> "DataFrame":
        if not cols:
            return self
        keys = [self._sort_key(self._data[c]) for c in reversed(cols)]
        order = np.lexsort(keys)
        if not ascending:
            order = order[::-1]
        return self.take(order)

    orderBy = sort

    @staticmethod
    def _sort_key(arr: np.ndarray) -> np.ndarray:
        if arr.dtype == object:
            try:
                # Numeric-valued object column (e.g. None-padded from_rows):
                # sort numerically, Nones last.
                return np.asarray(
                    [np.inf if x is None else float(x) for x in arr])
            except (TypeError, ValueError):
                return np.asarray([str(x) for x in arr])
        return arr

    def random_split(self, weights: Sequence[float],
                     seed: int = 0) -> list["DataFrame"]:
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        n = self.num_rows
        assignment = rng.choice(len(w), size=n, p=w)
        return [self.take(np.flatnonzero(assignment == i))
                for i in range(len(w))]

    randomSplit = random_split

    # ------------------------------------------------------------ combination
    def union(self, other: "DataFrame") -> "DataFrame":
        if set(self.columns) != set(other.columns):
            raise ValueError(
                f"union schema mismatch: {self.columns} vs {other.columns}")
        data = {}
        for k in self.columns:
            a, b = self._data[k], other._data[k]
            if a.dtype == object or b.dtype == object:
                out = np.empty(len(a) + len(b), dtype=object)
                # Per-row assignment so a 2-D numeric side becomes row cells.
                out[:len(a)] = [a[i] for i in range(len(a))] \
                    if a.ndim > 1 else a
                out[len(a):] = [b[i] for i in range(len(b))] \
                    if b.ndim > 1 else b
                data[k] = out
            else:
                data[k] = np.concatenate([a, b])
        return self._with_data(data)

    @staticmethod
    def concat(dfs: Iterable["DataFrame"]) -> "DataFrame":
        dfs = list(dfs)
        if not dfs:
            return DataFrame()
        out = dfs[0]
        for d in dfs[1:]:
            out = out.union(d)
        return out

    def join(self, other: "DataFrame", on: str | Sequence[str],
             how: str = "inner") -> "DataFrame":
        left = self.to_pandas()
        right = other.to_pandas()
        merged = left.merge(right, on=on, how=how)
        return DataFrame.from_pandas(merged, num_partitions=self.num_partitions)

    def group_by(self, *cols: str):
        return GroupedData(self, list(cols))

    groupBy = group_by

    # ----------------------------------------------------------- partitioning
    def repartition(self, n: int) -> "DataFrame":
        out = self._with_data(dict(self._data))
        out.num_partitions = max(1, int(n))
        return out

    def coalesce(self, n: int) -> "DataFrame":
        return self.repartition(min(self.num_partitions, n))

    def partition_bounds(self) -> list[tuple[int, int]]:
        """Row ranges of each logical partition (contiguous block layout)."""
        n, p = self.num_rows, self.num_partitions
        sizes = [n // p + (1 if i < n % p else 0) for i in range(p)]
        bounds, start = [], 0
        for s in sizes:
            bounds.append((start, start + s))
            start += s
        return bounds

    def partitions(self) -> list["DataFrame"]:
        return [self.take(np.arange(a, b)) for a, b in self.partition_bounds()]

    def map_partitions(self, fn: Callable[["DataFrame"], "DataFrame"]) -> "DataFrame":
        parts = [fn(p) for p in self.partitions()]
        out = DataFrame.concat(
            [p for p in parts if p is not None and p.columns])
        out.num_partitions = self.num_partitions
        return out

    def cache(self) -> "DataFrame":
        return self  # data is already materialized host-side

    # ------------------------------------------------------------------- I/O
    def collect(self) -> list[Row]:
        cols = self.columns
        out = []
        for i in range(self.num_rows):
            out.append(Row({c: self._item(self._data[c], i) for c in cols}))
        return out

    @staticmethod
    def _item(arr: np.ndarray, i: int):
        v = arr[i]
        if isinstance(v, np.generic):
            return v.item()
        return v

    def to_pandas(self):
        import pandas as pd
        data = {}
        for k, v in self._data.items():
            if v.ndim > 1:
                col = np.empty(v.shape[0], dtype=object)
                col[:] = [v[i] for i in range(v.shape[0])]
                data[k] = col
            else:
                data[k] = v
        return pd.DataFrame(data)

    toPandas = to_pandas

    @staticmethod
    def from_pandas(pdf, num_partitions: int = 1) -> "DataFrame":
        data = {}
        for c in pdf.columns:
            col = pdf[c].to_numpy()
            if col.dtype == object and len(col) and isinstance(col[0], np.ndarray):
                try:
                    col = np.stack(col)
                except ValueError:
                    pass
            data[str(c)] = col
        return DataFrame(data, num_partitions=num_partitions)

    def to_arrow(self):
        """DataFrame → Arrow Table (see :mod:`.arrow`; imports pyarrow)."""
        from .arrow import columns_to_table
        return columns_to_table(self)

    toArrow = to_arrow

    @staticmethod
    def from_arrow(table, num_partitions: int = 1) -> "DataFrame":
        """Arrow Table / RecordBatch → DataFrame (dictionary arrays →
        categorical metadata)."""
        from .arrow import from_arrow
        return from_arrow(table, num_partitions=num_partitions)

    @staticmethod
    def from_arrow_batches(batches, num_partitions: int = 1) -> "DataFrame":
        """An iterable of Arrow RecordBatches (or a RecordBatchReader) →
        one DataFrame."""
        from .arrow import from_arrow_batches
        return from_arrow_batches(batches, num_partitions=num_partitions)

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]],
                  num_partitions: int = 1) -> "DataFrame":
        if not rows:
            return DataFrame()
        cols: list[str] = []
        for r in rows:
            for k in r.keys():
                if k not in cols:
                    cols.append(k)
        return DataFrame({c: [r.get(c) for r in rows] for c in cols},
                         num_partitions=num_partitions)

    def _with_data(self, data: dict[str, np.ndarray]) -> "DataFrame":
        out = DataFrame.__new__(DataFrame)
        out._data = data
        out.num_partitions = self.num_partitions
        # column metadata rides along for columns that survive the
        # derivation unchanged (ColumnMetadata.carry drops metadata for
        # replaced arrays — stale metadata must not resolve)
        from .bindings import ColumnMetadata
        ColumnMetadata.carry(self, out)
        return out

    # ------------------------------------------------------------------ repr
    def __repr__(self) -> str:
        return (f"DataFrame[{self.num_rows} rows x {len(self.columns)} cols; "
                f"{self.num_partitions} partitions]"
                + "".join(f"\n  {k}: {v.dtype}{list(v.shape[1:]) or ''}"
                          for k, v in self._data.items()))

    def show(self, n: int = 20) -> None:
        print(self.limit(n).to_pandas().to_string())


class GroupedData:
    """Minimal group-by support (host-side, pandas-backed)."""

    def __init__(self, df: DataFrame, cols: list[str]):
        self._df = df
        self._cols = cols

    def agg(self, **aggs: tuple[str, str] | str) -> DataFrame:
        """agg(out_col=("in_col", "sum"), n=("*", "count"))"""
        pdf = self._df.to_pandas()
        g = pdf.groupby(self._cols, sort=False)
        out = {}
        for name, spec in aggs.items():
            col, how = spec if isinstance(spec, tuple) else (spec, "sum")
            if how == "count":
                out[name] = g.size()
            else:
                out[name] = getattr(g[col], how)()
        import pandas as pd
        res = pd.DataFrame(out).reset_index()
        return DataFrame.from_pandas(res, num_partitions=self._df.num_partitions)

    def count(self) -> DataFrame:
        return self.agg(count=("*", "count"))
