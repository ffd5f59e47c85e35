"""Arrow interchange — the columnar bridge to Spark/pandas/any producer.

The port's copy of ``mmlspark_tpu/core/arrow.py``, with the same mapping in
both directions:
- numeric/bool scalar columns        ↔ primitive arrays, zero-copy when
  single-chunk and null-free;
- fixed-width vector columns [n, w]  ↔ ``FixedSizeList`` arrays;
- strings/bytes/ragged lists         ↔ ``string``/``binary``/``list``
  (materialized host-side object columns);
- categorical columns                ↔ ``dictionary`` arrays: the indices
  become the column, the dictionary becomes :class:`.bindings.ColumnMetadata`
  categorical levels (field metadata under the JAX package's key, so a
  table written by either package reads in the other);
- nulls in numeric columns           → ``NaN`` (integer-with-null promotes
  to float64).

``pyarrow`` is imported only when a conversion runs; nothing on the GPU
path needs it.
"""

from __future__ import annotations

import json

import numpy as np

# the JAX package's field-metadata key: one table format for both packages
_LEVELS_KEY = b"mmlspark_tpu.categorical_levels"


def _require_pyarrow():
    try:
        import pyarrow as pa
        return pa
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "pyarrow is required for Arrow interchange "
            "(DataFrame.from_arrow/to_arrow)") from e


def _array_to_numpy(pa_mod, arr, field):
    """One Arrow array (single chunk) → (numpy column, metadata|None)."""
    pa = pa_mod
    t = arr.type
    if pa.types.is_dictionary(t):
        levels = arr.dictionary.to_pylist()
        idx = arr.indices
        if idx.null_count:
            out = idx.cast(pa.float32()).to_numpy(zero_copy_only=False)
        else:
            out = idx.to_numpy(zero_copy_only=False).astype(np.float32)
        return out, {"categorical": True, "levels": levels}
    if pa.types.is_fixed_size_list(t):
        w = t.list_size
        # .values ignores the slice window (returns the full child
        # array), so apply arr.offset ourselves — record batches from
        # to_batches()/streams are slices of one parent buffer
        values = arr.values
        if values.null_count or arr.null_count:
            raise ValueError(
                f"fixed-size-list column {field.name!r} has nulls; "
                "vector columns must be dense")
        flat = values.to_numpy(
            zero_copy_only=_is_primitive(pa, values.type))
        start = arr.offset * w
        return flat[start:start + len(arr) * w].reshape(len(arr), w), None
    if pa.types.is_boolean(t):
        if arr.null_count:
            # bool-with-null would otherwise land as an object column of
            # True/None/False, breaking the nulls→NaN contract
            return (arr.cast(pa.float64())
                    .to_numpy(zero_copy_only=False)), None
        return arr.to_numpy(zero_copy_only=False), None
    if _is_primitive(pa, t):
        if arr.null_count:
            # NaN is the engines' missing marker. Floats keep their own
            # dtype (no needless float64 promotion on the feature-matrix
            # path); only integers must widen to hold NaN.
            if pa.types.is_floating(t):
                return arr.to_numpy(zero_copy_only=False), None
            return (arr.cast(pa.float64())
                    .to_numpy(zero_copy_only=False)), None
        return arr.to_numpy(zero_copy_only=True), None
    # strings / binary / ragged lists / structs → host-side object column
    out = np.empty(len(arr), object)
    out[:] = [np.asarray(v) if isinstance(v, list) else v
              for v in arr.to_pylist()]
    return out, None


def _is_primitive(pa, t) -> bool:
    return (pa.types.is_integer(t) or pa.types.is_floating(t))


def table_to_columns(table):
    """Arrow Table/RecordBatch → ({name: np column}, {name: metadata})."""
    pa = _require_pyarrow()
    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    cols: dict[str, np.ndarray] = {}
    metas: dict[str, dict] = {}
    for i, field in enumerate(table.schema):
        chunked = table.column(i)
        if chunked.num_chunks == 1:
            arr = chunked.chunk(0)
        elif chunked.num_chunks == 0:
            arr = pa.array([], type=field.type)
        else:
            arr = chunked.combine_chunks()
            if isinstance(arr, pa.ChunkedArray):  # pyarrow version drift
                arr = arr.chunk(0)
        col, meta = _array_to_numpy(pa, arr, field)
        cols[field.name] = col
        if meta is None and field.metadata and \
                _LEVELS_KEY in field.metadata:
            meta = {"categorical": True,
                    "levels": json.loads(field.metadata[_LEVELS_KEY])}
        if meta:
            metas[field.name] = meta
    return cols, metas


def columns_to_table(df):
    """DataFrame → Arrow Table (numeric columns zero-copy; categorical
    metadata encoded in field metadata so it survives a round trip)."""
    pa = _require_pyarrow()
    from .bindings import ColumnMetadata

    arrays, fields = [], []
    for name in df.columns:
        col = df[name]
        meta = ColumnMetadata.get(df, name)
        field_meta = None
        if meta and meta.get("categorical"):
            field_meta = {_LEVELS_KEY:
                          json.dumps(list(meta["levels"])).encode()}
        if col.ndim == 2:
            w = col.shape[1]
            flat = np.ascontiguousarray(col).reshape(-1)
            arr = pa.FixedSizeListArray.from_arrays(pa.array(flat), w)
        elif col.dtype == object:
            vals = list(col)
            if vals and isinstance(vals[0], np.ndarray):
                arr = pa.array([None if v is None else list(np.asarray(v))
                                for v in vals])
            else:
                arr = pa.array(vals)
        else:
            arr = pa.array(col)
        arrays.append(arr)
        fields.append(pa.field(name, arr.type, metadata=field_meta))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def from_arrow(table, num_partitions: int = 1):
    """Arrow Table / RecordBatch → DataFrame (with categorical
    metadata)."""
    from .bindings import ColumnMetadata
    from .dataframe import DataFrame
    cols, metas = table_to_columns(table)
    df = DataFrame(cols, num_partitions=num_partitions)
    for name, meta in metas.items():
        ColumnMetadata.attach(df, name, meta)
    return df


def from_arrow_batches(batches, num_partitions: int = 1):
    """Streaming ingestion: an iterable of RecordBatches (or a
    RecordBatchReader) → one DataFrame via a single unified Arrow table
    — numeric data never materializes as Python objects, and
    dictionary-encoded columns whose dictionaries legally change
    mid-stream are unified (per-batch decoding against the last
    dictionary would silently mislabel categories)."""
    pa = _require_pyarrow()
    from .dataframe import DataFrame
    schema = getattr(batches, "schema", None)  # RecordBatchReader
    batch_list = list(batches)
    if not batch_list and schema is None:
        return DataFrame()
    try:
        # a known schema keeps zero-row streams schema-correct: the
        # columns come through empty but named and typed
        table = pa.Table.from_batches(batch_list, schema=schema)
    except pa.lib.ArrowInvalid as e:
        raise ValueError(f"batch schema drift: {e}") from e
    return from_arrow(table, num_partitions=num_partitions)
