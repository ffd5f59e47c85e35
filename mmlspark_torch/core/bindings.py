"""Dataclass ↔ DataFrame row codecs, and per-column metadata.

Reference ``core/schema/SparkBindings.scala:13-39``: a case-class ↔ Row
codec derived once per type and reused by the HTTP/serving layers to get
typed views over rows. Here the typed carrier is a ``@dataclass``; the
codec walks its (possibly nested) field structure.

Also the categorical-metadata companion of reference
``core/schema/Categoricals.scala``: level lists attached to a column travel
with the DataFrame through select/filter-style operations via
:class:`ColumnMetadata`.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, get_args, get_origin

import numpy as np

from .dataframe import DataFrame


class DataclassBindings:
    """Codec for one dataclass type (reference ``SparkBindings[T]``)."""

    def __init__(self, cls: type):
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"{cls!r} is not a dataclass")
        self.cls = cls
        self.fields = dataclasses.fields(cls)
        self.hints = typing.get_type_hints(cls)

    # ------------------------------------------------------------ encoding
    def to_df(self, items: list) -> DataFrame:
        """list[T] → DataFrame with one column per field (nested
        dataclasses stay nested as object cells)."""
        cols: dict[str, np.ndarray] = {}
        for f in self.fields:
            vals = [self._encode(getattr(it, f.name)) for it in items]
            arr = np.empty(len(items), object)
            arr[:] = vals
            cols[f.name] = arr
        return DataFrame(cols)

    def _encode(self, v: Any) -> Any:
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: self._encode(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, (list, tuple)):
            return [self._encode(x) for x in v]
        if isinstance(v, np.generic):
            return v.item()
        return v

    # ------------------------------------------------------------ decoding
    def from_df(self, df: DataFrame) -> list:
        """DataFrame → list[T]; missing columns use field defaults."""
        out = []
        for i in range(len(df)):
            kwargs = {}
            for f in self.fields:
                if f.name in df.columns:
                    kwargs[f.name] = self._decode(
                        df[f.name][i], self.hints.get(f.name))
                elif f.default is not dataclasses.MISSING:
                    kwargs[f.name] = f.default
                elif f.default_factory is not dataclasses.MISSING:
                    kwargs[f.name] = f.default_factory()
                else:
                    raise KeyError(
                        f"column {f.name!r} absent and field has no "
                        f"default (decoding {self.cls.__name__})")
            out.append(self.cls(**kwargs))
        return out

    def _decode(self, v: Any, hint) -> Any:
        if hint is None:
            return v
        import types
        origin = get_origin(hint)
        if origin in (typing.Union, types.UnionType):  # Optional[T], X | None
            args = [a for a in get_args(hint) if a is not type(None)]
            if v is None:
                return None
            return self._decode(v, args[0]) if len(args) == 1 else v
        if dataclasses.is_dataclass(hint) and isinstance(v, dict):
            sub = DataclassBindings(hint)
            kwargs = {f.name: sub._decode(v.get(f.name),
                                          sub.hints.get(f.name))
                      for f in sub.fields if f.name in v}
            return hint(**kwargs)
        if origin in (list, tuple) and isinstance(v, (list, tuple,
                                                      np.ndarray)):
            args = get_args(hint)
            elem = args[0] if args else None
            seq = [self._decode(x, elem) for x in v]
            return tuple(seq) if origin is tuple else seq
        if isinstance(v, np.generic):
            v = v.item()
        if hint in (int, float, str, bool) and v is not None:
            return hint(v)
        return v


def bindings(cls: type) -> DataclassBindings:
    """Sugar mirroring the reference's companion-object pattern."""
    return DataclassBindings(cls)




class ColumnMetadata:
    """Per-column metadata side-channel (reference ``Categoricals.scala``
    attaches category levels to ML attributes; DataFrame columns here are
    bare arrays, so metadata rides on the DataFrame instance)."""

    _KEY = "__column_metadata__"

    @classmethod
    def attach(cls, df, col: str, meta: dict):
        """Return a df whose ``col`` carries ``meta``; stored on the
        DataFrame instance and copied by value to derived frames that
        keep the column (via ``carry``)."""
        store = dict(getattr(df, cls._KEY, {}))
        store[col] = dict(meta)
        setattr(df, cls._KEY, store)
        return df

    @classmethod
    def get(cls, df, col: str) -> dict | None:
        return getattr(df, cls._KEY, {}).get(col)

    @classmethod
    def carry(cls, src, dst):
        """Propagate metadata for every column dst kept from src (by
        name); replacing a column's values drops its metadata
        (``DataFrame.with_column`` calls :meth:`invalidate`)."""
        store = {c: dict(m) for c, m in getattr(src, cls._KEY, {}).items()
                 if c in dst.columns}
        if store:
            setattr(dst, cls._KEY, {**getattr(dst, cls._KEY, {}), **store})
        return dst

    @classmethod
    def invalidate(cls, df, col: str):
        """Drop ``col``'s metadata (its values were replaced)."""
        store = getattr(df, cls._KEY, None)
        if store and col in store:
            store = dict(store)
            del store[col]
            setattr(df, cls._KEY, store)
        return df

    @classmethod
    def set_categorical(cls, df, col: str, levels: list):
        return cls.attach(df, col, {"categorical": True,
                                    "levels": list(levels)})

    @classmethod
    def categorical_levels(cls, df, col: str) -> list | None:
        meta = cls.get(df, col) or {}
        return meta.get("levels") if meta.get("categorical") else None
