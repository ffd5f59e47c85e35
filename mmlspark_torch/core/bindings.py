"""Per-column metadata that travels with a DataFrame.

The categorical-metadata companion of reference
``core/schema/Categoricals.scala``: level lists attached to a column travel
with the DataFrame through select/filter-style operations via
:class:`ColumnMetadata`. The dataclass row codecs of the JAX package's
``core/bindings.py`` come with the serving slice.
"""

from __future__ import annotations


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
