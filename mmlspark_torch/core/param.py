"""Typed parameter system — the config backbone of every pipeline stage.

Mirrors the capability of SparkML ``Params`` plus the reference's complex-param
extensions (reference ``core/serialize/ComplexParam.scala``,
``org/apache/spark/ml/param/``, ``org/apache/spark/ml/Serializer.scala:1-147``):
parameters whose values are not JSON-encodable (stage lists, functions)
serialize alongside pipeline metadata so whole pipelines round-trip through
save/load. The port carries the param types its stages use; the JAX
package's DataFrame, array and service params come with the slices whose
stages need them.

Design: params are class-level ``Param`` descriptors on a ``Params`` subclass.
Setter/getter methods (``setFoo``/``getFoo``) are synthesized automatically,
which is what makes the binding/codegen layer (reference
``codegen/Wrappable.scala``) nearly free here.
"""

from __future__ import annotations

import json
import os
import pickle
import numpy as np
from typing import Any, Callable


class TypeConverters:
    """Value coercion/validation, analogous to pyspark's TypeConverters."""

    @staticmethod
    def identity(v):
        return v

    @staticmethod
    def toString(v):
        if v is None or isinstance(v, str):
            return v
        raise TypeError(f"expected str, got {type(v).__name__}")

    @staticmethod
    def toInt(v):
        if isinstance(v, bool):
            raise TypeError("expected int, got bool")
        if isinstance(v, (int, np.integer)):
            return int(v)
        if isinstance(v, float) and v.is_integer():
            return int(v)
        raise TypeError(f"expected int, got {type(v).__name__}")

    @staticmethod
    def toFloat(v):
        if isinstance(v, bool):
            raise TypeError("expected float, got bool")
        if isinstance(v, (int, float, np.integer, np.floating)):
            return float(v)
        raise TypeError(f"expected float, got {type(v).__name__}")

    @staticmethod
    def toBoolean(v):
        if isinstance(v, (bool, np.bool_)):
            return bool(v)
        raise TypeError(f"expected bool, got {type(v).__name__}")

    @staticmethod
    def toListString(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return [TypeConverters.toString(x) for x in v]
        raise TypeError(f"expected list[str], got {type(v).__name__}")

    @staticmethod
    def toListInt(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return [TypeConverters.toInt(x) for x in v]
        raise TypeError(f"expected list[int], got {type(v).__name__}")

    @staticmethod
    def toListFloat(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return [TypeConverters.toFloat(x) for x in v]
        raise TypeError(f"expected list[float], got {type(v).__name__}")

    @staticmethod
    def toDict(v):
        if isinstance(v, dict):
            return dict(v)
        raise TypeError(f"expected dict, got {type(v).__name__}")


class Param:
    """A typed, documented parameter slot. JSON-serializable values only."""

    complex = False

    def __init__(self, name: str, doc: str = "",
                 converter: Callable[[Any], Any] = TypeConverters.identity,
                 default: Any = None, has_default: bool | None = None):
        self.name = name
        self.doc = doc
        self.converter = converter
        self.default = default
        self.has_default = (default is not None) if has_default is None \
            else has_default

    def __set_name__(self, owner, attr):
        if attr != self.name:
            raise ValueError(f"Param attribute {attr!r} != name {self.name!r}")

    def __get__(self, obj, objtype=None):
        return self  # params are accessed as descriptors, values via get()

    def encode(self, value) -> Any:
        """To a JSON-encodable representation."""
        return _to_jsonable(value)

    def decode(self, payload) -> Any:
        return payload

    def __repr__(self):
        return f"Param({self.name!r})"


def _to_jsonable(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _to_jsonable(x) for k, x in v.items()}
    return v


class ComplexParam(Param):
    """A param whose value isn't JSON-encodable; persisted to its own subdir.

    Equivalent in role to the reference's ``ComplexParam`` hierarchy
    (``core/serialize/ComplexParam.scala``, ``EstimatorParam``, ``UDFParam``,
    ``DataFrameParam``, ``ByteArrayParam``, ...).
    """

    complex = True

    def save_value(self, value, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "value.pkl"), "wb") as f:
            pickle.dump(value, f)

    def load_value(self, path: str):
        with open(os.path.join(path, "value.pkl"), "rb") as f:
            return pickle.load(f)


class StageParam(ComplexParam):
    """Holds a pipeline stage (Estimator/Transformer/Model) as a value.

    Reference: ``EstimatorParam`` / ``TransformerParam`` / ``ModelParam``.
    """

    def save_value(self, value, path: str) -> None:
        value.save(path)

    def load_value(self, path: str):
        from .serialize import load_stage
        return load_stage(path)


class StageListParam(ComplexParam):
    """A list of pipeline stages (used by Pipeline itself)."""

    def save_value(self, value, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        manifest = []
        for i, stage in enumerate(value):
            sub = os.path.join(path, f"{i}")
            stage.save(sub)
            manifest.append(f"{i}")
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    def load_value(self, path: str):
        from .serialize import load_stage
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        return [load_stage(os.path.join(path, name)) for name in manifest]


class UDFParam(ComplexParam):
    """User function param (reference ``UDFParam``); pickled."""


class Params:
    """Base for anything with params. Synthesizes set/get accessors."""

    _uid_counters: dict[str, int] = {}

    def __init__(self, **kwargs):
        cls = type(self)
        n = Params._uid_counters.get(cls.__name__, 0)
        Params._uid_counters[cls.__name__] = n + 1
        self.uid = f"{cls.__name__}_{n:04x}"
        self._paramMap: dict[str, Any] = {}
        self._defaultOverrides: dict[str, Any] = {}
        if kwargs:
            self.setParams(**kwargs)

    # ------------------------------------------------------------- reflection
    @classmethod
    def params(cls) -> list[Param]:
        # cached per class (stored in cls.__dict__, so subclasses build
        # their own): the MRO walk dominated hot paths like per-request
        # model scoring (~30 params() calls per transform). Params are
        # class attributes fixed at class-creation time — the framework
        # never attaches one at runtime.
        cached = cls.__dict__.get("_params_cache")
        if cached is not None:
            return cached
        out, seen = [], set()
        for klass in cls.__mro__:
            for k, v in vars(klass).items():
                if isinstance(v, Param) and k not in seen:
                    seen.add(k)
                    out.append(v)
        cls._params_cache = out
        return out

    @classmethod
    def get_param(cls, name: str) -> Param:
        cached = cls.__dict__.get("_param_by_name")
        if cached is None:
            cached = {p.name: p for p in cls.params()}
            cls._param_by_name = cached
        p = cached.get(name)
        if p is None:
            raise AttributeError(f"{cls.__name__} has no param {name!r}")
        return p

    @classmethod
    def has_param(cls, name: str) -> bool:
        return any(p.name == name for p in cls.params())

    hasParam = has_param

    # -------------------------------------------------------------- accessors
    def set(self, param: Param | str, value: Any) -> "Params":
        p = self.get_param(param) if isinstance(param, str) else param
        self._paramMap[p.name] = p.converter(value)
        return self

    def setParams(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    @staticmethod
    def _default_value(p: Param) -> Any:
        # Copy mutable defaults so callers can't corrupt the shared Param.
        if isinstance(p.default, list):
            return list(p.default)
        if isinstance(p.default, dict):
            return dict(p.default)
        return p.default

    def _setDefault(self, **kwargs) -> "Params":
        """Instance-level default overrides (SparkML ``setDefault``): used by
        stages whose natural defaults differ from the shared contract mixins
        (e.g. image stages default inputCol to "image")."""
        for k, v in kwargs.items():
            p = self.get_param(k)
            self._defaultOverrides[p.name] = \
                v if v is None else p.converter(v)
        return self

    def get(self, param: Param | str, default: Any = None) -> Any:
        p = self.get_param(param) if isinstance(param, str) else param
        if p.name in self._paramMap:
            return self._paramMap[p.name]
        if p.name in self._defaultOverrides:
            return self._defaultOverrides[p.name]
        if p.has_default:
            return self._default_value(p)
        return default

    def getOrDefault(self, param: Param | str) -> Any:
        p = self.get_param(param) if isinstance(param, str) else param
        if p.name in self._paramMap:
            return self._paramMap[p.name]
        if p.name in self._defaultOverrides:
            return self._defaultOverrides[p.name]
        if p.has_default:
            return self._default_value(p)
        raise KeyError(f"param {p.name!r} is not set and has no default")

    def isSet(self, param: Param | str) -> bool:
        p = self.get_param(param) if isinstance(param, str) else param
        return p.name in self._paramMap

    def isDefined(self, param: Param | str) -> bool:
        p = self.get_param(param) if isinstance(param, str) else param
        return (p.name in self._paramMap
                or p.name in self._defaultOverrides or p.has_default)

    def explainParams(self) -> str:
        lines = []
        for p in sorted(self.params(), key=lambda p: p.name):
            cur = self._paramMap.get(p.name, "undefined")
            dflt = p.default if p.has_default else "undefined"
            lines.append(f"{p.name}: {p.doc} (default: {dflt}, current: {cur})")
        return "\n".join(lines)

    def copy(self, extra: dict | None = None) -> "Params":
        out = type(self).__new__(type(self))
        out.__dict__.update(
            {k: v for k, v in self.__dict__.items()
             if k not in ("_paramMap", "_defaultOverrides")})
        out._paramMap = dict(self._paramMap)
        out._defaultOverrides = dict(self._defaultOverrides)
        if extra:
            out.setParams(**extra)
        return out

    def _copy_params_to(self, other: "Params") -> None:
        for name, value in self._paramMap.items():
            if other.has_param(name):
                other._paramMap[name] = value
        for name, value in self._defaultOverrides.items():
            if other.has_param(name) and name not in other._defaultOverrides:
                other._defaultOverrides[name] = value

    # -------------------------------------------------- synthesized accessors
    def __getattr__(self, item: str):
        # Only called when normal lookup fails: synthesize setX/getX.
        if item.startswith(("set", "get")) and len(item) > 3:
            name = item[3].lower() + item[4:]
            if type(self).has_param(name):
                if item.startswith("set"):
                    def setter(value, _name=name):
                        return self.set(_name, value)
                    return setter

                def getter(_name=name):
                    return self.getOrDefault(_name)
                return getter
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {item!r}")

    def __repr__(self):
        shown = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items())
                          if not isinstance(v, (np.ndarray,)))
        return f"{type(self).__name__}({shown})"
