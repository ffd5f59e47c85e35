"""Stage save/load — complex-params-aware persistence.

Role of the reference's ``ComplexParamsWritable``/``ComplexParamsReadable`` +
``org/apache/spark/ml/Serializer.scala:1-147``: stage metadata (class, uid,
simple params) goes to ``metadata.json``; complex params (models, stage lists,
arrays, functions) each persist to their own subdirectory via the param's own
codec. Classes self-register on definition so ``load_stage`` can resolve them.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any

_STAGE_REGISTRY: dict[str, type] = {}


def register_stage(cls: type) -> None:
    _STAGE_REGISTRY[cls.__name__] = cls
    _STAGE_REGISTRY[f"{cls.__module__}.{cls.__name__}"] = cls


def resolve_stage_class(qualified: str) -> type:
    if qualified in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[qualified]
    module, _, name = qualified.rpartition(".")
    if module:
        importlib.import_module(module)
        if qualified in _STAGE_REGISTRY:
            return _STAGE_REGISTRY[qualified]
    raise KeyError(f"unknown stage class {qualified!r}")


class SaveLoadMixin:
    """save/load for Params subclasses."""

    def save(self, path: str, overwrite: bool = True) -> None:
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        os.makedirs(path, exist_ok=True)
        simple, complex_names = {}, []
        for p in type(self).params():
            if p.name not in self._paramMap:
                continue
            value = self._paramMap[p.name]
            if p.complex:
                p.save_value(value, os.path.join(path, "params", p.name))
                complex_names.append(p.name)
            else:
                simple[p.name] = p.encode(value)
        meta = {
            "class": f"{type(self).__module__}.{type(self).__name__}",
            "uid": self.uid,
            "paramMap": simple,
            "complexParams": complex_names,
            # instance-level default overrides (set by stage __init__ or
            # _setDefault) must survive load, which bypasses __init__
            "defaultOverrides": {
                k: type(self).get_param(k).encode(v)
                for k, v in self._defaultOverrides.items()},
            "library": "mmlspark_torch",
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=1)
        self._save_extra(path)

    def _save_extra(self, path: str) -> None:
        """Hook for stages with non-param state."""

    def _load_extra(self, path: str) -> None:
        pass

    @classmethod
    def load(cls, path: str):
        stage = load_stage(path)
        if not isinstance(stage, cls):
            raise TypeError(f"loaded {type(stage).__name__}, expected "
                            f"{cls.__name__}")
        return stage

    write = save  # familiar aliases
    read = load


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = resolve_stage_class(meta["class"])
    stage = cls.__new__(cls)
    # Re-run Params init without subclass __init__ side effects.
    from .param import Params
    Params.__init__(stage)
    stage.uid = meta["uid"]
    for name, payload in meta["paramMap"].items():
        if stage.has_param(name):
            p = stage.get_param(name)
            stage._paramMap[name] = p.decode(payload)
    for name, payload in meta.get("defaultOverrides", {}).items():
        if stage.has_param(name):
            stage._defaultOverrides[name] = \
                stage.get_param(name).decode(payload)
    for name in meta["complexParams"]:
        p = stage.get_param(name)
        stage._paramMap[name] = p.load_value(
            os.path.join(path, "params", name))
    stage._load_extra(path)
    return stage
