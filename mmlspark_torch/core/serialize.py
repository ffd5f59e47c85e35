"""Stage save/load — complex-params-aware persistence.

Role of the reference's ``ComplexParamsWritable``/``ComplexParamsReadable`` +
``org/apache/spark/ml/Serializer.scala:1-147``: stage metadata (class, uid,
simple params) goes to ``metadata.json``; complex params (models, stage lists,
arrays, functions) each persist to their own subdirectory via the param's own
codec. Classes self-register on definition so ``load_stage`` can resolve them.

One format for both packages: ``metadata.json`` names a stage by the JAX
package's qualified class name (``mmlspark_tpu.<module>.<Class>``; the
port's modules mirror its paths), so the JAX package's loader finds its own
class, and ``"library"`` says which package wrote it. The port resolves such
a name to its own registered class by the bare class name, importing at
most its own mirror module, never the JAX package. A complex param that the
JAX package pickled holds objects of that package: the port reads the
``model`` of ``TextEncoderFeaturizer``, ``ImageFeaturizer`` and ``TPUModel``
(a ``LoadedModel`` of a text encoder, ResNet or ViT) through
``foreign_pickle``, which maps the few globals such a
payload names to stand-ins of its own and imports none of them; any other
raises ``NotImplementedError`` naming the class it holds.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
from typing import Any

from . import foreign_pickle
from .param import ComplexParam, Params

_STAGE_REGISTRY: dict[str, type] = {}


def register_stage(cls: type) -> None:
    _STAGE_REGISTRY[cls.__name__] = cls
    _STAGE_REGISTRY[f"{cls.__module__}.{cls.__name__}"] = cls


_REFERENCE, _PORT = "mmlspark_tpu", "mmlspark_torch"
# the complex params whose JAX-pickled payload the port reads
_FOREIGN_MODELS = {("TextEncoderFeaturizer", "model"),
                   ("ImageFeaturizer", "model"), ("TPUModel", "model")}


def saved_class_name(cls: type) -> str:
    """The name ``save`` writes: the JAX package's qualified name of the
    class this port class mirrors."""
    module = cls.__module__
    if module == _PORT or module.startswith(_PORT + "."):
        module = _REFERENCE + module[len(_PORT):]
    return f"{module}.{cls.__name__}"


def resolve_stage_class(qualified: str) -> type:
    if qualified in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[qualified]
    module, _, name = qualified.rpartition(".")
    if module == _REFERENCE or module.startswith(_REFERENCE + "."):
        # the JAX package's name: the port's mirror module, never JAX's
        module = _PORT + module[len(_REFERENCE):]
        if name not in _STAGE_REGISTRY:
            try:
                importlib.import_module(module)
            except ModuleNotFoundError as e:
                # no mirror module (the class is not ported): say so below;
                # a port module that fails on its own imports raises
                if e.name is None or not (module == e.name
                                          or module.startswith(e.name + ".")):
                    raise
        if name in _STAGE_REGISTRY:
            return _STAGE_REGISTRY[name]
    elif module:
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
            "class": saved_class_name(type(self)),
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


def _load_foreign(cls: type, name: str, where: str) -> Any:
    """A complex param the JAX package pickled: a ``model`` of
    :data:`_FOREIGN_MODELS` through ``foreign_pickle`` (a global outside its
    list raises ``UnpicklingError``), any other ``NotImplementedError`` naming the class
    the payload holds (or the first global the port does not read)."""
    with open(os.path.join(where, "value.pkl"), "rb") as f:
        data = f.read()
    if (cls.__name__, name) in _FOREIGN_MODELS:
        return foreign_pickle.loaded_model_from_record(
            foreign_pickle.loads(data))
    try:
        held = foreign_pickle.type_name(foreign_pickle.loads(data))
    except pickle.UnpicklingError as e:
        held = f"an object the port does not read ({e})"
    raise NotImplementedError(
        f"{cls.__name__}.{name} at {where}: the JAX package pickled "
        f"{held}; the port reads a JAX-pickled complex param only for "
        f"{', '.join(sorted('.'.join(m) for m in _FOREIGN_MODELS))}")


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = resolve_stage_class(meta["class"])
    stage = cls.__new__(cls)
    # Re-run Params init without subclass __init__ side effects.
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
    foreign = meta.get("library", _REFERENCE) != _PORT
    for name in meta["complexParams"]:
        p = stage.get_param(name)
        where = os.path.join(path, "params", name)
        if foreign and type(p).load_value is ComplexParam.load_value:
            stage._paramMap[name] = _load_foreign(cls, name, where)
        else:
            stage._paramMap[name] = p.load_value(where)
    stage._load_extra(path)
    return stage
