"""Read a text-encoder ``LoadedModel`` the JAX package pickled, without JAX.

A ``TextEncoderFeaturizer`` saved by the JAX package with ``model`` set
holds, in ``params/model/value.pkl``, a pickled
``mmlspark_tpu.models.zoo.LoadedModel``: a ``ModelSchema``, a flax
``TextEncoder`` and its variables (JAX arrays). Such a payload names a
small closed set of globals, and :class:`ForeignUnpickler` maps each to a
stand-in of the port's own, importing none of them:

- numpy's ``ndarray``, ``dtype`` and array ``_reconstruct`` stay numpy's;
- ``jax._src.array._reconstruct_array`` rebuilds the numpy array from the
  inner reduce tuple it carries (the array's own bytes and dtype);
- ``jax.numpy.bfloat16`` and ``jax.numpy.float32`` become :class:`Marker`s
  of the dtype's name;
- the JAX package's ``LoadedModel``, ``ModelSchema``,
  ``_TextEncoderBuilder`` and ``TextEncoder`` and flax's module
  bookkeeping (``_ModuleInternalState``, ``SetupState``, ``FlaxId``)
  become :class:`Record`s of the state they were pickled with;
- the attention function ``_dense_attention`` becomes a :class:`Marker`:
  the featurizer picks attention by its ``attentionImpl`` Param.

Any other global raises ``pickle.UnpicklingError`` naming it, so the list
is also a safety rule: a payload cannot make the loader call or import
anything outside it. :func:`loaded_model_from_record` then builds the
port's ``TextEncoder`` from the record's fields with the weights carried
across by ``models.convert.text_encoder_from_flax``.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np

_NP_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(1))[0]
_ZOO = "mmlspark_tpu.models.zoo"
_TEXT = "mmlspark_tpu.dl.text_encoder"
_LOADED_MODEL = f"{_ZOO}.LoadedModel"
_TEXT_ENCODER = f"{_TEXT}.TextEncoder"
_DTYPES = {"jax.numpy.bfloat16": "bfloat16", "jax.numpy.float32": "float32"}


class Marker:
    """A foreign global that carries only its name (a dtype, a function)."""

    def __init__(self, qualname: str):
        self.qualname = qualname

    def __repr__(self) -> str:
        return f"Marker({self.qualname})"


class Record:
    """An instance of a foreign class as plain data: ``qualname`` the
    class's qualified name, ``args`` what it was constructed with (enum
    members and other reduce calls), ``state`` its pickled ``__dict__``."""

    qualname = "?"

    def __new__(cls, *args):
        obj = super().__new__(cls)
        obj.args, obj.state = args, {}
        return obj

    def __init__(self, *args):
        pass

    def __setstate__(self, state) -> None:
        if isinstance(state, tuple):             # (dict, slot state)
            merged = {}
            for part in state:
                merged.update(part or {})
            state = merged
        self.state = dict(state)

    def __repr__(self) -> str:
        return f"Record({self.qualname})"


def _record_class(qualname: str) -> type:
    return type(qualname.rpartition(".")[2], (Record,),
                {"qualname": qualname, "__module__": __name__})


def _reconstruct_array(fun, args, arr_state, aval_state):
    """The JAX array's numpy value, from its inner reduce tuple."""
    if fun is not _NP_RECONSTRUCT:
        raise pickle.UnpicklingError(
            "a JAX array whose payload is not a numpy array")
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


_RECORDS = {f"{_ZOO}.LoadedModel", f"{_ZOO}.ModelSchema",
            f"{_ZOO}._TextEncoderBuilder", _TEXT_ENCODER,
            "flax.linen.module._ModuleInternalState",
            "flax.linen.module.SetupState", "flax.ids.FlaxId"}
_MARKERS = {f"{_TEXT}._dense_attention", *_DTYPES}
ALLOWED = {
    **{name: _record_class(name) for name in sorted(_RECORDS)},
    **{name: Marker(name) for name in sorted(_MARKERS)},
    "jax._src.array._reconstruct_array": _reconstruct_array,
    "numpy.ndarray": np.ndarray,
    "numpy.dtype": np.dtype,
    "numpy._core.multiarray._reconstruct": _NP_RECONSTRUCT,
    "numpy.core.multiarray._reconstruct": _NP_RECONSTRUCT,
}


class ForeignUnpickler(pickle.Unpickler):
    """Unpickle with every global taken from :data:`ALLOWED`; any other
    raises ``UnpicklingError`` before anything is imported or called."""

    def find_class(self, module: str, name: str) -> Any:
        qualname = f"{module}.{name}"
        if qualname not in ALLOWED:
            raise pickle.UnpicklingError(
                f"the pickle names the global {qualname!r}, which a "
                "JAX-saved text-encoder model does not hold; refusing to "
                "load it")
        return ALLOWED[qualname]


def loads(data: bytes) -> Any:
    """Unpickle ``data`` through :class:`ForeignUnpickler`."""
    return ForeignUnpickler(io.BytesIO(data)).load()


def type_name(obj: Any) -> str:
    """What a payload holds: a record's foreign class, else the type."""
    if isinstance(obj, Record):
        return obj.qualname
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def loaded_model_from_record(obj: Any):
    """The port's ``LoadedModel`` for a JAX ``LoadedModel`` record holding a
    ``TextEncoder``: the same architecture (vocab, width, depth, heads, mlp
    width, compute dtype) with the same weights. Raises
    ``NotImplementedError`` naming the class for anything else."""
    import torch

    from ..models.convert import text_encoder_from_flax
    from ..models.zoo import LoadedModel, ModelSchema, _TextEncoderBuilder

    if not (isinstance(obj, Record) and obj.qualname == _LOADED_MODEL):
        raise NotImplementedError(
            f"the pickled payload holds a {type_name(obj)}; the port reads "
            "a JAX-saved LoadedModel of a text encoder")
    module = obj.state.get("module")
    if not (isinstance(module, Record) and module.qualname == _TEXT_ENCODER):
        raise NotImplementedError(
            f"the pickled LoadedModel holds a {type_name(module)}; the port "
            "reads text-encoder models (mmlspark_tpu.dl.text_encoder."
            "TextEncoder)")
    m = module.state
    dtype = m.get("dtype")
    if not (isinstance(dtype, Marker) and dtype.qualname in _DTYPES):
        raise NotImplementedError(
            f"the pickled TextEncoder computes in {dtype!r}; the port reads "
            f"{' and '.join(sorted(_DTYPES))}")
    encoder = text_encoder_from_flax(
        obj.state["variables"], heads=int(m["heads"]),
        dtype=getattr(torch, _DTYPES[dtype.qualname]))
    arch = (encoder.vocab, encoder.width, encoder.depth, encoder.mlp_dim)
    fields = tuple(m[f] for f in ("vocab", "width", "depth", "mlp_dim"))
    if arch != fields:
        raise ValueError(f"the pickled TextEncoder's fields (vocab, width, "
                         f"depth, mlp_dim) {fields} disagree with its "
                         f"weights' shapes {arch}")
    s = obj.state["schema"].state
    kept = {f: s[f] for f in ("name", "dataset", "model_type", "input_node",
                              "num_layers", "input_size", "num_classes")
            if f in s}
    schema = ModelSchema(
        **kept, layer_names=tuple(s.get("layer_names", ())),
        builder=_TextEncoderBuilder(encoder.vocab, encoder.width,
                                    encoder.depth, encoder.heads,
                                    encoder.mlp_dim))
    return LoadedModel(schema, encoder)
