"""Read a ``LoadedModel`` the JAX package pickled, without JAX.

A ``TextEncoderFeaturizer``, ``ImageFeaturizer`` or ``TPUModel`` saved by
the JAX package with ``model`` set holds, in ``params/model/value.pkl``, a
pickled ``mmlspark_tpu.models.zoo.LoadedModel``: a ``ModelSchema``, a flax
``TextEncoder``, ``ResNet`` or ``ViT`` and its variables (JAX arrays). Such
a payload names a small closed set of globals, and
:class:`ForeignUnpickler` maps each to a stand-in of the port's own,
importing none of them:

- numpy's ``ndarray``, ``dtype`` and array ``_reconstruct`` stay numpy's;
- ``jax._src.array._reconstruct_array`` rebuilds the numpy array from the
  inner reduce tuple it carries (the array's own bytes and dtype);
- ``jax.numpy.bfloat16`` and ``jax.numpy.float32`` become :class:`Marker`s
  of the dtype's name;
- the JAX package's ``LoadedModel``, ``ModelSchema``,
  ``_TextEncoderBuilder``, ``TextEncoder``, ``ResNet`` and ``ViT`` and
  flax's module bookkeeping (``_ModuleInternalState``, ``SetupState``,
  ``FlaxId``) become :class:`Record`s of the state they were pickled with;
- the attention function ``_dense_attention``, the ResNet block classes
  and the zoo's builder functions (``ResNet18`` ... ``ViT_L_16``) become
  :class:`Marker`s: the port rebuilds the architecture from the record's
  fields and the weights' shapes.

Any other global raises ``pickle.UnpicklingError`` naming it, so the list
is also a safety rule: a payload cannot make the loader call or import
anything outside it. :func:`loaded_model_from_record` then builds the
port's module from the record's fields with the weights carried across by
``models.convert`` (``text_encoder_from_flax``, ``resnet_from_flax``,
``vit_from_flax``).
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np

_NP_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(1))[0]
_ZOO = "mmlspark_tpu.models.zoo"
_TEXT = "mmlspark_tpu.dl.text_encoder"
_RESNET = "mmlspark_tpu.models.resnet"
_VIT = "mmlspark_tpu.models.vit"
_LOADED_MODEL = f"{_ZOO}.LoadedModel"
_TEXT_ENCODER = f"{_TEXT}.TextEncoder"
_RESNET_MODULE = f"{_RESNET}.ResNet"
_VIT_MODULE = f"{_VIT}.ViT"
# the zoo's image builders (a schema's ``builder``), by module
_IMAGE_BUILDERS = {_RESNET: ("ResNet18", "ResNet34", "ResNet50", "ResNet101"),
                   _VIT: ("ViT_B_16", "ViT_L_16")}
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
            f"{_ZOO}._TextEncoderBuilder", _TEXT_ENCODER, _RESNET_MODULE,
            _VIT_MODULE, "flax.linen.module._ModuleInternalState",
            "flax.linen.module.SetupState", "flax.ids.FlaxId"}
_MARKERS = {f"{_TEXT}._dense_attention", *_DTYPES,
            f"{_RESNET}.BasicBlock", f"{_RESNET}.BottleneckBlock",
            *(f"{m}.{n}" for m, names in _IMAGE_BUILDERS.items()
              for n in names)}
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
                "JAX-saved text-encoder, ResNet or ViT model does not hold; "
                "refusing to load it")
        return ALLOWED[qualname]


def loads(data: bytes) -> Any:
    """Unpickle ``data`` through :class:`ForeignUnpickler`."""
    return ForeignUnpickler(io.BytesIO(data)).load()


def type_name(obj: Any) -> str:
    """What a payload holds: a record's foreign class, else the type."""
    if isinstance(obj, Record):
        return obj.qualname
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def _torch_dtype(module: Record):
    import torch
    dtype = module.state.get("dtype")
    if not (isinstance(dtype, Marker) and dtype.qualname in _DTYPES):
        raise NotImplementedError(
            f"the pickled {module.qualname.rpartition('.')[2]} computes in "
            f"{dtype!r}; the port reads {' and '.join(sorted(_DTYPES))}")
    return getattr(torch, _DTYPES[dtype.qualname])


def _schema(obj: Record, builder):
    from ..models.zoo import ModelSchema
    s = obj.state["schema"].state
    kept = {f: s[f] for f in ("name", "dataset", "model_type", "input_node",
                              "num_layers", "input_size", "num_classes")
            if f in s}
    return ModelSchema(**kept, layer_names=tuple(s.get("layer_names", ())),
                       builder=builder)


def _image_builder(obj: Record):
    """The port's builder for a zoo image schema (its JAX builder marker),
    else None: a custom schema's module comes with the weights."""
    from ..models.zoo import _ImageBuilder
    marker = obj.state["schema"].state.get("builder")
    if isinstance(marker, Marker):
        module, _, name = marker.qualname.rpartition(".")
        if name in _IMAGE_BUILDERS.get(module, ()):
            return _ImageBuilder(".resnet" if module == _RESNET else ".vit",
                                 name, None if module == _RESNET else
                                 obj.state["schema"].state.get("input_size"))
    return None


def _text_encoder(obj: Record, module: Record):
    from ..models.convert import text_encoder_from_flax
    from ..models.zoo import _TextEncoderBuilder
    m = module.state
    encoder = text_encoder_from_flax(
        obj.state["variables"], heads=int(m["heads"]),
        dtype=_torch_dtype(module))
    arch = (encoder.vocab, encoder.width, encoder.depth, encoder.mlp_dim)
    fields = tuple(m[f] for f in ("vocab", "width", "depth", "mlp_dim"))
    if arch != fields:
        raise ValueError(f"the pickled TextEncoder's fields (vocab, width, "
                         f"depth, mlp_dim) {fields} disagree with its "
                         f"weights' shapes {arch}")
    return encoder, _TextEncoderBuilder(encoder.vocab, encoder.width,
                                        encoder.depth, encoder.heads,
                                        encoder.mlp_dim)


def _resnet(obj: Record, module: Record):
    from ..models.convert import resnet_from_flax
    m = module.state
    net = resnet_from_flax(obj.state["variables"], dtype=_torch_dtype(module),
                           remat=bool(m.get("remat", False)))
    block = m.get("block")
    arch = (net.stage_sizes, f"{_RESNET}.{net.block.__name__}", net.width,
            net.num_classes)
    fields = (tuple(m["stage_sizes"]), getattr(block, "qualname", block),
              m["width"], m["num_classes"])
    if arch != fields:
        raise ValueError(f"the pickled ResNet's fields (stage_sizes, block, "
                         f"width, num_classes) {fields} disagree with its "
                         f"weights {arch}")
    return net, _image_builder(obj)


def _vit(obj: Record, module: Record):
    from ..models.convert import vit_from_flax
    m = module.state
    net = vit_from_flax(obj.state["variables"], heads=int(m["heads"]),
                        dtype=_torch_dtype(module),
                        remat=bool(m.get("remat", False)))
    arch = (net.patch, net.width, net.depth, net.mlp_dim, net.num_classes)
    fields = tuple(m[f] for f in ("patch", "width", "depth", "mlp_dim",
                                  "num_classes"))
    if arch != fields:
        raise ValueError(f"the pickled ViT's fields (patch, width, depth, "
                         f"mlp_dim, num_classes) {fields} disagree with its "
                         f"weights' shapes {arch}")
    return net, _image_builder(obj)


_MODULES = {_TEXT_ENCODER: _text_encoder, _RESNET_MODULE: _resnet,
            _VIT_MODULE: _vit}


def loaded_model_from_record(obj: Any):
    """The port's ``LoadedModel`` for a JAX ``LoadedModel`` record holding a
    ``TextEncoder``, ``ResNet`` or ``ViT``: the same architecture (and
    compute dtype) with the same weights, BatchNorm running statistics
    included. Raises ``NotImplementedError`` naming the class for anything
    else."""
    from ..models.zoo import LoadedModel

    if not (isinstance(obj, Record) and obj.qualname == _LOADED_MODEL):
        raise NotImplementedError(
            f"the pickled payload holds a {type_name(obj)}; the port reads "
            "a JAX-saved LoadedModel of a text encoder, ResNet or ViT")
    module = obj.state.get("module")
    if not (isinstance(module, Record) and module.qualname in _MODULES):
        raise NotImplementedError(
            f"the pickled LoadedModel holds a {type_name(module)}; the port "
            f"reads {', '.join(sorted(_MODULES))}")
    net, builder = _MODULES[module.qualname](obj, module)
    return LoadedModel(_schema(obj, builder), net)
