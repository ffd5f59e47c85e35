"""Model registry and downloader, the port of ``mmlspark_tpu/models/zoo.py``.

Reference: ``downloader/ModelDownloader.scala`` + ``downloader/Schema.scala``
— a catalogue of pretrained models (``ModelSchema``: input node, layer
names) fetched with hash verification and retry. Here:

- the catalogue holds the image builtins (``ResNet18/34/50/101``,
  ``ViT_B_16``, ``ViT_L_16`` with their ``layer_names``), the
  ``TextEncoderBase`` text entry, and whatever ``register_*`` adds;
- a port ``LoadedModel`` holds an ``nn.Module`` that carries its own
  weights, where the JAX one holds a flax module and a variables dict;
- ``ModelDownloader.download_by_name`` reads the port's own format under
  ``MMLSPARK_TPU_MODEL_DIR``: ``<name>.pt``, a ``torch.save``d state dict
  (``models.convert.save_converted``), restored with retry, its manifest's
  SHA-256 checked once outside the retry. Without it, a seeded init keyed
  on the md5 of the name (allowed by default with a warning, or refused:
  ``allow_random_init`` and ``MMLSPARK_TPU_ALLOW_RANDOM_INIT``, as in the
  JAX package). A directory holding the JAX package's orbax checkpoint
  (``<name>/``) raises, naming the format: the port does not read it.
  Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from typing import Any, Callable

import torch
from torch import nn

from ..core.utils import retry_with_timeout


@dataclasses.dataclass
class ModelSchema:
    """Catalogue entry (reference ``downloader/Schema.scala``)."""
    name: str
    dataset: str = "ImageNet"
    model_type: str = "image"
    input_node: str = "image"
    num_layers: int = 0
    layer_names: tuple[str, ...] = ()
    input_size: int = 224
    num_classes: int = 1000
    builder: Callable[..., Any] | None = None


_REGISTRY: dict[str, ModelSchema] = {}


def register_model(schema: ModelSchema) -> ModelSchema:
    _REGISTRY[schema.name] = schema
    return schema


def get_model(name: str) -> ModelSchema:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


class _TextEncoderBuilder:
    """Picklable text-encoder factory (a closure would break ComplexParam
    persistence of a stage holding the LoadedModel)."""

    def __init__(self, vocab: int, width: int, depth: int, heads: int,
                 mlp_dim: int):
        self.vocab, self.width, self.depth = vocab, width, depth
        self.heads, self.mlp_dim = heads, mlp_dim

    def __call__(self, **kwargs):
        from ..dl.text_encoder import TextEncoder
        return TextEncoder(vocab=self.vocab, width=self.width,
                           depth=self.depth, heads=self.heads,
                           mlp_dim=self.mlp_dim, **kwargs)


def register_text_encoder(name: str, *, vocab: int, width: int,
                          depth: int, heads: int,
                          mlp_dim: int | None = None,
                          seq_len: int = 128) -> ModelSchema:
    """Register a text-encoder catalogue entry carrying the encoder's
    hyperparameters; ``schema.builder(generator=...)`` makes the module."""
    return register_model(ModelSchema(
        name=name, dataset="custom", model_type="text",
        num_layers=depth, input_node="tokens", input_size=seq_len,
        num_classes=0,
        builder=_TextEncoderBuilder(vocab, width, depth, heads,
                                    mlp_dim or 4 * width),
        layer_names=tuple(f"block{i}" for i in range(depth))
        + ("tokens", "pooled")))


class _BertEncoderBuilder:
    """Picklable BERT-encoder factory (as ``_TextEncoderBuilder``)."""

    def __init__(self, **arch):
        self.arch = dict(arch)

    def __call__(self, **kwargs):
        from ..dl.bert import BertEncoder
        return BertEncoder(**self.arch, **kwargs)


def register_bert_encoder(name: str, *, vocab: int, width: int, depth: int,
                          heads: int, mlp_dim: int, max_len: int = 512,
                          type_vocab: int = 2, pooler: bool = True,
                          seq_len: int = 128) -> ModelSchema:
    """Register an ingested-BERT catalogue entry: ``schema.builder(
    generator=...)`` makes the architecture, which
    ``models.convert.bert_encoder_from_torch`` fills with a foreign
    checkpoint's weights. ``input_size`` is ``seq_len`` clamped to the
    learned position table (``max_len``)."""
    return register_model(ModelSchema(
        name=name, dataset="custom", model_type="text",
        num_layers=depth, input_node="tokens",
        input_size=min(seq_len, max_len), num_classes=0,
        builder=_BertEncoderBuilder(vocab=vocab, width=width, depth=depth,
                                    heads=heads, mlp_dim=mlp_dim,
                                    max_len=max_len, type_vocab=type_vocab,
                                    pooler=pooler),
        layer_names=tuple(f"block{i}" for i in range(depth))
        + ("tokens", "pooled", "cls")))


class _ImageBuilder:
    """Picklable factory of a zoo image model (a module-level function of
    ``models.resnet`` or ``models.vit``, by name)."""

    def __init__(self, module: str, name: str, image_size: int | None = None):
        self.module, self.name, self.image_size = module, name, image_size

    def __call__(self, **kwargs):
        import importlib
        fn = getattr(importlib.import_module(self.module, __package__),
                     self.name)
        if self.image_size is not None:
            kwargs.setdefault("image_size", self.image_size)
        return fn(**kwargs)


def _register_builtins():
    for name, layers in [("ResNet18", 18), ("ResNet34", 34),
                         ("ResNet50", 50), ("ResNet101", 101)]:
        register_model(ModelSchema(
            name=name, num_layers=layers,
            builder=_ImageBuilder(".resnet", name),
            layer_names=("stage1", "stage2", "stage3", "stage4",
                         "pooled", "logits")))
    for name, depth in [("ViT_B_16", 12), ("ViT_L_16", 24)]:
        register_model(ModelSchema(
            name=name, num_layers=depth,
            builder=_ImageBuilder(".vit", name, image_size=224),
            layer_names=tuple(f"block{i + 1}" for i in range(depth))
            + ("pooled", "logits")))
    # the default text entry, as in the JAX package's catalogue
    register_text_encoder("TextEncoderBase", vocab=32768, width=256, depth=4,
                          heads=8, mlp_dim=1024)


_register_builtins()


@dataclasses.dataclass
class LoadedModel:
    """A model ready for inference: schema + module (with its weights)."""
    schema: ModelSchema
    module: nn.Module

    @property
    def layer_names(self) -> list[str]:
        return list(self.schema.layer_names)


def _torch_dtype(dtype):
    """A torch dtype, or its name (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class ModelDownloader:
    """Resolve a catalogue model to weights (reference
    ``ModelDownloader.downloadByName``): the port's checkpoint under
    ``local_dir`` (default ``MMLSPARK_TPU_MODEL_DIR``), else a seeded init."""

    def __init__(self, local_dir: str | None = None):
        self.local_dir = local_dir or os.environ.get(
            "MMLSPARK_TPU_MODEL_DIR", "")

    def download_by_name(self, name: str, *, num_classes: int | None = None,
                         dtype=None, remat: bool | None = None,
                         allow_random_init: bool | None = None
                         ) -> LoadedModel:
        """Resolve ``name`` to a ready model on the CPU (the stages move it
        to their device).

        ``dtype`` is the compute dtype (a torch dtype or its name);
        ``remat`` recomputes blocks in the backward; neither changes the
        parameter names, so checkpoints load either way.

        ``allow_random_init``: with no checkpoint, True falls back to the
        seeded init (shape checks, architecture tests), False raises
        ``FileNotFoundError``; None reads ``MMLSPARK_TPU_ALLOW_RANDOM_INIT``
        (default allow, with a warning)."""
        schema = get_model(name)
        kwargs = {}
        if num_classes is not None:
            kwargs["num_classes"] = num_classes
        if dtype is not None:
            kwargs["dtype"] = _torch_dtype(dtype)
        if remat is not None:
            kwargs["remat"] = remat
        path = self._ckpt_path(schema)
        if path:
            with torch.device("meta"):         # no throwaway random init
                module = schema.builder(**kwargs)
            state = self._restore(schema, path)
            module.load_state_dict(state, strict=True, assign=True)
        else:
            module = schema.builder(
                generator=self._seeded(schema, allow_random_init), **kwargs)
        return LoadedModel(schema=schema, module=module)

    # -- weights ------------------------------------------------------------
    def _ckpt_path(self, schema: ModelSchema) -> str | None:
        if not self.local_dir:
            return None
        from .convert import checkpoint_paths
        path, _ = checkpoint_paths(schema.name, self.local_dir)
        if os.path.isfile(path):
            return path
        if os.path.isdir(os.path.join(self.local_dir, schema.name)):
            raise ValueError(
                f"{os.path.join(self.local_dir, schema.name)} holds an orbax "
                "checkpoint (the JAX package's format), which the port does "
                f"not read; it loads {schema.name}.pt, a torch.save'd state "
                "dict with its manifest: convert the weights with "
                "mmlspark_torch.models.convert (models.resnet_from_flax, "
                "vit_from_flax, text_encoder_from_flax, then "
                "save_converted)")
        return None

    def _restore(self, schema: ModelSchema, path: str) -> dict:
        from .convert import checkpoint_paths, verify_checkpoint
        state = retry_with_timeout(
            lambda: torch.load(path, map_location="cpu", weights_only=True),
            backoffs_ms=(0, 100, 200))
        # the digest is deterministic, so it is checked once, outside the
        # retry: corrupted weights fail loudly
        _, manifest = checkpoint_paths(schema.name, self.local_dir)
        if os.path.exists(manifest):
            verify_checkpoint(state, manifest)
        return state

    def _seeded(self, schema: ModelSchema,
                allow_random_init: bool | None) -> torch.Generator:
        if allow_random_init is None:
            allow_random_init = os.environ.get(
                "MMLSPARK_TPU_ALLOW_RANDOM_INIT", "1") != "0"
            if allow_random_init:
                warnings.warn(
                    f"no checkpoint for {schema.name!r} under "
                    f"{self.local_dir or '<unset MMLSPARK_TPU_MODEL_DIR>'}; "
                    "initializing RANDOM weights (shape-correct, not "
                    "pretrained). Pass allow_random_init=True to silence, "
                    "or point MMLSPARK_TPU_MODEL_DIR at converted weights.",
                    stacklevel=4)
        if not allow_random_init:
            raise FileNotFoundError(
                f"no local checkpoint for model {schema.name!r} (looked "
                f"under {self.local_dir or '<unset>'}) and allow_random_init "
                "is False; convert weights with mmlspark_torch.models.convert "
                "and set MMLSPARK_TPU_MODEL_DIR")
        seed = int(hashlib.md5(schema.name.encode()).hexdigest()[:8], 16)
        return torch.Generator().manual_seed(seed)
