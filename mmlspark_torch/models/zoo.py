"""Model catalogue entries and the loaded-model holder.

The part of ``mmlspark_tpu/models/zoo.py`` that the text encoder's ``model``
Param needs: ``ModelSchema``, the registry, ``register_text_encoder`` with
its ``TextEncoderBase`` entry, ``register_bert_encoder`` (``:115-150``) and
``LoadedModel`` (``:161-169``). A port
``LoadedModel`` holds an ``nn.Module`` that carries its own weights, where
the JAX one holds a flax module and a variables dict. ``ModelDownloader``
and the image catalogue come with the DL model slice (ROADMAP.md §1
item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from torch import nn


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


# default text entry, as in the JAX package's catalogue
register_text_encoder("TextEncoderBase", vocab=32768, width=256, depth=4,
                      heads=8, mlp_dim=1024)


@dataclasses.dataclass
class LoadedModel:
    """A model ready for inference: schema + module (with its weights)."""
    schema: ModelSchema
    module: nn.Module

    @property
    def layer_names(self) -> list[str]:
        return list(self.schema.layer_names)
