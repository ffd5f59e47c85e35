"""Carry weights into the port's text modules.

The JAX package's ``models/convert.py`` turns torch checkpoints into flax
params. Here a flax ``TextEncoder``'s params, as numpy arrays, become a port
``TextEncoder`` with identical weights, so both packages embed the same text
the same way; a flax ``MaskedLMModel``'s params become a port
``MaskedLMModel``, so both can train from the same weights. A BERT-class
checkpoint reaches the port's ``BertEncoder`` two ways: a foreign state dict
in the HuggingFace layout (``bert_encoder_from_torch``, the counterpart of
the JAX ``torch_bert_to_flax`` and ``bert_encoder_from_torch``) or the JAX
package's converted params (``bert_encoder_from_flax``).
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Callable

import numpy as np
import torch

from ..dl.bert import BertEncoder
from ..dl.pretrain import MaskedLMModel
from ..dl.text_encoder import TextEncoder, _dense_attention

_DENSE = ("qkv", "out", "mlp_1", "mlp_2")
_NORMS = ("ln_1", "ln_2")


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))    # a writable copy


def _host_f32(x) -> torch.Tensor:
    """A state-dict entry (a tensor on any device, in any float dtype, or an
    array) as a writable f32 CPU tensor."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return _f32(x)


def text_encoder_from_flax(params: dict, *, heads: int,
                           dtype: torch.dtype = torch.bfloat16,
                           attention_fn: Callable = _dense_attention
                           ) -> TextEncoder:
    """``params``: the flax ``TextEncoder``'s ``params`` tree (or the
    variables dict holding it), leaves as numpy arrays. Vocab, width, depth
    and mlp width come from the shapes; ``heads`` does not show in them.
    Dense kernels ``[in, out]`` become ``weight`` ``[out, in]``; LayerNorm
    ``scale`` becomes ``weight``."""
    p = params.get("params", params)
    vocab, width = np.shape(p["embed"]["embedding"])
    depth = sum(1 for k in p if re.fullmatch(r"block\d+", k))
    mlp_dim = np.shape(p["block0"]["mlp_1"]["kernel"])[1]
    state = {"embed.weight": _f32(p["embed"]["embedding"]),
             "ln.weight": _f32(p["ln"]["scale"]),
             "ln.bias": _f32(p["ln"]["bias"])}
    for i in range(depth):
        blk = p[f"block{i}"]
        for name in _DENSE:
            state[f"block{i}.{name}.weight"] = _f32(blk[name]["kernel"]).T
            state[f"block{i}.{name}.bias"] = _f32(blk[name]["bias"])
        for name in _NORMS:
            state[f"block{i}.{name}.weight"] = _f32(blk[name]["scale"])
            state[f"block{i}.{name}.bias"] = _f32(blk[name]["bias"])
    with torch.device("meta"):                 # no throwaway random init
        module = TextEncoder(vocab=vocab, width=width, depth=depth,
                             heads=heads, mlp_dim=mlp_dim,
                             attention_fn=attention_fn, dtype=dtype)
    module.load_state_dict({k: v.contiguous() for k, v in state.items()},
                           strict=True, assign=True)
    return module


def masked_lm_from_flax(params: dict, *, heads: int,
                        dtype: torch.dtype = torch.bfloat16,
                        attention_fn: Callable = _dense_attention
                        ) -> MaskedLMModel:
    """``params``: the flax ``MaskedLMModel``'s ``params`` tree (or the
    variables dict holding it), leaves as numpy arrays. The trunk under
    ``encoder`` goes through :func:`text_encoder_from_flax`; the head's
    ``lm_head/kernel`` ``[W, V]`` becomes ``weight`` ``[V, W]``."""
    p = params.get("params", params)
    module = MaskedLMModel(text_encoder_from_flax(
        p["encoder"], heads=heads, dtype=dtype, attention_fn=attention_fn))
    module.lm_head.load_state_dict(
        {"weight": _f32(p["lm_head"]["kernel"]).T.contiguous(),
         "bias": _f32(p["lm_head"]["bias"])}, strict=True)
    return module


# the port's BertBlock parameter -> the HF layer's module (under
# ``encoder.layer.{i}.``)
_BERT_DENSE = {"q": "attention.self.query", "k": "attention.self.key",
               "v": "attention.self.value", "out": "attention.output.dense",
               "mlp_1": "intermediate.dense", "mlp_2": "output.dense"}
_BERT_NORMS = {"ln_att": "attention.output.LayerNorm",
               "ln_ffn": "output.LayerNorm"}


def _build_bert(state: dict, arch: dict, dtype: torch.dtype) -> BertEncoder:
    with torch.device("meta"):                 # no throwaway random init
        module = BertEncoder(**arch, dtype=dtype)
    module.load_state_dict({k: v.contiguous() for k, v in state.items()},
                           strict=True, assign=True)
    return module


def bert_encoder_from_torch(state_dict: dict, heads: int | None = None,
                            config=None, *,
                            dtype: torch.dtype = torch.float32
                            ) -> BertEncoder:
    """A foreign BERT-style ``state_dict`` (HF naming:
    ``embeddings.word_embeddings`` / ``encoder.layer.N.attention.self
    .query`` / ..., with or without a leading ``bert.`` prefix) → a port
    ``BertEncoder`` carrying those weights, ready for
    ``TextEncoderFeaturizer(model=LoadedModel(...))``.

    The JAX ``torch_bert_to_flax``'s rules: every dimension is read from
    the weight shapes (vocab and width from the word embedding, depth from
    the layer indices, mlp_dim from the intermediate projection, max_len
    and type_vocab from their embeddings); older exports' ``gamma``/``beta``
    stand for a LayerNorm's ``weight``/``bias``; the ``position_ids``
    buffer is ignored; the pretraining head (``cls.*``) is dropped and any
    other leftover key raises. ``heads`` is the one dimension a state dict
    cannot carry: pass it, or ``config`` (a ``config.json`` path or dict,
    its ``num_attention_heads``); with neither, ``width // 64`` is assumed
    with a warning. ``dtype`` is the compute dtype (the JAX module's
    default, f32); the module attends densely, and ``with_attention`` (or
    the featurizer's ``attentionImpl``) picks another implementation."""
    sd = {}
    for k, v in state_dict.items():
        k = k[5:] if k.startswith("bert.") else k
        if not k.startswith("cls."):           # masked-LM pretraining head
            sd[k] = v

    def take(name):
        return _host_f32(sd.pop(name))

    def lnorm(name):
        w = sd.pop(name + ".weight", None)
        w = sd.pop(name + ".gamma") if w is None else w
        b = sd.pop(name + ".bias", None)
        b = sd.pop(name + ".beta") if b is None else b
        return [_host_f32(w), _host_f32(b)]

    state = {"word.weight": take("embeddings.word_embeddings.weight"),
             "pos.weight": take("embeddings.position_embeddings.weight"),
             "typ.weight": take("embeddings.token_type_embeddings.weight")}
    sd.pop("embeddings.position_ids", None)    # a buffer, not a weight
    state["embed_ln.weight"], state["embed_ln.bias"] = lnorm(
        "embeddings.LayerNorm")
    vocab, width = state["word.weight"].shape
    depth = 1 + max((int(k.split(".")[2]) for k in sd
                     if k.startswith("encoder.layer.")), default=-1)
    if depth <= 0:
        raise ValueError("state_dict has no encoder.layer.* weights — "
                         "not a BERT-style checkpoint")
    for i in range(depth):
        t = f"encoder.layer.{i}."
        for name, hf in _BERT_DENSE.items():
            state[f"block{i}.{name}.weight"] = take(t + hf + ".weight")
            state[f"block{i}.{name}.bias"] = take(t + hf + ".bias")
        for name, hf in _BERT_NORMS.items():
            state[f"block{i}.{name}.weight"], state[f"block{i}.{name}.bias"] \
                = lnorm(t + hf)
    pooler = "pooler.dense.weight" in sd
    if pooler:
        state["pooler_dense.weight"] = take("pooler.dense.weight")
        state["pooler_dense.bias"] = take("pooler.dense.bias")
    if sd:
        raise ValueError(
            f"{len(sd)} unconverted torch weights (first: "
            f"{sorted(sd)[:5]}) — state_dict does not match the expected "
            "BERT layout")
    if heads is None and config is not None:
        if isinstance(config, (str, os.PathLike)):
            with open(config) as f:
                config = json.load(f)
        heads = config.get("num_attention_heads")
    if heads is None:
        heads = max(width // 64, 1)
        warnings.warn(
            f"head count not provided — assuming {heads} (width {width} / "
            "64, the BERT convention). A checkpoint with a different head "
            "count would convert into DIFFERENT attention numerics with no "
            "error; pass heads= or config=<config.json> to be exact.",
            stacklevel=2)
    if width % int(heads) != 0:
        raise ValueError(f"heads={heads} must divide width={width}")
    arch = dict(vocab=int(vocab), width=int(width), depth=int(depth),
                heads=int(heads),
                mlp_dim=int(state["block0.mlp_1.weight"].shape[0]),
                max_len=int(state["pos.weight"].shape[0]),
                type_vocab=int(state["typ.weight"].shape[0]), pooler=pooler)
    return _build_bert(state, arch, dtype)


def bert_encoder_from_flax(params: dict, *, heads: int,
                           dtype: torch.dtype = torch.float32
                           ) -> BertEncoder:
    """``params``: the JAX ``BertEncoder``'s ``params`` tree (or the
    variables dict holding it, as the JAX ``bert_encoder_from_torch``
    returns it), leaves as numpy arrays. Dimensions come from the shapes,
    ``heads`` from the caller; Dense kernels ``[in, out]`` become weights
    ``[out, in]``, LayerNorm ``scale`` becomes ``weight``."""
    p = params.get("params", params)
    depth = sum(1 for k in p if re.fullmatch(r"block\d+", k))
    state = {"word.weight": _f32(p["word"]["embedding"]),
             "pos.weight": _f32(p["pos"]["embedding"]),
             "typ.weight": _f32(p["type"]["embedding"]),
             "embed_ln.weight": _f32(p["embed_ln"]["scale"]),
             "embed_ln.bias": _f32(p["embed_ln"]["bias"])}
    for i in range(depth):
        blk = p[f"block{i}"]
        for name in _BERT_DENSE:
            state[f"block{i}.{name}.weight"] = _f32(blk[name]["kernel"]).T
            state[f"block{i}.{name}.bias"] = _f32(blk[name]["bias"])
        for name in _BERT_NORMS:
            state[f"block{i}.{name}.weight"] = _f32(blk[name]["scale"])
            state[f"block{i}.{name}.bias"] = _f32(blk[name]["bias"])
    pooler = "pooler" in p
    if pooler:
        state["pooler_dense.weight"] = _f32(p["pooler"]["kernel"]).T
        state["pooler_dense.bias"] = _f32(p["pooler"]["bias"])
    vocab, width = state["word.weight"].shape
    arch = dict(vocab=int(vocab), width=int(width), depth=depth,
                heads=int(heads),
                mlp_dim=int(state["block0.mlp_1.weight"].shape[0]),
                max_len=int(state["pos.weight"].shape[0]),
                type_vocab=int(state["typ.weight"].shape[0]), pooler=pooler)
    return _build_bert(state, arch, dtype)
