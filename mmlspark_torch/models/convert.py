"""Carry weights into the port's modules, and persist them.

The JAX package's ``models/convert.py`` turns torch checkpoints into flax
params. Here:

- a flax ``TextEncoder``'s params, as numpy arrays, become a port
  ``TextEncoder`` with identical weights, so both packages embed the same
  text the same way; a flax ``MaskedLMModel``'s params become a port
  ``MaskedLMModel``, so both can train from the same weights;
- a BERT-class checkpoint reaches the port's ``BertEncoder`` two ways: a
  foreign state dict in the HuggingFace layout (``bert_encoder_from_torch``,
  the counterpart of the JAX ``torch_bert_to_flax`` and
  ``bert_encoder_from_torch``) or the JAX package's converted params
  (``bert_encoder_from_flax``);
- a torchvision ResNet or ViT state dict becomes the port's ``ResNet`` or
  ``ViT`` (``resnet_from_torch``, ``vit_from_torch``, dispatched by zoo name
  in ``module_from_torch``: the counterparts of ``torch_resnet_to_flax``,
  ``torch_vit_to_flax`` and ``torch_to_flax``), and the JAX package's flax
  variables, params and ``batch_stats``, become the same modules
  (``resnet_from_flax``, ``vit_from_flax``);
- ``save_converted`` writes a module's state dict with ``torch.save`` and a
  SHA-256 manifest beside it, the port's own format, which
  ``ModelDownloader`` reads back by name and verifies
  (``verify_checkpoint``); ``convert_torch_checkpoint`` and the CLI
  (``python -m mmlspark_torch.models.convert <src.pt> <name> [out_dir]``)
  do both steps.

A state dict that does not match the expected layout fails loudly: a
missing weight raises ``KeyError``, a leftover one ``ValueError``.
"""

from __future__ import annotations

import hashlib
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


# ------------------------------------------------------------------ vision
_ARCHS = {
    # name -> (stage_sizes, block prefix, convs per block)
    "ResNet18": ((2, 2, 2, 2), "BasicBlock", 2),
    "ResNet34": ((3, 4, 6, 3), "BasicBlock", 2),
    "ResNet50": ((3, 4, 6, 3), "BottleneckBlock", 3),
    "ResNet101": ((3, 4, 23, 3), "BottleneckBlock", 3),
}
_VIT_ARCHS = {
    # name -> (width, depth, heads)
    "ViT_B_16": (768, 12, 12),
    "ViT_L_16": (1024, 24, 16),
}


def _leftover(sd: dict, layout: str) -> None:
    if sd:
        raise ValueError(
            f"{len(sd)} unconverted torch weights (first: {sorted(sd)[:5]}) "
            f"— state_dict does not match the expected {layout} layout")


def _load(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    module.load_state_dict({k: v.contiguous() for k, v in state.items()},
                           strict=True, assign=True)
    return module


def _hwio_to_oihw(kernel) -> torch.Tensor:
    return _f32(kernel).permute(3, 2, 0, 1)


def resnet_from_flax(variables: dict, *, dtype: torch.dtype = torch.bfloat16,
                     remat: bool = False):
    """The JAX package's ResNet variables (``{"params", "batch_stats"}``,
    leaves as numpy arrays) → a port ``ResNet`` with the same weights and
    running statistics. The architecture comes from the tree: the block
    type from the block names, the width from ``conv_init``, the stages
    from where a block's filters change, the classes from ``head``. HWIO
    kernels become OIHW; a Dense ``[in, out]`` kernel becomes ``[out, in]``."""
    from .resnet import BasicBlock, BottleneckBlock, ResNet
    if "batch_stats" not in variables:
        raise ValueError("a ResNet needs its BatchNorm running statistics: "
                         "pass the full variables dict (params + "
                         "batch_stats), not a params-only tree")
    p, s = variables["params"], variables["batch_stats"]
    block = BottleneckBlock if any(k.startswith("BottleneckBlock_")
                                   for k in p) else BasicBlock
    n_blocks = sum(1 for k in p if re.fullmatch(rf"{block.__name__}_\d+", k))
    filters = [np.shape(p[f"{block.__name__}_{i}"]["Conv_0"]["kernel"])[3]
               for i in range(n_blocks)]
    stage_sizes = [sum(1 for f in filters if f == v)
                   for v in dict.fromkeys(filters)]
    width = np.shape(p["conv_init"]["kernel"])[3]
    state = {}

    def conv(name, tree):
        state[f"{name}.weight"] = _hwio_to_oihw(tree["kernel"])

    def norm(name, params, stats):
        state[f"{name}.scale"] = _f32(params["scale"])
        state[f"{name}.bias"] = _f32(params["bias"])
        state[f"{name}.mean"] = _f32(stats["mean"])
        state[f"{name}.var"] = _f32(stats["var"])

    conv("conv_init", p["conv_init"])
    norm("bn_init", p["bn_init"], s["bn_init"])
    for i in range(n_blocks):
        name = f"{block.__name__}_{i}"
        for k in sorted(p[name]):
            if k.startswith("Conv_"):
                conv(f"{name}.{k}", p[name][k])
            else:
                norm(f"{name}.{k}", p[name][k], s[name][k])
    state["head.weight"] = _f32(p["head"]["kernel"]).T
    state["head.bias"] = _f32(p["head"]["bias"])
    with torch.device("meta"):                 # no throwaway random init
        module = ResNet(stage_sizes, block, len(state["head.bias"]), width,
                        dtype=dtype, remat=remat)
    return _load(module, state)


def vit_from_flax(variables: dict, *, heads: int | None = None,
                  model_name: str | None = None,
                  dtype: torch.dtype = torch.bfloat16, remat: bool = False):
    """The JAX package's ViT params (or the variables dict holding them),
    leaves as numpy arrays → a port ``ViT`` with the same weights. Patch,
    width, depth, mlp width, classes and image size come from the shapes;
    ``heads`` does not show in them: pass it, or a zoo ``model_name``."""
    from .vit import ViT
    p = variables.get("params", variables)
    if heads is None:
        if model_name not in _VIT_ARCHS:
            raise ValueError("pass heads= (a state dict cannot carry the "
                             "head count) or a zoo model_name from "
                             f"{sorted(_VIT_ARCHS)}")
        heads = _VIT_ARCHS[model_name][2]
    patch, _, _, width = np.shape(p["conv_proj"]["kernel"])
    depth = sum(1 for k in p if re.fullmatch(r"block\d+", k))
    tokens = np.shape(p["pos_embedding"])[1]
    side = int(round((tokens - 1) ** 0.5))
    if side * side != tokens - 1:
        raise ValueError(f"pos_embedding holds {tokens} tokens: not a square "
                         "grid of patches plus the class token")
    state = {"conv_proj.weight": _hwio_to_oihw(p["conv_proj"]["kernel"]),
             "conv_proj.bias": _f32(p["conv_proj"]["bias"]),
             "class_token": _f32(p["class_token"]),
             "pos_embedding": _f32(p["pos_embedding"]),
             "ln.weight": _f32(p["ln"]["scale"]),
             "ln.bias": _f32(p["ln"]["bias"]),
             "head.weight": _f32(p["head"]["kernel"]).T,
             "head.bias": _f32(p["head"]["bias"])}
    for i in range(depth):
        blk, t = p[f"block{i}"], f"block{i}."
        for name in ("ln_1", "ln_2"):
            state[t + name + ".weight"] = _f32(blk[name]["scale"])
            state[t + name + ".bias"] = _f32(blk[name]["bias"])
        dense = {f"attn.{n}": blk["attn"][n] for n in ("q", "k", "v", "out")}
        dense.update(mlp_1=blk["mlp_1"], mlp_2=blk["mlp_2"])
        for name, tree in dense.items():
            state[t + name + ".weight"] = _f32(tree["kernel"]).T
            state[t + name + ".bias"] = _f32(tree["bias"])
    with torch.device("meta"):
        module = ViT(patch=int(patch), width=int(width), depth=depth,
                     heads=int(heads),
                     mlp_dim=int(np.shape(p["block0"]["mlp_1"]["kernel"])[1]),
                     num_classes=int(np.shape(p["head"]["bias"])[0]),
                     dtype=dtype, remat=remat, image_size=int(patch) * side)
    return _load(module, state)


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _torch_resnet_tree(state_dict: dict, model_name: str) -> dict:
    """torchvision ResNet ``state_dict`` → the flax variables tree, as the
    JAX ``torch_resnet_to_flax`` builds it (leaves numpy)."""
    if model_name not in _ARCHS:
        raise KeyError(f"no torchvision mapping for {model_name!r}; "
                       f"supported: {sorted(_ARCHS)}")
    stage_sizes, prefix, n_convs = _ARCHS[model_name]
    sd = dict(state_dict)
    params: dict = {}
    stats: dict = {}

    def conv(dst: dict, flax_name: str, torch_name: str):
        w = _np(sd.pop(torch_name + ".weight"))
        dst[flax_name] = {"kernel": w.transpose(2, 3, 1, 0)}  # OIHW→HWIO

    def bn(torch_name: str, flax_name: str, p: dict, s: dict):
        p[flax_name] = {"scale": _np(sd.pop(torch_name + ".weight")),
                        "bias": _np(sd.pop(torch_name + ".bias"))}
        s[flax_name] = {"mean": _np(sd.pop(torch_name + ".running_mean")),
                        "var": _np(sd.pop(torch_name + ".running_var"))}
        sd.pop(torch_name + ".num_batches_tracked", None)

    conv(params, "conv_init", "conv1")
    bn("bn1", "bn_init", params, stats)
    block_idx = 0
    for li, n_blocks in enumerate(stage_sizes):
        for bj in range(n_blocks):
            t = f"layer{li + 1}.{bj}"
            bp: dict = {}
            bs: dict = {}
            for k in range(n_convs):
                conv(bp, f"Conv_{k}", f"{t}.conv{k + 1}")
                bn(f"{t}.bn{k + 1}", f"BatchNorm_{k}", bp, bs)
            if f"{t}.downsample.0.weight" in sd:
                conv(bp, f"Conv_{n_convs}", f"{t}.downsample.0")
                bn(f"{t}.downsample.1", f"BatchNorm_{n_convs}", bp, bs)
            params[f"{prefix}_{block_idx}"] = bp
            stats[f"{prefix}_{block_idx}"] = bs
            block_idx += 1
    params["head"] = {"kernel": _np(sd.pop("fc.weight")).T,
                      "bias": _np(sd.pop("fc.bias"))}
    _leftover(sd, "torchvision")
    return {"params": params, "batch_stats": stats}


def resnet_from_torch(state_dict: dict, model_name: str, *,
                      dtype: torch.dtype = torch.bfloat16,
                      remat: bool = False):
    """torchvision ResNet ``state_dict`` (``conv1``, ``bn1``,
    ``layer<L>.<B>.conv<k>``/``bn<k>``/``downsample``, ``fc``) → a port
    ``ResNet`` (``model_name`` picks the stage sizes and the block type)."""
    return resnet_from_flax(_torch_resnet_tree(state_dict, model_name),
                            dtype=dtype, remat=remat)


def vit_from_torch(state_dict: dict, model_name: str | None = None, *,
                   heads: int | None = None,
                   dtype: torch.dtype = torch.bfloat16, remat: bool = False):
    """torchvision ViT ``state_dict`` (``vit_b_16`` layout) → a port ``ViT``.

    ``conv_proj`` is the patchify conv; ``class_token`` and
    ``encoder.pos_embedding`` carry over; per block
    ``encoder.layers.encoder_layer_i``: ``ln_1``/``ln_2``, the fused
    ``self_attention.in_proj_weight`` ``[3W, W]`` split into q/k/v,
    ``out_proj``, ``mlp.0``/``mlp.3`` (or the older ``mlp.linear_1``/
    ``linear_2``); ``encoder.ln``; ``heads.head``. Width and depth come from
    the shapes (and must match ``model_name``'s, when given); ``heads``
    from the caller or ``model_name``."""
    sd = dict(state_dict)
    width = int(sd["conv_proj.weight"].shape[0])
    depth = 1 + max((int(k.split(".")[2].rsplit("_", 1)[1]) for k in sd
                     if k.startswith("encoder.layers.encoder_layer_")),
                    default=-1)
    if model_name is not None:
        if model_name not in _VIT_ARCHS:
            raise KeyError(f"no torchvision ViT mapping for {model_name!r}; "
                           f"supported: {sorted(_VIT_ARCHS)}")
        if _VIT_ARCHS[model_name][:2] != (width, depth):
            raise ValueError(
                f"{model_name} is width, depth {_VIT_ARCHS[model_name][:2]}; "
                f"the state dict holds {(width, depth)}")
    params: dict = {}

    def dense(name: str):
        return {"kernel": _np(sd.pop(name + ".weight")).T,
                "bias": _np(sd.pop(name + ".bias"))}

    def lnorm(name: str):
        return {"scale": _np(sd.pop(name + ".weight")),
                "bias": _np(sd.pop(name + ".bias"))}

    params["conv_proj"] = {
        "kernel": _np(sd.pop("conv_proj.weight")).transpose(2, 3, 1, 0),
        "bias": _np(sd.pop("conv_proj.bias"))}
    params["class_token"] = _np(sd.pop("class_token"))
    params["pos_embedding"] = _np(sd.pop("encoder.pos_embedding"))
    for i in range(depth):
        t = f"encoder.layers.encoder_layer_{i}"
        in_w = _np(sd.pop(t + ".self_attention.in_proj_weight"))
        in_b = _np(sd.pop(t + ".self_attention.in_proj_bias"))
        attn = {n: {"kernel": in_w[j * width:(j + 1) * width].T,
                    "bias": in_b[j * width:(j + 1) * width]}
                for j, n in enumerate(("q", "k", "v"))}
        attn["out"] = dense(t + ".self_attention.out_proj")
        mlp1 = t + ".mlp.0" if t + ".mlp.0.weight" in sd \
            else t + ".mlp.linear_1"
        mlp2 = t + ".mlp.3" if t + ".mlp.3.weight" in sd \
            else t + ".mlp.linear_2"
        params[f"block{i}"] = {"ln_1": lnorm(t + ".ln_1"), "attn": attn,
                               "ln_2": lnorm(t + ".ln_2"),
                               "mlp_1": dense(mlp1), "mlp_2": dense(mlp2)}
    params["ln"] = lnorm("encoder.ln")
    params["head"] = dense("heads.head")
    _leftover(sd, "torchvision")
    return vit_from_flax({"params": params}, heads=heads,
                         model_name=model_name, dtype=dtype, remat=remat)


def module_from_torch(state_dict: dict, model_name: str, *,
                      dtype: torch.dtype = torch.bfloat16):
    """Dispatch to the family converter by zoo model name (the JAX
    ``torch_to_flax``)."""
    if model_name in _VIT_ARCHS:
        return vit_from_torch(state_dict, model_name, dtype=dtype)
    return resnet_from_torch(state_dict, model_name, dtype=dtype)


# ------------------------------------------------------------- persistence
def _state_dict(model) -> dict:
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    return {k: v.detach().cpu() for k, v in model.items()}


def _tree_sha256(state_dict: dict) -> str:
    """Deterministic digest over a state dict: each entry's name, shape and
    f32 bytes, in sorted name order."""
    h = hashlib.sha256()
    for name in sorted(state_dict):
        arr = _np(state_dict[name])
        h.update(f"/{name}".encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def checkpoint_paths(model_name: str, out_dir: str) -> tuple[str, str]:
    """``(weights, manifest)`` of a converted model under ``out_dir``:
    ``<name>.pt`` and ``<name>.pt.manifest.json`` (beside, never over, the
    JAX package's orbax directory ``<name>/`` and its manifest)."""
    path = os.path.abspath(os.path.join(out_dir, f"{model_name}.pt"))
    return path, path + ".manifest.json"


def save_converted(model, model_name: str, out_dir: str | None = None) -> str:
    """Write ``model``'s state dict (a module or the dict itself) with
    ``torch.save`` and a SHA-256 manifest under ``out_dir`` (default
    ``MMLSPARK_TPU_MODEL_DIR``). Returns the weights' path."""
    out_dir = out_dir or os.environ.get("MMLSPARK_TPU_MODEL_DIR", "")
    if not out_dir:
        raise ValueError("no output dir: pass out_dir or set "
                         "MMLSPARK_TPU_MODEL_DIR")
    os.makedirs(out_dir, exist_ok=True)
    state = _state_dict(model)
    path, manifest = checkpoint_paths(model_name, out_dir)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(manifest, "w") as f:
        json.dump({"name": model_name, "format": "torch.save state_dict",
                   "sha256": _tree_sha256(state)}, f)
    return path


def verify_checkpoint(state_dict: dict, manifest_path: str) -> None:
    """The reference's hash check (``ModelDownloader.scala:37-60``): raise
    on a digest mismatch."""
    with open(manifest_path) as f:
        manifest = json.load(f)
    got = _tree_sha256(state_dict)
    if got != manifest["sha256"]:
        raise IOError(
            f"checkpoint hash mismatch for {manifest.get('name')}: "
            f"manifest {manifest['sha256'][:12]}…, computed {got[:12]}… — "
            "refusing corrupted/partial weights")


def convert_torch_checkpoint(src, model_name: str,
                             out_dir: str | None = None) -> str:
    """One call: a torchvision ``.pt``/``.pth`` path (or a state dict) →
    the port's verified checkpoint. Returns the weights' path."""
    if isinstance(src, (str, os.PathLike)):
        obj = torch.load(src, map_location="cpu", weights_only=True)
        state_dict = obj.get("state_dict", obj) if isinstance(obj, dict) \
            else obj
    else:
        state_dict = src
    module = module_from_torch(state_dict, model_name)
    return save_converted(module, model_name, out_dir)


def _main(argv):
    """CLI: ``python -m mmlspark_torch.models.convert <src.pt[h]> <name>
    [out_dir]`` — torchvision weights to the port's checkpoint with its
    manifest, e.g. ``... resnet50-0676ba61.pth ResNet50``. Point
    ``MMLSPARK_TPU_MODEL_DIR`` at the output to load them by name."""
    if len(argv) < 2:
        print(_main.__doc__)
        return 2
    path = convert_torch_checkpoint(
        argv[0], argv[1], argv[2] if len(argv) > 2 else None)
    print(f"converted {argv[1]} -> {path}")
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(_main(sys.argv[1:]))
