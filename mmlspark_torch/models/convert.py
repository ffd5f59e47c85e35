"""Carry the JAX package's text-encoder weights into the port.

The JAX package's ``models/convert.py`` goes the other way (torch
checkpoints → flax). Here a flax ``TextEncoder``'s params, as numpy arrays,
become a port ``TextEncoder`` with identical weights, so both packages
embed the same text the same way; a flax ``MaskedLMModel``'s params become
a port ``MaskedLMModel``, so both can train from the same weights.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch

from ..dl.pretrain import MaskedLMModel
from ..dl.text_encoder import TextEncoder, _dense_attention

_DENSE = ("qkv", "out", "mlp_1", "mlp_2")
_NORMS = ("ln_1", "ln_2")


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))    # a writable copy


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
