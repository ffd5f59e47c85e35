"""BERT-architecture encoder for ingested checkpoints.

The port of ``mmlspark_tpu/dl/bert.py``. ``TextEncoder`` (pre-LN, sinusoidal
positions) is the framework's own architecture; a BERT-class checkpoint
(post-LN blocks, LEARNED position and token-type embeddings, an embedding
LayerNorm) cannot be mapped onto it weight for weight, so this module
computes the published BERT layer: ``models.convert.bert_encoder_from_torch``
carries a foreign state dict in the HuggingFace layout into it, and
``bert_encoder_from_flax`` the JAX package's params.

Numerics follow the flax modules: weights stored in f32 and cast to the
compute dtype at each use (``text_encoder.Dense``), every LayerNorm with eps
1e-12 computed in f32 and cast back to ``dtype``, the exact-erf GELU.

Output contract as ``TextEncoder``'s, ``{"tokens": [N, T, W] in dtype,
"pooled": [N, W] f32}`` (masked mean over non-pad tokens, pad id 0), plus
``"cls"`` (the first position, f32) and, with ``pooler``, ``"cls_pooled"``
(the tanh-projected first position, BERT's sentence vector), so
``TextEncoderFeaturizer`` runs either module. Attention is pluggable as in
``TextEncoder`` (``make_attention_fn``); it has no parameters, so
``with_attention`` keeps the weights.

Sequence and tensor parallelism as in ``TextEncoder``: with a
sequence-sharding attention (ring, Ulysses) the module takes one rank's
block of the sequence, looks up the positions of its global offset, sums
the mean pool over the axis and takes ``cls`` from the axis's first rank;
under a mesh in scope with ``tp`` > 1 each block attends on its share of
the heads (``text_encoder.head_parallel``). ``BertEncoder``'s partition
rules register here, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import axis_size
from ..parallel.partition import (DtypePolicy, constrain_activation,
                                  register_partition_rules)
from .text_encoder import (Dense, _dense_attention, head_parallel,
                           seq_offset, seq_shard, seq_sum)

LN_EPS = 1e-12                    # BERT's layer_norm_eps


class BertBlock(nn.Module):
    """Post-LN transformer block (the published BERT layer): the attention
    and feed-forward residuals each followed by a LayerNorm, the exact-erf
    GELU in the feed-forward. Parameters: ``q``, ``k``, ``v``, ``out``,
    ``ln_att``, ``mlp_1``, ``mlp_2``, ``ln_ffn`` (the flax names)."""

    def __init__(self, heads: int, mlp_dim: int, width: int,
                 attention_fn: Callable = _dense_attention,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.mlp_dim, self.width = heads, mlp_dim, width
        self.attention_fn = attention_fn
        self.dtype = dtype
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(width, width, dtype))
        self.ln_att = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp_1 = Dense(width, mlp_dim, dtype)
        self.mlp_2 = Dense(mlp_dim, width, dtype)
        self.ln_ffn = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x, key_mask=None):
        B, T, W = x.shape
        hd = W // self.heads

        def split(a):
            return a.view(B, T, self.heads, hd).transpose(1, 2)

        o = head_parallel(self.attention_fn, split(self.q(x)),
                          split(self.k(x)), split(self.v(x)), key_mask)
        o = o.transpose(1, 2).reshape(B, T, W).to(self.dtype)
        x = self.ln_att((x + self.out(o)).float()).to(self.dtype)
        h = F.gelu(self.mlp_1(x), approximate="none")
        return self.ln_ffn((x + self.mlp_2(h)).float()).to(self.dtype)


class BertEncoder(nn.Module):
    """Token ids [N, T] → ``{"tokens", "pooled", "cls"[, "cls_pooled"]}``.

    The JAX module's attribute names (vocab/width/depth/heads/mlp_dim/
    max_len/type_vocab/pooler/attention_fn/dtype/remat). Parameters:
    ``word``, ``pos``, ``typ`` (flax's ``type``), ``embed_ln``,
    ``block{i}`` and, with ``pooler``, ``pooler_dense`` (flax's
    ``pooler``). A fresh module holds
    BERT's initial weights (normal, std 0.02, for embeddings and dense
    weights; zero biases; LayerNorm 1/0) drawn from ``generator``; a
    converted one is built by ``models.convert``. Pad id 0 is masked out of
    attention keys and the mean pool.

    ``T > max_len`` raises ``ValueError``: the learned position table ends
    there, and clamping would give every later position the last one's
    embedding. ``remat=True`` runs each block through
    ``torch.utils.checkpoint`` under grad (the JAX ``nn.remat``)."""

    def __init__(self, vocab: int = 30522, width: int = 256, depth: int = 4,
                 heads: int = 4, mlp_dim: int = 1024, max_len: int = 512,
                 type_vocab: int = 2, pooler: bool = True,
                 attention_fn: Callable = _dense_attention,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.vocab, self.width, self.depth = vocab, width, depth
        self.heads, self.mlp_dim, self.max_len = heads, mlp_dim, max_len
        self.type_vocab, self.pooler = type_vocab, pooler
        self.attention_fn, self.dtype, self.remat = attention_fn, dtype, remat
        self.word = nn.Embedding(vocab, width)
        self.pos = nn.Embedding(max_len, width)
        self.typ = nn.Embedding(type_vocab, width)
        self.embed_ln = nn.LayerNorm(width, eps=LN_EPS)
        for i in range(depth):
            self.add_module(f"block{i}", BertBlock(
                heads, mlp_dim, width, attention_fn=attention_fn,
                dtype=dtype))
        if pooler:
            self.add_module("pooler_dense", Dense(width, width, dtype))
        self.reset_parameters(generator)

    @property
    def blocks(self) -> list[BertBlock]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """BERT's initialiser (``initializer_range`` 0.02)."""
        for m in self.modules():
            if isinstance(m, (nn.Embedding, Dense)):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
                if isinstance(m, Dense):
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def with_attention(self, attention_fn: Callable) -> "BertEncoder":
        """A copy with the same weights that runs ``attention_fn``."""
        new = copy.deepcopy(self)
        new.attention_fn = attention_fn
        for block in new.blocks:
            block.attention_fn = attention_fn
        return new

    def forward(self, ids, train: bool = False, type_ids=None):
        """``train`` is the JAX module's flag; there is no dropout, so both
        modes compute the same function. ``type_ids`` default to 0. With a
        sequence-sharding attention ``ids`` is this rank's block."""
        T = ids.shape[1]
        shard = seq_shard(self.attention_fn)
        offset = seq_offset(self.attention_fn, T)
        total = T * (1 if shard is None else axis_size(*shard))
        if total > self.max_len:
            raise ValueError(
                f"sequence length {total} exceeds this checkpoint's learned "
                f"position table ({self.max_len}); truncate or chunk "
                "upstream (WordPieceTokenizerModel maxLength)")
        pos = offset + torch.arange(T, device=ids.device)
        typ = torch.zeros_like(ids) if type_ids is None else type_ids
        x = (self.word(ids).to(self.dtype) + self.pos(pos).to(self.dtype)[None]
             + self.typ(typ).to(self.dtype))
        x = constrain_activation(self.embed_ln(x.float()).to(self.dtype),
                                 "BertEncoder")
        key_mask = ids != 0
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = (checkpoint(block, x, key_mask, use_reentrant=False)
                 if remat else block(x, key_mask))
            x = constrain_activation(x, "BertEncoder")
        mask = key_mask.float()[..., None]
        pooled = seq_sum((x.float() * mask).sum(1), self.attention_fn) \
            / seq_sum(mask.sum(1), self.attention_fn).clamp_min(1.0)
        first = x[:, 0]
        if shard is not None:
            # the first token lives on the axis's first rank: a sum of it
            # there and zeros elsewhere hands it to every rank
            first = seq_sum(first if offset == 0 else torch.zeros_like(first),
                            self.attention_fn)
        out = {"tokens": x, "pooled": pooled, "cls": first.float()}
        if self.pooler:
            out["cls_pooled"] = torch.tanh(
                self.pooler_dense(first)).float()
        return out


# Partition rules for BertEncoder, the JAX package's (bert.py:160-181) on
# the port's names (torch weights [out, in], each kernel spec reversed):
# vocab-sharded word embedding, q/k/v and mlp_1 column-parallel, out and
# mlp_2 row-parallel, everything per-channel replicated.
register_partition_rules("BertEncoder", [
    (r"word/weight", ("tp", None)),
    (r"(pos|typ)/weight", ()),
    (r"(embed_ln|ln_att|ln_ffn)/(weight|bias)", ()),
    (r"(q|k|v)/weight", ("tp", None)),
    (r"(q|k|v)/bias", ("tp",)),
    (r"out/weight", (None, "tp")),
    (r"out/bias", ()),
    (r"mlp_1/weight", ("tp", None)),
    (r"mlp_1/bias", ("tp",)),
    (r"mlp_2/weight", (None, "tp")),
    (r"mlp_2/bias", ()),
    (r"pooler_dense/(weight|bias)", ()),
],
    dtype_policy=DtypePolicy(param_dtype="float32",
                             compute_dtype="bfloat16",
                             grad_accum_dtype="float32"),
    activation_spec=("dp",))
