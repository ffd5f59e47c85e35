"""Long-context transformer text encoder and its pipeline stage.

The port of ``mmlspark_tpu/dl/text_encoder.py``'s encoder and stage: a
compact pre-LN transformer encoder whose attention implementation is pluggable
(``make_attention_fn``):

- ``dense``     — standard softmax attention, the whole score matrix;
- ``pallas``    — the fused flash-attention kernels (``flash_attention.py``):
  the hand-written CUDA kernels on the card, their plain versions on the
  CPU. Without grad (the featurizer runs under ``torch.inference_mode()``)
  that is the forward K2a; under grad (training, ``dl/pretrain.py``) the
  forward that saves the lse (K2b) and the fused backward (K2d, K2e), and
  with ``causal=True`` their causal branches (K2c-lse, causal K2d/K2e);
- ``blockwise`` — single-device flash-style blocks in plain PyTorch;
- ``ring``/``ring_flash`` and ``ulysses``/``ulysses_flash`` — attention
  over a sequence sharded along a mesh axis (``parallel.ring_attention``,
  ``parallel.ulysses``), with plain or kernel (``_flash``) local attention.

Every implementation takes ``causal`` (``make_attention_fn(impl,
causal=True)``): lower-triangular masking, the decoder pattern; the
``pallas`` forward is then K2c (K2c-lse under grad).
``TextEncoder(remat=True)`` recomputes each block's forward in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat``). The decode
side (``EncoderBlock.decode_step``, ``prefill``, ``decode_window`` and the
``TextEncoder`` methods around them) keeps per-block KV caches
``[B, H, L, hd]`` that it writes in place at the current position (the JAX
package returns new caches instead); ``dl.generate`` and the paged engine
(``serving/llm.py``) run on it.

``TextEncoderFeaturizer`` wraps the encoder as a pipeline stage: token-id
rows → mean-pooled embeddings. The numerics follow the flax modules: weights
stored in f32 and cast to the compute dtype (bf16 by default) at each use,
LayerNorm in f32 with eps 1e-6, the tanh GELU, sinusoidal positions in
f32 cast to the compute dtype.

``modelName`` resolves a zoo entry through ``models.ModelDownloader`` (a
checkpoint must exist: no random init behind a pretrained name), and
``quantize=True`` embeds through ``models.quantize_text_encoder`` (int8
dense layers, dense attention only).

Sequence and tensor parallelism: an encoder whose attention is sequence-
sharded (ring or Ulysses over a mesh's ``sp`` axis) takes one rank's block
of the sequence, adds the sinusoidal positions of its global offset, and
sums the masked mean pool over the axis, so ``pooled`` is the whole
sequence's on every rank. Under a mesh in scope (``parallel.mesh_scope``;
the sharded train step enters one) with ``tp`` > 1, each block attends on
its rank's share of the heads and all-gathers the heads' outputs
(:func:`head_parallel`). ``constrain_activation`` marks the block
boundaries where the JAX package constrains activations.
"""

from __future__ import annotations

import copy
import functools
import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import ComplexParam, Param, Transformer, TypeConverters as TC
from ..core.contracts import HasInputCol, HasOutputCol
from ..device import resolve_device
from ..parallel.partition import (DtypePolicy, constrain_activation,
                                  register_partition_rules)
from ..parallel.ring_attention import blockwise_attention
from .flash_attention import flash_attention

SHARDED_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")

LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated to ±2


def _dense_attention(q, k, v, key_mask=None, causal: bool = False):
    """Dense attention: f32 scores, ``-inf`` masking (the key mask and,
    with ``causal``, keys after the row), NaN→0 for rows with no allowed
    key, ``p`` cast to v's dtype before the PV product."""
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    if causal:
        pos = torch.arange(q.shape[2], device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    if key_mask is not None or causal:
        # a fully-masked row: softmax over -inf is NaN; emit zeros like
        # the blockwise and flash accumulators
        p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _window_positions(pos, B: int, w: int, device) -> torch.Tensor:
    """[B, w] positions of a window starting at ``pos``: an int (every row)
    or a [B] tensor of per-row starts."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((B,), pos, device=device)
    return pos[:, None] + torch.arange(w, device=device)


def seq_shard(attention_fn):
    """``(mesh, axis)`` when ``attention_fn`` shards the sequence over a
    mesh axis of more than one rank (ring, Ulysses), else ``None``."""
    from ..parallel.mesh import axis_size
    mesh = getattr(attention_fn, "mesh", None)
    axis = getattr(attention_fn, "seq_axis", None)
    if mesh is None or axis is None or axis_size(mesh, axis) <= 1:
        return None
    return mesh, axis


def seq_offset(attention_fn, T: int) -> int:
    """The global position of this rank's first token (0 unsharded)."""
    from ..parallel.mesh import axis_rank
    shard = seq_shard(attention_fn)
    return 0 if shard is None else axis_rank(*shard) * T


def seq_sum(x, attention_fn):
    """``x`` summed over the sequence-sharding axis (the identity
    unsharded): a sum over the whole sequence from each rank's part."""
    from ..parallel.collectives import allreduce
    shard = seq_shard(attention_fn)
    return x if shard is None else allreduce(x, shard[1], mesh=shard[0])


def head_parallel(attention_fn, q, k, v, key_mask):
    """``attention_fn`` on this rank's ``tp`` share of the heads, the
    heads' outputs all-gathered (the backward reduce-scatters), under the
    mesh in scope; the plain call without one or with ``tp`` = 1."""
    from ..parallel.collectives import allgather
    from ..parallel.mesh import axis_rank, axis_size, current_mesh
    mesh = current_mesh()
    n = 1 if mesh is None else axis_size(mesh, "tp")
    if n <= 1:
        return attention_fn(q, k, v, key_mask)
    H = q.shape[1]
    if H % n:
        raise ValueError(f"{H} heads do not divide over tp={n}")
    r, h = axis_rank(mesh, "tp"), H // n
    sl = slice(r * h, (r + 1) * h)
    o = attention_fn(q[:, sl], k[:, sl], v[:, sl], key_mask)
    return allgather(o, "tp", mesh=mesh, gather_axis=1)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)``: an f32 weight stored ``[out, in]`` (the
    flax kernel is ``[in, out]``) and bias; input, weight and bias are cast
    to the compute dtype, and the product and the bias add each round in
    it."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's Dense init: truncated lecun-normal weight, zero bias."""
        std = self.weight.shape[1] ** -0.5 / LECUN_TRUNC
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return (F.linear(x.to(self.dtype), self.weight.to(self.dtype))
                + self.bias.to(self.dtype))


def _layer_norm(width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=1e-6)      # flax's eps, not torch's 1e-5


class EncoderBlock(nn.Module):
    """Pre-LN block over an externally supplied attention fn
    (``fn(q, k, v, key_mask)``, [B,H,T,D]³ → [B,H,T,D]). ``key_mask``
    excludes padding keys from every softmax, so a row's output never
    depends on how far the batch was padded."""

    def __init__(self, heads: int, mlp_dim: int, width: int,
                 attention_fn: Callable = _dense_attention,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.heads, self.mlp_dim, self.width = heads, mlp_dim, width
        self.attention_fn = attention_fn
        self.dtype = dtype
        self.ln_1 = _layer_norm(width)
        self.qkv = Dense(width, 3 * width, dtype)
        self.out = Dense(width, width, dtype)
        self.ln_2 = _layer_norm(width)
        self.mlp_1 = Dense(width, mlp_dim, dtype)
        self.mlp_2 = Dense(mlp_dim, width, dtype)

    def _project_qkv(self, x):
        """ln_1 → fused qkv projection → per-head split. [B, T, W] → q, k,
        v [B, H, T, hd], strided views of the one projection output."""
        hd = self.width // self.heads
        h = self.ln_1(x.float()).to(self.dtype)
        qkv = self.qkv(h)
        B, T = qkv.shape[:2]
        return tuple(a.view(B, T, self.heads, hd).transpose(1, 2)
                     for a in qkv.split(self.width, dim=-1))

    def _merge_out(self, o):
        """Head merge + output projection ([B, H, T, hd] → [B, T, W])."""
        B, H, T, D = o.shape
        o = o.transpose(1, 2).reshape(B, T, self.width)
        return self.out(o.to(self.dtype))

    def attend(self, x, key_mask=None):
        """The attention residual: x + out(attention(qkv(ln_1 x)))."""
        q, k, v = self._project_qkv(x)
        return x + self._merge_out(
            head_parallel(self.attention_fn, q, k, v, key_mask))

    def pre_ffn_norm(self, x):
        """ln_2 alone."""
        return self.ln_2(x.float())

    def ffn(self, x):
        """The dense feed-forward residual."""
        h = self.mlp_1(self.ln_2(x.float()))
        h = F.gelu(h, approximate="tanh")         # flax nn.gelu's default
        return x + self.mlp_2(h)

    def forward(self, x, key_mask=None):
        return self.ffn(self.attend(x, key_mask))

    def decode_step(self, x_tok, k_cache, v_cache, pos: int):
        """One cached decode step: ``x_tok`` [B, 1, W] at position ``pos``;
        this position's k/v are written into the caches [B, H, L, hd] in
        place, and attention runs over cache entries ``<= pos`` (the
        causal row) with the dense formulation. Returns y [B, 1, W]."""
        return self.decode_window(x_tok, k_cache, v_cache, pos)

    def prefill(self, x):
        """The whole prefix [B, P, W] in one forward through the block's own
        ``attention_fn`` (causal for an LM; K2c with ``pallas``). Returns
        ``(y [B, P, W], k, v [B, H, P, hd])`` to seed the caches."""
        q, k, v = self._project_qkv(x)
        o = self.attention_fn(q, k, v, None)
        return self.ffn(x + self._merge_out(o)), k, v

    def decode_window(self, x_win, k_cache, v_cache, pos):
        """``decode_step`` over a window ``x_win`` [B, w, W] at positions
        ``[pos, pos + w)``: the window's k/v are written into the caches in
        place and row i attends cache entries ``<= pos + i`` (f32 scores,
        ``-inf`` outside, softmax, NaN→0, ``p`` in v's dtype: the JAX
        ``decode_window``'s formulation). ``pos`` is an int, or a [B] int64
        tensor of per-row starts (the JAX engine's ``vmap`` of this method
        over rows: the dense re-gather mode); rows of a window that reach
        past the cache are padding, and their k/v land in its last entry.
        Returns y [B, w, W]."""
        q, k, v = self._project_qkv(x_win)            # [B, H, w, hd]
        L = k_cache.shape[2]
        at = _window_positions(pos, *x_win.shape[:2], x_win.device)  # [B, w]
        b = torch.arange(x_win.shape[0], device=x_win.device)[:, None]
        put = at.clamp_max(L - 1)
        k_cache[b, :, put] = k.transpose(1, 2)
        v_cache[b, :, put] = v.transpose(1, 2)
        keys = torch.arange(L, device=x_win.device)
        hidden = (keys > at[..., None])[:, None]                  # [B,1,w,L]
        scale = (self.width // self.heads) ** -0.5
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         k_cache.float()) * scale
        s = s.masked_fill(hidden, float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache)
        return self.ffn(x_win + self._merge_out(o))


class TextEncoder(nn.Module):
    """Token ids [N, T] → ``{"tokens": [N, T, W] f32, "pooled": [N, W]
    f32}``; ``pooled`` is the masked mean over non-pad tokens (pad id 0).

    Parameter names follow the flax module's (``embed``, ``block{i}`` with
    ``ln_1``/``qkv``/``out``/``ln_2``/``mlp_1``/``mlp_2``, final ``ln``);
    ``models.convert.text_encoder_from_flax`` carries its weights across.
    A fresh module draws its weights from ``generator`` with flax's
    initialisers (truncated lecun-normal Dense kernels, zero biases,
    LayerNorm 1/0, embedding normal with std W^-½): the same distributions
    as the JAX package, not the same bits.

    ``remat=True`` is the JAX module's ``nn.remat(EncoderBlock)``: under
    grad each block runs through ``torch.utils.checkpoint`` (non-reentrant),
    so its activations are recomputed in the backward instead of stored; the
    block's attention forward then runs twice a step (with ``pallas``, two
    lse-forward launches per block). The function computed, and its
    gradients, are the same."""

    def __init__(self, vocab: int = 32768, width: int = 256, depth: int = 4,
                 heads: int = 8, mlp_dim: int = 1024,
                 attention_fn: Callable = _dense_attention,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 remat: bool = False):
        super().__init__()
        self.vocab, self.width, self.depth = vocab, width, depth
        self.remat = remat
        self.heads, self.mlp_dim = heads, mlp_dim
        self.attention_fn = attention_fn
        self.dtype = dtype
        self.embed = nn.Embedding(vocab, width)
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                heads, mlp_dim, width, attention_fn=attention_fn,
                dtype=dtype))
        self.ln = _layer_norm(width)
        self.reset_parameters(generator)

    @property
    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.normal_(self.embed.weight, 0.0, self.width ** -0.5,
                        generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def with_attention(self, attention_fn: Callable) -> "TextEncoder":
        """A copy with the same weights that runs ``attention_fn``
        (attention has no parameters)."""
        new = copy.deepcopy(self)
        new.attention_fn = attention_fn
        for block in new.blocks:
            block.attention_fn = attention_fn
        return new

    def positions(self, pos):
        """The sinusoidal encoding of positions ``pos`` (any shape) →
        ``[..., W]``: ``concat(sin, cos)`` of ``pos / 10000^(2·dim/W)`` in
        f32, cast to the compute dtype."""
        dim = torch.arange(self.width // 2, dtype=torch.float32,
                           device=pos.device)
        ang = pos.float()[..., None] / 10000.0 ** (2 * dim / self.width)
        return torch.cat([torch.sin(ang), torch.cos(ang)],
                         dim=-1).to(self.dtype)

    def embed_ids(self, ids, offset: int = 0):
        """Embedding + fixed sinusoidal positions → [N, T, W] block input;
        ``offset`` is the global position of the first column."""
        pos = offset + torch.arange(ids.shape[1], device=ids.device)
        return self.embed(ids).to(self.dtype) + self.positions(pos)[None]

    def embed_token(self, tok, pos: int):
        """Single-position prologue for cached decoding: [B] token ids at
        position ``pos`` → [B, 1, W], the constants of ``embed_ids``."""
        return self.embed_window(tok[:, None], pos)

    def embed_window(self, toks, pos):
        """[B, w] token ids at positions ``[pos, pos + w)`` → [B, w, W];
        ``pos`` an int or a [B] tensor of per-row starts."""
        at = _window_positions(pos, *toks.shape, toks.device)
        return self.embed(toks).to(self.dtype) + self.positions(at)

    def decode_blocks(self, x_tok, caches, pos: int):
        """One position through every block with its KV caches (``caches``:
        a sequence of (k, v) ``[B, H, L, hd]`` per block, written in place).
        Returns the final-LN'd [B, 1, W] activation in f32."""
        return self.decode_window_blocks(x_tok, caches, pos)

    def decode_window_blocks(self, x_win, caches, pos):
        """A window [B, w, W] at positions ``[pos, pos + w)`` through every
        block (``EncoderBlock.decode_window``), caches written in place.
        Returns the final-LN'd [B, w, W] in f32."""
        for block, (kc, vc) in zip(self.blocks, caches):
            x_win = block.decode_window(x_win, kc, vc, pos)
        return self.ln(x_win.float())

    def prefill_caches(self, ids_prefix, caches):
        """Seed the caches for positions ``[0, P)`` with one batched causal
        forward over ``ids_prefix`` [B, P] (real tokens only in every row:
        no key mask). Writes the caches in place and returns them."""
        x = self.embed_ids(ids_prefix)
        P = ids_prefix.shape[1]
        for block, (kc, vc) in zip(self.blocks, caches):
            x, k, v = block.prefill(x)
            kc[:, :, :P] = k
            vc[:, :, :P] = v
        return caches

    def finalize(self, x, ids):
        """Final LN + masked mean pool over non-pad tokens, in f32 (over
        the whole sequence when it is sharded)."""
        x = self.ln(x.float())
        mask = (ids != 0).float()[..., None]
        total = seq_sum((x * mask).sum(1), self.attention_fn)
        count = seq_sum(mask.sum(1), self.attention_fn)
        return {"tokens": x, "pooled": total / count.clamp_min(1.0)}

    def forward(self, ids, train: bool = False):
        """``train`` is the JAX module's flag; the encoder has no dropout,
        so both modes compute the same function. With a sequence-sharding
        attention ``ids`` is this rank's block of the sequence."""
        x = constrain_activation(
            self.embed_ids(ids, seq_offset(self.attention_fn, ids.shape[1])),
            "TextEncoder")
        key_mask = ids != 0
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = (checkpoint(block, x, key_mask, use_reentrant=False)
                 if remat else block(x, key_mask))
            x = constrain_activation(x, "TextEncoder")
        return self.finalize(x, ids)


# Partition rules for TextEncoder, the JAX package's (text_encoder.py:
# 332-355) on the port's names: a torch weight is [out, in] where the flax
# kernel is [in, out], so each kernel spec reverses (the same layout after
# the converter's transpose). Vocab-sharded embedding, fused qkv and mlp_1
# column-parallel, out and mlp_2 row-parallel.
register_partition_rules("TextEncoder", [
    (r"embed/weight", ("tp", None)),
    (r"(ln_1|ln_2)/(weight|bias)", ()),
    (r"(^|/)ln/(weight|bias)", ()),
    (r"qkv/weight", ("tp", None)),
    (r"qkv/bias", ("tp",)),
    (r"out/weight", (None, "tp")),
    (r"out/bias", ()),
    (r"mlp_1/weight", ("tp", None)),
    (r"mlp_1/bias", ("tp",)),
    (r"mlp_2/weight", (None, "tp")),
    (r"mlp_2/bias", ()),
],
    dtype_policy=DtypePolicy(param_dtype="float32",
                             compute_dtype="bfloat16",
                             grad_accum_dtype="float32"),
    activation_spec=("dp",))


def _flash_fn(q, k, v, key_mask=None, *, causal: bool = False):
    return flash_attention(q, k, v, key_mask=key_mask, causal=causal)


def _blockwise_fn(q, k, v, key_mask=None, *, block_size: int = 512,
                  causal: bool = False):
    return blockwise_attention(q, k, v, block_size=block_size,
                               key_mask=key_mask, causal=causal)


def make_attention_fn(impl: str = "dense", block_size: int | None = None,
                      causal: bool = False, mesh=None,
                      axis: str = "sp") -> Callable:
    """Resolve an attention implementation by name: ``dense``, ``pallas``
    (the flash kernels, differentiable through the fused backward; the port
    sizes its own blocks, so ``block_size`` applies to ``blockwise`` only)
    or ``blockwise``. ``causal``: lower-triangular masking, for every
    implementation (``pallas`` then runs K2c without grad, and under grad
    the causal forward that saves the lse, K2c-lse, with the causal fused
    backward, K2d and K2e, so a causal LM trains through the kernels). The
    returned functions
    pickle, so a stage holding an encoder saves.

    ``ring``/``ring_flash`` and ``ulysses``/``ulysses_flash`` need ``mesh``
    (a ``DeviceMesh`` or a ``parallel.MeshSpec``) whose ``axis`` shards the
    sequence; the returned function takes one rank's ``[B, H, T/n, D]``
    blocks. ``_flash`` runs the kernels locally: a ring step's
    ``flash_attention_lse`` (K2b, K2c-lse when causal; K2d/K2e under grad),
    Ulysses' ``flash_attention`` on its heads (K2a, K2c when causal)."""
    if impl == "dense":
        return functools.partial(_dense_attention, causal=True) if causal \
            else _dense_attention
    if impl == "pallas":
        return functools.partial(_flash_fn, causal=True) if causal \
            else _flash_fn
    if impl == "blockwise":
        return functools.partial(_blockwise_fn,
                                 block_size=block_size or 512,
                                 causal=causal)
    if impl in ("ring", "ring_flash"):
        from ..parallel.ring_attention import make_ring_attention
        if mesh is None:
            raise ValueError("ring attention needs a mesh")
        return make_ring_attention(
            mesh, causal=causal, axis=axis,
            local_impl="flash" if impl == "ring_flash" else "blockwise")
    if impl in ("ulysses", "ulysses_flash"):
        from ..parallel.ulysses import make_ulysses_attention
        if mesh is None:
            raise ValueError("ulysses attention needs a mesh")
        return make_ulysses_attention(
            mesh, axis=axis, causal=causal, block_size=block_size,
            local_impl="flash" if impl == "ulysses_flash" else "blockwise")
    raise ValueError(f"unknown attention impl {impl!r}; expected "
                     "dense|pallas|blockwise|ring|ring_flash|ulysses|"
                     "ulysses_flash")


def _pooled(module, ids):
    return module(ids)["pooled"]


class TextEncoderFeaturizer(Transformer, HasInputCol, HasOutputCol):
    """Pipeline stage: tokenized text → pooled transformer embeddings
    ([n, W] float32), the port of the JAX package's stage with the same
    Params plus ``device``. Rows are token-id sequences padded to a
    multiple of ``seqChunk`` (pad id 0 is masked out of attention and the
    mean pool).

    Weights: ``model=`` a ``models.LoadedModel`` holding a port
    ``TextEncoder`` (``models.convert.text_encoder_from_flax`` brings the
    JAX package's weights across) or an ingested ``BertEncoder``
    (``models.convert.bert_encoder_from_torch``), rebuilt with the
    requested attention; or ``modelName=`` a zoo entry saved with
    ``models.save_converted`` (read by ``models.ModelDownloader``);
    otherwise drawn from ``torch.Generator().manual_seed(seed)`` with
    flax's initialiser distributions — not the JAX package's bits, so pass
    ``model=`` for the same embeddings in both packages. ``quantize=True``
    embeds a plain ``TextEncoder`` through ``models.quantize_text_encoder``
    (dense attention only; ``pallas`` or ``blockwise`` raise).

    ``mesh`` (a ``DeviceMesh`` or a ``parallel.MeshSpec`` over the process
    group; runtime wiring, not saved): every rank of the mesh transforms
    the same frame. Rows pad to a multiple of the ``dp`` size with pad id
    0 and each rank embeds the rows of its ``dp`` coordinate; with
    ``sp`` > 1 the sequence stays sharded over ``sp`` (the attention must
    be a ring or Ulysses one, built over the mesh); the pooled rows are
    all-gathered over ``dp`` and the padding rows dropped, so every rank
    returns the whole frame's features.
    """

    attentionImpl = Param("attentionImpl",
                          "dense|pallas|blockwise|ring|ring_flash|ulysses|"
                          "ulysses_flash",
                          TC.toString, default="dense", has_default=True)
    seqChunk = Param("seqChunk", "pad sequence length to a multiple of "
                     "this (ring/ulysses need the sp-axis size to "
                     "divide T)", TC.toInt, default=128, has_default=True)
    vocabSize = Param("vocabSize", "embedding vocabulary", TC.toInt,
                      default=32768, has_default=True)
    width = Param("width", "model width", TC.toInt, default=256,
                  has_default=True)
    depth = Param("depth", "encoder blocks", TC.toInt, default=4,
                  has_default=True)
    heads = Param("heads", "attention heads (must divide width)",
                  TC.toInt, default=8, has_default=True)
    seed = Param("seed", "init seed", TC.toInt, default=0,
                 has_default=True)
    model = ComplexParam(
        "model", "explicit LoadedModel text encoder — PRETRAINED "
        "weights; overrides the width/depth/… params with the loaded "
        "architecture", default=None, has_default=True)
    modelName = Param(
        "modelName", "zoo text-model name to resolve through "
        "ModelDownloader (empty = random init from the width/depth "
        "params)", TC.toString, default="", has_default=True)
    quantize = Param(
        "quantize", "embed through the int8 post-training-quantized "
        "path", TC.toBoolean, default=False, has_default=True)
    device = Param("device", "torch device: 'cuda' (default) or 'cpu'",
                   TC.toString, default="cuda")

    # class-level defaults: load_stage rebuilds stages without __init__
    _cache: tuple | None = None
    _mesh = None

    def __init__(self, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="tokens", outputCol="features")
        self._mesh = mesh

    def _encoder(self) -> tuple[Callable, torch.device]:
        """The embedding function (token ids on the device → pooled [N, W])
        and the device, built once per configuration."""
        dev = resolve_device(self.get("device"))
        loaded = self.get("model")
        if self._mesh is not None:
            from ..parallel.mesh import as_mesh
            self._mesh = as_mesh(self._mesh, dev.type)
        key = (dev, id(loaded), id(self._mesh), self.get("attentionImpl"),
               self.get("vocabSize"), self.get("width"), self.get("depth"),
               self.get("heads"), self.get("seed"), self.get("modelName"),
               self.get("quantize"),
               os.environ.get("MMLSPARK_TPU_MODEL_DIR", ""))
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1], dev
        impl = self.get("attentionImpl")
        attn = make_attention_fn(
            impl, mesh=self._mesh if impl in SHARDED_IMPLS else None)
        if loaded is None and self.get("modelName"):
            from ..models.zoo import ModelDownloader
            # an explicitly named zoo model fails loudly without its
            # checkpoint: random weights behind a pretrained name would
            # quietly drop quality to the random-init floor
            loaded = ModelDownloader().download_by_name(
                self.get("modelName"), allow_random_init=False)
        if loaded is not None:
            from .bert import BertEncoder       # bert imports this module
            if not isinstance(loaded.module, (TextEncoder, BertEncoder)):
                raise TypeError(
                    f"model {getattr(loaded.schema, 'name', '?')!r} is not "
                    "a text encoder (register text entries with "
                    "models.register_text_encoder)")
            # the loaded architecture (a TextEncoder or an ingested
            # BertEncoder), same weights, requested attention
            module = loaded.module.with_attention(attn)
        else:
            width, heads = self.get("width"), self.get("heads")
            if width % (2 * heads) != 0:
                raise ValueError(
                    f"width={width} must be a multiple of 2*heads "
                    f"(heads={heads}): heads split the width and the "
                    "sinusoidal position encoding needs an even width")
            module = TextEncoder(
                vocab=self.get("vocabSize"), width=width, heads=heads,
                depth=self.get("depth"), attention_fn=attn,
                generator=torch.Generator().manual_seed(self.get("seed")))
        module = module.to(dev).eval()
        if self.get("quantize"):
            from ..models.quantize import quantize_text_encoder
            if type(module) is not TextEncoder:
                raise ValueError(
                    "quantize=True supports plain TextEncoder models only "
                    f"(got {type(module).__name__})")
            q_forward, qparams = quantize_text_encoder(module)
            embed = functools.partial(q_forward, qparams)
        else:
            embed = functools.partial(_pooled, module)
        self._cache = (key, embed)
        return embed, dev

    def _transform(self, df):
        embed, dev = self._encoder()
        rows = list(df[self.get("inputCol")])
        chunk = self.get("seqChunk")
        T = max((len(r) for r in rows), default=1)
        T = -(-T // chunk) * chunk
        ids = np.zeros((len(rows), T), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = np.asarray(r, np.int32)
        if self._mesh is not None:
            pooled = self._sharded(embed, ids, dev)
        else:
            with torch.inference_mode():
                pooled = embed(torch.from_numpy(ids).to(dev))
        return df.with_column(self.get("outputCol"),
                              pooled.float().cpu().numpy())

    def _sharded(self, embed, ids: np.ndarray, dev) -> torch.Tensor:
        """The pooled rows of ``ids`` over the mesh (class docstring)."""
        from ..parallel.collectives import allgather
        from ..parallel.mesh import axis_rank, axis_size
        from ..parallel.sharding import pad_rows, unpad_rows
        mesh, n_real = self._mesh, len(ids)
        dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
        if sp > 1 and self.get("attentionImpl") not in SHARDED_IMPLS:
            raise ValueError(
                f"a mesh with sp={sp} shards the sequence: attentionImpl "
                f"must be one of {SHARDED_IMPLS}, not "
                f"{self.get('attentionImpl')!r}")
        ids, _ = pad_rows(ids, dp, pad_value=0)
        rows = len(ids) // dp
        r = axis_rank(mesh, "dp")
        block = ids[r * rows:(r + 1) * rows]
        if sp > 1:
            if block.shape[1] % sp:
                raise ValueError(f"sequence length {block.shape[1]} must "
                                 f"divide by sp={sp} (seqChunk)")
            t = block.shape[1] // sp
            s = axis_rank(mesh, "sp")
            block = block[:, s * t:(s + 1) * t]
        with torch.inference_mode():
            pooled = embed(torch.from_numpy(np.ascontiguousarray(block))
                           .to(dev))
            pooled = allgather(pooled, "dp", mesh=mesh)
        return unpad_rows(pooled, n_real)
