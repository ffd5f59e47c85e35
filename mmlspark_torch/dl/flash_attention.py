"""K2a, K2b, K2c, K2d, K2e: the flash-attention kernels — CUDA, plain
versions, autograd, and switch.

The long-context encoder's hot op. The JAX package runs it as Pallas TPU
kernels in ``mmlspark_tpu/dl/pallas_attention.py``: the forward
``_flash_kernel`` (K2a, ``:77``, launched at ``:337``), the forward with the
row logsumexp ``_flash_kernel_lse`` (K2b, ``:126``, launched at ``:320``),
and the fused backward ``_bwd_dq_kernel`` (K2d, ``:350``, launched at
``:462``) and ``_bwd_dkv_kernel`` (K2e, ``:388``, launched at ``:483``),
behind the custom VJPs of ``flash_attention`` and ``flash_attention_lse``
(``:516-693``), and the causal forward ``_flash_kernel_causal_packed``
(K2c, ``:142``, launched at ``:297``, and with the lse at ``:285``) with
the causal branches of ``_flash_kernel`` (causal K2a), ``_flash_kernel_lse``
(causal K2b) and the backward kernels. Here:

- :func:`flash_cuda` (K2a), :func:`flash_lse_cuda` (K2b) and
  :func:`flash_causal_cuda` (K2c, which also stands for causal K2a: one
  kernel visits only the key tiles a q tile can reach) launch the
  hand-written Hopper forward in ``csrc/flash_attn.cu``; with
  ``causal=True`` :func:`flash_lse_cuda` is K2c with the lse (K2c-lse,
  which is also causal K2b);
  :func:`flash_dq_cuda` (K2d) and :func:`flash_dkv_cuda` (K2e) the backward
  in ``csrc/flash_bwd.cu``, causal or not; each is built with nvcc for
  ``sm_90a`` on first use and bound with ctypes (see the sources for their
  design and what bounds them), and each counts its launches
  (``.launches``), and the wrappers that take ``causal`` count their causal
  launches apart (``.causal_launches``);
- :func:`flash_torch`, :func:`flash_lse_torch`, :func:`flash_dq_torch`,
  :func:`flash_dkv_torch` and :func:`flash_bwd_torch` are the plain PyTorch
  versions: dense f32 scores with the kernels' masking and rounding points
  (the tests and the CPU route use them);
- :func:`flash_attention` and :func:`flash_attention_lse` are the switches:
  the kernels for CUDA tensors, the plain versions for CPU tensors. Under
  grad they run a ``torch.autograd.Function`` whose forward saves the lse
  (K2b, or K2c-lse when causal) and whose backward is K2d + K2e (causal
  when the forward was); without grad (e.g. under
  ``torch.inference_mode()``) ``flash_attention`` runs K2a or K2c alone. A
  build or launch failure raises; nothing falls back.

Contract: q/k/v ``[B, H, T, D]`` of one dtype (bf16 or f32), ``key_mask``
``[B, T]`` bool (True = valid, None = all valid) → ``[B, H, T, D]`` in v's
dtype. Invalid keys score ``-1e30`` (not ``-inf``), ``p`` is zeroed again
at invalid keys after ``exp``, the unnormalised ``p`` is cast to v's dtype
before the PV product, and the output is ``acc / max(l, 1e-35)``: a row
with no valid key is exactly 0, and its lse is ``-1e30``. The backward
recomputes ``p = exp(s - lse)`` (zeroed at invalid keys), ``ds = p·(dp -
dsum)·scale`` with ``dsum = Σ_d dO·o`` (minus ``dlse`` for the lse
variant), rounds ``ds`` to k's dtype for dq and to q's for dk and ``p`` to
dO's for dv, and sums in f32.

Causal: query row ``r`` sits at global position ``q_offset + r`` and key
``c`` at ``k_offset + c``; a pair is allowed iff the key is valid and
``k_offset + c <= q_offset + r``, masked as an invalid key is, in the
forward and the backward alike. As in the JAX package the offsets only
matter with ``causal=True``.

Head dims: the kernels of ``flash_attn.cu`` and ``flash_bwd.cu`` are built
for D = 32, 64, 128 and 256 in bf16 and up to 128 in f32 (the f32 kernels,
the tight check, keep their tiles in static shared memory). The wrappers
run any D: up to 256 at the next of those, above 256 at the next multiple
of :data:`WIDE_CHUNK` (:func:`kernel_head_dim`), zero-padding q, k, v (and
dO) on D (:func:`pad_head_dim`) and scaling by the true ``D^-0.5``; zero
columns leave every ``q·k`` unchanged and give zero output columns, which
are sliced off the outputs and the gradients. A head dim wider than the
widest instance built for its dtype (256 in bf16, :data:`F32_HEAD_DIM_MAX`
in f32) runs on the wide kernels of ``csrc/attn_wide.cu``, which split D
as :func:`wide_plan` says: into units of 128 columns in bf16 and 64 in f32,
two a CTA (bf16's K2e one), in a thread-block cluster that sums each CTA's
partial scores (up to :data:`WIDE_UNITS_MAX` units: D <= 2048 in bf16,
1024 in f32), and wider into chunks of :data:`WIDE_CHUNK` columns that
each recompute the scores (see the source). The reference pads every head dim to 128 lanes
the same way (``pallas_attention.py:19-21``). The plain versions take
``scale`` too, so the tests can hold the padding against the unpadded
computation on the CPU.

Tiles: the bf16 forward (K2a, K2b, K2c, K2c-lse) runs each head dim at
its default tile (:func:`forward_instances`: q tiles of :data:`BLOCK_Q`
rows, a key tile and a TMA ring depth that are template arguments of the
kernel), or, at D = 64, at one of :data:`TUNED_TILES`, built into a
library of their own (``csrc/flash_tuned.cu``) that a process with no
tuned winner never builds or loads. ``flash_cuda``, ``flash_lse_cuda`` and
``flash_causal_cuda`` take ``block_k=`` and ``stages=``; without them the
tiles come from ``perf.autotune``'s winner for the call's shape on the card
(``attn_key(T, D, causal)``), else the default (:func:`forward_tiles`),
the port of the reference's ``_resolve_blocks`` (``pallas_attention.py:
628-662``). An explicit tile that is not an instance raises ``ValueError``;
a winner that is not falls back to the default. The backward (K2d, K2e),
the f32 path and the wide route keep their own tiles.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..native.loader import CudaLoader
from ..obs.attribution import analytic_cost
from ..parallel.ring_attention import blockwise_attention
from ..perf import autotune as _autotune

HEAD_DIMS = (32, 64, 128, 256)   # the bf16 instances of the main kernels
F32_HEAD_DIM_MAX = 128    # the widest f32 instance (the tight check)
WIDE_CHUNK = 128          # the padding step above 256; the split chunk
WIDE_UNITS_MAX = 16       # units of a wide cluster (its CTAs: 8, or 16
                          # at one unit a CTA, the H100's largest)
NEG = -1e30               # the TPU kernel's additive mask value
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ALIGN = 16               # the kernels stage rows as 16-byte vectors
BWD_IMPLS = ("auto", "pallas", "blockwise")
BLOCK_Q = 128             # the bf16 forward's q tile: two warpgroups of 64
SMEM_MAX = 232448         # dynamic shared memory a CTA may opt into
TUNED_HEAD_DIM = 64       # the head dim of flash_tuned.cu's instances
# (key tile, ring stages) of flash_tuned.cu's instances, its TILE(...) list
TUNED_TILES = ((128, 3), (128, 2), (64, 4), (64, 3), (64, 2))

_FWD_HEADERS = ("dl/csrc/flash_common.cuh", "dl/csrc/flash_fwd.cuh",
                "dl/csrc/flash_dense.cuh")
_LOADER = CudaLoader("mmlspark_flash", ["dl/csrc/flash_attn.cu"],
                     headers=_FWD_HEADERS)
_LOADER_TUNED = CudaLoader("mmlspark_flash_tuned",
                           ["dl/csrc/flash_tuned.cu"], headers=_FWD_HEADERS)
_LOADER_BWD = CudaLoader("mmlspark_flash_bwd", ["dl/csrc/flash_bwd.cu"],
                         headers=("dl/csrc/flash_common.cuh",))
_LOADER_WIDE = CudaLoader("mmlspark_attn_wide", ["dl/csrc/attn_wide.cu"],
                          headers=("dl/csrc/flash_common.cuh",))

def _check_inputs(q, k, v, key_mask) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must all be [B, H, T, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if key_mask is not None:
        B, _, T, _ = q.shape
        if key_mask.shape != (B, T) or key_mask.dtype != torch.bool:
            raise ValueError(f"key_mask must be bool [B, T] = [{B}, {T}], "
                             f"got {key_mask.dtype} {tuple(key_mask.shape)}")
        if key_mask.device != q.device:
            raise ValueError(f"key_mask on {key_mask.device}, q on "
                             f"{q.device}")


def _check_rows(q, dout, lse, dsum) -> None:
    """The backward's extra inputs: dO like q, lse and dsum f32 [B, H, T]."""
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f"dO must match q ({q.dtype} {tuple(q.shape)} on "
                         f"{q.device}), got {dout.dtype} "
                         f"{tuple(dout.shape)} on {dout.device}")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{name} must be f32 {tuple(q.shape[:3])} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def kernel_head_dim(D: int) -> int:
    """The head dim the kernels run ``D`` at: the smallest of
    :data:`HEAD_DIMS` that holds it, and above 256 the next multiple of
    :data:`WIDE_CHUNK` (the reference pads to 128 lanes). There is no
    upper limit in code: the real one is memory (the padded q, k, v and
    their outputs, and K3's pools, at this width)."""
    for dim in HEAD_DIMS:
        if D <= dim:
            return dim
    return -(-D // WIDE_CHUNK) * WIDE_CHUNK


def wide_head_dim(D: int, dtype: torch.dtype) -> bool:
    """True when the kernel head dim ``D`` is wider than the widest
    instance built for ``dtype`` (256 in bf16, :data:`F32_HEAD_DIM_MAX` in
    f32): it then runs on the wide kernels, as :func:`wide_plan` says."""
    return D > (F32_HEAD_DIM_MAX if dtype == torch.float32
                else HEAD_DIMS[-1])


class WidePlan(NamedTuple):
    """How a wide kernel runs a kernel head dim: ``route`` "cluster" (D in
    ``units`` of ``unit`` columns, a consumer warpgroup each, in clusters
    of ``ctas`` CTAs that sum their partial scores) or "split" (``units``
    chunks of ``unit`` columns, each recomputing the scores; ``ctas`` 0).
    ``ctas`` is what the launcher is handed and launches."""
    route: str
    unit: int
    units: int
    ctas: int


@functools.lru_cache(maxsize=64)
def wide_plan(D: int, dtype: torch.dtype, kernel: str = "fwd") -> WidePlan:
    """The split of a kernel head dim ``D`` (a multiple of
    :data:`WIDE_CHUNK`) for the wide ``kernel`` ("fwd": K2a-K2c and K3's
    window, "dq": K2d, "dkv": K2e) in ``dtype``: units of one warpgroup's
    256 bytes a row (128 columns in bf16, 64 in f32) in a cluster while
    there are at most :data:`WIDE_UNITS_MAX` (D <= 2048 in bf16, 1024 in
    f32), two a CTA (bf16's K2e one: its dK and dV take a warpgroup's
    registers); wider, the split kernels in chunks of :data:`WIDE_CHUNK`
    columns."""
    unit = 64 if dtype == torch.float32 else 128
    units = D // unit
    if D % unit == 0 and units <= WIDE_UNITS_MAX:
        per_cta = 1 if kernel == "dkv" and dtype == torch.bfloat16 else 2
        return WidePlan("cluster", unit, units, -(-units // per_cta))
    return WidePlan("split", WIDE_CHUNK, D // WIDE_CHUNK, 0)


def pad_head_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with zero columns appended on its last axis up to ``dim`` (``t``
    itself when it is that wide already)."""
    return t if t.shape[-1] == dim else F.pad(t, (0, dim - t.shape[-1]))


def _unpad(t: torch.Tensor, D: int) -> torch.Tensor:
    """The first ``D`` columns of a kernel output (``t`` itself when it has
    no padding: indexing costs the host a few microseconds a call)."""
    return t if t.shape[-1] == D else t[..., :D]


# ------------------------------------------------------------ tiles

def default_tile(D: int) -> tuple[int, int]:
    """(key tile, ring stages) of the bf16 forward's default instance at
    kernel head dim D (``flash_fwd.cuh``'s ``default_bk``,
    ``default_stages``): 128 keys and 4 stages, 64 keys at D = 128, 32
    keys and 3 stages at D = 256."""
    return (32 if D == 256 else 64 if D == 128 else 128,
            3 if D == 256 else 4)


def forward_smem(D: int, block_k: int, stages: int) -> int:
    """Dynamic shared memory of the bf16 forward's CTA at this tile
    (``Tile::SMEM``): the swizzle slack, two Q buffers, the ring of K and V
    tiles, the stages' validity words and the barriers."""
    return (1024 + 2 * BLOCK_Q * D * 2 + stages * 2 * block_k * D * 2
            + stages * 16 + (2 * stages + 4) * 8)


def forward_instances(D: int, itemsize: int = 2) -> list[tuple]:
    """The (block_q, block_k, stages) tiles the forward is built at for
    kernel head dim D: in bf16 (``itemsize`` 2) the default
    (:func:`default_tile`) first, then at D = :data:`TUNED_HEAD_DIM`
    :data:`TUNED_TILES`; f32 and the wide head dims have their route's
    own tiles alone, ``(None, None, None)``."""
    if itemsize != 2 or D not in HEAD_DIMS:
        return [(None, None, None)]
    tiles = [default_tile(D)]
    if D == TUNED_HEAD_DIM:
        tiles += [t for t in TUNED_TILES
                  if forward_smem(D, *t) <= SMEM_MAX]
    return [(BLOCK_Q, bk, st) for bk, st in tiles]


@functools.lru_cache(maxsize=256)
def _instance(D: int, block_q, block_k, stages) -> tuple[int, int]:
    """The (key tile, stages) of the bf16 instance at D that these tiles
    name (``None``: the default's); raises ``ValueError`` for one that is
    not built."""
    bk0, st0 = default_tile(D)
    tile = (BLOCK_Q, bk0 if block_k is None else block_k,
            st0 if stages is None else stages)
    if block_q not in (None, BLOCK_Q) or tile not in forward_instances(D):
        raise ValueError(
            f"no bf16 forward instance at D = {D} with block_q {block_q}, "
            f"block_k {block_k}, stages {stages}: built are "
            f"{forward_instances(D)} (block_q, block_k, stages)")
    return tile[1:]


def forward_tiles(T: int, D: int, causal: bool = False,
                  block_k: int | None = None,
                  stages: int | None = None) -> tuple[int, int]:
    """The (key tile, ring stages) a bf16 forward launch at kernel head dim
    D runs with: the caller's, else ``perf.autotune``'s winner for
    ``attn_key(T, D, causal)`` on the card, else the default. An explicit
    tile that is not an instance raises ``ValueError``; a winner that is
    not gives the default."""
    return _autotune.resolve(
        "flash_attention", _autotune.attn_key(T, D, causal),
        lambda block_q, block_k, stages: _instance(D, block_q, block_k,
                                                   stages),
        block_q=None, block_k=block_k, stages=stages)


# ------------------------------------------------------------ plain versions

def _allowed(key_mask, T=None, causal=False, q_offset=0, k_offset=0,
             device=None):
    """The allowed (query, key) pairs, broadcastable to ``[B, H, T, T]``:
    the key mask, and with ``causal`` ``k_offset + c <= q_offset + r``;
    None when every pair is allowed."""
    allowed = None if key_mask is None else key_mask[:, None, None, :]
    if causal:
        pos = torch.arange(T, device=device)
        tri = (k_offset + pos)[None, :] <= (q_offset + pos)[:, None]
        allowed = tri if allowed is None else allowed & tri
    return allowed


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


# ------------------------------------------------- the kernels' own counts
# what obs.attribution counts for one call, on either route: the kernels'
# formulas over the allowed (query, key) pairs P (the bounds of PERF.md),
# with each input read once and each output written once

def allowed_pairs(q, key_mask=None, causal=False, q_offset=0,
                  k_offset=0) -> int:
    """The allowed (query, key) pairs over all heads: ``H x`` the pairs
    of the key mask (all keys without one) and, with ``causal``,
    ``k_offset + c <= q_offset + r``."""
    B, H, T, _ = q.shape
    valid = (torch.ones(B, T, dtype=torch.bool, device=q.device)
             if key_mask is None else key_mask.bool())
    if not causal:
        return H * T * int(valid.sum())
    m = torch.arange(T, device=q.device) + (int(k_offset) - int(q_offset))
    rows = (T - m.clamp(min=0)).clamp(min=0)      # rows r >= m of key c
    return H * int((valid * rows).sum())


def _tensor_bytes(q) -> int:
    return q.numel() * q.element_size()


def _mask_bytes(key_mask) -> int:
    return 0 if key_mask is None else key_mask.numel() * \
        key_mask.element_size()


def _cost_forward(lse: bool, causal_always: bool = False):
    """Forward (K2a/K2b/K2c/K2c-lse): 4·P·D, q, k, v and o (and the f32
    lse rows) moved once."""
    def cost(q, k, v, key_mask=None, *, causal=False, q_offset=0,
             k_offset=0, **_):
        pairs = allowed_pairs(q, key_mask, causal or causal_always,
                              q_offset, k_offset)
        rows = q.shape[0] * q.shape[1] * q.shape[2] * 4 if lse else 0
        return (4 * pairs * q.shape[-1],
                4 * _tensor_bytes(q) + rows + _mask_bytes(key_mask))
    return cost


def _cost_backward(dkv: bool):
    """K2d: 6·P·D, q, k, v, dO, dq and two f32 rows moved once; K2e:
    8·P·D, with dk and dv in place of dq."""
    def cost(q, k, v, key_mask, dout, lse, dsum, *, causal=False,
             q_offset=0, k_offset=0, **_):
        pairs = allowed_pairs(q, key_mask, causal, q_offset, k_offset)
        rows = q.shape[0] * q.shape[1] * q.shape[2] * 4
        return ((8 if dkv else 6) * pairs * q.shape[-1],
                (6 if dkv else 5) * _tensor_bytes(q) + 2 * rows
                + _mask_bytes(key_mask))
    return cost


def _plain_forward(q, k, v, key_mask, causal=False, q_offset=0,
                   k_offset=0, scale=None):
    """The forward in f32 all at once (one k-block of the TPU kernel): the
    output in v's dtype, the row max ``m`` and the row sum ``l``. ``scale``
    defaults to ``D^-0.5``."""
    _check_inputs(q, k, v, key_mask)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * _scale(q, scale)
    allowed = _allowed(key_mask, q.shape[2], causal, q_offset, k_offset,
                       q.device)
    if allowed is not None:
        s = torch.where(allowed, s, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-35)).to(v.dtype), m, l


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the layout its kernel hands back: a ``[B, H, T, D]`` view
    of a ``[B, T, H, kernel_head_dim(D)]`` buffer. The operations after a
    plain version are then those after its kernel, and a count of the
    program is the same on both routes."""
    B, H, T, D = t.shape
    buf = torch.empty(B, T, H, kernel_head_dim(D), dtype=t.dtype,
                      device=t.device)
    return _unpad(buf.permute(0, 2, 1, 3), D).copy_(t)


@analytic_cost(_cost_forward(False))
def flash_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: torch.Tensor | None = None, *,
                causal: bool = False, q_offset: int = 0,
                k_offset: int = 0, scale: float | None = None
                ) -> torch.Tensor:
    """Plain PyTorch K2a (and, with ``causal``, K2c): the whole score
    matrix in f32 at once, with the kernel's masking and casting (one
    k-block of the TPU kernel), in the kernel's output layout."""
    return _kernel_layout(_plain_forward(q, k, v, key_mask, causal,
                                         q_offset, k_offset, scale)[0])


@analytic_cost(_cost_forward(True))
def flash_lse_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None, *,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, scale: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2b (and, with ``causal``, K2c-lse):
    :func:`flash_torch`'s output and the f32 row logsumexp ``m + log(max(l,
    1e-35))`` ``[B, H, T]`` (``-1e30`` for a row with no allowed key)."""
    o, m, l = _plain_forward(q, k, v, key_mask, causal, q_offset, k_offset,
                             scale)
    return _kernel_layout(o), (m + torch.log(l.clamp_min(1e-35)))[..., 0]


def _plain_grads_of_scores(q, k, v, key_mask, dout, lse, dsum, causal=False,
                           q_offset=0, k_offset=0, scale=None):
    """``p = exp(s - lse)`` zeroed outside the allowed pairs (a select: at a
    masked pair the exp may be inf) and ``ds = p·(dp - dsum)·scale``, in
    f32."""
    _check_inputs(q, k, v, key_mask)
    _check_rows(q, dout, lse, dsum)
    scale = _scale(q, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    allowed = _allowed(key_mask, q.shape[2], causal, q_offset, k_offset,
                       q.device)
    if allowed is not None:
        p = torch.where(allowed, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, p * (dp - dsum[..., None]) * scale


@analytic_cost(_cost_backward(False))
def flash_dq_torch(q, k, v, key_mask, dout, lse, dsum, *,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0, scale: float | None = None
                   ) -> torch.Tensor:
    """Plain PyTorch K2d: ``dq = ds.astype(k) · k`` in q's dtype."""
    _, ds = _plain_grads_of_scores(q, k, v, key_mask, dout, lse, dsum,
                                   causal, q_offset, k_offset, scale)
    return _kernel_layout(torch.einsum("bhqk,bhkd->bhqd",
                                       ds.to(k.dtype).float(),
                                       k.float()).to(q.dtype))


@analytic_cost(_cost_backward(True))
def flash_dkv_torch(q, k, v, key_mask, dout, lse, dsum, *,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, scale: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2e: ``dk = ds.astype(q)ᵀ · q`` in k's dtype and
    ``dv = p.astype(dO)ᵀ · dO`` in v's dtype."""
    p, ds = _plain_grads_of_scores(q, k, v, key_mask, dout, lse, dsum,
                                   causal, q_offset, k_offset, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                      dout.float())
    return _kernel_layout(dk.to(k.dtype)), _kernel_layout(dv.to(v.dtype))


def flash_dsum(o: torch.Tensor, dout: torch.Tensor,
               dlse: torch.Tensor | None = None) -> torch.Tensor:
    """The backward's D-term ``Σ_d dO·o`` in f32 ``[B, H, T]``, minus the lse
    cotangent ``dlse`` for the lse variant (∂lse/∂s = p folds into it). Plain
    PyTorch beside the kernels, as the JAX package computes it in XLA."""
    dsum = (dout.float() * o.float()).sum(-1)
    if dlse is not None:
        dsum = dsum - dlse.float()
    return dsum.contiguous()


def flash_bwd_torch(q, k, v, key_mask, o, lse, dout, dlse=None, *,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, scale: float | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch fused backward (K2d + K2e) from the saved output and
    lse: ``(dq, dk, dv)``."""
    dsum = flash_dsum(o, dout, dlse)
    pos = dict(causal=causal, q_offset=q_offset, k_offset=k_offset,
               scale=scale)
    return (flash_dq_torch(q, k, v, key_mask, dout, lse, dsum, **pos),
            *flash_dkv_torch(q, k, v, key_mask, dout, lse, dsum, **pos))


# ------------------------------------------------------------- the kernels

# the launchers' ctypes argtypes, which the wide instances share
_c_void_p, _c_int, _c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [
    _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,  # q k v mask o
    _c_void_p,                                              # lse (K2b)
    _c_int, _c_int, _c_int, _c_int, _c_int,                 # dtype B H T D
    *[_c_ll] * 12,                                          # q/k/v/o strides
    _c_ll, ctypes.c_float,                              # mask stride, scale
    _c_int, _c_ll, _c_ll,                       # causal, q_offset, k_offset
    _c_int, _c_void_p]                                      # device, stream
# the wide launchers take wide_plan's CTAs (0: split) before the device
_WIDE_FWD_ARGS = [*_FWD_ARGS[:-2], _c_int, *_FWD_ARGS[-2:]]
# the tuned launcher: bf16 only (no dtype), the key tile and stages before
# the device
_TUNED_ARGS = [*_FWD_ARGS[:6], *_FWD_ARGS[7:-2], _c_int, _c_int,
               *_FWD_ARGS[-2:]]
_BWD_ARGS = [
    _c_int,                                                 # 0 = dq, 1 = dk/dv
    *[_c_void_p] * 10,                  # q k v dO mask lse dsum dq dk dv
    _c_int, _c_int, _c_int, _c_int, _c_int,                 # dtype B H T D
    ctypes.POINTER(_c_ll), _c_ll, ctypes.c_float,   # strides, mask, scale
    _c_int, _c_ll, _c_ll,                       # causal, q_offset, k_offset
    _c_int, _c_void_p]                                      # device, stream
_WIDE_BWD_ARGS = [*_BWD_ARGS[:-2], _c_int, *_BWD_ARGS[-2:]]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _LOADER.load()
    lib.mmlspark_flash_launch.argtypes = _FWD_ARGS
    lib.mmlspark_flash_launch.restype = _c_int
    lib.mmlspark_flash_error_string.argtypes = [_c_int]
    lib.mmlspark_flash_error_string.restype = ctypes.c_char_p
    lib.mmlspark_flash_design.argtypes = []
    lib.mmlspark_flash_design.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    lib = _LOADER_BWD.load()
    lib.mmlspark_flash_bwd_launch.argtypes = _BWD_ARGS
    lib.mmlspark_flash_bwd_launch.restype = _c_int
    lib.mmlspark_flash_bwd_error_string.argtypes = [_c_int]
    lib.mmlspark_flash_bwd_error_string.restype = ctypes.c_char_p
    lib.mmlspark_flash_bwd_design.argtypes = []
    lib.mmlspark_flash_bwd_design.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_tuned() -> ctypes.CDLL:
    lib = _LOADER_TUNED.load()
    lib.mmlspark_flash_tuned_launch.argtypes = _TUNED_ARGS
    lib.mmlspark_flash_tuned_launch.restype = _c_int
    lib.mmlspark_flash_tuned_error_string.argtypes = [_c_int]
    lib.mmlspark_flash_tuned_error_string.restype = ctypes.c_char_p
    return lib


def build_kernel() -> str:
    """Build (if needed) and load K2a/K2b/K2c; returns nvcc's output for the
    build (registers, shared memory, spills), or "" if it was built
    earlier."""
    _library()
    return _LOADER.build_log()


def build_tuned_kernel() -> str:
    """Build (if needed) and load the forward's tuned instances
    (``csrc/flash_tuned.cu``); returns nvcc's output as
    :func:`build_kernel` does."""
    _library_tuned()
    return _LOADER_TUNED.build_log()


def kernel_design() -> str:
    """One line on the bf16 forward's design (CTA shape, tiles, ring
    stages, shared memory, register split), from the built library."""
    return _library().mmlspark_flash_design().decode()


@functools.lru_cache(maxsize=None)
def _library_wide() -> ctypes.CDLL:
    lib = _LOADER_WIDE.load()
    lib.mmlspark_wide_flash_launch.argtypes = _WIDE_FWD_ARGS
    lib.mmlspark_wide_bwd_launch.argtypes = _WIDE_BWD_ARGS
    lib.mmlspark_wide_paged_launch.argtypes = [
        *[_c_void_p] * 6, *[_c_int] * 8, *[_c_ll] * 6, ctypes.c_float,
        _c_int, _c_int, _c_void_p]          # ..., scale, ctas, device
    for fn in (lib.mmlspark_wide_flash_launch, lib.mmlspark_wide_bwd_launch,
               lib.mmlspark_wide_paged_launch):
        fn.restype = _c_int
    lib.mmlspark_wide_error_string.argtypes = [_c_int]
    lib.mmlspark_wide_error_string.restype = ctypes.c_char_p
    return lib


def build_wide_kernel() -> str:
    """Build (if needed) and load the wide-head-dim instances
    (``csrc/attn_wide.cu``); returns nvcc's output as
    :func:`build_kernel` does."""
    _library_wide()
    return _LOADER_WIDE.build_log()


def build_bwd_kernel() -> str:
    """Build (if needed) and load K2d/K2e; returns nvcc's output as
    :func:`build_kernel` does."""
    _library_bwd()
    return _LOADER_BWD.build_log()


def kernel_bwd_design() -> str:
    """One line on the bf16 backward's design, as :func:`kernel_design`."""
    return _library_bwd().mmlspark_flash_bwd_design().decode()


def _check_layout(name: str, t: torch.Tensor) -> None:
    """Unit stride on D and 16-byte-aligned rows: what the kernels' vector
    loads need. Strided views (the split of a fused qkv projection) pass;
    nothing is copied to make a tensor fit."""
    if not _fits_layout(t):
        raise ValueError(f"{name} needs unit stride on D and rows that "
                         f"start on {_ALIGN}-byte boundaries, got strides "
                         f"{t.stride()} with {t.element_size()}-byte "
                         "elements")


def _fits_layout(t: torch.Tensor) -> bool:
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % _ALIGN == 0
            and not any(s * size % _ALIGN for s in t.stride()[:3]))


def _check_kernel_inputs(fn: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {q.device}; use the "
                         "plain version (or the flash_attention switch) for "
                         "CPU tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} takes bf16 or f32, got {q.dtype}")
    D = q.shape[-1]
    if D == kernel_head_dim(D):  # padded tensors are laid out afresh
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_layout(name, t)


def _heads_last(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A ``[B, H, T, D]`` view of a new ``[B, T, H, D]`` buffer: the head
    merge after attention (or the qkv split's backward) is then free."""
    B, H, T, D = q.shape
    return torch.empty(B, T, H, D, dtype=dtype,
                       device=q.device).permute(0, 2, 1, 3)


def _mask_arg(key_mask, T):
    """The kernels' mask pointer and batch stride ([B, T] bytes)."""
    if key_mask is None:
        return None, T
    mask = key_mask.contiguous()
    return mask, mask.stride(0)


def _wide_ctas(wide: bool, D: int, dtype: torch.dtype,
               kernel: str = "fwd") -> tuple:
    """The wide launchers' extra argument: :func:`wide_plan`'s CTAs of a
    cluster (0: the split kernels); none for the built instances."""
    return (wide_plan(D, dtype, kernel).ctas,) if wide else ()


def _error_string(lib, wide: bool, err: int, bwd: bool = False) -> str:
    fn = (lib.mmlspark_wide_error_string if wide
          else lib.mmlspark_flash_bwd_error_string if bwd
          else lib.mmlspark_flash_error_string)
    return fn(err).decode()


def _launch_forward(fn: str, q, k, v, key_mask, with_lse: bool,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, block_k: int | None = None,
                    stages: int | None = None):
    _check_inputs(q, k, v, key_mask)
    _check_kernel_inputs(fn, q, k, v)
    D = q.shape[-1]
    Dk = kernel_head_dim(D)
    wide = wide_head_dim(Dk, q.dtype)
    tiled = q.dtype == torch.bfloat16 and not wide
    if not tiled and (block_k is not None or stages is not None):
        raise ValueError(f"{fn}: block_k and stages pick a bf16 forward "
                         f"instance; {q.dtype} at head dim {Dk} runs its "
                         "route's own tiles")
    q, k, v = (pad_head_dim(t, Dk) for t in (q, k, v))
    B, H, T, _ = q.shape
    tile = (forward_tiles(T, Dk, causal, block_k, stages) if tiled
            else None)
    out = _heads_last(q, v.dtype)
    lse = (torch.empty(B, H, T, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if T == 0 or B * H == 0:
        return _unpad(out, D), lse
    mask, mask_sb = _mask_arg(key_mask, T)
    tuned = tile is not None and tile != default_tile(Dk)
    lib = (_library_wide() if wide else _library_tuned() if tuned
           else _library())
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    rest = (B, H, T, Dk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], mask_sb, D ** -0.5, int(causal),
            int(q_offset), int(k_offset))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if tuned:
        err = lib.mmlspark_flash_tuned_launch(*args, *rest, *tile,
                                              q.device.index, stream)
    else:
        launch = (lib.mmlspark_wide_flash_launch if wide
                  else lib.mmlspark_flash_launch)
        err = launch(*args, _DTYPE_CODES[q.dtype], *rest,
                     *_wide_ctas(wide, Dk, q.dtype), q.device.index, stream)
    if err != 0:
        kid = ("K2c-lse" if with_lse else "K2c") if causal else \
            "K2b" if with_lse else "K2a"
        where = (" (wide head dim)" if wide else
                 f" (tuned instance block_k {tile[0]}, stages {tile[1]})"
                 if tuned else "")
        message = (lib.mmlspark_flash_tuned_error_string(err).decode()
                   if tuned else _error_string(lib, wide, err))
        raise RuntimeError(f"{kid} flash-attention kernel launch failed"
                           f"{where}: {message} (cudaError {err})")
    return _unpad(out, D), lse


@analytic_cost(_cost_forward(False))
def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_mask: torch.Tensor | None = None, *,
               block_k: int | None = None,
               stages: int | None = None) -> torch.Tensor:
    """Launch K2a (``csrc/flash_attn.cu``) on PyTorch's current stream: the
    forward alone, with no autograd graph (:func:`flash_attention` takes the
    autograd Function under grad). Raises for tensors that are not on a
    CUDA device, for a dtype other than bf16/f32, and when the kernel does
    not build or launch. Other head dims run zero-padded to
    :func:`kernel_head_dim`, and those wider than the built instances on
    the wide ones (split over D). ``block_k`` and ``stages`` pick the bf16
    instance (:func:`forward_tiles`: else the tuned winner, else the
    default).

    Returns a ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer, so the
    caller's head merge is a free reshape."""
    out, _ = _launch_forward("flash_cuda", q, k, v, key_mask, False,
                             block_k=block_k, stages=stages)
    flash_cuda.launches += 1
    return out


flash_cuda.launches = 0


def _count(wrapper, causal: bool) -> None:
    """One launch on ``wrapper``'s causal or non-causal counter."""
    if causal:
        wrapper.causal_launches += 1
    else:
        wrapper.launches += 1


@analytic_cost(_cost_forward(True))
def flash_lse_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor | None = None, *,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0, block_k: int | None = None,
                   stages: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2b, or with ``causal`` K2c-lse (K2c's kernel with the lse
    flag, which also stands for causal K2b): :func:`flash_cuda`'s or
    :func:`flash_causal_cuda`'s output and the f32 row logsumexp
    ``[B, H, T]`` (contiguous), which the fused backward reads. Counts
    non-causal launches in ``.launches`` and causal ones in
    ``.causal_launches``. ``block_k``/``stages`` as :func:`flash_cuda`."""
    out, lse = _launch_forward("flash_lse_cuda", q, k, v, key_mask, True,
                               causal, q_offset, k_offset, block_k, stages)
    _count(flash_lse_cuda, causal)
    return out, lse


flash_lse_cuda.launches = flash_lse_cuda.causal_launches = 0


@analytic_cost(_cost_forward(False, causal_always=True))
def flash_causal_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor | None = None, *,
                      q_offset: int = 0, k_offset: int = 0,
                      block_k: int | None = None,
                      stages: int | None = None) -> torch.Tensor:
    """Launch K2c (``csrc/flash_attn.cu``, K2a's kernel with the causal
    flag): the causal forward with global positions ``q_offset + r`` and
    ``k_offset + c``, each q tile visiting only the key tiles it can reach.
    No autograd graph. Raises as :func:`flash_cuda` does. Counts its own
    launches, apart from K2a's. ``block_k``/``stages`` as
    :func:`flash_cuda`."""
    out, _ = _launch_forward("flash_causal_cuda", q, k, v, key_mask, False,
                             True, q_offset, k_offset, block_k, stages)
    flash_causal_cuda.launches += 1
    return out


flash_causal_cuda.launches = 0


def _launch_backward(fn: str, dkv: bool, q, k, v, key_mask, dout, lse,
                     dsum, causal=False, q_offset=0, k_offset=0):
    """Launch K2d (``dkv=False``: returns dq) or K2e (returns dk, dv),
    causal on the global positions ``q_offset + r``, ``k_offset + c``. A
    dO without unit stride on D or with unaligned rows (an incoming
    gradient may have any strides) is copied to a contiguous buffer
    first; q/k/v must fit as they are."""
    _check_inputs(q, k, v, key_mask)
    _check_rows(q, dout, lse, dsum)
    _check_kernel_inputs(fn, q, k, v)
    D = q.shape[-1]
    Dk = kernel_head_dim(D)
    q, k, v, dout = (pad_head_dim(t, Dk) for t in (q, k, v, dout))
    if not _fits_layout(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    lse, dsum = lse.contiguous(), dsum.contiguous()
    B, H, T, _ = q.shape
    outs = ((_heads_last(k, k.dtype), _heads_last(v, v.dtype)) if dkv
            else (_heads_last(q, q.dtype),))
    if T == 0 or B * H == 0:
        return tuple(_unpad(t, D) for t in outs)
    dq, dk, dv = (None, *outs) if dkv else (outs[0], None, None)
    mask, mask_sb = _mask_arg(key_mask, T)
    strides = [s for t in (q, k, v, dout, dq, dk, dv)
               for s in (t.stride()[:3] if t is not None else (0, 0, 0))]
    wide = wide_head_dim(Dk, q.dtype)
    lib = _library_wide() if wide else _library_bwd()
    launch = (lib.mmlspark_wide_bwd_launch if wide
              else lib.mmlspark_flash_bwd_launch)
    err = launch(
        int(dkv), q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        None if mask is None else mask.data_ptr(), lse.data_ptr(),
        dsum.data_ptr(), *(None if t is None else t.data_ptr()
                           for t in (dq, dk, dv)),
        _DTYPE_CODES[q.dtype], B, H, T, Dk,
        (ctypes.c_longlong * 21)(*strides), mask_sb, D ** -0.5,
        int(causal), int(q_offset), int(k_offset),
        *_wide_ctas(wide, Dk, q.dtype, "dkv" if dkv else "dq"),
        q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{'causal ' if causal else ''}{'K2e' if dkv else 'K2d'} "
            "flash-attention backward kernel launch failed"
            f"{' (wide head dim)' if wide else ''}: "
            f"{_error_string(lib, wide, err, bwd=True)} (cudaError {err})")
    return tuple(_unpad(t, D) for t in outs)


@analytic_cost(_cost_backward(False))
def flash_dq_cuda(q, k, v, key_mask, dout, lse, dsum, *,
                  causal: bool = False, q_offset: int = 0,
                  k_offset: int = 0) -> torch.Tensor:
    """Launch K2d (``csrc/flash_bwd.cu``; causal K2d with ``causal``): dq
    in q's dtype, as a ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer.
    Counts as :func:`flash_lse_cuda` does."""
    (dq,) = _launch_backward("flash_dq_cuda", False, q, k, v, key_mask,
                             dout, lse, dsum, causal, q_offset, k_offset)
    _count(flash_dq_cuda, causal)
    return dq


flash_dq_cuda.launches = flash_dq_cuda.causal_launches = 0


@analytic_cost(_cost_backward(True))
def flash_dkv_cuda(q, k, v, key_mask, dout, lse, dsum, *,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2e (``csrc/flash_bwd.cu``; causal K2e with ``causal``): dk
    and dv in k's and v's dtypes, as ``[B, H, T, D]`` views of
    ``[B, T, H, D]`` buffers. Counts as :func:`flash_lse_cuda` does."""
    dk, dv = _launch_backward("flash_dkv_cuda", True, q, k, v, key_mask,
                              dout, lse, dsum, causal, q_offset, k_offset)
    _count(flash_dkv_cuda, causal)
    return dk, dv


flash_dkv_cuda.launches = flash_dkv_cuda.causal_launches = 0


def flash_bwd_cuda(q, k, v, key_mask, o, lse, dout, dlse=None, *,
                   causal: bool = False, q_offset: int = 0,
                   k_offset: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward on the card: ``dsum`` in plain PyTorch, then K2d
    and K2e. Returns ``(dq, dk, dv)``."""
    dsum = flash_dsum(o, dout, dlse)
    pos = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    return (flash_dq_cuda(q, k, v, key_mask, dout, lse, dsum, **pos),
            *flash_dkv_cuda(q, k, v, key_mask, dout, lse, dsum, **pos))


# ----------------------------------------------------------------- autograd

class _Flash(torch.autograd.Function):
    """``flash_attention`` under grad. ``bwd_impl`` ``"auto"``/``"pallas"``:
    the forward runs K2b (K2c-lse when causal) and saves the output and the
    lse, the backward is K2d + K2e (the plain versions for CPU tensors).
    ``"blockwise"``: the forward runs K2a (K2c when causal) and the backward
    is autograd through ``blockwise_attention`` from q, k, v with the same
    causal mask and offsets (the JAX package's recompute backward).
    ``pos`` holds ``causal``, ``q_offset`` and ``k_offset``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, use_cuda, bwd_impl, pos):
        ctx.use_cuda, ctx.bwd_impl, ctx.pos = use_cuda, bwd_impl, pos
        if bwd_impl == "blockwise":
            o = _forward(q, k, v, key_mask, use_cuda, pos)
            ctx.save_for_backward(q, k, v, key_mask)
            return o
        o, lse = (flash_lse_cuda if use_cuda else flash_lse_torch)(
            q, k, v, key_mask, **pos)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        if ctx.bwd_impl == "blockwise":
            q, k, v, key_mask = ctx.saved_tensors
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = blockwise_attention(*leaves, key_mask=key_mask,
                                          **ctx.pos)
                grads = torch.autograd.grad(out, leaves, dout)
            return (*grads, None, None, None, None)
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        bwd = flash_bwd_cuda if ctx.use_cuda else flash_bwd_torch
        return (*bwd(q, k, v, key_mask, o, lse, dout, **ctx.pos), None,
                None, None, None)


class _FlashLse(torch.autograd.Function):
    """``flash_attention_lse`` under grad: K2b (K2c-lse when causal)
    forward, K2d + K2e backward with the lse cotangent folded into
    ``dsum``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, use_cuda, pos):
        ctx.use_cuda, ctx.pos = use_cuda, pos
        o, lse = (flash_lse_cuda if use_cuda else flash_lse_torch)(
            q, k, v, key_mask, **pos)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        bwd = flash_bwd_cuda if ctx.use_cuda else flash_bwd_torch
        return (*bwd(q, k, v, key_mask, o, lse, dout, dlse, **ctx.pos),
                None, None, None)


def _forward(q, k, v, key_mask, use_cuda, pos):
    """The forward alone: K2a, or K2c with ``pos["causal"]`` (their plain
    versions for ``use_cuda=False``)."""
    if not use_cuda:
        return flash_torch(q, k, v, key_mask, **pos)
    if pos["causal"]:
        return flash_causal_cuda(q, k, v, key_mask,
                                 q_offset=pos["q_offset"],
                                 k_offset=pos["k_offset"])
    return flash_cuda(q, k, v, key_mask)


def _positions(causal, q_offset, k_offset) -> dict:
    """The causal flag and offsets the kernels take; without ``causal``
    the offsets are ignored, as in the JAX package."""
    if not causal:
        return dict(causal=False, q_offset=0, k_offset=0)
    return dict(causal=True, q_offset=int(q_offset), k_offset=int(k_offset))


def _route(q, impl) -> bool:
    """True for the kernels, False for the plain versions."""
    if impl is None:
        return q.device.type == "cuda"
    if impl not in ("cuda", "torch"):
        raise ValueError(f"impl must be None, 'cuda' or 'torch', got "
                         f"{impl!r}")
    if impl == "cuda" and q.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {q.device}")
    return impl == "cuda"


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None, *,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, impl: str | None = None,
                    bwd_impl: str = "auto") -> torch.Tensor:
    """Fused flash attention, the port of ``pallas_attention.flash_attention``.
    q/k/v ``[B, H, T, D]``; ``key_mask`` ``[B, T]`` bool (True = valid).
    ``impl=None`` takes the kernels (``"cuda"``) for CUDA tensors and the
    plain versions (``"torch"``) for CPU tensors; ``impl="cuda"`` on CPU
    tensors raises; ``impl="torch"`` runs the plain versions on any device.

    Without grad this is K2a, or with ``causal=True`` K2c (lower-triangular
    masking on the global positions ``q_offset + r``, ``k_offset + c``;
    the offsets are ignored without ``causal``, as in the JAX package).
    Under grad it is an autograd Function: ``bwd_impl`` ``"auto"`` or
    ``"pallas"`` save the lse in the forward (K2b, or K2c-lse when causal)
    and run the fused backward (K2d, K2e, causal when the forward is);
    ``"blockwise"`` runs the forward alone (K2a or K2c) and autograd through
    ``blockwise_attention`` with the same mask and offsets backward."""
    use_cuda = _route(q, impl)
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl={bwd_impl!r} is not one of "
                         f"{'|'.join(BWD_IMPLS)}")
    pos = _positions(causal, q_offset, k_offset)
    if _needs_grad(q, k, v):
        return _Flash.apply(q, k, v, key_mask, use_cuda, bwd_impl, pos)
    return _forward(q, k, v, key_mask, use_cuda, pos)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor | None = None, *,
                        causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0, impl: str | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row logsumexp of the
    scaled scores, ``(o [B, H, T, D], lse [B, H, T] f32)``, the port of
    ``pallas_attention.flash_attention_lse``: K2b, or with ``causal`` K2c-lse
    (offsets as for :func:`flash_attention`, ignored without ``causal``),
    and under grad the fused backward with the lse cotangent folded into
    ``dsum``, so it is differentiable in both outputs. A row with no allowed
    key has o = 0 and lse = -1e30. ``impl`` as for
    :func:`flash_attention`."""
    use_cuda = _route(q, impl)
    pos = _positions(causal, q_offset, k_offset)
    if _needs_grad(q, k, v):
        return _FlashLse.apply(q, k, v, key_mask, use_cuda, pos)
    return (flash_lse_cuda if use_cuda else flash_lse_torch)(
        q, k, v, key_mask, **pos)
