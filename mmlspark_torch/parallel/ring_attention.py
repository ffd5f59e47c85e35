"""Ring attention: exact attention over sequence-sharded inputs.

The port of ``mmlspark_tpu/parallel/ring_attention.py``. The mesh axis
``sp`` shards Q/K/V along the sequence over ranks; K/V blocks (and their key
mask) rotate around the ring by point-to-point sends while each rank keeps
a numerically stable running softmax over the blocks it has seen, so
attention over T positions costs O(T/n) memory a rank (Liu et al., "Ring
Attention with Blockwise Transformers"; PAPERS.md).

``blockwise_attention`` is the single-device half: a running max ``m``,
denominator ``l`` and accumulator ``acc`` over key blocks, so the ``[T, T]``
score matrix never materializes; it runs in the inputs' dtype, as the JAX
version does. ``ring_attention`` runs on one rank's shards, as the JAX
function runs inside ``shard_map``: ``local_impl="blockwise"`` updates the
running softmax in plain PyTorch, ``"flash"`` calls ``flash_attention_lse``
once a ring step with the held block's global offsets (K2b, K2c-lse when
causal; K2d/K2e under grad) and merges the normalised partials by their lse
in an f32 carry.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import collectives as _coll


def _block_update(q, k, v, m, l, acc, bias, scale):
    """One blockwise softmax-attention accumulation step.

    q [B,H,Tq,D]; k,v [B,H,Tk,D]; m,l [B,H,Tq]; acc [B,H,Tq,D].
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m, s.amax(-1))
    # a fully-masked block leaves m_new = -inf; exp(s - m_new) would be
    # exp(-inf - -inf) = nan, so shift by 0 there (every term is then
    # exp(-inf) = 0, the correct weight)
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, acc_new


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False, scale: float | None = None,
                        key_mask=None, return_lse: bool = False,
                        q_offset: int = 0, k_offset: int = 0):
    """Single-device blockwise (flash-style) attention.

    q/k/v: [B, H, T, D]. ``key_mask`` [B, T] bool marks valid keys (False =
    padding, excluded from the softmax). ``return_lse`` also returns the
    per-row logsumexp [B, H, T], with fully-masked rows at the finite
    sentinel ~-1e30. ``q_offset``/``k_offset`` shift the global positions
    the causal mask compares.
    """
    B, H, T, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    nb = -(-T // block_size)
    pad = nb * block_size - T
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    if key_mask is not None and pad:
        key_mask = F.pad(key_mask, (0, pad))
    neg_inf = torch.tensor(float("-inf"), dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    q_pos = q_offset + torch.arange(T, device=q.device)

    m = torch.full((B, H, T), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    for i in range(nb):
        lo = i * block_size
        k_idx = lo + torch.arange(block_size, device=q.device)  # LOCAL: pads
        bias = torch.where(k_idx[None, :] >= T, neg_inf, zero)
        if causal:
            bias = bias + torch.where(
                (k_offset + k_idx)[None, :] > q_pos[:, None], neg_inf, zero)
        bias = bias[None, None]
        if key_mask is not None:
            mb = key_mask[:, lo:lo + block_size]
            bias = bias + torch.where(mb, zero, neg_inf)[:, None, None, :]
        m, l, acc = _block_update(q, kp[:, :, lo:lo + block_size],
                                  vp[:, :, lo:lo + block_size], m, l, acc,
                                  bias, scale)
    # valid rows have l >= 1 (the row max contributes exp(0)); fully-masked
    # rows have l == 0 exactly and acc == 0
    l_safe = torch.where(l > 0, l, 1.0)
    out = acc / l_safe[..., None]
    if return_lse:
        return out, torch.clamp_min(m + torch.log(l.clamp_min(1e-35)), -1e30)
    return out


def _rotate(kv, mask, group, n):
    """K/V (stacked, one message) and the key mask one step round the ring:
    rank i's go to rank i + 1."""
    perm = [(j, (j + 1) % n) for j in range(n)]
    kv = _coll.ppermute(kv, group, perm)
    mask = _coll.ppermute(mask.to(torch.uint8), group, perm).bool()
    return kv, mask


def _merge(o, lse, o_i, lse_i):
    """Merge two normalised partial attentions (the f32 carry ``o``,
    ``lse`` and a step's ``o_i``, ``lse_i``): weights exp(lse - M) a side;
    an empty side carries lse = -1e30."""
    m_new = torch.maximum(lse, lse_i)
    la = torch.exp(lse - m_new)
    lb = torch.exp(lse_i - m_new)
    denom = (la + lb).clamp_min(1e-35)
    o = (o * la[..., None] + o_i.float() * lb[..., None]) / denom[..., None]
    return o, m_new + torch.log(denom)


def ring_attention(q, k, v, *, axis="sp", causal: bool = False,
                   scale: float | None = None, key_mask=None,
                   local_impl: str = "blockwise", mesh=None):
    """Exact attention with Q/K/V sequence-sharded over ``axis``: each rank
    holds its ``[B, H, T/n, D]`` block (blocks in sequence order along the
    axis) and ``key_mask`` ``[B, T/n]`` bool (True = valid key), and gets
    its block of the output. ``axis`` names a dim of ``mesh`` (default: the
    mesh in scope) or is a process group. K/V and the mask rotate n - 1
    times; causal masking compares global positions.

    ``local_impl``: ``"blockwise"`` (plain running softmax, any ``scale``)
    or ``"flash"`` (the fused kernels a step, the kernel's fixed D**-0.5
    scale)."""
    group = _coll.resolve_group(axis, mesh)
    n = 1 if group is None else torch.distributed.get_world_size(group)
    my = _coll.axis_index(group)
    B, H, Tl, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    if key_mask is None:
        key_mask = torch.ones((B, Tl), dtype=torch.bool, device=q.device)
    kv, mc = torch.stack([k, v]), key_mask

    if local_impl == "flash":
        if scale != D ** -0.5:
            raise NotImplementedError(
                "local_impl='flash' uses the kernel's fixed D**-0.5 scale")
        from ..dl.flash_attention import flash_attention_lse
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, Tl), -1e30, dtype=torch.float32,
                         device=q.device)
        for i in range(n):
            src = (my - i) % n      # whose K/V block this rank holds now
            o_i, lse_i = flash_attention_lse(
                q, kv[0], kv[1], key_mask=mc, causal=causal,
                q_offset=my * Tl, k_offset=src * Tl)
            o, lse = _merge(o, lse, o_i, lse_i)
            if i < n - 1:
                kv, mc = _rotate(kv, mc, group, n)
        return o.to(q.dtype)
    if local_impl != "blockwise":
        raise ValueError(f"unknown local_impl {local_impl!r}; expected "
                         "blockwise|flash")

    q_pos = my * Tl + torch.arange(Tl, device=q.device)
    neg_inf = torch.tensor(float("-inf"), dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    m = torch.full((B, H, Tl), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    for i in range(n):
        src = (my - i) % n
        if causal:
            k_pos = src * Tl + torch.arange(Tl, device=q.device)
            bias = torch.where(k_pos[None, :] > q_pos[:, None], neg_inf,
                               zero)[None, None]
        else:
            bias = torch.zeros((1, 1, 1, Tl), dtype=q.dtype, device=q.device)
        bias = bias + torch.where(mc, zero, neg_inf)[:, None, None, :]
        m, l, acc = _block_update(q, kv[0], kv[1], m, l, acc, bias, scale)
        if i < n - 1:
            kv, mc = _rotate(kv, mc, group, n)
    # l == 0 exactly for fully-masked rows (valid rows have l >= 1)
    return acc / torch.where(l > 0, l, 1.0)[..., None]


class RingAttention:
    """``fn(q, k, v, key_mask=None)`` over one rank's shards: what
    :func:`make_ring_attention` returns. ``seq_axis``/``mesh`` tell a model
    that its sequence is sharded over that axis."""

    def __init__(self, mesh, causal, axis, batch_axis, local_impl):
        if local_impl not in ("blockwise", "flash"):
            raise ValueError(f"unknown local_impl {local_impl!r}; "
                             "expected blockwise|flash")
        self.mesh, self.causal, self.seq_axis = mesh, causal, axis
        self.batch_axis, self.local_impl = batch_axis, local_impl

    def __call__(self, q, k, v, key_mask=None):
        return ring_attention(q, k, v, axis=self.seq_axis, mesh=self.mesh,
                              causal=self.causal, key_mask=key_mask,
                              local_impl=self.local_impl)


def make_ring_attention(mesh, *, causal: bool = False, axis: str = "sp",
                        batch_axis: str | None = None,
                        local_impl: str = "blockwise") -> RingAttention:
    """Ring attention over ``mesh``'s ``axis``: the returned
    ``fn(q, k, v, key_mask=None)`` takes this rank's ``[B, H, T/n, D]``
    blocks (and optionally rows sharded over ``batch_axis``: 2-D data x
    sequence parallelism, where the ring runs within each row block, since
    ``axis``'s group is this rank's line of the mesh) and ``key_mask``
    ``[B, T/n]`` bool."""
    from .mesh import as_mesh
    return RingAttention(as_mesh(mesh), causal, axis, batch_axis,
                         local_impl)
