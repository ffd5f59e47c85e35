"""Blockwise attention: exact softmax attention in key blocks, O(T) memory.

The single-device half of ``mmlspark_tpu/parallel/ring_attention.py``
(``_block_update``, ``blockwise_attention``, ``:27-116``): a running max
``m``, denominator ``l`` and accumulator ``acc`` over key blocks, so the
``[T, T]`` score matrix never materializes. It runs in the inputs' dtype,
as the JAX version does. Ring attention over a sequence-sharded mesh comes
with the parallel slice (ROADMAP.md §1 item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
