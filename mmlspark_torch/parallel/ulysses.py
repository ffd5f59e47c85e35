"""Ulysses-style all-to-all sequence parallelism.

The port of ``mmlspark_tpu/parallel/ulysses.py``, the second long-context
strategy beside ring attention: each rank holds a sequence block, and an
all-to-all re-shards the activations from sequence-sharded to head-sharded
before attention, so every rank attends over the whole sequence for its
share of the heads; a second all-to-all restores sequence sharding (the
public DeepSpeed-Ulysses formulation, PAPERS.md). Two all-to-alls move
O(T·D/n) a rank whatever the sequence length, but the rank count is capped
by the head count (n ≤ H).
"""

from __future__ import annotations

import torch

from . import collectives as _coll
from .ring_attention import blockwise_attention


class UlyssesAttention:
    """``fn(q, k, v, key_mask=None)`` over one rank's sequence blocks: what
    :func:`make_ulysses_attention` returns. ``seq_axis``/``mesh`` tell a
    model that its sequence is sharded over that axis."""

    def __init__(self, mesh, axis, causal, scale, block_size, batch_axis,
                 local_impl):
        from .mesh import axis_size
        self.mesh, self.seq_axis, self.causal = mesh, axis, causal
        self.scale, self.block_size = scale, block_size
        self.batch_axis, self.local_impl = batch_axis, local_impl
        self.n = axis_size(mesh, axis)

    def __call__(self, q, k, v, key_mask=None):
        B, H, t, D = q.shape
        d = self.n
        if H % d != 0:
            raise ValueError(
                f"ulysses needs head count {H} divisible by the "
                f"'{self.seq_axis}' axis size {d} (use ring attention "
                "otherwise)")
        h = H // d
        group = _coll.resolve_group(self.seq_axis, self.mesh)
        if key_mask is None:
            key_mask = torch.ones((B, t), dtype=torch.bool, device=q.device)

        def seq_to_heads(x):
            # [B, H, t, D] → [B, H/d, T, D]: head group j of every rank's
            # sequence block lands on rank j, blocks stacked in rank order
            # (= sequence order)
            x = _coll.all_to_all(x.reshape(B, d, h, t, D), group,
                                 split_axis=1, concat_axis=2)
            return x.reshape(B, h, d * t, D)

        def heads_to_seq(x):
            # the inverse: sequence block i of every head group goes home
            # to rank i, head groups stacked in rank order (= head order)
            x = _coll.all_to_all(x.reshape(B, h, d, t, D), group,
                                 split_axis=2, concat_axis=1)
            return x.reshape(B, d * h, t, D)

        qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
        # every rank attends over the whole sequence for its head group,
        # so it needs the whole key mask
        full_mask = _coll.allgather(key_mask.to(torch.uint8), group,
                                    gather_axis=1).bool()
        if self.local_impl == "flash":
            from ..dl.flash_attention import flash_attention
            out = flash_attention(qh, kh, vh, key_mask=full_mask,
                                  causal=self.causal)
        else:
            out = blockwise_attention(qh, kh, vh, causal=self.causal,
                                      scale=self.scale,
                                      block_size=self.block_size or 512,
                                      key_mask=full_mask)
        return heads_to_seq(out)


def make_ulysses_attention(mesh, axis: str = "sp", *, causal: bool = False,
                           scale: float | None = None,
                           block_size: int | None = None,
                           batch_axis: str | None = None,
                           local_impl: str = "blockwise"
                           ) -> UlyssesAttention:
    """All-to-all sequence-parallel attention over ``mesh``'s ``axis``.

    The returned ``fn(q, k, v, key_mask=None)`` takes this rank's
    ``[B, H, T/n, D]`` blocks (rows optionally sharded over ``batch_axis``:
    2-D data x sequence parallelism) and ``key_mask`` ``[B, T/n]``; H must
    divide by the axis size (checked at the call, as in the JAX package).

    ``local_impl``: ``"blockwise"`` or ``"flash"`` (the fused kernels: K2a,
    K2c when causal; after the all-to-all each rank holds the whole
    sequence in global order, so the kernel's causal mask applies as it
    is), the latter with the kernel's fixed D**-0.5 scale only."""
    from .mesh import as_mesh
    if local_impl not in ("blockwise", "flash"):
        raise ValueError(f"unknown local_impl {local_impl!r}; expected "
                         "blockwise|flash")
    if local_impl == "flash" and scale is not None:
        raise NotImplementedError(
            "local_impl='flash' supports the kernel's fixed D**-0.5 scale "
            "only")
    return UlyssesAttention(as_mesh(mesh), axis, causal, scale, block_size,
                            batch_axis, local_impl)
