"""Collectives over ``torch.distributed``: the port of
``mmlspark_tpu/parallel/collectives.py``.

The JAX package is one controller over a device mesh, and its collectives
run inside ``shard_map`` over a named mesh axis. The port's idiom is one
process per device under ``torch.distributed``; a *shard group* is what a
mesh axis is there:

- ``None``: one shard, no collective (every function is the identity);
- a ``ProcessGroup``: a flat group of ranks (``shardAxisName="dp"``);
- a 2-D ``DeviceMesh`` (``shardAxisName="slice,dp"``, ``allreduce`` only):
  ranks of one host form the inner ``dp`` dim and hosts the outer
  ``slice`` dim, so a reduction runs within each host first and across
  hosts second, the reference's ICI-then-DCN composition;
- an axis name (``"sp"``): that dim of the ``mesh=`` passed, or of the mesh
  in scope (``mesh.mesh_scope``).

``allgather``, ``psum_scatter``, ``ppermute``, ``ring_permute`` and
``all_to_all`` are differentiable, each backward the exact transpose of its
forward over the ranks' tensors taken together: the reduce-scatter, the
all-gather, the inverse permutation and the inverse all-to-all; a summing
``allreduce`` of a tensor that needs grad transposes to itself. So a
program whose ranks each call ``backward`` on their own scalar gets the
gradient of the sum of those scalars (``dl/train.py`` scales a loss that
every rank of a group holds accordingly).

gloo runs ``all_reduce`` on CUDA tensors; its point-to-point sends of CUDA
tensors abort, and its other collectives are not documented for them
(``tools/probe_gloo_cuda.py``), so with gloo a CUDA operand of any
collective but all_reduce is staged through pinned host memory;
``staged.copies``/``staged.bytes`` count those copies (NCCL needs none).
``allreduce.calls``/``.bytes``/``.seconds`` count the all-reduces a process
issued, the bytes each rank contributed and the host time inside them (with
gloo, the wait for the device's queued work included); every collective
also records ``collective_calls_total``/``collective_bytes_total`` and
``parallel_collective_bytes_total{op,axis}`` in the obs registry, as the
JAX package's ``_observed`` does.
"""

from __future__ import annotations

import math
import os
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

# shard groups built so far, keyed by their shape: building one is itself a
# collective over the whole world, so every rank builds each exactly once
_GROUPS: dict = {}


def world_size() -> int:
    """Ranks of the default process group (1 when none is initialised)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _is_mesh(group) -> bool:
    return hasattr(group, "get_group") and hasattr(group, "mesh")


def group_size(group) -> int:
    """Shards of a shard group (1 for ``None``)."""
    if group is None:
        return 1
    if _is_mesh(group):
        return group.size()
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's shard index in a shard group: its rank in a flat group,
    its row-major coordinate in a mesh (0 for ``None``)."""
    if group is None:
        return 0
    if _is_mesh(group):
        s, d = group.get_coordinate()
        return s * group.shape[1] + d
    return dist.get_rank(group)


def _label(axis) -> str:
    if isinstance(axis, str):
        return axis
    return "group" if axis is not None else "none"


def _record(op: str, x: torch.Tensor, axis) -> None:
    """One collective issue in the obs registry (calls, per-rank bytes)."""
    from ..obs import registry as _obs
    from ..obs.profile import process_label
    pl = process_label()
    lab = dict(op=op, axis=_label(axis),
               **({"process": pl} if pl is not None else {}))
    nbytes = x.numel() * x.element_size()
    _obs.counter("collective_calls_total",
                 "collective issue count, by op/axis").inc(1, **lab)
    _obs.counter("collective_bytes_total",
                 "per-rank payload bytes at collective issue, by op/axis"
                 ).inc(nbytes, **lab)
    _obs.counter("parallel_collective_bytes_total",
                 "per-rank payload bytes at collective issue, by op/axis "
                 "(partition-engine series; same numbers as "
                 "collective_bytes_total)").inc(nbytes, **lab)


def resolve_group(axis, mesh=None):
    """The shard group an ``axis`` argument names: ``None``, a process group
    or a mesh as they are; an axis name through ``mesh`` (default: the mesh
    in scope), ``None`` for a size-1 axis."""
    if not isinstance(axis, str):
        return axis
    from .mesh import axis_group, current_mesh
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"collective over axis {axis!r} with no mesh: pass "
                         "mesh= or run inside parallel.mesh_scope(mesh)")
    return axis_group(mesh, axis)


def _group_ranks(group) -> tuple[int, int]:
    """(this rank's index in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _staged(group, *tensors) -> bool:
    """Whether CUDA operands go through the host for ``group`` (gloo; see
    the module docstring)."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == "gloo")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    staged.copies += 1
    staged.bytes += t.numel() * t.element_size()
    return host


def _from_host(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    staged.copies += 1
    staged.bytes += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=False)


# the host staging's copies and bytes (gloo with CUDA operands)
staged = SimpleNamespace(copies=0, bytes=0)


def _reduce(out: torch.Tensor, groups, op) -> torch.Tensor:
    t0 = time.perf_counter()
    for g in groups:
        dist.all_reduce(out, op=op, group=g)
        allreduce.calls += 1
        allreduce.bytes += out.numel() * out.element_size()
    allreduce.seconds += time.perf_counter() - t0
    return out


class _PSum(torch.autograd.Function):
    """Summing all-reduce whose backward is itself (its transpose)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _reduce(x.contiguous().clone(), groups, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous().clone(), ctx.groups,
                       dist.ReduceOp.SUM), None


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


def allreduce(x: torch.Tensor, group, op: str = "sum", *,
              mesh=None) -> torch.Tensor:
    """``x`` reduced over every shard of ``group`` (``psum``/``pmax``/
    ``pmin``/``pmean``: op ``sum``, ``max``, ``min``, ``mean``); a new
    tensor, ``x`` is left as it was. Every rank of the group must call it,
    in the same order, with a tensor of the same shape. A ``sum`` of a
    tensor that needs grad is differentiable (the backward sums the
    cotangents the same way)."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}")
    label = group
    group = resolve_group(group, mesh)
    if group is None:
        return x
    _record(f"allreduce_{op}", x, label)
    groups = ([group.get_group(d) for d in reversed(range(group.ndim))]
              if _is_mesh(group) else [group])
    if op == "sum" and x.requires_grad and torch.is_grad_enabled():
        return _PSum.apply(x, groups)
    out = _reduce(x.contiguous().clone(), groups, _OPS[op])
    if op == "mean":
        out = out / math.prod(dist.get_world_size(g) for g in groups)
    return out


allreduce.calls = 0
allreduce.bytes = 0
allreduce.seconds = 0.0


# ------------------------------------------ collectives over one group, dim 0
def _all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    """[m, ...] on each rank → [n·m, ...], rank order."""
    _, n = _group_ranks(group)
    x = x.contiguous()
    host = _staged(group, x)
    src = _to_host(x) if host else x
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=src.device, pin_memory=host)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, src, group=group)
    return _from_host(out, x) if host else out


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """[n·m, ...] on each rank → the sum of every rank's block ``r``."""
    r, n = _group_ranks(group)
    x = x.contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {n} "
                         "ranks")
    m = x.shape[0] // n
    if _staged(group, x):
        # gloo reduces CUDA tensors in place: sum on the card, keep a block
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out[r * m:(r + 1) * m].clone()
    out = torch.empty((m, *x.shape[1:]), dtype=x.dtype, device=x.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, x, group=group)
    return out


def _all_to_all0(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each rank: block j goes to rank j; block j of the result
    came from rank j."""
    x = x.contiguous()
    host = _staged(group, x)
    src = _to_host(x) if host else x
    out = torch.empty_like(src, pin_memory=host) if host else \
        torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return _from_host(out, x) if host else out


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``perm``: ``(src, dst)`` pairs of group ranks; a rank that receives
    from none gets zeros, as ``jax.lax.ppermute`` gives."""
    r, _ = _group_ranks(group)
    x = x.contiguous()
    send_to = [d for s, d in perm if s == r]
    recv_from = [s for s, d in perm if d == r]
    host = _staged(group, x)
    src = _to_host(x) if host else x
    out = torch.zeros_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, d), group)
           for d in send_to if d != r]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s),
                       group) for s in recv_from if s != r]
    if r in send_to and r in recv_from:
        out.copy_(src)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_host(out, x) if host else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather0(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all0(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all0(g, ctx.group), None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


def allgather(x: torch.Tensor, axis, *, tiled: bool = True,
              gather_axis: int = 0, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, in rank order: concatenated on dim
    ``gather_axis`` (``tiled``) or stacked as a new dim there. Backward: the
    reduce-scatter."""
    group = resolve_group(axis, mesh)
    if group is None:
        return x if tiled else x.unsqueeze(gather_axis)
    _record("allgather", x, axis)
    n = dist.get_world_size(group)
    d = gather_axis % (x.dim() + (0 if tiled else 1))
    if not tiled:
        x = x.unsqueeze(d)
    y = _AllGather.apply(x.movedim(d, 0), group)
    y = y.reshape(n * x.shape[d], *y.shape[1:])
    return y.movedim(0, d)


def psum_scatter(x: torch.Tensor, axis, *, scatter_axis: int = 0,
                 mesh=None) -> torch.Tensor:
    """reduce_scatter: each rank gets its block (rank order) of the sum of
    every rank's ``x`` along dim ``scatter_axis``. Backward: the
    all-gather."""
    group = resolve_group(axis, mesh)
    if group is None:
        return x
    _record("psum_scatter", x, axis)
    d = scatter_axis % x.dim()
    return _ReduceScatter.apply(x.movedim(d, 0), group).movedim(0, d)


def ppermute(x: torch.Tensor, axis, perm, *, mesh=None) -> torch.Tensor:
    """Point-to-point permutation over ``axis`` with an explicit ``(src,
    dst)`` list of axis indices (ring attention's rotation). Backward: the
    inverse permutation."""
    group = resolve_group(axis, mesh)
    if group is None:
        return x
    _record("ppermute", x, axis)
    return _Permute.apply(x, group, [tuple(p) for p in perm])


def all_to_all(x: torch.Tensor, axis, *, split_axis: int, concat_axis: int,
               tiled: bool = False, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all``: ``x`` splits into one block a rank along
    ``split_axis`` (untiled: that dim has the axis's size and is dropped);
    block j goes to rank j, and the blocks received are concatenated in
    rank order along ``concat_axis`` (untiled: stacked as a new dim there).
    Backward: the inverse all-to-all (Ulysses' sequence↔heads exchange)."""
    group = resolve_group(axis, mesh)
    if group is None:
        return x
    _record("all_to_all", x, axis)
    n = dist.get_world_size(group)
    if tiled:
        blocks = x.chunk(n, split_axis)
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all: split dim {x.shape[split_axis]} "
                             f"!= axis size {n}")
        blocks = x.unbind(split_axis)
    got = _AllToAll.apply(torch.stack(blocks), group).unbind(0)
    return torch.cat(got, concat_axis) if tiled else \
        torch.stack(got, concat_axis)


def axis_index(axis, *, mesh=None) -> int:
    """This rank's coordinate along ``axis`` (0 for a size-1 axis)."""
    group = resolve_group(axis, mesh)
    _record("axis_index", torch.zeros((), dtype=torch.int32), axis)
    return 0 if group is None else dist.get_rank(group)


def ring_permute(x: torch.Tensor, axis, shift: int = 1, *,
                 mesh=None) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``axis``: rank i's goes to rank
    i + shift (the building block of ring attention)."""
    group = resolve_group(axis, mesh)
    if group is None:
        return x
    n = dist.get_world_size(group)
    _record("ring_permute", x, axis)
    return _Permute.apply(x, group, [(i, (i + shift) % n) for i in range(n)])


def barrier(axis, *, mesh=None) -> None:
    """Every rank of ``axis`` waits for the others (a trivial all-reduce,
    as the JAX package's psum of a scalar)."""
    group = resolve_group(axis, mesh)
    if group is None:
        return
    cuda = dist.get_backend(group) == "nccl"
    z = torch.zeros((), dtype=torch.int32,
                    device=torch.cuda.current_device() if cuda else "cpu")
    _record("barrier", z, axis)
    dist.all_reduce(z, group=group)


def shard_group(num_shards: int, axes: tuple = ("dp",),
                device_type: str = "cpu"):
    """The shard group of ``num_shards`` ranks this rank trains in, or
    ``None`` for one shard. Every rank of the world must call it with the
    same arguments (building a group is a collective).

    One axis: the world is cut into blocks of ``num_shards`` consecutive
    ranks (the whole world when they are equal), each block training as
    one group; a trailing block may be smaller. Two axes: a
    ``DeviceMesh`` over the whole world, ``LOCAL_WORLD_SIZE`` ranks (the
    ranks of one host, as ``torchrun`` sets it) to its inner dim.
    """
    world = world_size()
    ns = min(int(num_shards), world)
    if ns <= 1:
        return None
    if len(axes) == 1:
        if ns == world:
            return dist.group.WORLD
        key = ("blocks", ns)
        if key not in _GROUPS:
            blocks = [dist.new_group(list(range(s, min(s + ns, world))))
                      for s in range(0, world, ns)]
            _GROUPS[key] = blocks
        return _GROUPS[key][dist.get_rank() // ns]
    if len(axes) != 2:
        raise ValueError(
            f"shardAxisName supports one or two levels, got {axes}")
    if ns != world:
        raise ValueError(
            f"a two-level shard mesh spans every rank: numShards={ns} of "
            f"{world} ranks")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        local = world
    key = ("mesh", device_type, world // local, local, tuple(axes))
    if key not in _GROUPS:
        from torch.distributed.device_mesh import init_device_mesh
        _GROUPS[key] = init_device_mesh(device_type, (world // local, local),
                                        mesh_dim_names=tuple(axes))
    return _GROUPS[key]
