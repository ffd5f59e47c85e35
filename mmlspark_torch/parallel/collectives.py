"""Collectives over ``torch.distributed`` for training on more than one rank.

The counterpart of ``mmlspark_tpu/parallel/collectives.py:75-85``. The JAX
package is one controller over a device mesh: rows shard over a named mesh
axis and ``psum`` runs inside ``shard_map``. The port's idiom is one
process per device under ``torch.distributed``; a *shard group* is what a
mesh axis is there:

- ``None``: one shard, no collective (every function is the identity);
- a ``ProcessGroup``: a flat group of ranks (``shardAxisName="dp"``);
- a 2-D ``DeviceMesh`` (``shardAxisName="slice,dp"``): ranks of one host
  form the inner ``dp`` dim and hosts the outer ``slice`` dim, so a
  reduction runs within each host first and across hosts second, the
  reference's ICI-then-DCN composition.

Only ``all_reduce`` is used, so the gloo backend serves CUDA tensors too
(it stages each reduction through the host). ``allreduce.calls`` and
``allreduce.bytes`` count the collectives a process issued and the bytes
each rank contributed, the JAX package's ``parallel_collective_bytes``;
``allreduce.seconds`` is the host time spent inside them (with gloo, the
wait for the device's queued work included).
"""

from __future__ import annotations

import os
import time

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


def allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over every shard of ``group`` (the JAX ``allreduce``'s
    ``psum``, the one reduction training needs); a new tensor, ``x`` is
    left as it was. Every rank of the group must call it, in the same
    order, with a tensor of the same shape."""
    if group is None:
        return x
    out = x.contiguous().clone()
    groups = ([group.get_group(d) for d in reversed(range(group.ndim))]
              if _is_mesh(group) else [group])
    t0 = time.perf_counter()
    for g in groups:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
        allreduce.calls += 1
        allreduce.bytes += out.numel() * out.element_size()
    allreduce.seconds += time.perf_counter() - t0
    return out


allreduce.calls = 0
allreduce.bytes = 0
allreduce.seconds = 0.0


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
