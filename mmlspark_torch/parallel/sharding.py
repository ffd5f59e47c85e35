"""Row padding for sharded training.

The port's copy of ``mmlspark_tpu/parallel/sharding.py:pad_rows``. The
reference's answer to ragged work is the ``ignore`` protocol: empty Spark
partitions opt out of the collective ring (``lightgbm/TrainUtils.scala:
652-669``). Ranks that run one program in lockstep need equal blocks
instead, so rows are padded to a multiple of the shard count and carry a
validity mask; every reduction honours the mask, so a pad row is the
moral equivalent of an ignored partition.

A JAX ``NamedSharding`` is the placements a ``DTensor`` carries here
(:func:`replicated`, :func:`batch_sharding`), and :func:`shard_batch` gives
each rank its own block of the padded rows, a plain tensor on the mesh's
device: one process a rank holds only its block.
"""

from __future__ import annotations

import numpy as np


def pad_rows(arrays, multiple: int, pad_value=0.0):
    """Pad each array's leading dim up to a multiple; returns
    (padded_arrays, mask) where mask is f32 [n_padded] with 1 = real row.

    Accepts a single array or a sequence; None entries pass through. Each
    array keeps its own dtype (the pad constant is cast into it); the mask
    alone is always f32.
    """
    single = not isinstance(arrays, (list, tuple))
    arrs = [arrays] if single else list(arrays)
    n = next(a.shape[0] for a in arrs if a is not None)
    n_pad = (-n) % multiple
    out = []
    for a in arrs:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        if a.shape[0] != n:
            raise ValueError("inconsistent leading dims")
        pad_width = [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)
        fill = np.asarray(pad_value).astype(a.dtype, casting="unsafe")
        out.append(np.pad(a, pad_width, constant_values=fill))
    mask = np.ones(n + n_pad, np.float32)
    mask[n:] = 0.0
    return (out[0] if single else out), mask


def _placements(mesh, axis=None, dim: int = 0) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    axes = () if axis is None else ((axis,) if isinstance(axis, str)
                                    else tuple(axis))
    return tuple(Shard(dim) if a in axes else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    return _placements(mesh)


def batch_sharding(mesh, axis: str = "dp", ndim: int = 2) -> tuple:
    """Placements of rows sharded over ``axis``, other dims replicated
    (``ndim`` is the JAX signature's; placements do not depend on it)."""
    return _placements(mesh, axis)


def unpad_rows(array, n_real: int):
    return array[:n_real]


def shard_batch(mesh, arrays, axis: str = "dp", pad_value=0.0):
    """Pad rows to a multiple of the ``axis`` size and keep this rank's
    block, on the mesh's device. Returns ``(blocks, mask_block, n_real)``:
    ``n_real`` the rows before padding, ``mask_block`` this rank's slice of
    the f32 validity mask."""
    import torch
    from .mesh import axis_rank, axis_size
    from .partition import _mesh_device

    single = not isinstance(arrays, (list, tuple))
    arrs = [arrays] if single else list(arrays)
    n_real = next(a.shape[0] for a in arrs if a is not None)
    axes = [axis] if isinstance(axis, str) else list(axis)
    size, idx = 1, 0
    for a in axes:                  # row-major over the named axes
        idx = idx * axis_size(mesh, a) + axis_rank(mesh, a)
        size *= axis_size(mesh, a)
    padded, mask = pad_rows(arrs, size, pad_value)
    rows = len(mask) // size
    sl = slice(idx * rows, (idx + 1) * rows)
    dev = _mesh_device(mesh)
    out = [None if a is None else torch.from_numpy(
        np.ascontiguousarray(a[sl])).to(dev) for a in padded]
    mask_dev = torch.from_numpy(mask[sl]).to(dev)
    return (out[0] if single else out), mask_dev, n_real
