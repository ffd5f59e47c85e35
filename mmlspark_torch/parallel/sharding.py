"""Row padding for sharded training.

The port's copy of ``mmlspark_tpu/parallel/sharding.py:pad_rows``. The
reference's answer to ragged work is the ``ignore`` protocol: empty Spark
partitions opt out of the collective ring (``lightgbm/TrainUtils.scala:
652-669``). Ranks that run one program in lockstep need equal blocks
instead, so rows are padded to a multiple of the shard count and carry a
validity mask; every reduction honours the mask, so a pad row is the
moral equivalent of an ignored partition.
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
