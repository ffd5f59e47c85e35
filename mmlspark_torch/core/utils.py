"""Core numeric helpers shared by stages.

The port's share of the JAX package's ``core/utils.py``; its retry, timing
and cluster-topology helpers come with the serving and parallel slices.
"""

from __future__ import annotations

import numpy as np


def stable_sigmoid(x: np.ndarray) -> np.ndarray:
    """Overflow-free logistic: exp is only ever taken of a non-positive
    argument."""
    x = np.asarray(x)
    e = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def as_2d_features(df, features_col: str) -> np.ndarray:
    """Features column → dense float32 [n, d] matrix."""
    arr = df[features_col]
    if arr.dtype == object:
        arr = np.stack([np.asarray(v, dtype=np.float32) for v in arr])
    if arr.ndim == 1:
        arr = arr[:, None]
    return np.ascontiguousarray(arr, dtype=np.float32)
