"""Host-side categorical encoders for the auto-featurizer.

String one-hot and hash encodings are host work (Python string hashing and
lookup per cell), kept here so ``featurize.FeaturizeModel`` keeps its numeric
paths in torch on its device. The port's copy of
``mmlspark_tpu/featurize/_hostenc.py``: the same crc32 hash and the same
float32 matrices.
"""

from __future__ import annotations

import zlib

import numpy as np


def stable_hash(value: str, seed: int = 0) -> int:
    """Deterministic cross-process string hash (crc32-based)."""
    return zlib.crc32(value.encode("utf-8"), seed) & 0x7FFFFFFF


def encode_onehot(arr, levels: list[str], width: int) -> np.ndarray:
    """Object column → [n, width] float32 one-hot over fitted levels
    (unseen values encode as the zero vector)."""
    lookup = {v: i for i, v in enumerate(levels)}
    mat = np.zeros((len(arr), width), dtype=np.float32)
    for i, v in enumerate(arr):
        j = lookup.get(str(v))
        if j is not None:
            mat[i, j] = 1.0
    return mat


def encode_hash(arr, width: int) -> np.ndarray:
    """Object column → [n, width] float32 hashed counts."""
    mat = np.zeros((len(arr), width), dtype=np.float32)
    for i, v in enumerate(arr):
        if v is not None:
            mat[i, stable_hash(str(v)) % width] += 1.0
    return mat
