"""Quantile feature binning — stage 0 of the histogram GBDT engine.

Role of the reference's native ``LGBM_DatasetCreateFromMats`` preprocessing
(LightGBM C++ builds per-feature bin mappers; the Scala layer at
``lightgbm/dataset/LightGBMDataset.scala:16-184`` only wraps it): continuous
features are discretized into at most ``max_bin`` quantile bins so histogram
construction is a fixed-width integer scatter instead of a sort.

Bin ids are ``uint8`` (max_bin ≤ 255 values + bin 0 reserved for
missing/NaN), so the binned matrix is 4x smaller than float32 in device
memory — the histogram kernel is bandwidth-bound, and this is its biggest
lever. Boundaries are computed on the host once with numpy, by the same code
as the JAX package (``mmlspark_tpu/lightgbm/binning.py``) so they are
bit-equal; the per-row mapping is a ``torch.searchsorted`` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

MISSING_BIN = 0  # bin id reserved for NaN


def compute_bin_boundaries(x: np.ndarray, max_bin: int = 255,
                           sample_cnt: int = 200_000,
                           seed: int = 2) -> np.ndarray:
    """Per-feature upper boundaries, shape [F, max_bin-1], padded with +inf.

    Value v maps to the smallest bin b with v <= bound[b] (bins are
    1-indexed; 0 is the missing bin). Boundaries are midpoints between
    distinct quantile values, like LightGBM's ``FindBinWithZeroAsOneBin``.
    """
    n, F = x.shape
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        x = x[rng.choice(n, sample_cnt, replace=False)]
    bounds = np.full((F, max_bin - 1), np.inf, dtype=np.float64)
    for f in range(F):
        col = x[:, f]
        col = col[~np.isnan(col)]
        if col.size == 0:
            continue
        uniq = np.unique(col)
        if uniq.size <= max_bin - 1:
            # Small-cardinality feature: one bin per distinct value;
            # boundary = midpoint between consecutive distinct values.
            mids = (uniq[:-1] + uniq[1:]) / 2.0
            bounds[f, :mids.size] = mids
            if mids.size < max_bin - 1:
                bounds[f, mids.size] = np.inf
        else:
            qs = np.quantile(uniq, np.linspace(0, 1, max_bin)[1:-1],
                             method="linear")
            qs = np.unique(qs)
            bounds[f, :qs.size] = qs
    return bounds.astype(np.float32)


def bin_features(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Map raw float32 features [n, F] to bin ids [n, F] (uint8; 0 =
    missing) on ``x``'s device.

    ``searchsorted(bounds_f, v, right=False) + 1`` gives the smallest bin
    whose boundary is >= v; NaN maps to MISSING_BIN.
    """
    if boundaries.shape[1] + 1 > 255:
        raise ValueError(f"{boundaries.shape[1] + 1} bins do not fit the "
                         "uint8 bin ids (max_bin must be <= 255)")
    x = x.to(torch.float32)
    bounds = boundaries.to(device=x.device, dtype=torch.float32).contiguous()
    ids = torch.searchsorted(bounds, x.T.contiguous(), right=False) + 1
    ids = torch.where(torch.isnan(x.T), MISSING_BIN, ids)
    return ids.T.to(torch.uint8).contiguous()


def bin_upper_value(boundaries: np.ndarray, feature: int,
                    bin_id: int) -> float:
    """Real-valued split threshold for ``bin <= bin_id`` decisions.

    Used when exporting trees so prediction runs on raw features with
    ``value <= threshold`` exactly like a LightGBM text model.
    """
    if bin_id <= 0:
        return -np.inf
    b = boundaries[feature]
    idx = min(bin_id - 1, b.shape[0] - 1)
    v = float(b[idx])
    if not np.isfinite(v):
        finite = b[np.isfinite(b)]
        v = float(finite[-1]) if finite.size else 0.0
    return v
