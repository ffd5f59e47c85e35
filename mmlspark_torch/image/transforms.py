"""ImageTransformer: a chain of batched image operators, the port of
``mmlspark_tpu/image/transforms.py``.

Reference ``opencv/ImageTransformer.scala:27-436``: a stage list
(``resize``, ``crop``, ``colorFormat``, ``flip``, ``blur``, ``threshold``,
``gaussianKernel``) applied per row through OpenCV. Here the chain runs
eagerly over the whole batch on the stage's ``device``: uniform images in
one pass, ragged ones grouped by shape, one pass per distinct shape. (The
JAX package compiles the chain into one jitted program; its fused form
comes with the compile plane, ROADMAP.md §1 item 9.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Param, Transformer, TypeConverters as TC
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..core.dataframe import object_column
from . import ops


def images_to_batch(col: np.ndarray) -> tuple[np.ndarray, bool]:
    """Column of images → float32 NHWC batch.

    Accepts a 4-D numeric array (uniform) or an object array of HWC (or HW
    grayscale) arrays. Returns (batch, was_uniform). Ragged inputs raise —
    callers group by shape first (see ``ImageTransformer._transform``)."""
    if isinstance(col, np.ndarray) and col.ndim == 4:
        return np.asarray(col, np.float32), True
    arrs = [np.asarray(a, np.float32) for a in col]
    shapes = {a.shape for a in arrs}
    if len(shapes) != 1:
        raise ValueError(f"ragged image shapes {shapes}")
    batch = np.stack(arrs)
    if batch.ndim == 3:  # grayscale HW → HWC
        batch = batch[..., None]
    return batch, False


class ImageTransformer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Chainable image ops, batched on the stage's device.

    >>> ImageTransformer().setInputCol("image").resize(224, 224).flip(1)
    """

    stages = Param("stages", "list of (op, kwargs) image stages",
                   TC.identity, default=[], has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="image", outputCol="image")

    # -- fluent builders (reference ImageTransformer public API) -----------
    def _add(self, op: str, **kw):
        # stored as [op, kwargs] lists so the JSON round trip is identity
        self.set("stages", list(self.get("stages")) + [[op, kw]])
        return self

    def resize(self, height: int, width: int):
        return self._add("resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add("crop", x=x, y=y, height=height, width=width)

    def colorFormat(self, format: str):
        return self._add("color_format", conversion=format)

    def flip(self, flipCode: int = 1):
        return self._add("flip", flip_code=flipCode)

    def blur(self, height: float, width: float):
        return self._add("blur", height=height, width=width)

    def threshold(self, threshold: float, maxVal: float,
                  thresholdType: str = "binary"):
        return self._add("threshold", thresh=threshold, max_val=maxVal,
                         threshold_type=thresholdType)

    def gaussianKernel(self, apertureSize: int, sigma: float):
        return self._add("gaussian_blur", aperture_size=apertureSize,
                         sigma=sigma)

    # -- execution ---------------------------------------------------------
    _OPS = {"resize": ops.resize, "crop": ops.crop, "flip": ops.flip,
            "color_format": ops.color_format, "blur": ops.blur,
            "threshold": ops.threshold, "gaussian_blur": ops.gaussian_blur}

    def _run(self, batch: np.ndarray) -> np.ndarray:
        """The chain over one uniform NHWC batch on the stage's device."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(
            self._device()).float()
        for op, kw in self.get("stages"):
            x = self._OPS[op](x, **kw)
        return x.cpu().numpy()

    def _transform(self, df):
        col = df[self.getInputCol()]
        if isinstance(col, np.ndarray) and col.ndim == 4:
            return df.with_column(self.getOutputCol(), self._run(col))
        # ragged: group rows by image shape, one pass per distinct shape
        arrs = [np.asarray(a, np.float32) for a in col]
        arrs = [a[..., None] if a.ndim == 2 else a for a in arrs]
        by_shape: dict[tuple, list[int]] = {}
        for i, a in enumerate(arrs):
            by_shape.setdefault(a.shape, []).append(i)
        results: list = [None] * len(arrs)
        for idxs in by_shape.values():
            out = self._run(np.stack([arrs[i] for i in idxs]))
            for j, i in enumerate(idxs):
                results[i] = out[j]
        if len({r.shape for r in results}) == 1:
            return df.with_column(self.getOutputCol(), np.stack(results))
        return df.with_column(self.getOutputCol(), object_column(results))
