"""Image pipeline stages: resize, unroll, augment — the port of
``mmlspark_tpu/image/stages.py``.

Reference ``image/`` package: ``ResizeImageTransformer.scala``,
``UnrollImage.scala`` (image → flat vector in CHW order),
``ImageSetAugmenter.scala`` (left/right flip augmentation). Each computes
on its ``device`` and hands the column back to the host. ``UnrollImage``
also carries the reference's traced form: a stacked numeric NHWC column
unrolls on the device inside a fused segment (``core/compile.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import Param, Transformer, TypeConverters as TC
from ..core.compile import run_traced
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..core.dataframe import readable_dtype
from . import ops
from .transforms import images_to_batch


def _resize_host(img: np.ndarray, H: int, W: int, dev) -> np.ndarray:
    """One HWC (or HW) image resized on ``dev``, back as float32 HWC."""
    a = np.asarray(img, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)[None]
    return ops.resize(x, H, W)[0].cpu().numpy()


class ResizeImageTransformer(Transformer, HasInputCol, HasOutputCol,
                             HasDevice):
    """Reference ``image/ResizeImageTransformer.scala`` — the OpenCV-free
    resize ``ImageFeaturizer`` runs first. The column is uploaded in its own
    dtype (uint8 images stay uint8 on the wire) and comes back float32."""

    height = Param("height", "target height", TC.toInt)
    width = Param("width", "target width", TC.toInt)
    nChannels = Param("nChannels", "channel count override", TC.toInt,
                      default=None, has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="image", outputCol="image")

    def _transform(self, df):
        col = df[self.getInputCol()]
        H, W = self.getHeight(), self.getWidth()
        dev = self._device()
        if isinstance(col, np.ndarray) and col.ndim == 4:
            x = torch.from_numpy(np.ascontiguousarray(col)).to(dev)
            out = ops.resize(x, H, W).cpu().numpy()
        else:
            out = np.stack([_resize_host(a, H, W, dev) for a in col])
        return df.with_column(self.getOutputCol(), out)


class UnrollImage(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Image → flat feature vector in CHW order (reference
    ``image/UnrollImage.scala``: CNTK expects channels-first; the layout is
    kept so unrolled features are comparable)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="image", outputCol="unrolled")

    def _transform(self, df):
        ic, oc = self.getInputCol(), self.getOutputCol()
        batch, _ = images_to_batch(df[ic])
        host = run_traced(self, {ic: batch}, self._device())
        return df.with_column(oc, host[oc])

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        # the traced form needs an already-stacked numeric NHWC column
        # (trailing [H, W, C]); object columns stay on the eager path,
        # where images_to_batch stacks (and grayscale-expands) on host
        return ic in schema and readable_dtype(schema[ic][0]) \
            and len(schema[ic][1]) == 3

    def _trace(self, cols):
        out = dict(cols)
        batch = cols[self.getInputCol()].to(torch.float32)
        # NHWC → [n, C·H·W]
        out[self.getOutputCol()] = batch.permute(0, 3, 1, 2).reshape(
            batch.shape[0], -1)
        return out


class UnrollBinaryImage(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Decode encoded image bytes, then unroll (reference
    ``image/UnrollImage.scala``'s UnrollBinaryImage). Decoding goes through
    PIL (``io.binary.decode_image``), imported when a row is decoded; the
    optional resize runs on the stage's device."""

    height = Param("height", "resize height", TC.toInt, default=None,
                   has_default=True)
    width = Param("width", "resize width", TC.toInt, default=None,
                  has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="image", outputCol="unrolled")

    def _transform(self, df):
        from ..io.binary import decode_image
        H, W = self.get("height"), self.get("width")
        out = []
        for b in df[self.getInputCol()]:
            a = np.asarray(decode_image(b), np.float32)
            if a.ndim == 2:
                a = a[..., None]
            if H and W and a.shape[:2] != (H, W):
                a = _resize_host(a, H, W, self._device())
            out.append(np.transpose(a, (2, 0, 1)).reshape(-1))
        return df.with_column(self.getOutputCol(), np.stack(out))


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol, HasDevice):
    """Dataset augmentation by flips (reference
    ``image/ImageSetAugmenter.scala``): the original rows plus one copy per
    enabled flip."""

    flipLeftRight = Param("flipLeftRight", "add L/R flipped copies",
                          TC.toBoolean, default=True, has_default=True)
    flipUpDown = Param("flipUpDown", "add U/D flipped copies",
                       TC.toBoolean, default=False, has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="image", outputCol="image")

    def _transform(self, df):
        batch, _ = images_to_batch(df[self.getInputCol()])
        out = df.with_column(self.getOutputCol(), batch)
        x = torch.from_numpy(batch).to(self._device())
        for enabled, code in ((self.get("flipLeftRight"), 1),
                              (self.get("flipUpDown"), 0)):
            if enabled:
                out = out.union(df.with_column(
                    self.getOutputCol(), ops.flip(x, code).cpu().numpy()))
        return out
