"""Binary and image file reading, the port of ``mmlspark_tpu/io/binary.py``
(host code, no tensors).

Reference ``io/binary/BinaryFileFormat.scala:34-245`` — a Hadoop file
format yielding (path, bytes) rows, with zip-entry expansion and Bernoulli
subsampling — and the patched Spark image source
(``org/apache/spark/ml/source/image/PatchedImageFileFormat.scala``).
Here both are columnar readers producing DataFrames. Decoding goes through
PIL, imported when an image is decoded: a reader of raw bytes needs nothing
beyond the standard library.
"""

from __future__ import annotations

import fnmatch
import io as _io
import os
import random
import zipfile

import numpy as np

from ..core import DataFrame


def decode_image(data: bytes) -> np.ndarray:
    """Decode encoded image bytes → HWC uint8 array, **BGR** channel order
    (Spark ImageSchema convention, kept so unrolled features match the
    reference's layout)."""
    from PIL import Image
    img = Image.open(_io.BytesIO(data))
    arr = np.asarray(img.convert("RGB") if img.mode not in ("RGB", "L")
                     else img)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[..., ::-1]  # RGB → BGR
    return arr


def _iter_files(path: str, glob: str | None, recursive: bool = True):
    if os.path.isfile(path):
        yield path
        return
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            if glob is None or fnmatch.fnmatch(f, glob):
                yield os.path.join(root, f)
        if not recursive:
            break


class BinaryFileReader:
    """(path, bytes) reader with zip expansion + subsampling
    (reference ``BinaryFileFormat`` ``subsample``/``inspectZip`` options and
    ``ZipIterator``, ``core/env/StreamUtilities.scala``)."""

    def __init__(self, glob: str | None = None, inspect_zip: bool = True,
                 sample_ratio: float = 1.0, seed: int = 0):
        self.glob = glob
        self.inspect_zip = inspect_zip
        self.sample_ratio = sample_ratio
        self.seed = seed

    def read(self, path: str) -> DataFrame:
        rng = random.Random(self.seed)
        paths, blobs = [], []

        def keep():
            return self.sample_ratio >= 1.0 or rng.random() < \
                self.sample_ratio

        for f in _iter_files(path, self.glob):
            if self.inspect_zip and zipfile.is_zipfile(f):
                with zipfile.ZipFile(f) as z:
                    for name in z.namelist():
                        if name.endswith("/"):
                            continue
                        if keep():
                            paths.append(f"{f}::{name}")
                            blobs.append(z.read(name))
            elif keep():
                with open(f, "rb") as fh:
                    paths.append(f)
                    blobs.append(fh.read())
        path_col = np.empty(len(paths), object)
        path_col[:] = paths
        blob_col = np.empty(len(blobs), object)
        blob_col[:] = blobs
        return DataFrame({"path": path_col, "bytes": blob_col})


def read_binary_files(path: str, glob: str | None = None,
                      sample_ratio: float = 1.0,
                      inspect_zip: bool = True) -> DataFrame:
    """``spark.read.binary`` equivalent (``io/IOImplicits.scala``)."""
    return BinaryFileReader(glob, inspect_zip, sample_ratio).read(path)


def read_images(path: str, glob: str | None = "*",
                decode: bool = True) -> DataFrame:
    """``spark.read.image`` equivalent. Decoded column holds HWC uint8 BGR
    arrays (object column if shapes differ). Files PIL cannot decode are
    dropped; without PIL it raises ``ImportError`` rather than drop them
    all."""
    df = read_binary_files(path, glob, inspect_zip=False)
    if not decode:
        return df
    from PIL import Image
    images = []
    keep_idx = []
    for i, b in enumerate(df["bytes"]):
        try:
            images.append(decode_image(b))
            keep_idx.append(i)
        except (OSError, ValueError, SyntaxError,
                Image.DecompressionBombError):
            continue  # non-image files are dropped, like the image source
    col = np.empty(len(images), object)
    col[:] = images
    paths = df["path"][keep_idx]
    return DataFrame({"path": paths, "image": col})
