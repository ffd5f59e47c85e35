"""Streaming image/file directory source, the port of
``mmlspark_tpu/io/image_source.py`` (host code, no tensors).

Reference ``org/apache/spark/ml/source/image/PatchedImageFileFormat.scala``
(the image format patched to work under structured streaming) + the
streaming half of ``io/binary/BinaryFileFormat.scala``: a directory is a
stream; each micro-batch is the set of files that appeared since the last
offset.

Offsets are (mtime_ns, path) watermarks, serialized as JSON like the
serving source's offsets (``HTTPSourceV2.scala:106-110``) so a restarted
stream resumes where it stopped.
"""

from __future__ import annotations

import fnmatch
import json
import os
import time

import numpy as np

from ..core import DataFrame
from .binary import decode_image


class FileStreamSource:
    """Micro-batch file stream over a directory tree.

    Each :meth:`next_batch` returns a DataFrame of (path, mtime, bytes)
    rows for files not yet seen at the current offset, oldest first.
    """

    def __init__(self, path: str, glob: str = "*", recursive: bool = True,
                 max_files_per_batch: int = 1000):
        self.path = path
        self.glob = glob
        self.recursive = recursive
        self.max_files_per_batch = max_files_per_batch
        # watermark: strictly-greater (mtime_ns, path) pairs are new
        self._offset: tuple[int, str] = (-1, "")

    # -------------------------------------------------------------- offsets
    def offset_json(self) -> str:
        """Serializable stream position (reference offsets-as-JSON)."""
        return json.dumps({"mtime_ns": self._offset[0],
                           "path": self._offset[1]})

    def restore_offset(self, offset_json: str) -> None:
        d = json.loads(offset_json)
        self._offset = (int(d["mtime_ns"]), d["path"])

    # -------------------------------------------------------------- batches
    def _list_new(self) -> list[tuple[int, str]]:
        found: list[tuple[int, str]] = []
        for root, dirs, files in os.walk(self.path):
            if not self.recursive:
                dirs[:] = []
            for name in files:
                if not fnmatch.fnmatch(name, self.glob):
                    continue
                full = os.path.join(root, name)
                try:
                    mtime = os.stat(full).st_mtime_ns
                except OSError:
                    continue  # deleted between listing and stat
                if (mtime, full) > self._offset:
                    found.append((mtime, full))
        found.sort()
        return found[:self.max_files_per_batch]

    def next_batch(self) -> DataFrame | None:
        """New files since the offset → DataFrame, or None when idle."""
        batch = self._list_new()
        if not batch:
            return None
        rows = []
        for mtime, full in batch:
            try:
                with open(full, "rb") as f:
                    rows.append((full, mtime, f.read()))
            except OSError:
                continue
        if not rows:
            return None
        self._offset = (batch[-1][0], batch[-1][1])
        paths = np.asarray([r[0] for r in rows], object)
        mtimes = np.asarray([r[1] for r in rows], np.int64)
        blobs = np.empty(len(rows), object)
        blobs[:] = [r[2] for r in rows]
        return DataFrame({"path": paths, "modificationTime": mtimes,
                          "content": blobs})

    def stream(self, poll_interval: float = 0.2,
               idle_timeout: float | None = None):
        """Generator of micro-batches; stops after ``idle_timeout``
        seconds without new files (None = forever)."""
        last_data = time.monotonic()
        while True:
            batch = self.next_batch()
            if batch is not None:
                last_data = time.monotonic()
                yield batch
                continue
            if (idle_timeout is not None
                    and time.monotonic() - last_data > idle_timeout):
                return
            time.sleep(poll_interval)


class ImageStreamSource(FileStreamSource):
    """File stream + image decode: batches carry an ``image`` column of
    HWC uint8 arrays (the reference's streaming image source shape);
    undecodable files land in ``error`` instead of killing the stream."""

    def __init__(self, path: str, glob: str = "*", **kwargs):
        super().__init__(path, glob=glob, **kwargs)

    def next_batch(self) -> DataFrame | None:
        df = super().next_batch()
        if df is None:
            return None
        images = np.empty(len(df), object)
        errors = np.empty(len(df), object)
        for i, blob in enumerate(df["content"]):
            try:
                images[i] = decode_image(bytes(blob))
                errors[i] = None
            except Exception as e:
                images[i] = None
                errors[i] = str(e)
        return (df.with_column("image", images)
                  .with_column("error", errors))
