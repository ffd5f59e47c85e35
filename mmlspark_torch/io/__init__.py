"""IO layer, the port of ``mmlspark_tpu/io``: binary and image file reading
(``io/binary/BinaryFileFormat.scala``: whole files and zip entries as (path,
bytes) rows, and the patched image data source) and the streaming file
sources. ``io/http/`` (HTTP as a column type: the request/response schema,
the client stack, ``HTTPTransformer`` and the port forwarders) is a
subpackage the serving plane imports. The parquet readers and the PowerBI
sink come with the long tail (ROADMAP.md §1 item 11)."""

from .binary import (BinaryFileReader, decode_image, read_binary_files,
                     read_images)
from .image_source import FileStreamSource, ImageStreamSource

__all__ = ["BinaryFileReader", "decode_image", "read_binary_files",
           "read_images", "FileStreamSource", "ImageStreamSource"]
