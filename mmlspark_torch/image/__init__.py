"""Image processing and DL featurization stages, the port of
``mmlspark_tpu/image``: ``ImageTransformer`` (batched tensor ops in place of
``opencv/ImageTransformer.scala``'s per-row OpenCV), ``UnrollImage``,
``ResizeImageTransformer``, ``ImageSetAugmenter`` and ``ImageFeaturizer``
over the port's model zoo."""

from .featurizer import ImageFeaturizer
from .stages import (ImageSetAugmenter, ResizeImageTransformer,
                     UnrollBinaryImage, UnrollImage)
from .transforms import ImageTransformer, images_to_batch

__all__ = ["ImageTransformer", "ImageSetAugmenter", "ResizeImageTransformer",
           "UnrollImage", "UnrollBinaryImage", "ImageFeaturizer",
           "images_to_batch"]
