"""Batched image operators, the port of ``mmlspark_tpu/image/ops.py``. All
take and return float32 NHWC tensors, on whatever device they lie.

The reference shells out to OpenCV per row
(``opencv/ImageTransformer.scala:27-436``); here each operator is a few
whole-batch tensor ops:

- ``resize`` is ``jax.image.resize(method="linear")``: a separable
  triangle-kernel resampling whose kernel widens by the scale when
  downsampling (it antialiases), applied as two contractions with the JAX
  package's weight matrices (``scale_and_translate``), computed in f32 from
  its formula; a spatial axis whose size does not change is left alone;
- ``crop``, ``center_crop``, ``flip`` (OpenCV codes), ``color_format``
  (BGR; OpenCV's luma weights), the separable box ``blur`` and
  ``gaussian_blur`` (edge-replicated, along W then H) and ``threshold``
  (OpenCV's five types).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_F32_EPS = float(np.finfo(np.float32).eps)


@functools.lru_cache(maxsize=64)
def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """``[in_size, out_size]`` f32 weights of ``jax.image``'s linear
    resampling (``compute_weight_mat`` with the triangle kernel, no
    translation): output sample j reads input i with weight
    ``max(0, 1 - |s_j - i| / k)``, ``s_j = (j + 0.5) / scale - 0.5``,
    ``k = max(1 / scale, 1)``, each column normalised."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Reference ``ResizeImage`` stage (``ImageTransformer.scala:42-73``):
    ``jax.image.resize(images, (B, height, width, C), "linear")``."""
    _, H, W, _ = images.shape
    x = images.float()
    if H != height:
        wh = torch.from_numpy(_weight_mat(H, height)).to(x.device)
        x = torch.einsum("nhwc,ho->nowc", x, wh)
    if W != width:
        ww = torch.from_numpy(_weight_mat(W, width)).to(x.device)
        x = torch.einsum("nhwc,wp->nhpc", x, ww)
    return x.contiguous()


def crop(images: torch.Tensor, x: int, y: int, height: int,
         width: int) -> torch.Tensor:
    """Reference ``CropImage`` (``ImageTransformer.scala:75-100``): (x, y)
    is the top-left corner, x the column offset, y the row offset."""
    return images[:, y:y + height, x:x + width, :]


def center_crop(images: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    _, H, W, _ = images.shape
    y = max((H - height) // 2, 0)
    x = max((W - width) // 2, 0)
    return images[:, y:y + height, x:x + width, :]


def flip(images: torch.Tensor, flip_code: int = 1) -> torch.Tensor:
    """Reference ``Flip`` (``ImageTransformer.scala:122-146``); OpenCV
    codes: 1 = horizontal (around the y-axis), 0 = vertical, -1 = both."""
    if flip_code == 1:
        return images.flip(2)
    if flip_code == 0:
        return images.flip(1)
    return images.flip(1, 2)


def color_format(images: torch.Tensor, conversion: str) -> torch.Tensor:
    """Reference ``ColorFormat`` (``ImageTransformer.scala:102-120``).
    Images are BGR-ordered (the Spark ImageSchema convention)."""
    if conversion in ("bgr2gray", "gray"):
        b, g, r = images[..., 0], images[..., 1], images[..., 2]
        return (0.114 * b + 0.587 * g + 0.299 * r)[..., None]
    if conversion == "bgr2rgb":
        return images.flip(-1)
    raise ValueError(f"unsupported conversion {conversion!r}")


def _gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    # OpenCV: sigma <= 0 → computed from the kernel size
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-x ** 2 / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _depthwise_sep_conv(images: torch.Tensor, kx: np.ndarray,
                        ky: np.ndarray) -> torch.Tensor:
    """Separable depthwise convolution: 1-D kernels along W then H, over
    edge-replicated padding."""
    C = images.shape[-1]
    px, py = len(kx) // 2, len(ky) // 2
    x = images.float().permute(0, 3, 1, 2)                  # NCHW view
    x = F.pad(x, (px, px, py, py), mode="replicate")
    wx = torch.from_numpy(kx).to(x.device).view(1, 1, 1, -1)
    x = F.conv2d(x, wx.expand(C, 1, 1, len(kx)).contiguous(), groups=C)
    wy = torch.from_numpy(ky).to(x.device).view(1, 1, -1, 1)
    x = F.conv2d(x, wy.expand(C, 1, len(ky), 1).contiguous(), groups=C)
    return x.permute(0, 2, 3, 1).contiguous()


def blur(images: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Reference ``Blur`` (``ImageTransformer.scala:148-170``): a
    normalised box filter of size (width, height)."""
    kh, kw = int(height), int(width)
    kx = np.full(kw, 1.0 / kw, np.float32)
    ky = np.full(kh, 1.0 / kh, np.float32)
    return _depthwise_sep_conv(images, kx, ky)


def gaussian_blur(images: torch.Tensor, aperture_size: int,
                  sigma: float) -> torch.Tensor:
    """Reference ``GaussianKernel`` (``ImageTransformer.scala:199-221``)."""
    k = _gaussian_kernel_1d(aperture_size, sigma)
    return _depthwise_sep_conv(images, k, k)


def threshold(images: torch.Tensor, thresh: float, max_val: float,
              threshold_type: str = "binary") -> torch.Tensor:
    """Reference ``Threshold`` (``ImageTransformer.scala:172-197``); OpenCV
    threshold types."""
    zero = torch.zeros((), dtype=images.dtype, device=images.device)
    top = torch.full((), max_val, dtype=images.dtype, device=images.device)
    t = {"binary": lambda x: torch.where(x > thresh, top, zero),
         "binary_inv": lambda x: torch.where(x > thresh, zero, top),
         "trunc": lambda x: torch.clamp_max(x, thresh),
         "tozero": lambda x: torch.where(x > thresh, x, zero),
         "tozero_inv": lambda x: torch.where(x > thresh, zero, x)}
    if threshold_type not in t:
        raise ValueError(f"unknown threshold type {threshold_type!r}")
    return t[threshold_type](images)
