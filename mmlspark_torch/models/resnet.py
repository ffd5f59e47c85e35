"""ResNet family, the port of ``mmlspark_tpu/models/resnet.py``.

The forward returns every named endpoint (``stage1..4``, ``pooled``,
``logits``), so ``ImageFeaturizer``'s ``cutOutputLayers`` is a dict lookup.
The numerics follow the flax modules:

- input is NHWC, as the image column holds it; it is cast to the compute
  dtype and viewed as NCHW in ``channels_last`` memory, the layout cuDNN
  runs NHWC convolutions in, so no transpose is copied;
- bf16 compute over f32 parameters and BatchNorm statistics: each conv casts
  its f32 weight at use; BatchNorm normalises in f32 and rounds to the
  compute dtype;
- explicit symmetric pads (the torchvision convention, which converted
  checkpoints need), the stem's max pool ``(3, 3) / (2, 2)`` with pad 1 and
  ``-inf`` fill;
- the stage endpoints go out in **NHWC** order (a permuted view of the
  channels_last activations), as the JAX package's do: ``TPUModel``
  flattens them, so NCHW order would permute every flattened feature;
- ``pooled`` is the spatial mean in the compute dtype, then f32; ``logits``
  the head's output in f32.

BatchNorm under ``train=True`` follows flax, not ``nn.BatchNorm2d``: the
batch mean and the biased variance (``E[x²] − E[x]²`` in f32, clipped at 0)
normalise, and the running statistics move as ``0.9 · old + 0.1 · batch``,
eps 1e-5. The update is committed once, after the whole forward, so a
``remat=True`` block (``torch.utils.checkpoint``, the counterpart of
``nn.remat``) that is recomputed in the backward does not move them twice.

Parameter names mirror the flax tree (``conv_init``, ``bn_init``,
``BottleneckBlock_<i>.Conv_<k>``, ``BatchNorm_<k>`` with ``scale``,
``bias`` and the ``mean``/``var`` buffers, ``head``); conv weights are
stored OIHW, the torch layout. ``models.convert`` carries weights in from a
torchvision state dict or from the JAX package's variables.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dl.text_encoder import LECUN_TRUNC, Dense
from ..parallel.partition import DtypePolicy, register_partition_rules

BN_EPS = 1e-5                # flax BatchNorm's default
BN_MOMENTUM = 0.9


class Conv(nn.Module):
    """flax ``nn.Conv(dtype=...)`` with explicit symmetric padding: an f32
    weight stored OIHW, cast to the compute dtype (in channels_last memory)
    at use; a bias, when there is one, is added in the compute dtype after
    the convolution, as flax adds it."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's Conv init: truncated lecun-normal kernel, zero bias."""
        fan_in = self.weight[0].numel()
        std = fan_in ** -0.5 / LECUN_TRUNC
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x.to(self.dtype), w, None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, dtype=...)`` over the channel axis
    of an NCHW-shaped tensor: ``scale``/``bias`` parameters and ``mean``/
    ``var`` running statistics, all f32; the output is rounded to the
    compute dtype."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.pending: tuple | None = None      # batch stats to commit

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            mu = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mu * mu).clamp_min(0.0)
            self.pending = (mu.detach(), var.detach())
        else:
            mu, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (xf - mu[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)

    @torch.no_grad()
    def commit(self) -> None:
        """Move the running statistics toward the last batch's (flax's
        rule), once per forward."""
        if self.pending is not None:
            mu, var = self.pending
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mu)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
            self.pending = None


class _Block(nn.Module):
    """Shared by both block types: ``Conv_<k>``/``BatchNorm_<k>`` in flax's
    call order, the last of the main path's norms initialised to zero, and
    the 1x1 downsample (the next index) when the residual's shape
    changes."""

    expansion = 1
    mains: tuple = ()            # (kernel, padding, takes the stride)

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        widths = self._widths(cin, filters)
        for k, ((kernel, pad, strided), (ci, co)) in enumerate(
                zip(self.mains, widths)):
            self.add_module(f"Conv_{k}", Conv(
                ci, co, kernel, strides if strided else 1, pad, dtype=dtype))
            self.add_module(f"BatchNorm_{k}", BatchNorm(co, dtype))
        out = filters * self.expansion
        self.has_down = cin != out or strides != 1
        if self.has_down:
            n = len(self.mains)
            self.add_module(f"Conv_{n}", Conv(cin, out, 1, strides,
                                              dtype=dtype))
            self.add_module(f"BatchNorm_{n}", BatchNorm(out, dtype))

    def _widths(self, cin: int, filters: int) -> list:
        raise NotImplementedError(
            f"{type(self).__name__}: a block type lists its convolutions' "
            "(in, out) widths")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for m in self.children():
            if isinstance(m, Conv):
                m.reset_parameters(generator)
        getattr(self, f"BatchNorm_{len(self.mains) - 1}").scale.zero_()

    def forward(self, x, train: bool = False):
        y = x
        n = len(self.mains)
        for k in range(n):
            y = getattr(self, f"BatchNorm_{k}")(
                getattr(self, f"Conv_{k}")(y), train)
            if k < n - 1:
                y = F.relu(y)
        residual = x
        if self.has_down:
            residual = getattr(self, f"BatchNorm_{n}")(
                getattr(self, f"Conv_{n}")(x), train)
        return F.relu(y + residual)


class BasicBlock(_Block):
    """Two 3x3 convs, the stride on the first."""

    mains = ((3, 1, True), (3, 1, False))

    def _widths(self, cin, filters):
        return [(cin, filters), (filters, filters)]


class BottleneckBlock(_Block):
    """1x1, 3x3 (the stride: torchvision's v1.5), 1x1 to 4x the filters."""

    expansion = 4
    mains = ((1, 0, False), (3, 1, True), (1, 0, False))

    def _widths(self, cin, filters):
        return [(cin, filters), (filters, filters), (filters, 4 * filters)]


class ResNet(nn.Module):
    """NHWC images → ``{"stage1".."stage4", "pooled", "logits"}``.

    ``pooled`` (the global-average-pool vector) is the transfer-learning
    feature. A fresh module draws its weights from ``generator`` with
    flax's initialisers (the same distributions as the JAX package, not the
    same bits): truncated lecun-normal kernels, BatchNorm 1/0 with each
    block's last scale 0, running statistics 0/1."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BottleneckBlock,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.block, self.num_classes, self.width = block, num_classes, width
        self.dtype, self.remat = dtype, remat
        self.conv_init = Conv(3, width, 7, 2, 3, dtype=dtype)
        self.bn_init = BatchNorm(width, dtype)
        cin, idx = width, 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"{block.__name__}_{idx}", block(
                    cin, width * 2 ** i, strides, dtype))
                cin = width * 2 ** i * block.expansion
                idx += 1
        self.head = Dense(cin, num_classes, dtype)
        self.reset_parameters(generator)

    @property
    def blocks(self) -> list:
        return [getattr(self, f"{self.block.__name__}_{i}")
                for i in range(sum(self.stage_sizes))]

    @property
    def layer_names(self) -> list[str]:
        """Feature endpoints ordered shallow→deep (the reference's
        ``ModelSchema.layerNames``)."""
        return ([f"stage{i + 1}" for i in range(len(self.stage_sizes))]
                + ["pooled", "logits"])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.conv_init.reset_parameters(generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, x, train: bool = False):
        """``x``: NHWC images in any numeric dtype."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # NCHW, channels_last
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        remat = self.remat and torch.is_grad_enabled()
        endpoints, blocks = {}, iter(self.blocks)
        for i, n_blocks in enumerate(self.stage_sizes):
            for _ in range(n_blocks):
                blk = next(blocks)
                x = (checkpoint(blk, x, train, use_reentrant=False)
                     if remat else blk(x, train))
            endpoints[f"stage{i + 1}"] = x.permute(0, 2, 3, 1)   # NHWC
        pooled = x.mean((2, 3))
        endpoints["pooled"] = pooled.float()
        endpoints["logits"] = self.head(pooled).float()
        if train:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.commit()
        return endpoints


# Partition rules for the ResNet family, the JAX package's (resnet.py:
# 149-164) on the port's names: conv weights are OIHW here (HWIO in flax),
# so the out-channel dim the flax spec ("tp",) shards is dim 0; the head's
# torch weight is [out, in]. BatchNorm scales, biases and statistics
# replicate.
register_partition_rules("ResNet", [
    (r"(bn_init|BatchNorm_\d+)/(scale|bias|mean|var)", ()),
    (r"conv_init/weight", ("tp", None, None, None)),
    (r"Conv_\d+/weight", ("tp", None, None, None)),
    (r"head/weight", ("tp", None)),
    (r"head/bias", ()),
],
    dtype_policy=DtypePolicy(param_dtype="float32",
                             compute_dtype="bfloat16",
                             grad_accum_dtype="float32"),
    activation_spec=("dp",))


def ResNet18(num_classes=1000, dtype=torch.bfloat16, remat=False,
             generator=None):
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, dtype=dtype,
                  remat=remat, generator=generator)


def ResNet34(num_classes=1000, dtype=torch.bfloat16, remat=False,
             generator=None):
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes, dtype=dtype,
                  remat=remat, generator=generator)


def ResNet50(num_classes=1000, dtype=torch.bfloat16, remat=False,
             generator=None):
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes, dtype=dtype,
                  remat=remat, generator=generator)


def ResNet101(num_classes=1000, dtype=torch.bfloat16, remat=False,
              generator=None):
    return ResNet((3, 4, 23, 3), BottleneckBlock, num_classes, dtype=dtype,
                  remat=remat, generator=generator)
