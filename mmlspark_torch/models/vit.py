"""Vision Transformer (ViT-B/16 family), the port of
``mmlspark_tpu/models/vit.py``.

torchvision's ``vit_b_16`` layout (pre-LN blocks, a class token first, learned
position embeddings) with the flax modules' numerics:

- the patchify conv is VALID with stride = patch, its bias added in the
  compute dtype after the convolution; patches flatten row-major, as the
  flax ``[N, h, w, W] → [N, h·w, W]`` reshape orders them;
- LayerNorms run in f32 with flax's eps 1e-6 (not torch's 1e-5);
- attention is dense: f32 scores (``q·kᵀ`` of the compute-dtype
  projections), divided by ``sqrt(hd)`` *after* the product, softmax in
  f32, then cast to the compute dtype before ``attn @ v``;
- the MLP's GELU is the exact (erf) form.

Endpoints (the ``cutOutputLayers`` contract): ``block1..depth`` (token
tensors ``[N, T, W]`` in the compute dtype), ``pooled`` (the final-LN class
token, f32) and ``logits`` (f32). ``pos_embedding`` is ``[1, T, W]`` with
``T = (image_size / patch)² + 1``, 197 at 224, so the module is built for
one ``image_size``. ``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dl.text_encoder import Dense, _layer_norm
from .resnet import Conv


class MHA(nn.Module):
    """Multi-head self-attention with separate ``q``/``k``/``v``/``out``
    Dense layers (torch's fused ``in_proj_weight`` splits into them)."""

    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.heads, self.width, self.dtype = heads, width, dtype
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(width, width, dtype))

    def forward(self, x):
        N, T, W = x.shape
        hd = W // self.heads

        def split(a):
            return a.view(N, T, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = q.float() @ k.float().transpose(-1, -2)
        root = torch.tensor(float(hd), device=x.device).sqrt()   # f32
        attn = torch.softmax(logits / root, dim=-1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(N, T, W)
        return self.out(out)


class Block(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, width: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = _layer_norm(width)
        self.attn = MHA(width, heads, dtype)
        self.ln_2 = _layer_norm(width)
        self.mlp_1 = Dense(width, mlp_dim, dtype)
        self.mlp_2 = Dense(mlp_dim, width, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x.float()).to(self.dtype))
        h = self.mlp_1(self.ln_2(x.float()).to(self.dtype))
        return x + self.mlp_2(F.gelu(h, approximate="none"))


class ViT(nn.Module):
    """NHWC images → ``{"block1"..f"block{depth}", "pooled", "logits"}``.

    A fresh module draws its weights from ``generator`` with flax's
    initialisers: truncated lecun-normal kernels, zero biases, a zero class
    token, position embeddings normal with std 0.02, LayerNorm 1/0."""

    def __init__(self, patch: int = 16, width: int = 768, depth: int = 12,
                 heads: int = 12, mlp_dim: int = 3072, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False,
                 image_size: int = 224,
                 generator: torch.Generator | None = None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image_size={image_size} is not a multiple of "
                             f"patch={patch}")
        self.patch, self.width, self.depth = patch, width, depth
        self.heads, self.mlp_dim, self.num_classes = heads, mlp_dim, num_classes
        self.dtype, self.remat, self.image_size = dtype, remat, image_size
        self.conv_proj = Conv(3, width, patch, patch, 0, bias=True,
                              dtype=dtype)
        self.class_token = nn.Parameter(torch.zeros(1, 1, width))
        tokens = (image_size // patch) ** 2 + 1
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, width))
        for i in range(depth):
            self.add_module(f"block{i}", Block(width, heads, mlp_dim, dtype))
        self.ln = _layer_norm(width)
        self.head = Dense(width, num_classes, dtype)
        self.reset_parameters(generator)

    @property
    def blocks(self) -> list[Block]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @property
    def layer_names(self) -> list[str]:
        return ([f"block{i + 1}" for i in range(self.depth)]
                + ["pooled", "logits"])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.conv_proj.reset_parameters(generator)
        nn.init.zeros_(self.class_token)
        nn.init.normal_(self.pos_embedding, 0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x, train: bool = False):
        """``x``: NHWC images in any numeric dtype. ``train`` is the JAX
        module's flag; there is no dropout, so both modes compute the same
        function."""
        N = x.shape[0]
        x = self.conv_proj(x.to(self.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                     # [N, T-1, W]
        cls = self.class_token.to(self.dtype).expand(N, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        if x.shape[1] != self.pos_embedding.shape[1]:
            raise ValueError(
                f"{x.shape[1]} tokens against a position table of "
                f"{self.pos_embedding.shape[1]}: the module was built for "
                f"{self.image_size}x{self.image_size} images")
        x = x + self.pos_embedding.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        endpoints = {}
        for i, blk in enumerate(self.blocks):
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
            endpoints[f"block{i + 1}"] = x
        x = self.ln(x.float())
        endpoints["pooled"] = x[:, 0]
        endpoints["logits"] = self.head(x[:, 0].to(self.dtype)).float()
        return endpoints


def ViT_B_16(num_classes=1000, dtype=torch.bfloat16, remat=False,
             image_size=224, generator=None):
    return ViT(num_classes=num_classes, dtype=dtype, remat=remat,
               image_size=image_size, generator=generator)


def ViT_L_16(num_classes=1000, dtype=torch.bfloat16, remat=False,
             image_size=224, generator=None):
    return ViT(width=1024, depth=24, heads=16, mlp_dim=4096,
               num_classes=num_classes, dtype=dtype, remat=remat,
               image_size=image_size, generator=generator)
