"""Post-training int8 quantization, the port of
``mmlspark_tpu/models/quantize.py``.

The scheme is the JAX package's (w8a8-dynamic):

- BatchNorm folds into the preceding conv (``w' = w·γ/√(σ²+ε)``,
  ``b' = β − μ·γ/√(σ²+ε)``), so the quantized graph has no normalisation;
- weights: per-output-channel symmetric int8, ``s_c = max|w_c| / 127``;
- activations: per-row symmetric int8 with a dynamic scale (the max over
  every non-batch axis), so a row's features never depend on its minibatch
  neighbours;
- round half to even (``torch.round``, as ``jnp.round``), clip to ±127;
- the products accumulate in **int32, exactly**, and dequantize as
  ``y·(s_x·s_c) + b`` in f32; residual adds, ReLU and pooling stay in f32.

f32 cannot hold the sums exactly (a 3x3x512 conv sums up to 7.4e7 > 2²⁴), so
the int8 product is ``torch._int_mm`` over an im2col of the int8
activations: cuBLAS's int8 GEMM on the card, an integer GEMM on the CPU;
both give the exact int32 sums. ``_int_mm`` needs more than 16 rows and a
multiple of 8 in K and N, so :func:`int8_matmul` zero-pads them (conv_init's
K is 7·7·3 = 147). The JAX package does this product in XLA, outside any
Pallas kernel, so the port's counterpart is the library call.

``quantize_resnet`` returns ``(q_forward, qparams)`` as the JAX version
does, ``q_forward(qparams, images) -> pooled [N, C] f32``; qparams hold
the weights in HWIO order, int8, beside their f32 scales and folded biases,
on the module's device. ``quantize_text_encoder`` does the same for a
``TextEncoder``'s dense layers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-5


def _fold(conv, bn):
    """Fold a BatchNorm into its preceding bias-free conv: the conv's
    weight in HWIO order (``[kh, kw, ci, co]``, the JAX layout) and the
    folded bias, both f32."""
    w = conv.weight.detach().float().permute(2, 3, 1, 0)
    inv = bn.scale.detach().float() / torch.sqrt(bn.var.float() + _EPS)
    return w * inv, bn.bias.detach().float() - bn.mean.float() * inv


def _quant_w(w):
    """Per-output-channel symmetric int8 over an HWIO kernel:
    ``(w_q int8, scale f32 [co])``."""
    s = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq.contiguous(), s


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - x.shape[dim]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 ``a`` [M, K] and ``b`` [K, N] through
    ``torch._int_mm``, zero-padding M past 16 rows and K, N to multiples
    of 8 (zero rows and columns add nothing to the sums)."""
    M, K = a.shape
    N = b.shape[1]
    Kp, Np, Mp = -(-K // 8) * 8, -(-N // 8) * 8, max(M, 17)
    a = _pad_to(_pad_to(a, 1, Kp), 0, Mp)
    b = _pad_to(_pad_to(b, 0, Kp), 1, Np)
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def _quantize_rows(x):
    """Per-row dynamic int8: ``(x_q int8, s_x f32 [N, 1, ..., 1])``."""
    axes = tuple(range(1, x.ndim))
    s_x = torch.clamp_min(x.abs().amax(dim=axes, keepdim=True) / 127.0,
                          1e-12)
    return torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8), s_x


def _im2col(xq, kh: int, kw: int, stride: int, pad: int):
    """NHWC int8 → ``[N·Ho·Wo, kh·kw·C]`` patches in (i, j, c) order (the
    HWIO kernel's row order); zero padding is zero in int8 too."""
    N, H, W, C = xq.shape
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    Ho = (H + 2 * pad - kh) // stride + 1
    Wo = (W + 2 * pad - kw) // stride + 1
    cols = [xq[:, i:i + stride * (Ho - 1) + 1:stride,
               j:j + stride * (Wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    patches = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return patches.reshape(N * Ho * Wo, kh * kw * C), (N, Ho, Wo)


def _qconv(x, wq, s_w, b, *, stride: int, pad: int):
    """int8 conv (NHWC) with a dynamic per-row activation scale; f32 out."""
    xq, s_x = _quantize_rows(x)
    kh, kw, ci, co = wq.shape
    patches, (N, Ho, Wo) = _im2col(xq, kh, kw, stride, pad)
    y = int8_matmul(patches, wq.reshape(kh * kw * ci, co))
    y = y.reshape(N, Ho, Wo, co)
    return y.float() * (s_x * s_w) + b


def _block_layout(block_name: str):
    """(stride taken, padding) of each main conv of a block type; a conv
    past them is the 1x1 downsample."""
    if block_name == "BasicBlock":
        return [(True, 1), (False, 1)]
    return [(False, 0), (True, 1), (False, 0)]


def quantize_resnet(module):
    """Fold and quantize a port ``ResNet`` (any of the zoo's, both block
    types); returns ``(q_forward, qparams)`` with ``q_forward(qparams,
    images) -> pooled [N, C] f32`` (the ImageFeaturizer feature vector).
    The dense head stays out: the endpoint of record is the pooled vector
    before it."""
    from .resnet import ResNet
    if not isinstance(module, ResNet):
        raise TypeError(f"quantize_resnet takes a ResNet, got "
                        f"{type(module).__name__}")
    w, b = _fold(module.conv_init, module.bn_init)
    q = {"conv_init": (*_quant_w(w), b), "blocks": []}
    for blk in module.blocks:
        n = len(blk.mains) + int(blk.has_down)
        q["blocks"].append([
            (*_quant_w(w), b) for w, b in (
                _fold(getattr(blk, f"Conv_{k}"), getattr(blk, f"BatchNorm_{k}"))
                for k in range(n))])
    layout = _block_layout(module.block.__name__)
    return functools.partial(_q_forward_resnet, tuple(module.stage_sizes),
                             layout), q


def _q_forward_resnet(stage_sizes, layout, qp, x):
    x = x.float()
    wq, sw, bias = qp["conv_init"]
    x = F.relu(_qconv(x, wq, sw, bias, stride=2, pad=3))
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    idx = 0
    for i, nb in enumerate(stage_sizes):
        for j in range(nb):
            strides = 2 if i > 0 and j == 0 else 1
            qconvs = qp["blocks"][idx]
            y = x
            for ci, (strided, pad) in enumerate(layout):
                wq, sw, bias = qconvs[ci]
                y = _qconv(y, wq, sw, bias,
                           stride=strides if strided else 1, pad=pad)
                if ci < len(layout) - 1:
                    y = F.relu(y)
            residual = x
            if len(qconvs) > len(layout):
                wq, sw, bias = qconvs[-1]
                residual = _qconv(x, wq, sw, bias, stride=strides, pad=0)
            x = F.relu(y + residual)
            idx += 1
    return x.mean((1, 2))


def cosine_fidelity(a, b) -> float:
    """Mean row-wise cosine similarity — the one copy of the fidelity
    arithmetic."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return float((num / np.maximum(den, 1e-12)).mean())


def quantization_fidelity(module, q_forward, qparams, images) -> float:
    """Mean cosine between the module's pooled features and the int8
    path's on ``images`` (NHWC, on the module's device)."""
    with torch.inference_mode():
        ref = module(images)["pooled"]
        got = q_forward(qparams, images)
    return cosine_fidelity(ref.float().cpu().numpy(),
                           got.float().cpu().numpy())


class QuantizedResNet(torch.nn.Module):
    """A module around ``quantize_resnet``'s output, so ``TPUModel`` runs
    it as any model: ``forward(x) -> {"pooled": ...}``. The int8 weights,
    scales and biases are buffers, so ``.to(device)`` moves them."""

    def __init__(self, module):
        super().__init__()
        self.q_forward, qparams = quantize_resnet(module)
        flat = [("conv_init", qparams["conv_init"])] + [
            (f"b{i}_{k}", c) for i, convs in enumerate(qparams["blocks"])
            for k, c in enumerate(convs)]
        self.layout = [len(c) for c in qparams["blocks"]]
        for name, (wq, s, b) in flat:
            self.register_buffer(f"{name}_wq", wq)
            self.register_buffer(f"{name}_s", s)
            self.register_buffer(f"{name}_b", b)

    def qparams(self) -> dict:
        def get(name):
            return tuple(getattr(self, f"{name}_{p}") for p in ("wq", "s", "b"))
        return {"conv_init": get("conv_init"),
                "blocks": [[get(f"b{i}_{k}") for k in range(n)]
                           for i, n in enumerate(self.layout)]}

    def forward(self, x, train: bool = False):
        return {"pooled": self.q_forward(self.qparams(), x)}


# ------------------------------------------------------------------- text
def _quant_dense_w(w):
    """Per-output-column symmetric int8 for a dense kernel ``[in, out]``."""
    s = torch.clamp_min(w.abs().amax(dim=0) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return wq, s


def _qdense(x, wq, s_w, b):
    """int8 matmul with a dynamic per-row activation scale; f32 out.
    ``x`` [N, ..., in] → [N, ..., out]; the scale is the max over the
    non-batch axes, so a row's output is independent of its neighbours."""
    if x.ndim < 2:
        raise ValueError("_qdense needs a batched input [N, ..., in]; "
                         f"got shape {tuple(x.shape)}")
    xq, s_x = _quantize_rows(x)
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    y = y.reshape(*x.shape[:-1], wq.shape[1])
    return y.float() * (s_x * s_w) + b


def _ln(x, p):
    """LayerNorm in f32 (flax defaults: eps 1e-6, scale and bias)."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * p["scale"] + p["bias"]


def _dense_params(d):
    """A port ``Dense`` (weight ``[out, in]``) → ``(w_q [in, out], s, b)``."""
    return (*_quant_dense_w(d.weight.detach().float().T),
            d.bias.detach().float())


def _norm_params(ln):
    return {"scale": ln.weight.detach().float(),
            "bias": ln.bias.detach().float()}


def quantize_text_encoder(module):
    """w8a8-dynamic quantization of a port ``TextEncoder``'s dense layers
    (qkv, out, mlp: the bulk of the encoder's FLOPs); the embedding,
    LayerNorms, softmax and the attention contraction stay in f32. Returns
    ``(q_forward, qparams)`` with ``q_forward(qparams, ids) -> pooled [N, W]
    f32``, the ``TextEncoderFeaturizer`` feature vector.

    Dense attention only (causality read off ``module.attention_fn``, as the
    JAX version reads it): the flash kernels or a sharded attention raise
    rather than quantize into a forward of other semantics."""
    from ..dl.text_encoder import _dense_attention
    fn = module.attention_fn
    if fn is _dense_attention:
        causal = False
    elif isinstance(fn, functools.partial) and fn.func is _dense_attention:
        causal = bool(fn.keywords.get("causal", False))
    else:
        raise ValueError(
            "quantize_text_encoder supports dense attention only "
            "(make_attention_fn('dense', ...)); got a custom/sharded "
            "attention_fn whose semantics the quantized forward "
            "cannot reproduce")
    q = {"embed": module.embed.weight.detach().float(),
         "blocks": [{"ln_1": _norm_params(b.ln_1), "ln_2": _norm_params(b.ln_2),
                     "qkv": _dense_params(b.qkv), "out": _dense_params(b.out),
                     "mlp_1": _dense_params(b.mlp_1),
                     "mlp_2": _dense_params(b.mlp_2)}
                    for b in module.blocks],
         "ln": _norm_params(module.ln)}
    return functools.partial(_q_forward_text, module.heads, module.width,
                             causal), q


def _q_forward_text(heads, width, causal, qp, ids):
    N, T = ids.shape
    hd = width // heads
    x = qp["embed"][ids]                                  # [N, T, W] f32
    pos = torch.arange(T, device=ids.device, dtype=torch.float32)[:, None]
    dim = torch.arange(width // 2, device=ids.device,
                       dtype=torch.float32)[None, :]
    ang = pos / 10000.0 ** (2 * dim / width)
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]
    key_mask = ids != 0

    def split(a):
        return a.reshape(N, T, heads, hd).transpose(1, 2)

    for bp in qp["blocks"]:
        h = _ln(x, bp["ln_1"])
        qh, kh, vh = _qdense(h, *bp["qkv"]).split(width, dim=-1)
        s = (split(qh) @ split(kh).transpose(-1, -2)) * hd ** -0.5
        if causal:
            tri = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()
            s = s.masked_fill(~tri, float("-inf"))
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        o = (p @ split(vh)).transpose(1, 2).reshape(N, T, width)
        x = x + _qdense(o, *bp["out"])
        h = F.gelu(_qdense(_ln(x, bp["ln_2"]), *bp["mlp_1"]),
                   approximate="tanh")
        x = x + _qdense(h, *bp["mlp_2"])
    x = _ln(x, qp["ln"])
    mask = key_mask.float()[..., None]
    return (x * mask).sum(1) / mask.sum(1).clamp_min(1.0)
