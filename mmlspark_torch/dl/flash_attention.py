"""K2a: the flash-attention forward — CUDA kernel, plain version, and switch.

The long-context encoder's hot op. The JAX package runs it as the Pallas TPU
kernel ``_flash_kernel`` (``mmlspark_tpu/dl/pallas_attention.py:77``,
launched by ``_flash_forward`` at ``:337``) behind ``flash_attention``
(``:696-740``). Here:

- :func:`flash_cuda` launches the hand-written Hopper kernel in
  ``csrc/flash_attn.cu`` (built with nvcc for ``sm_90a`` on first use, bound
  with ctypes); see the source for its design and what bounds it;
- :func:`flash_torch` is the plain PyTorch version: dense f32 scores with
  the kernel's masking semantics (the tests and the CPU route use it);
- :func:`flash_attention` is the switch: the kernel for CUDA tensors, the
  plain version for CPU tensors. A build or launch failure raises; nothing
  falls back.

Contract: q/k/v ``[B, H, T, D]`` of one dtype (bf16 or f32), ``key_mask``
``[B, T]`` bool (True = valid, None = all valid) → ``[B, H, T, D]`` in v's
dtype. Invalid keys score ``-1e30`` (not ``-inf``), ``p`` is zeroed again
at invalid keys after ``exp``, the unnormalised ``p`` is cast to v's dtype
before the PV product, and the output is ``acc / max(l, 1e-35)``: a row
with no valid key is exactly 0.

Not ported here: the causal variants and the logsumexp output (K2b, K2c;
ROADMAP.md §2), the backward kernels (K2d, K2e), and the TPU's block-size
resolution and autotune lookup, which size blocks for VMEM.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..native.loader import CudaLoader

HEAD_DIMS = (32, 64, 128)
NEG = -1e30               # the TPU kernel's additive mask value
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ALIGN = 16               # the kernel stages K/V rows as 16-byte vectors

_LOADER = CudaLoader("mmlspark_flash", ["dl/csrc/flash_attn.cu"])

LATER_CAUSAL = ("causal flash attention (K2c and causal K2a) comes with the "
                "LLM slice (ROADMAP.md §1 item 8, §2)")
LATER_LSE = ("flash_attention_lse (K2b) comes with text-encoder training "
             "(ROADMAP.md §1 item 7, §2)")


def _check_inputs(q, k, v, key_mask) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must all be [B, H, T, D] of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if key_mask is not None:
        B, _, T, _ = q.shape
        if key_mask.shape != (B, T) or key_mask.dtype != torch.bool:
            raise ValueError(f"key_mask must be bool [B, T] = [{B}, {T}], "
                             f"got {key_mask.dtype} {tuple(key_mask.shape)}")
        if key_mask.device != q.device:
            raise ValueError(f"key_mask on {key_mask.device}, q on "
                             f"{q.device}")


def flash_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K2a: the whole score matrix in f32 at once, with the
    kernel's masking and casting (one k-block of the TPU kernel)."""
    _check_inputs(q, k, v, key_mask)
    D = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * D ** -0.5
    if key_mask is not None:
        allowed = key_mask[:, None, None, :]
        s = torch.where(allowed, s, NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    if key_mask is not None:
        p = torch.where(allowed, p, 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-35)).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _LOADER.load()
    c_void_p, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mmlspark_flash_launch.argtypes = [
        c_void_p, c_void_p, c_void_p, c_void_p, c_void_p,  # q k v mask o
        c_int, c_int, c_int, c_int, c_int,                 # dtype B H T D
        *[c_ll] * 12,                                      # q/k/v/o strides
        c_ll, ctypes.c_float,                              # mask stride, scale
        c_int, c_void_p]                                   # device, stream
    lib.mmlspark_flash_launch.restype = c_int
    lib.mmlspark_flash_error_string.argtypes = [c_int]
    lib.mmlspark_flash_error_string.restype = ctypes.c_char_p
    return lib


def build_kernel() -> str:
    """Build (if needed) and load K2a; returns nvcc's output for the build
    (registers, shared memory, spills), or "" if it was built earlier."""
    _library()
    return _LOADER.build_log()


def _check_layout(name: str, t: torch.Tensor) -> None:
    """Unit stride on D and 16-byte-aligned rows: what the kernel's vector
    loads need. Strided views (the split of a fused qkv projection) pass;
    nothing is copied to make a tensor fit."""
    size = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name} needs unit stride on D, got strides "
                         f"{t.stride()}")
    if t.data_ptr() % _ALIGN or any(s * size % _ALIGN for s in t.stride()[:3]):
        raise ValueError(f"{name} rows must start on {_ALIGN}-byte "
                         f"boundaries (strides {t.stride()}, "
                         f"{size}-byte elements)")


def flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K2a (``csrc/flash_attn.cu``) on PyTorch's current stream.
    Forward only: raises when an input requires grad with grad mode on
    (the backward kernels come with training). Raises for tensors that are
    not on a CUDA device, for a dtype other than bf16/f32 or a head dim
    other than 32/64/128, and when the kernel does not build or launch.

    Returns a ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer, so the
    caller's head merge is a free reshape."""
    _check_inputs(q, k, v, key_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_cuda is forward-only: an input requires grad, and the "
            "backward kernels (K2d/K2e) come with text-encoder training "
            "(ROADMAP.md §1 item 7); run under torch.inference_mode() or "
            "use flash_torch")
    if q.device.type != "cuda":
        raise ValueError(f"flash_cuda needs CUDA tensors, got {q.device}; "
                         "use flash_torch (or flash_attention) for CPU "
                         "tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_cuda takes bf16 or f32, got {q.dtype}")
    B, H, T, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_cuda takes head dims {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    out = torch.empty(B, T, H, D, dtype=v.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if T == 0 or B * H == 0:
        return out
    mask = None
    if key_mask is not None:
        mask = key_mask.contiguous()      # [B, T] bytes, not q/k/v
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mmlspark_flash_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], B, H, T, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], T if mask is None else mask.stride(0),
        D ** -0.5, q.device.index, stream)
    if err != 0:
        raise RuntimeError(
            "K2a flash-attention kernel launch failed: "
            f"{lib.mmlspark_flash_error_string(err).decode()} (cudaError "
            f"{err})")
    flash_cuda.launches += 1
    return out


flash_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: torch.Tensor | None = None, *,
                    causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0, impl: str | None = None
                    ) -> torch.Tensor:
    """Fused flash attention, the port of ``pallas_attention.flash_attention``
    (non-causal forward). q/k/v ``[B, H, T, D]``; ``key_mask`` ``[B, T]``
    bool (True = valid). ``impl=None`` takes the kernel (``"cuda"``) for
    CUDA tensors and the plain version (``"torch"``) for CPU tensors;
    ``impl="cuda"`` on CPU tensors raises; ``impl="torch"`` runs the plain
    version on any device."""
    if causal or q_offset or k_offset:
        raise NotImplementedError(LATER_CAUSAL)
    if impl is None:
        impl = "cuda" if q.device.type == "cuda" else "torch"
    if impl == "cuda":
        return flash_cuda(q, k, v, key_mask)
    if impl == "torch":
        return flash_torch(q, k, v, key_mask)
    raise ValueError(f"impl must be None, 'cuda' or 'torch', got {impl!r}")


def flash_attention_lse(*args, **kwargs):
    """The logsumexp-returning variant (K2b): not ported yet."""
    raise NotImplementedError(LATER_LSE)
