"""K3: paged window attention over the block table — CUDA kernel, plain
version and switch.

The LLM serving engine's hot op. The JAX package runs it as the Pallas TPU
kernel ``_paged_kernel`` (``mmlspark_tpu/dl/pallas_paged_attention.py:89``,
launched by ``_paged_pallas`` at ``:199``) behind ``paged_window_attention``,
with the pure-lax ``_paged_reference`` off the TPU. Here:

- :func:`paged_cuda` launches the hand-written Hopper kernel in
  ``csrc/paged_attn.cu`` (its own library, built with nvcc for ``sm_90a`` on
  first use and bound with ctypes; see the source for its design and what
  bounds it) and counts its launches;
- :func:`paged_torch` is the plain version: it gathers each slot's chain
  through the table inside the call, then applies exactly the formulation
  of ``EncoderBlock.decode_window`` and ``_paged_reference`` (f32 scores ×
  ``hd^-0.5``, ``-inf`` outside ``t <= pos + i``, softmax, NaN → 0, ``p``
  cast to v's dtype), which keeps the engine token-identical to
  ``dl.generate`` on the CPU;
- :func:`paged_window_attention` is the switch: the kernel for CUDA
  tensors, the plain version for CPU tensors. A build or launch failure
  raises; nothing falls back.

Contract: q ``[S, H, w, hd]`` holds w query rows per slot at global
positions ``pos[s] + i``; ``k_pool``/``v_pool`` are one layer's pools
``[NB, BL, H, hd]`` (the window's own k/v already scattered); ``rows``
``[S, MB]`` is ``PagedKVManager.block_rows`` (``TRASH_BLOCK`` padding);
``pos`` ``[S]``. Row i attends chain positions ``t <= pos[s] + i``. The
kernel skips trash entries whole (a slot whose row is all trash gives
exactly 0); the plain version, as ``_paged_reference``, masks by position
only, so the two agree wherever the chain covers ``[0, pos + w)``, which is
every live slot of the engine.

Head dims: K3 is built for hd = 32, 64, 128 and 256 (256 in bf16 only;
the f32 kernel stops at 128). The engine allocates its pools at the
kernel's head dim on every device (``paged_kv.pool_head_dim``: hd padded up
to the next of those, once), the window's k/v are zero-padded as they are
scattered, and both versions take pools wider than q: q is zero-padded to
the pools' width, scores are scaled by q's true ``hd^-0.5`` and the output
is sliced back to hd. hd above 256 (above 128 in f32) raises on CUDA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..native.loader import CudaLoader
from .flash_attention import (F32_HEAD_DIM_MAX, HEAD_DIMS, _unpad,
                              pad_head_dim)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ALIGN = 16               # the kernel stages rows as 16-byte vectors

_LOADER = CudaLoader("mmlspark_paged", ["dl/csrc/paged_attn.cu"])


def _check_inputs(q, k_pool, v_pool, rows, pos) -> None:
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError("q must be [S, H, w, hd] and the pools one "
                         f"[NB, BL, H, hd] shape, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    S, H, _, hd = q.shape
    if k_pool.shape[2:] != (H, hd):
        raise ValueError(f"pools {tuple(k_pool.shape)} do not hold "
                         f"{H} heads of {hd} for q {tuple(q.shape)}")
    if not q.dtype == k_pool.dtype == v_pool.dtype:
        raise TypeError(f"q and pool dtypes differ: {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if rows.dim() != 2 or rows.shape[0] != S or pos.shape != (S,):
        raise ValueError(f"rows must be [S, max_blocks] and pos [S] with "
                         f"S = {S}, got {tuple(rows.shape)}, "
                         f"{tuple(pos.shape)}")
    for name, t in (("rows", rows), ("pos", pos)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if len({t.device for t in (q, k_pool, v_pool, rows, pos)}) != 1:
        raise ValueError("q, the pools, rows and pos must be on one device")


def paged_torch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K3: gather each chain through the table, then dense
    attention with the ``decode_window`` formulation. Returns
    ``[S, H, w, hd]`` in v's dtype, hd being q's; pools wider than q are
    zero-padded columns (scores scaled by q's own ``hd^-0.5``)."""
    d = q.shape[-1]
    q = pad_head_dim(q, k_pool.shape[-1])
    _check_inputs(q, k_pool, v_pool, rows, pos)
    S, H, w, hd = q.shape
    NB, BL = k_pool.shape[:2]
    L = rows.shape[1] * BL
    dev = q.device
    idx = (rows.long()[:, :, None] * BL
           + torch.arange(BL, device=dev)).reshape(S, L)
    k = k_pool.reshape(NB * BL, H, hd)[idx].transpose(1, 2)  # [S, H, L, hd]
    v = v_pool.reshape(NB * BL, H, hd)[idx].transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    limit = pos.long()[:, None] + torch.arange(w, device=dev)    # [S, w]
    allowed = torch.arange(L, device=dev) <= limit[:, :, None]   # [S, w, L]
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)[..., :d]


# ------------------------------------------------------------- the kernel

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _LOADER.load()
    c_void_p, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mmlspark_paged_launch.argtypes = [
        *[c_void_p] * 6,                             # q k v rows pos o
        *[c_int] * 8,                                # dtype S H w D NB BL MB
        *[c_ll] * 6,                                 # q and o strides
        ctypes.c_float, c_int, c_void_p]             # scale, device, stream
    lib.mmlspark_paged_launch.restype = c_int
    lib.mmlspark_paged_error_string.argtypes = [c_int]
    lib.mmlspark_paged_error_string.restype = ctypes.c_char_p
    return lib


def build_kernel() -> str:
    """Build (if needed) and load K3; returns nvcc's output for the build
    (registers, shared memory, spills), or "" if it was built earlier."""
    _library()
    return _LOADER.build_log()


def paged_cuda(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
               rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Launch K3 (``csrc/paged_attn.cu``) on PyTorch's current stream.
    Raises for tensors that are not on a CUDA device, a dtype other than
    bf16/f32, pools whose head dim is not 32/64/128/256 (``init_pools``
    makes them so up to 256; f32 up to 128), a q without unit stride on
    hd or with unaligned rows, pools that are not contiguous, and when the
    kernel does not build or launch. A q narrower than the pools is
    zero-padded and scaled by its own ``hd^-0.5``; the output is sliced
    back to its width.

    Returns a ``[S, H, w, hd]`` view of a ``[S, w, H, hd]`` buffer, so the
    caller's head merge is a free reshape."""
    d = q.shape[-1]
    q = pad_head_dim(q, k_pool.shape[-1])
    _check_inputs(q, k_pool, v_pool, rows, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_cuda needs CUDA tensors, got {q.device}; "
                         "use paged_torch (or the paged_window_attention "
                         "switch) for CPU tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_cuda takes bf16 or f32, got {q.dtype}")
    S, H, w, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_cuda takes pools of head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if hd > F32_HEAD_DIM_MAX and q.dtype == torch.float32:
        raise ValueError(f"paged_cuda: the f32 kernel takes head dims up to "
                         f"{F32_HEAD_DIM_MAX}, got pools of {hd}; head dims "
                         f"up to {HEAD_DIMS[-1]} run in bf16")
    size = q.element_size()
    if q.stride(3) != 1 or q.data_ptr() % _ALIGN or any(
            st * size % _ALIGN for st in q.stride()[:3]):
        raise ValueError(f"q needs unit stride on hd and rows on {_ALIGN}-"
                         f"byte boundaries, got strides {q.stride()}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous and {_ALIGN}-byte "
                             "aligned")
    rows = rows.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(S, w, H, hd, dtype=v_pool.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if S * H * w == 0:
        return _unpad(out, d)
    NB, BL = k_pool.shape[:2]
    lib = _library()
    err = lib.mmlspark_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), rows.data_ptr(),
        pos.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype], S, H, w, hd,
        NB, BL, rows.shape[1], *q.stride()[:3], *out.stride()[:3],
        d ** -0.5, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "K3 paged-attention kernel launch failed: "
            f"{lib.mmlspark_paged_error_string(err).decode()} "
            f"(cudaError {err})")
    paged_cuda.launches += 1
    return _unpad(out, d)


paged_cuda.launches = 0


# ------------------------------------------------------------- the switch

def paged_window_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, rows: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Windowed paged attention, the port of
    ``pallas_paged_attention.paged_window_attention``: q ``[S, H, w, hd]``
    at global positions ``pos[s] + i`` over one layer's pools through the
    block table ``rows``; returns ``[S, H, w, hd]``.

    Takes the kernel for CUDA tensors and the plain version for CPU
    tensors. The TPU kernel's tiling knobs (``block_kv``, ``slots_tile``)
    are not carried over: the CUDA kernel sizes its own tiles."""
    return (paged_cuda if q.device.type == "cuda" else paged_torch)(
        q, k_pool, v_pool, rows, pos)
