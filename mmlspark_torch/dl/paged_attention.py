"""K3: paged window attention over the block table — CUDA kernels, plain
versions and switch.

The LLM serving engine's hot op. The JAX package runs it as the Pallas TPU
kernel ``_paged_kernel`` (``mmlspark_tpu/dl/pallas_paged_attention.py:89``,
launched by ``_paged_pallas`` at ``:199``) behind ``paged_window_attention``,
with the pure-lax ``_paged_reference`` off the TPU. Here:

- :func:`paged_decode_cuda` launches the split-KV decode kernel of
  ``csrc/paged_decode.cu`` for windows of up to :data:`DECODE_MAX_ROWS`
  rows (the engine's decode step, w = 1, and its verify window, w =
  spec_k + 1): the chain is cut into chunks across CTAs by
  :func:`decode_plan`, and a second small kernel, ``paged_combine``,
  merges the chunks' partial softmax states (not launched for a plan of
  one chunk). It counts its launches (``.launches``) and the combine's
  (``.combine_launches``);
- :func:`paged_cuda` launches the window kernel of ``csrc/paged_attn.cu``
  for wider windows (prefill): the flash forward's body
  (``csrc/flash_fwd.cuh``) with K and V copied through the table, its
  work items (slot, head, 128-row q tile) walked by persistent CTAs; where
  :func:`window_plan` cuts the chain into chunks, the decode kernel's
  combine merges them. It counts its launches (``.launches``) and the
  combine's (``.combine_launches``). Each source is its own library, built
  with nvcc for ``sm_90a`` on first use and bound with ctypes; see the
  sources for their designs and what bounds them;
- :func:`paged_torch` is the plain version: it gathers each slot's chain
  through the table inside the call, then applies exactly the formulation
  of ``EncoderBlock.decode_window`` and ``_paged_reference`` (f32 scores ×
  ``hd^-0.5``, ``-inf`` outside ``t <= pos + i``, softmax, NaN → 0, ``p``
  cast to v's dtype), which keeps the engine token-identical to
  ``dl.generate`` on the CPU; :func:`paged_partials_torch` and
  :func:`paged_combine_torch` are the plain versions of the split kernels'
  two passes (per-chunk ``(m, l, acc)``, then the merge), the decode
  kernel's and the window kernel's alike;
- :func:`paged_window_attention` is the switch: for CUDA tensors the
  decode kernel up to :data:`DECODE_MAX_ROWS` rows and the window kernel
  above, the plain version for CPU tensors. A build or launch failure
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

Head dims: the engine allocates its pools at the kernels' head dim on
every device (``paged_kv.pool_head_dim``: ``kernel_head_dim``, hd padded
up to the next of 32/64/128/256, above 256 to a multiple of 128), the
window's k/v are zero-padded as they are scattered, and every version
takes pools wider than q: q is zero-padded to the pools' width, scores are
scaled by q's true ``hd^-0.5`` and the output is sliced back to hd. The
decode kernel loops over the pools' head dim and takes any of them; the
window kernel's instances stop at 256 in bf16 and 128 in f32, and wider
pools run on its wide instance in ``csrc/attn_wide.cu``, split over hd as
``flash_attention.wide_plan`` says.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..native.loader import CudaLoader
from ..obs.attribution import analytic_cost
from .flash_attention import (_library_wide, _unpad, _wide_ctas,
                              kernel_head_dim, pad_head_dim, wide_head_dim)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ALIGN = 16               # the kernels stage rows as 16-byte vectors
NEG = -1e30               # the kernels' masked score
DECODE_MAX_ROWS = 16      # windows up to this wide take the decode kernel
_TRASH = 0                # paged_kv.TRASH_BLOCK

_LOADER = CudaLoader("mmlspark_paged", ["dl/csrc/paged_attn.cu"],
                     headers=("dl/csrc/flash_common.cuh",
                              "dl/csrc/flash_fwd.cuh"))
_LOADER_DECODE = CudaLoader("mmlspark_paged_decode",
                            ["dl/csrc/paged_decode.cu"],
                            headers=("dl/csrc/flash_common.cuh",))


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


def _paged_cost(q, k_pool, v_pool, rows, pos):
    """What obs.attribution counts for one K3 call, on either route (the
    bound of PERF.md): 4·P·hd over each slot's allowed pairs
    ``w·(pos + 1) + w·(w - 1)/2`` per head, and the K/V blocks each chain
    reaches, q and o moved once."""
    S, H, w, d = q.shape
    NB, BL, _, hd = k_pool.shape
    p = pos.long()
    pairs = H * int((w * (p + 1) + w * (w - 1) // 2).sum())
    blocks = int(((p + w + BL - 1) // BL).clamp(max=rows.shape[1]).sum())
    return (4 * pairs * d,
            2 * blocks * BL * H * hd * k_pool.element_size()
            + 2 * S * H * w * d * q.element_size())


@analytic_cost(_paged_cost)
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


# ------------------------------------------------------- the decode plan

_STAGE_BYTES = 16384      # K (and V) bytes of one stage of the decode kernel
_STAGE_POSITIONS = 16     # chain positions of a stage, at most
_MAX_WARPS = 8            # consumer warps of a decode CTA
_CTAS_PER_SM = 2          # the grid the plan aims at


class DecodePlan(NamedTuple):
    """How the decode kernel cuts one call: ``hg`` heads (of ``n_hg``
    groups) and ``dpc`` column chunks (of ``n_dg`` groups; ``dch`` a head)
    per CTA, one consumer warp each; ``P`` chain positions a stage; chunks
    of ``L`` positions, ``n_chunks`` of them covering the table's
    ``MB * BL``; ``ctas`` in the grid."""
    hg: int
    n_hg: int
    dpc: int
    n_dg: int
    dch: int
    P: int
    L: int
    n_chunks: int
    ctas: int


@functools.lru_cache(maxsize=256)
def decode_plan(S: int, H: int, w: int, D: int, BL: int, MB: int,
                elem_size: int, n_sm: int) -> DecodePlan:
    """The decode kernel's plan from the shape alone (no data: the same
    shapes give the same plan, so a call's result does not depend on its
    timing or its positions). A CTA holds whole heads of its slot (all H
    where one position of them fits a stage) and up to 128 output columns
    a warp (64 above 8 rows); the chain of ``MB * BL`` positions is cut
    into chunks of a multiple of 16 positions so that the grid has
    about ``2 * n_sm`` CTAs, one chunk where the slots alone fill it."""
    dv = 128 if w <= 8 else 64
    dch = -(-D // dv)
    dpc = min(dch, _MAX_WARPS)
    hg = min(H, _MAX_WARPS // dpc) if dpc == dch else 1
    while hg > 1 and hg * D * elem_size > _STAGE_BYTES:
        hg -= 1
    P = _STAGE_POSITIONS
    while P > 1 and P * hg * D * elem_size > _STAGE_BYTES:
        P //= 2
    n_hg, n_dg = -(-H // hg), -(-dch // dpc)
    cap = MB * BL
    per_slot = max(1, -(-_CTAS_PER_SM * n_sm // (S * n_hg * n_dg)))
    L = max(_STAGE_POSITIONS, -(-cap // per_slot))
    L = -(-L // _STAGE_POSITIONS) * _STAGE_POSITIONS
    n_chunks = -(-cap // L)
    return DecodePlan(hg, n_hg, dpc, n_dg, dch, P, L, n_chunks,
                      S * n_hg * n_dg * n_chunks)


_WINDOW_ROWS = 128         # query rows of a window kernel work item
_WINDOW_MIN_CHUNK = 512   # chain positions of a window chunk, at least


class WindowPlan(NamedTuple):
    """How the window kernel cuts one call: ``n_qt`` q tiles of 128 rows a
    (slot, head); chunks of ``L`` chain positions, ``n_chunks`` of them
    covering the table's ``MB * BL``; ``ctas`` in the persistent grid."""
    n_qt: int
    L: int
    n_chunks: int
    ctas: int


@functools.lru_cache(maxsize=256)
def window_plan(S: int, H: int, w: int, D: int, BL: int, MB: int,
                elem_size: int, n_sm: int) -> WindowPlan:
    """The window kernel's plan from the shape alone (no data, as
    :func:`decode_plan`). A work item is a (slot, head, 128-row q tile);
    where there are fewer items than SMs (a warm suffix over a long cached
    prefix), the chain of ``MB * BL`` positions is cut into chunks of a
    multiple of 128 positions, at least 512, so that items x chunks come
    near the SM count; one chunk otherwise, and always in f32 (whose
    kernel does not split). Returns the plan and the persistent grid."""
    cap = MB * BL
    n_qt = -(-w // _WINDOW_ROWS)
    items = S * H * n_qt
    L = -(-cap // 128) * 128
    n_chunks = 1
    if elem_size == 2 and items < n_sm:
        per_item = -(-n_sm // items)
        L_split = max(_WINDOW_MIN_CHUNK, -(-cap // (per_item * 128)) * 128)
        if L_split < cap:
            L, n_chunks = L_split, -(-cap // L_split)
    return WindowPlan(n_qt, L, n_chunks, min(items * n_chunks, n_sm))


def paged_partials_torch(q, k_pool, v_pool, rows, pos, L: int,
                         n_chunks: int, scale: float | None = None):
    """Plain PyTorch version of the split kernels' first pass: for each
    chunk of ``L`` chain positions, the f32 ``(m, l, acc)`` of its allowed
    keys (trash and out-of-range entries skipped, ``t <= pos + i``), with
    m the row max of the scaled scores (``-1e30`` where none is allowed),
    ``p = exp(s - m)`` and ``acc = p.astype(v) @ v``. Returns ``m, l``
    ``[S, n_chunks, H, w]`` and ``acc`` ``[S, n_chunks, H, w, hd]``; q at
    the pools' width, ``scale`` its true ``hd^-0.5``."""
    _check_inputs(q, k_pool, v_pool, rows, pos)
    S, H, w, hd = q.shape
    NB, BL = k_pool.shape[:2]
    cap = rows.shape[1] * BL
    dev = q.device
    scale = hd ** -0.5 if scale is None else scale
    blk = rows.long()
    live = (blk != _TRASH) & (blk >= 0) & (blk < NB)               # [S, MB]
    idx = (blk.clamp(0, NB - 1)[:, :, None] * BL
           + torch.arange(BL, device=dev)).reshape(S, cap)
    k = k_pool.reshape(NB * BL, H, hd)[idx].transpose(1, 2)
    v = v_pool.reshape(NB * BL, H, hd)[idx].transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    t = torch.arange(cap, device=dev)
    limit = pos.long()[:, None] + torch.arange(w, device=dev)      # [S, w]
    allowed = (t <= limit[:, :, None]) \
        & live.repeat_interleave(BL, 1)[:, None, :]                # [S, w, L]
    ms, ls, accs = [], [], []
    for c in range(n_chunks):
        ok = (allowed & (t >= c * L) & (t < (c + 1) * L))[:, None]
        sc = torch.where(ok, s, NEG)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp(sc - m), 0.0)
        ms.append(m[..., 0])
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                                 v.float()))
    return (torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1))


def paged_combine_torch(m, l, acc, n_live, dtype) -> torch.Tensor:
    """Plain PyTorch version of the combine: merge each slot's first
    ``n_live[s]`` chunks (``m, l`` ``[S, C, H, w]``, ``acc`` ``[S, C, H, w,
    hd]``) into ``o = Σ f·acc / max(Σ f·l, 1e-35)``, ``f = exp(m - max
    m)``, in ``dtype`` ``[S, H, w, hd]``."""
    C = m.shape[1]
    use = (torch.arange(C, device=m.device)[None, :]
           < n_live[:, None])[:, :, None, None]                    # [S, C]
    m = torch.where(use, m, NEG)
    f = torch.where(use, torch.exp(m - m.amax(1, keepdim=True)), 0.0)
    den = (f * l).sum(1).clamp_min(1e-35)
    num = (f[..., None] * acc).sum(1)
    return (num / den[..., None]).to(dtype)


# ------------------------------------------------------------- the kernel

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _LOADER.load()
    c_void_p, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mmlspark_paged_launch.argtypes = [
        *[c_void_p] * 8,                  # q k v rows pos o part_acc part_ml
        *[c_int] * 8,                     # dtype S H w D NB BL MB
        *[c_ll] * 6,                      # q and o strides
        ctypes.c_float,                   # scale
        c_int, c_int,                     # L n_chunks
        c_int, c_void_p]                  # device, stream
    lib.mmlspark_paged_launch.restype = c_int
    lib.mmlspark_paged_error_string.argtypes = [c_int]
    lib.mmlspark_paged_error_string.restype = ctypes.c_char_p
    return lib


def _partials(q: torch.Tensor, n_chunks: int):
    """The split kernels' f32 scratch for ``n_chunks`` chunks of a call on
    q ``[S, H, w, hd]``: one buffer holding acc ``[S, n_chunks, H, w, hd]``
    then (m, l); returns it (keep it alive until the launches are queued)
    and the two addresses, or ``(None, None, None)`` for one chunk."""
    if n_chunks == 1:
        return None, None, None
    S, H, w, hd = q.shape
    rows = S * n_chunks * H * w
    scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                          device=q.device)
    return scratch, scratch.data_ptr(), scratch.data_ptr() + rows * hd * 4


def build_kernel() -> str:
    """Build (if needed) and load K3; returns nvcc's output for the build
    (registers, shared memory, spills), or "" if it was built earlier."""
    _library()
    return _LOADER.build_log()


def _check_card(fn: str, q, k_pool, v_pool) -> None:
    """What both kernels take: CUDA tensors of bf16 or f32, pools at a
    kernel head dim (``paged_kv.pool_head_dim``), q with unit stride on hd
    and 16-byte rows, contiguous 16-byte-aligned pools."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {q.device}; "
                         "use paged_torch (or the paged_window_attention "
                         "switch) for CPU tensors")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} takes bf16 or f32, got {q.dtype}")
    hd = q.shape[-1]
    if hd != kernel_head_dim(hd):
        raise ValueError(f"{fn} takes pools at a kernel head dim "
                         f"(paged_kv.pool_head_dim), got {hd}; "
                         f"{kernel_head_dim(hd)} would hold it")
    size = q.element_size()
    if q.stride(3) != 1 or q.data_ptr() % _ALIGN or any(
            st * size % _ALIGN for st in q.stride()[:3]):
        raise ValueError(f"q needs unit stride on hd and rows on {_ALIGN}-"
                         f"byte boundaries, got strides {q.stride()}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous and {_ALIGN}-byte "
                             "aligned")


@analytic_cost(_paged_cost)
def paged_cuda(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
               rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Launch K3's window kernel (``csrc/paged_attn.cu``; pools wider than
    its instances, 256 in bf16 and 128 in f32, on the wide instance of
    ``csrc/attn_wide.cu``) on PyTorch's current stream: any window, the
    engine's prefill ones in practice. Where :func:`window_plan` cuts the
    chain into chunks, the decode kernel's combine (``paged_combine``)
    merges them after it. Raises for tensors that are not on a CUDA device,
    a dtype other than bf16/f32, pools not at a kernel head dim
    (``init_pools`` makes them so), a q without unit stride on hd or with
    unaligned rows, pools that are not contiguous, and when a kernel does
    not build or launch. A q narrower than the pools is zero-padded and
    scaled by its own ``hd^-0.5``; the output is sliced back to its width.
    Counts its launches in ``.launches`` and the combine's in
    ``.combine_launches``.

    Returns a ``[S, H, w, hd]`` view of a ``[S, w, H, hd]`` buffer, so the
    caller's head merge is a free reshape."""
    d = q.shape[-1]
    q = pad_head_dim(q, k_pool.shape[-1])
    _check_inputs(q, k_pool, v_pool, rows, pos)
    _check_card("paged_cuda", q, k_pool, v_pool)
    S, H, w, hd = q.shape
    rows = rows.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(S, w, H, hd, dtype=v_pool.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if S * H * w == 0:
        return _unpad(out, d)
    NB, BL = k_pool.shape[:2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if wide_head_dim(hd, q.dtype):
        lib = _library_wide()
        err = lib.mmlspark_wide_paged_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            rows.data_ptr(), pos.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], S, H, w, hd, NB, BL, rows.shape[1],
            *q.stride()[:3], *out.stride()[:3], d ** -0.5,
            *_wide_ctas(True, hd, q.dtype), q.device.index, stream)
        if err != 0:
            raise RuntimeError(
                "K3 paged-attention window kernel launch failed (wide head "
                f"dim): {lib.mmlspark_wide_error_string(err).decode()} "
                f"(cudaError {err})")
        paged_cuda.launches += 1
        return _unpad(out, d)
    plan = window_plan_of(q, k_pool, rows)
    scratch, part_acc, part_ml = _partials(q, plan.n_chunks)
    lib = _library()
    err = lib.mmlspark_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), rows.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part_acc, part_ml,
        _DTYPE_CODES[q.dtype], S, H, w, hd, NB, BL, rows.shape[1],
        *q.stride()[:3], *out.stride()[:3], d ** -0.5, plan.L,
        plan.n_chunks, q.device.index, stream)
    if err != 0:
        raise RuntimeError(
            "K3 paged-attention window kernel launch failed: "
            f"{lib.mmlspark_paged_error_string(err).decode()} (code {err})")
    paged_cuda.launches += 1
    if plan.n_chunks > 1:
        dec = _decode_library()
        err = dec.mmlspark_paged_combine_launch(
            pos.data_ptr(), out.data_ptr(), part_acc, part_ml,
            _DTYPE_CODES[q.dtype], S, H, w, hd, BL, rows.shape[1],
            *out.stride()[:3], d ** -0.5, plan.L, plan.n_chunks,
            q.device.index, stream)
        if err != 0:
            raise RuntimeError(
                "K3 combine launch failed after the window kernel: "
                f"{dec.mmlspark_paged_decode_error_string(err).decode()} "
                f"(cudaError {err})")
        paged_cuda.combine_launches += 1
    return _unpad(out, d)


paged_cuda.launches = paged_cuda.combine_launches = 0


@functools.lru_cache(maxsize=None)
def _decode_library() -> ctypes.CDLL:
    lib = _LOADER_DECODE.load()
    c_void_p, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mmlspark_paged_decode_launch.argtypes = [
        *[c_void_p] * 8,                  # q k v rows pos o part_acc part_ml
        *[c_int] * 8,                     # dtype S H w D NB BL MB
        *[c_ll] * 6,                      # q and o strides
        ctypes.c_float,                   # scale
        *[c_int] * 5,                     # hg dpc P L n_chunks
        c_int, c_void_p]                  # device, stream
    lib.mmlspark_paged_decode_launch.restype = c_int
    lib.mmlspark_paged_combine_launch.argtypes = [
        *[c_void_p] * 4,                  # pos o part_acc part_ml
        *[c_int] * 7,                     # dtype S H w D BL MB
        *[c_ll] * 3,                      # o strides
        ctypes.c_float,                   # scale
        c_int, c_int,                     # L n_chunks
        c_int, c_void_p]                  # device, stream
    lib.mmlspark_paged_combine_launch.restype = c_int
    lib.mmlspark_paged_decode_error_string.argtypes = [c_int]
    lib.mmlspark_paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def build_decode_kernel() -> str:
    """Build (if needed) and load the decode kernel and its combine;
    returns nvcc's output as :func:`build_kernel` does."""
    _decode_library()
    return _LOADER_DECODE.build_log()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_of(q: torch.Tensor, k_pool: torch.Tensor,
            rows: torch.Tensor) -> DecodePlan:
    """:func:`decode_plan` for a call on these tensors (q at the pools'
    width) on q's card."""
    S, H, w, _ = q.shape
    NB, BL, _, hd = k_pool.shape
    return decode_plan(S, H, w, hd, BL, rows.shape[1], q.element_size(),
                       _sm_count(q.device.index))


def window_plan_of(q: torch.Tensor, k_pool: torch.Tensor,
                   rows: torch.Tensor) -> WindowPlan:
    """:func:`window_plan` for a call on these tensors (q at the pools'
    width) on q's card."""
    S, H, w, _ = q.shape
    NB, BL, _, hd = k_pool.shape
    return window_plan(S, H, w, hd, BL, rows.shape[1], q.element_size(),
                       _sm_count(q.device.index))


@analytic_cost(_paged_cost)
def paged_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, rows: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """Launch K3's split-KV decode kernel (``csrc/paged_decode.cu``) on
    PyTorch's current stream, for windows of up to
    :data:`DECODE_MAX_ROWS` rows, and, when :func:`decode_plan` cuts the
    chain into more than one chunk, the combine after it. Raises as
    :func:`paged_cuda` does, and for a wider window. Counts its launches in
    ``.launches`` and the combine's in ``.combine_launches``.

    Returns a ``[S, H, w, hd]`` view of a ``[S, w, H, hd]`` buffer."""
    d = q.shape[-1]
    q = pad_head_dim(q, k_pool.shape[-1])
    _check_inputs(q, k_pool, v_pool, rows, pos)
    _check_card("paged_decode_cuda", q, k_pool, v_pool)
    S, H, w, hd = q.shape
    if w > DECODE_MAX_ROWS:
        raise ValueError(f"paged_decode_cuda takes windows of up to "
                         f"{DECODE_MAX_ROWS} rows, got {w}; paged_cuda "
                         "takes wider ones")
    rows = rows.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty(S, w, H, hd, dtype=v_pool.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    if S * H * w == 0:
        return _unpad(out, d)
    NB, BL = k_pool.shape[:2]
    plan = plan_of(q, k_pool, rows)
    scratch, part_acc, part_ml = _partials(q, plan.n_chunks)
    lib = _decode_library()
    err = lib.mmlspark_paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), rows.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part_acc, part_ml,
        _DTYPE_CODES[q.dtype], S, H, w, hd, NB, BL, rows.shape[1],
        *q.stride()[:3], *out.stride()[:3], d ** -0.5, plan.hg, plan.dpc,
        plan.P, plan.L, plan.n_chunks, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "K3 split-KV decode kernel launch failed: "
            f"{lib.mmlspark_paged_decode_error_string(err).decode()} "
            f"(cudaError {err})")
    paged_decode_cuda.launches += 1
    if plan.n_chunks > 1:
        paged_decode_cuda.combine_launches += 1
    return _unpad(out, d)


paged_decode_cuda.launches = paged_decode_cuda.combine_launches = 0


# ------------------------------------------------------------- the switch

def paged_window_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, rows: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Windowed paged attention, the port of
    ``pallas_paged_attention.paged_window_attention``: q ``[S, H, w, hd]``
    at global positions ``pos[s] + i`` over one layer's pools through the
    block table ``rows``; returns ``[S, H, w, hd]``.

    For CUDA tensors, windows of up to :data:`DECODE_MAX_ROWS` rows (decode
    and the verify window) take the split-KV decode kernel and wider ones
    (prefill) the window kernel; CPU tensors take the plain version.
    The TPU kernel's tiling knobs (``block_kv``, ``slots_tile``) are not
    carried over: the CUDA kernels size their own tiles."""
    if not _route(q):
        return paged_torch(q, k_pool, v_pool, rows, pos)
    fn = paged_decode_cuda if q.shape[2] <= DECODE_MAX_ROWS else paged_cuda
    return fn(q, k_pool, v_pool, rows, pos)


def _route(q: torch.Tensor) -> bool:
    """True for the kernels (CUDA tensors), False for the plain version."""
    return q.device.type == "cuda"
