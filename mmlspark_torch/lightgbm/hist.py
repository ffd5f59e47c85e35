"""K1: the masked histogram build — CUDA kernel, plain version, and switch.

The hot op of GBDT training: accumulate (grad, hess, count) into
per-(feature, bin) cells. The JAX package runs it as the Pallas TPU kernel
``_hist_kernel`` (``mmlspark_tpu/lightgbm/pallas_hist.py:45``) on TPU and as
one scatter-add elsewhere (``engine.py:300-303``). Here:

- :func:`hist_cuda` launches the hand-written Hopper kernel in
  ``csrc/hist.cu`` (built with nvcc for ``sm_90a`` on first use, bound with
  ctypes); see the source for its design and what bounds it;
- :func:`hist_torch` is the plain PyTorch version: one ``index_add_`` over
  ``f*B + bin`` keys, the JAX scatter path's formulation;
  :func:`hist_partials_torch` is the plain version of the kernel's first
  pass (a histogram per row range of :func:`hist_plan`), whose sum over the
  ranges is the second;
- :func:`hist` picks one: the kernel for CUDA tensors, the plain version
  for CPU tensors. A build or launch failure raises; nothing falls back.

Contract of all three: bins uint8 or int32 ``[n, F]``, vals float32
``[n, 3]`` (pre-masked) → float32 ``[F, num_bins, 3]``. Bin ids outside
``[0, num_bins)`` add nothing. Rows at or past ``count`` (an int or a
one-element int tensor on the bins' device; default ``n``) add nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..native.loader import CudaLoader
from ..obs.attribution import analytic_cost

STAGE_BYTES = 16 * 1024   # bins and vals of one stage
STAGES = 4                # stages a CTA streams through (csrc/hist.cu)
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a CTA may opt into
_ALIGN = 16               # the bulk copies read 16-byte-aligned spans


class HistPlan(NamedTuple):
    """How K1 cuts one call: ``grid_x`` row ranges of ``rows_per_cta`` rows
    (a multiple of 16) by ``n_fb`` blocks of ``fb`` features, streamed in
    stages of ``stage_rows`` rows."""
    fb: int
    n_fb: int
    grid_x: int
    rows_per_cta: int
    stage_rows: int


@functools.lru_cache(maxsize=256)
def hist_plan(n: int, F: int, B: int, bin_bytes: int,
              n_sm: int) -> HistPlan:
    """K1's plan from the shape alone: stages of about
    :data:`STAGE_BYTES`; every feature in one CTA where its histogram
    (``F * B * 16`` bytes) fits beside the stages, else blocks of
    features; about one CTA per SM in all, over contiguous row ranges."""
    row_bytes = F * bin_bytes + 12
    stage_rows = max(16, STAGE_BYTES // row_bytes // 16 * 16)
    room = SMEM_LIMIT - STAGES * (stage_rows * row_bytes + 8) - 16
    fb = min(F, room // (B * 16))
    if fb < 1:
        raise ValueError(f"num_bins={B} needs {B * 16} B of shared memory "
                         f"per feature beside {STAGES} stages of {F} "
                         "features; "
                         f"{max(room, 0)} B are left of {SMEM_LIMIT}")
    n_fb = -(-F // fb)
    grid_x = max(1, min(-(-n // 16), n_sm // n_fb))
    rows_per_cta = -(-(-(-n // grid_x)) // 16) * 16
    return HistPlan(fb, n_fb, -(-n // rows_per_cta), rows_per_cta,
                    min(stage_rows, rows_per_cta))

_LOADER = CudaLoader("mmlspark_hist", ["lightgbm/csrc/hist.cu"])


def _check_inputs(bins: torch.Tensor, vals: torch.Tensor,
                  num_bins: int) -> None:
    if bins.dim() != 2:
        raise ValueError(f"bins must be [n, F], got shape {tuple(bins.shape)}")
    if bins.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"bins must be uint8 or int32, got {bins.dtype}")
    if vals.shape != (bins.shape[0], 3):
        raise ValueError(f"vals must be [n, 3] = [{bins.shape[0]}, 3], got "
                         f"{tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if vals.device != bins.device:
        raise ValueError(f"bins on {bins.device} but vals on {vals.device}")
    if int(num_bins) < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")


def _hist_cost(bins, vals, *, num_bins, count=None, **_):
    """What obs.attribution counts for one K1 call, on either route (the
    bound of PERF.md): 3 adds for each of the rows' F bins, the bins and
    the rows' three values read once, the histogram written once."""
    n, F = bins.shape
    if count is not None:
        n = max(0, min(int(count), n))
    return (3 * n * F,
            n * F * bins.element_size() + n * 12 + F * int(num_bins) * 12)


@analytic_cost(_hist_cost)
def hist_torch(bins: torch.Tensor, vals: torch.Tensor, *, num_bins: int,
               count: int | torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch histogram: one ``index_add_`` over ``f*B + bin`` keys
    (the JAX scatter path, ``engine.py:300-303``). Out-of-range bins and
    rows at or past ``count`` are routed to a trash cell that is dropped."""
    _check_inputs(bins, vals, num_bins)
    n, F = bins.shape
    B = int(num_bins)
    b = bins.to(torch.int64)
    keep = (b >= 0) & (b < B)
    if count is not None:
        rows = torch.arange(n, device=bins.device)
        keep = keep & (rows < torch.as_tensor(count, device=bins.device)
                       .reshape(()))[:, None]
    offsets = torch.arange(F, device=bins.device, dtype=torch.int64) * B
    keys = torch.where(keep, b + offsets[None, :], F * B)
    src = vals[:, None, :].expand(n, F, 3).reshape(n * F, 3)
    out = torch.zeros(F * B + 1, 3, dtype=torch.float32, device=bins.device)
    out.index_add_(0, keys.reshape(-1), src)
    return out[:F * B].reshape(F, B, 3)


def hist_partials_torch(bins: torch.Tensor, vals: torch.Tensor, *,
                        num_bins: int, rows_per_cta: int,
                        count: int | torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's first pass: the histogram of
    each range of ``rows_per_cta`` rows (rows at or past ``count`` add
    nothing), ``[G, F, num_bins, 3]``; the second pass sums them over G in
    order (``.sum(0)``)."""
    _check_inputs(bins, vals, num_bins)
    n = bins.shape[0]
    if count is not None:
        keep = torch.arange(n, device=bins.device) < torch.as_tensor(
            count, device=bins.device).reshape(())
        vals = vals * keep[:, None]
    return torch.stack([
        hist_torch(bins[r:r + rows_per_cta], vals[r:r + rows_per_cta],
                   num_bins=num_bins)
        for r in range(0, n, rows_per_cta)])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _LOADER.load()
    c_void_p, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mmlspark_hist_launch.argtypes = [
        c_void_p, c_int, c_void_p,             # bins, bin bytes, vals
        c_void_p, c_void_p,                    # partials, out
        c_ll, c_int, c_int,                    # n, F, B
        c_int, c_int, c_ll, c_int,             # fb, grid_x, rows a CTA, stage
        c_ll, c_void_p,                        # count (host, device ptr)
        c_int, c_void_p]                       # device, stream
    lib.mmlspark_hist_launch.restype = c_int
    lib.mmlspark_cuda_error_string.argtypes = [c_int]
    lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_kernel() -> str:
    """Build (if needed) and load K1; returns nvcc's output for the build
    (registers, shared memory, spills), or "" if it was built earlier."""
    _library()
    return _LOADER.build_log()


def _check_card(bins: torch.Tensor) -> None:
    if bins.device.type != "cuda":
        raise ValueError(
            f"hist_cuda needs CUDA tensors, got {bins.device}; use "
            "hist_torch (or hist) for CPU tensors")


@analytic_cost(_hist_cost)
def hist_cuda(bins: torch.Tensor, vals: torch.Tensor, *, num_bins: int,
              count: int | torch.Tensor | None = None) -> torch.Tensor:
    """Launch K1 (``csrc/hist.cu``: the per-CTA partial histograms, then
    their sum in CTA order) on PyTorch's current stream; one call counts
    one launch. Raises for tensors that are not on a CUDA device, and when
    the kernels do not build or do not launch."""
    _check_inputs(bins, vals, num_bins)
    _check_card(bins)
    n, F = bins.shape
    B = int(num_bins)
    if n == 0 or F == 0:
        return torch.zeros(F, B, 3, dtype=torch.float32, device=bins.device)
    bins, vals = (t.contiguous() if t.data_ptr() % _ALIGN == 0
                  else t.clone(memory_format=torch.contiguous_format)
                  for t in (bins, vals))
    count_host, count_dev = n, None
    if isinstance(count, torch.Tensor):
        if count.device != bins.device:
            raise ValueError(f"count on {count.device}, bins on "
                             f"{bins.device}")
        count_dev = count.reshape(1).to(torch.int32)
    elif count is not None:
        count_host = max(0, min(int(count), n))
    props = torch.cuda.get_device_properties(bins.device)
    plan = hist_plan(n, F, B, bins.element_size(),
                     props.multi_processor_count)
    part = torch.empty(plan.grid_x, F * B * 3, dtype=torch.float32,
                       device=bins.device)
    out = torch.empty(F, B, 3, dtype=torch.float32, device=bins.device)
    lib = _library()
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    err = lib.mmlspark_hist_launch(
        bins.data_ptr(), bins.element_size(), vals.data_ptr(),
        part.data_ptr(), out.data_ptr(), n, F, B, plan.fb, plan.grid_x,
        plan.rows_per_cta, plan.stage_rows, count_host,
        None if count_dev is None else count_dev.data_ptr(),
        bins.device.index, stream)
    if err != 0:
        raise RuntimeError(
            "K1 histogram kernel launch failed: "
            f"{lib.mmlspark_cuda_error_string(err).decode()} (cudaError "
            f"{err})")
    hist_cuda.launches += 1
    return out


hist_cuda.launches = 0


def hist(bins: torch.Tensor, vals: torch.Tensor, *, num_bins: int,
         count: int | torch.Tensor | None = None,
         impl: str | None = None) -> torch.Tensor:
    """The switch: ``impl=None`` takes the kernel (``"cuda"``) for CUDA
    tensors and the plain version (``"torch"``) for CPU tensors.
    ``impl="cuda"`` on CPU tensors raises; ``impl="torch"`` runs the plain
    version on any device (the card's comparison path)."""
    if impl is None:
        impl = "cuda" if bins.device.type == "cuda" else "torch"
    if impl == "cuda":
        return hist_cuda(bins, vals, num_bins=num_bins, count=count)
    if impl == "torch":
        return hist_torch(bins, vals, num_bins=num_bins, count=count)
    raise ValueError(f"impl must be None, 'cuda' or 'torch', got {impl!r}")
