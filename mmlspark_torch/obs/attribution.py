"""Device cost-attribution plane: per-program analytic rooflines.

The port's own copy of the JAX package's ``obs/attribution.py``, with the
same gauges, env overrides and resolution order. It answers, per program,
whether it is compute- or memory-bound and how far measured MFU sits from
the analytic ceiling:

- :class:`PeakSpec` — the per-platform peak table (flops + HBM
  bandwidth) every MFU and roofline divides by (StepProfiler MFU, the
  regression sentinel's synthetic steps). Resolution order: explicit
  argument > ``MMLSPARK_TPU_PEAK_FLOPS`` / ``MMLSPARK_TPU_PEAK_BYTES_PER_S``
  env overrides > the detected CUDA part (``torch.cuda.get_device_name``,
  read only where CUDA is already initialized) > the GPU family default
  (the H100 row) > the CPU fallback row.

- :class:`CostAttribution` — records each program's analytic cost and
  exports the roofline gauges:

  - ``profile_analytic_flops{program}`` — flops per execution,
  - ``profile_analytic_bytes{program}`` — device-memory bytes per
    execution,
  - ``profile_roofline_utilization{program,bound=compute|memory}`` —
    each resource's share of the roofline-critical time
    (``max(flops/peak_flops, bytes/peak_bw)``). The dominant resource
    reads 1.0 and names the program's placement; the other reads its
    arithmetic-intensity headroom. Both are always <= 1.0.

Where the JAX package reads XLA's ``cost_analysis`` of a compiled program,
the port counts one call of it (:meth:`CostAttribution.record_call`,
:func:`count_cost`): FLOPs through ``torch.utils.flop_counter.FlopCounterMode``
and bytes as every operation's tensor inputs read once and outputs written
once. The hand-written kernels are bound through ctypes, so neither counter
can see them: each kernel's wrapper and its plain version carry
:func:`analytic_cost`, which adds the kernel's own formula (the one the
bounds in ``PERF.md`` use) to the count and hides the wrapper's inner
operations, so a call counts the same on either route.

Feeding happens at LLM warm time (``serving/llm.py``). The recorded pair
also rides FeatureLog schema v6 rows (``analytic_flops`` /
``analytic_bytes``).

Import is stdlib-only and side-effect-free beyond registering the
gauges; torch is touched only inside a count, and CUDA only behind
``torch.cuda.is_initialized()``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
from dataclasses import dataclass, replace

from .metrics import registry as _registry

#: env overrides — an operator pinning the peak for an unlisted part
#: (or a derated clock) wins over the table, whatever the platform.
ENV_PEAK_FLOPS = "MMLSPARK_TPU_PEAK_FLOPS"
ENV_PEAK_BYTES = "MMLSPARK_TPU_PEAK_BYTES_PER_S"


@dataclass(frozen=True)
class PeakSpec:
    """One platform's analytic ceilings: peak FLOP/s and HBM B/s."""

    platform: str
    peak_flops: float
    hbm_bytes_per_s: float

    def roofline_seconds(self, flops: float, bytes_: float) -> float:
        """Analytic lower bound on execution time: the slower of the
        compute and memory pipes (the classic roofline)."""
        return max(float(flops) / self.peak_flops,
                   float(bytes_) / self.hbm_bytes_per_s)


#: Per-platform peaks. ``gpu-h100``: NVIDIA H100 SXM5 80 GB at its 700 W
#: power limit, 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s
#: of HBM3, from NVIDIA's data sheet
#: (https://www.nvidia.com/en-us/data-center/h100/); a card capped below
#: 700 W runs slower under load. The ``cpu`` row is the JAX package's
#: 1 Tflop/s reference point with a DDR-class bandwidth, so CPU rooflines
#: stay comparable across runs rather than pretending to model the host.
PEAK_SPECS: dict[str, PeakSpec] = {
    "gpu-h100": PeakSpec("gpu-h100", 989e12, 3.35e12),
    "cpu": PeakSpec("cpu", 1.0e12, 100e9),
}

#: family default: a CUDA part the table does not list resolves to the
#: H100 row (the card the port is built for)
_GPU_DEFAULT = "gpu-h100"
_FALLBACK = "cpu"


def cuda_initialized() -> bool:
    """Whether this process already holds a CUDA context. Never imports
    torch and never initializes CUDA: the guard every reader of
    ``torch.cuda`` in ``obs`` goes through (a host-only process must not
    pay context creation, or claim a card, for a metrics scrape)."""
    mod = sys.modules.get("torch")
    if mod is None:
        return False
    try:
        return bool(mod.cuda.is_initialized())
    except Exception:
        return False


def _gpu_generation() -> str | None:
    """The table key of the live CUDA part, with the never-initialize
    guard: only a process that already holds a context is asked."""
    if not cuda_initialized():
        return None
    try:
        name = str(sys.modules["torch"].cuda.get_device_name()).lower()
    except Exception:
        return None
    if "h100" in name:
        return "gpu-h100"
    return None


def peak_spec(platform: str | None = None) -> PeakSpec:
    """Resolve the :class:`PeakSpec` for ``platform`` (default: the
    live ``device_platform()``), applying the documented resolution
    order. Never raises: anything unrecognized (including the
    torch-absent ``"none"`` state) lands on the CPU fallback row."""
    from .profile import device_platform
    key = (platform or device_platform() or "").strip().lower()
    spec = PEAK_SPECS.get(key)
    if spec is None and key.startswith(("gpu", "cuda")):
        spec = PEAK_SPECS.get(_gpu_generation() or _GPU_DEFAULT) \
            or PEAK_SPECS[_GPU_DEFAULT]
    if spec is None:
        spec = PEAK_SPECS[_FALLBACK]
    flops_env = os.environ.get(ENV_PEAK_FLOPS)
    bytes_env = os.environ.get(ENV_PEAK_BYTES)
    try:
        if flops_env:
            spec = replace(spec, peak_flops=float(flops_env))
        if bytes_env:
            spec = replace(spec, hbm_bytes_per_s=float(bytes_env))
    except (TypeError, ValueError):
        pass  # a junk override must not take the metrics plane down
    return spec


# ------------------------------------------------------------ counting
class CostCount:
    """What :func:`count_cost` counted: ``flops`` (the flop counter's
    total plus the kernels' formulas) and ``bytes`` (each operation's
    tensor inputs read once and outputs written once, plus the
    kernels' formulas). Both are final once the ``with`` block ends."""

    __slots__ = ("flops", "bytes", "analytic_flops", "analytic_bytes")

    def __init__(self):
        self.flops = self.bytes = 0.0
        self.analytic_flops = self.analytic_bytes = 0.0


def _tensor_bytes(obj) -> int:
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


_ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided")
# views whose schema declares no alias (autograd treats their result as
# new), which still move no data
_UNSAFE_VIEWS = ("_unsafe_view",)


def _op_bytes(func, args, kwargs, out) -> int:
    """The bytes one operation moves: its tensor inputs read once and its
    outputs written once. Views (every return aliases an input without
    writing it) and bare allocations move nothing; a copy (``copy_``,
    ``clone``, ``_to_copy``) reads its source and writes its
    destination."""
    name = func.__name__.split(".")[0]
    if name in _ALLOCATIONS or name in _UNSAFE_VIEWS:
        return 0
    returns = func._schema.returns
    if returns and all(r.alias_info is not None and not r.alias_info.is_write
                       for r in returns):
        return 0
    if name == "copy_":
        return _tensor_bytes(args[1]) + _tensor_bytes(out)
    return _tensor_bytes(args) + _tensor_bytes(kwargs) + _tensor_bytes(out)


def _byte_mode(count: CostCount):
    """The dispatch mode that adds each operation's bytes to ``count``
    (a class made on first use: ``torch`` is imported inside a count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _ByteMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.count.bytes += _op_bytes(func, args, kwargs, out)
            return out

    mode = _ByteMode()
    mode.count = count
    return mode


def _active_count() -> CostCount | None:
    """The innermost :func:`count_cost` open on this thread (autograd's
    worker threads inherit the dispatch-mode stack), else None."""
    torch = sys.modules.get("torch")
    if torch is None or torch._C._len_torch_dispatch_stack() == 0:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        count = getattr(mode, "count", None)
        if isinstance(count, CostCount):
            return count
    return None


@contextlib.contextmanager
def count_cost():
    """Count the FLOPs and bytes of the torch work in the block::

        with count_cost() as c:
            step()
        c.flops, c.bytes

    Backward passes run inside the block count too. Kernels reached
    through :func:`analytic_cost` wrappers count by their formulas."""
    from torch.utils.flop_counter import FlopCounterMode
    count = CostCount()
    flop_mode = FlopCounterMode(display=False)
    with flop_mode, _byte_mode(count):
        yield count
    count.flops = float(flop_mode.get_total_flops()) + count.analytic_flops
    count.bytes += count.analytic_bytes


def analytic_cost(formula):
    """Decorator for a kernel's wrapper and its plain version: under an
    open :func:`count_cost`, ``formula(*args, **kwargs) -> (flops,
    bytes)`` is added to the count and the call itself runs with the
    counters set aside, so the CUDA route (whose kernel the counters
    cannot see) and the plain route (whose dense scores are more work
    than the kernel does) count the same. Outside a count it costs one
    check of the dispatch-mode stack."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            count = _active_count()
            if count is None:
                return fn(*args, **kwargs)
            from torch.utils._python_dispatch import _disable_current_modes
            flops, nbytes = formula(*args, **kwargs)
            count.analytic_flops += float(flops)
            count.analytic_bytes += float(nbytes)
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return counted
    return wrap


class CostAttribution:
    """The per-program analytic-cost table + its gauge exports."""

    def __init__(self, registry=None):
        reg = registry if registry is not None else _registry
        self._lock = threading.Lock()
        self._costs: dict[str, dict] = {}
        self._g_flops = reg.gauge(
            "profile_analytic_flops",
            "XLA cost_analysis flops per execution, by compiled program")
        self._g_bytes = reg.gauge(
            "profile_analytic_bytes",
            "XLA cost_analysis HBM bytes accessed per execution, by "
            "compiled program")
        self._g_roofline = reg.gauge(
            "profile_roofline_utilization",
            "each resource's share of the roofline-critical time per "
            "program (the bound that reads 1.0 is the program's "
            "placement; the other is its headroom)")

    def record_program(self, program: str, flops: float, bytes_: float,
                       *, service: str = "",
                       platform: str | None = None) -> dict:
        """Record one program's analytic cost and export its roofline
        placement against the resolved :class:`PeakSpec`. Returns the
        stored info dict."""
        spec = peak_spec(platform)
        flops = max(float(flops), 0.0)
        bytes_ = max(float(bytes_), 0.0)
        t_compute = flops / spec.peak_flops
        t_memory = bytes_ / spec.hbm_bytes_per_s
        critical = max(t_compute, t_memory, 1e-18)
        bound = "compute" if t_compute >= t_memory else "memory"
        self._g_flops.set(flops, program=program)
        self._g_bytes.set(bytes_, program=program)
        self._g_roofline.set(t_compute / critical, program=program,
                             bound="compute")
        self._g_roofline.set(t_memory / critical, program=program,
                             bound="memory")
        info = {
            "program": program,
            "service": service,
            "platform": spec.platform,
            "flops": flops,
            "bytes": bytes_,
            "bound": bound,
            "roofline_seconds": spec.roofline_seconds(flops, bytes_),
            "compute_seconds": t_compute,
            "memory_seconds": t_memory,
        }
        with self._lock:
            self._costs[program] = info
        return info

    def record_call(self, program: str, fn, *args, service: str = "",
                    platform: str | None = None, **kwargs) -> dict:
        """Run ``fn(*args, **kwargs)`` once under :func:`count_cost` and
        record what it counted as ``program``'s cost per execution (the
        port's counterpart of the JAX package's ``record_compiled``).
        Returns the stored info dict."""
        with count_cost() as c:
            fn(*args, **kwargs)
        return self.record_program(program, c.flops, c.bytes,
                                   service=service, platform=platform)

    # -- read surface ------------------------------------------------------
    def program_cost(self, program: str) -> dict | None:
        with self._lock:
            info = self._costs.get(program)
        return dict(info) if info is not None else None

    def programs(self) -> dict[str, dict]:
        """Copy of the whole table (bench banking / debug payloads)."""
        with self._lock:
            return {k: dict(v) for k, v in self._costs.items()}

    def service_cost(self, service: str) -> tuple[float, float]:
        """Summed (flops, bytes) across the service's recorded
        programs — the FeatureLog v6 row values a served request
        carries. (0.0, 0.0) until something was recorded for the
        service."""
        flops = bytes_ = 0.0
        with self._lock:
            for info in self._costs.values():
                if info.get("service") == service:
                    flops += info["flops"]
                    bytes_ += info["bytes"]
        return flops, bytes_

    def clear(self) -> None:
        with self._lock:
            self._costs.clear()


#: THE process-wide attribution table (LLM warm and the feature rows
#: share it).
cost_attribution = CostAttribution()
