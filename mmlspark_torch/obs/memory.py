"""Device-memory telemetry: always-on HBM gauges + watermark deltas.

The port's own copy of the JAX package's ``obs/memory.py``, with the same
series. It turns PyTorch's CUDA caching-allocator counters into registry
series every scrape sees:

- ``mem_hbm_bytes_in_use{device=...}`` / ``mem_hbm_peak_bytes`` /
  ``mem_hbm_limit_bytes`` — per CUDA device, ``process``-labelled under a
  ``torch.distributed`` group (same labelling contract as
  ``profile_step_seconds``), refreshed by :meth:`MemoryProfiler.update`.
  ``bytes_in_use`` is the allocator's ``allocated_bytes.all.current``,
  ``peak_bytes_in_use`` its ``allocated_bytes.all.peak``, and
  ``bytes_limit`` the card's total memory (``torch.cuda.mem_get_info``).
- ``mem_segment_delta_bytes{stage=...}`` — the live-buffer delta one
  profiled stage left behind (StepProfiler samples the watermark around
  every ``step``).
- ``mem_event_watermark_bytes{event=...}`` — the watermark at named
  lifecycle events.

Degradation contract: with no CUDA context in the process every function
returns ``[]``/``None`` and the gauges are simply ABSENT — never an
exception, never a zero sample that looks like a measurement. The guard
never imports torch and never initializes CUDA
(:func:`~.attribution.cuda_initialized`): a scrape in a host-only
process leaves ``torch.cuda.is_initialized()`` False.
"""

from __future__ import annotations

import sys
import threading

from .attribution import cuda_initialized
from .metrics import registry as _registry
from .profile import process_label

__all__ = ["MemoryProfiler", "device_memory_stats", "memory_profiler"]

# our stat key -> metric name. Only keys the allocator reports become
# samples.
_STAT_KEYS = (
    ("bytes_in_use", "mem_hbm_bytes_in_use"),
    ("peak_bytes_in_use", "mem_hbm_peak_bytes"),
    ("bytes_limit", "mem_hbm_limit_bytes"),
)

# allocator stat -> our key
_ALLOCATOR_KEYS = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
)


def _live_devices() -> list[int]:
    """The CUDA device indices, ONLY when a CUDA context already exists.
    Never imports torch, never initializes CUDA."""
    if not cuda_initialized():
        return []
    try:
        return list(range(sys.modules["torch"].cuda.device_count()))
    except Exception:
        return []


# device index -> total bytes: ``mem_get_info`` asks the CUDA runtime, and
# the total never changes, so each device is asked once; the step
# profiler reads the stats twice a step
_LIMITS: dict[int, int] = {}


def _bytes_limit(torch, i: int) -> int | None:
    if i not in _LIMITS:
        try:
            _LIMITS[i] = int(torch.cuda.mem_get_info(i)[1])
        except Exception:
            return None
    return _LIMITS[i]


def device_memory_stats() -> list[dict]:
    """Per-device allocator stats: ``[{"device": "0", "bytes_in_use":
    ..., ...}]`` with only the keys the allocator reports. ``[]`` with no
    CUDA context — the documented fallback the fleet exposition carries
    on hosts without device memory."""
    out: list[dict] = []
    for i in _live_devices():
        torch = sys.modules["torch"]
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = None
        if not stats:
            continue
        rec = {"device": str(i)}
        for src, key in _ALLOCATOR_KEYS:
            v = stats.get(src)
            if v is not None:
                rec[key] = int(v)
        limit = _bytes_limit(torch, i)
        if limit is not None:
            rec["bytes_limit"] = limit
        if len(rec) > 1:
            out.append(rec)
    return out


class MemoryProfiler:
    """Registry-backed view over :func:`device_memory_stats`.

    Stateless apart from its gauge handles; every method tolerates a
    process with no CUDA context by doing nothing (gauges stay absent).
    """

    def __init__(self, registry=None):
        reg = registry if registry is not None else _registry
        self._lock = threading.Lock()
        self._gauges = {
            suffix: reg.gauge(suffix, help_)
            for suffix, help_ in (
                ("mem_hbm_bytes_in_use",
                 "allocator bytes currently live, per local device"),
                ("mem_hbm_peak_bytes",
                 "allocator peak bytes since process start, per device"),
                ("mem_hbm_limit_bytes",
                 "allocator capacity, per local device"),
            )}
        self._g_segment = reg.gauge(
            "mem_segment_delta_bytes",
            "live-buffer delta across one profiled stage execution, "
            "by stage")
        self._g_event = reg.gauge(
            "mem_event_watermark_bytes",
            "total live bytes at a named lifecycle event "
            "(aot_warm, scale_up, ...)")
        #: devices whose gauges were ever set — so a device that stops
        #: reporting does not leave a stale sample
        self._seen_devices: set[str] = set()

    def _plab(self) -> dict:
        pl = process_label()
        return {"process": pl} if pl is not None else {}

    def update(self) -> list[dict]:
        """Refresh the ``mem_hbm_*`` gauges from the live allocator;
        returns the raw stats (``[]`` with no CUDA context — gauges
        absent)."""
        stats = device_memory_stats()
        plab = self._plab()
        reported: set[str] = set()
        for rec in stats:
            dev = rec["device"]
            reported.add(dev)
            for key, suffix in _STAT_KEYS:
                if key in rec:
                    self._gauges[suffix].set(rec[key], device=dev, **plab)
        with self._lock:
            gone = self._seen_devices - reported
            self._seen_devices |= reported
        for dev in gone:
            for g in self._gauges.values():
                g.remove_matching(device=dev)
        return stats

    def watermark(self) -> int | None:
        """Total live bytes across local devices, or None with no CUDA
        context (the delta hooks skip instead of recording a fake
        zero)."""
        vals = [r["bytes_in_use"] for r in device_memory_stats()
                if "bytes_in_use" in r]
        return sum(vals) if vals else None

    def segment_delta(self, stage: str, before: int | None,
                      after: int | None) -> int | None:
        """Record the live-buffer delta one profiled stage left behind
        (StepProfiler samples ``watermark()`` around the step and lands
        both ends here). None in, nothing recorded."""
        if before is None or after is None:
            return None
        delta = int(after) - int(before)
        self._g_segment.set(delta, stage=stage, **self._plab())
        return delta

    def note_event(self, event: str) -> int | None:
        """Stamp the current watermark for a lifecycle event and refresh
        the per-device gauges, so the event's memory cost is scrapeable
        next to its latency."""
        self.update()
        wm = self.watermark()
        if wm is not None:
            self._g_event.set(wm, event=event, **self._plab())
        return wm


#: THE process-wide memory profiler (StepProfiler and the fleet scrape
#: surface share it so the series stay one family).
memory_profiler = MemoryProfiler()
