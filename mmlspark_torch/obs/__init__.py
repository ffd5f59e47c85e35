"""Unified observability for the port: process-wide metrics + tracing +
profiling, the port's own copy of the JAX package's ``obs`` with the same
``__all__``, series, span names and env switches.

One registry (``registry``), one tracer (``tracer``), one flight
recorder (``flight_recorder``), one compile tracker
(``compile_tracker``) shared by every layer — the LightGBM boosting
loop, every stage call, the serving engine. Cross-process trace
propagation lives in ``obs.propagation`` (W3C-style traceparent),
Chrome-trace export and the flight recorder in ``obs.export``, the
compile/step profiler and cost-model feature log in ``obs.profile``,
device memory in ``obs.memory``, per-program rooflines in
``obs.attribution``, ``torch.profiler`` captures in ``obs.xprof``, the
telemetry history in ``obs.timeseries`` (watched live by
``obs.regression``), the fleet view in ``obs.fleet`` and the goodput
ledger in ``obs.goodput``.

Import is side-effect-free and device-free: it imports no torch and
never initializes CUDA.
"""

from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, registry)
from .tracing import Span, StageTimer, Tracer, tracer, wall_now
from .propagation import TraceContext, extract, inject
from .export import (FlightRecorder, SpanCollector, chrome_trace,
                     flight_recorder)
from .profile import (FEATURE_SCHEMA_VERSION, CompileTracker, FeatureLog,
                      StepProfiler, compile_tracker, feature_log,
                      step_profiler)
from .memory import MemoryProfiler, device_memory_stats, memory_profiler
from .timeseries import (Recorder, TimeSeriesStore, recorder,
                         timeline_payload, timeseries_store)
from .fleet import (BurnRateMonitor, FleetAggregator, FleetHealth,
                    StragglerDetector, fleet_aggregator, fleet_health,
                    local_fleet_snapshot, parse_exposition, parse_sample,
                    straggler_workers)
from .regression import (CusumDetector, RegressionSentinel, compare_benches,
                         sentinel)
from .attribution import (PEAK_SPECS, CostAttribution, PeakSpec,
                          cost_attribution, peak_spec)
from .goodput import (WASTE_CAUSES, GoodputLedger, goodput_ledger,
                      goodput_payload)
from .xprof import XprofCaptures, xprof_captures

__all__ = ["registry", "tracer", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "Tracer", "Span", "StageTimer", "wall_now",
           "DEFAULT_LATENCY_BUCKETS",
           "TraceContext", "extract", "inject",
           "FlightRecorder", "SpanCollector", "chrome_trace",
           "flight_recorder",
           "CompileTracker", "FeatureLog", "StepProfiler",
           "FEATURE_SCHEMA_VERSION",
           "compile_tracker", "feature_log", "step_profiler",
           "MemoryProfiler", "device_memory_stats", "memory_profiler",
           "FleetAggregator", "FleetHealth", "StragglerDetector",
           "BurnRateMonitor", "fleet_aggregator", "fleet_health",
           "local_fleet_snapshot", "parse_exposition", "parse_sample",
           "straggler_workers",
           "TimeSeriesStore", "Recorder", "timeseries_store", "recorder",
           "timeline_payload",
           "CusumDetector", "RegressionSentinel", "compare_benches",
           "sentinel",
           "PeakSpec", "PEAK_SPECS", "CostAttribution", "peak_spec",
           "cost_attribution",
           "GoodputLedger", "WASTE_CAUSES", "goodput_ledger",
           "goodput_payload",
           "XprofCaptures", "xprof_captures"]
