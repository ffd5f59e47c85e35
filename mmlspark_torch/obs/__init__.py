"""Observability for the port: the metrics registry (``obs/metrics.py``).

The tracer, profiler, fleet and attribution planes of the JAX package's
``obs`` come with ROADMAP.md §1 item 9.
"""

from .metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, bucket_quantile, registry)

__all__ = ["Counter", "DEFAULT_LATENCY_BUCKETS", "Gauge", "Histogram",
           "MetricsRegistry", "bucket_quantile", "registry"]
