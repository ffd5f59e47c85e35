"""Learned-performance subsystem: the consumers of the obs telemetry (the
port's own copy of the JAX package's ``perf``, with the same ``__all__``).

- :mod:`.costmodel` — a numpy ridge regression over FeatureLog rows
  that prices the scheduler's service times ahead of its per-bucket EWMA
  (behind a loud fallback gate) and orders a build by predicted traffic
  value.
- :mod:`.autotune` — the kernels' tile search and tuned-winner registry:
  K1's, K2's forward's and K3's decode cut, measured on the card and
  read back by the kernel wrappers at call time.

Import is stdlib + numpy + obs/sched only — no torch, no device.
"""

from . import autotune
from .costmodel import (CostModel, bucket_build_priority, enabled,
                        model_path, perf_root, shared_cost_model)

__all__ = ["CostModel", "bucket_build_priority", "enabled",
           "model_path", "perf_root", "shared_cost_model", "autotune"]
