"""Learned-performance subsystem: the consumers of the obs telemetry (the
port's own copy of the JAX package's ``perf``, with the same ``__all__``).

- :mod:`.costmodel` — a numpy ridge regression over FeatureLog rows
  that prices the scheduler's service times ahead of its per-bucket EWMA
  (behind a loud fallback gate) and orders a build by predicted traffic
  value.
- ``autotune`` — the kernels' tile search and tuned-winner registry —
  comes with ROADMAP.md §1 item 9c: any use of it raises
  ``NotImplementedError`` until then.

Import is stdlib + numpy + obs/sched only — no torch, no device.
"""

import types

from .costmodel import (CostModel, bucket_build_priority, enabled,
                        model_path, perf_root, shared_cost_model)


class _Later(types.ModuleType):
    """A module that is not ported yet: reading any public name raises
    ``NotImplementedError`` naming the ROADMAP item that brings it."""

    def __init__(self, name: str, item: str):
        super().__init__(name)
        self._item = item

    def __getattr__(self, attr: str):
        if attr.startswith("_"):
            raise AttributeError(attr)
        raise NotImplementedError(
            f"{self.__name__}.{attr}: the kernels' tile search and tuned "
            f"registry come with ROADMAP.md §1 item {self._item}")


autotune = _Later(f"{__name__}.autotune", "9c")

__all__ = ["CostModel", "bucket_build_priority", "enabled",
           "model_path", "perf_root", "shared_cost_model", "autotune"]
