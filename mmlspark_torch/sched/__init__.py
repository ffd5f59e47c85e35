"""Admission-controlled request scheduling for the port: the port's own
copy of the JAX package's ``sched``, with the same ``__all__``, series,
shed reasons and tiers.

The process-wide layer between a serving front and the model executors:

- :class:`~.policy.AdmissionController` — bounded queues, per-route
  concurrency limits, predictive deadline-budget load shedding
  (429 + Retry-After).
- :class:`~.policy.BatchPolicy` — the adaptive batch-close decision
  (deadline slack / padding-bucket fill / learned service-time
  estimate), shared by online serving and
  ``stages.DynamicBufferedBatcher``.
- :class:`~.policy.ServiceTimeEstimator` — the service-time price: the
  learned cost model (``perf.costmodel``) first, the per-bucket EWMA in
  the obs registry as its fallback.
- :class:`~.scheduler.RequestScheduler` — the deadline-aware queue an
  executor pulls batches from (condition-variable wakeups: zero idle
  CPU, immediate dispatch; expired requests shed before execution).
- :class:`~.continuous.SlotScheduler` — step-boundary admission for
  continuous generation batching (device half:
  ``dl.generate.ContinuousGenerator``).
- :class:`~.tenancy.Tenancy` — per-tenant quotas (rate / inflight /
  queue share), SLO tiers (gold / silver / best-effort deadlines), and
  the weighted-fair queue the scheduler dispatches from when tenancy
  is attached.

Import is stdlib + obs only — no torch, no HTTP, no device.
"""

from .continuous import SlotAssignment, SlotScheduler
from .policy import (AdmissionConfig, AdmissionController, BatchPolicy,
                     ServiceTimeEstimator, Shed, bucket_of)
from .scheduler import RequestScheduler
from .tenancy import (BEST_EFFORT, DEFAULT_TENANT, GOLD, SILVER,
                      Tenancy, TenantQuota, WeightedFairQueue,
                      clean_tenant)

__all__ = ["AdmissionConfig", "AdmissionController", "BatchPolicy",
           "RequestScheduler", "ServiceTimeEstimator", "Shed",
           "SlotAssignment", "SlotScheduler", "bucket_of",
           "Tenancy", "TenantQuota", "WeightedFairQueue",
           "clean_tenant", "DEFAULT_TENANT",
           "GOLD", "SILVER", "BEST_EFFORT"]
