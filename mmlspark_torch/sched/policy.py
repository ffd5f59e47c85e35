"""Scheduling policy: service-time estimation, admission control, and the
adaptive batch-close decision (the port's own copy of the JAX package's
``sched/policy.py``, with the same series, shed reasons and clock).

This is the "batching brain" shared by online serving (through
``sched.RequestScheduler``) and offline pipelines
(``stages.DynamicBufferedBatcher``). The reference's
``DynamicBufferedBatcher``/``MiniBatchTransformer`` (arXiv:1804.04031)
encoded ONE policy — "take whatever accumulated" — which is optimal only
when service time is size-independent. Under padded batch buckets it is
not: service cost is a step function of the bucket, and the right close
decision weighs three signals:

- **deadline slack** of the oldest queued request (waiting past the
  point where the batch can still finish in budget converts latency SLO
  misses into certainty);
- **padding-bucket fill** (a batch sitting exactly on a bucket boundary
  gains nothing from one more request — it doubles the padded shape);
- a **learned service-time estimate** (EWMA per bucket, stored in the
  process-wide obs ``MetricsRegistry`` so a scrape shows the learned
  model and the batcher literally reads its estimates back from the
  registry), priced first by the learned cost model
  (``perf.costmodel``) when one is attached and answers.

Stdlib only: no device and no torch.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass

from ..obs import registry as _default_registry

_COSTMODEL_LOG = logging.getLogger("mmlspark_torch.sched")

# close-decision outcomes (returned by BatchPolicy.decide)
GROW = "grow"     # more work is queued: take it
WAIT = "wait"     # pay latency to grow the batch (bounded wait)
CLOSE = "close"   # dispatch now


def bucket_of(n: int) -> int:
    """The padded batch size ``n`` executes as: next power of two
    (mirrors ``serving.bucket_pad`` — one compiled program per bucket)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class ServiceTimeEstimator:
    """Service-time pricing: learned cost model first, EWMA fallback.

    The EWMA store IS the obs registry: ``observe`` writes the updated
    EWMA into the ``sched_service_seconds_ewma{service=...,bucket=...}``
    gauge and ``estimate`` reads it back, so the learned model is
    scrape-visible and survives scheduler re-construction (the registry
    is idempotent get-or-create). A second gauge,
    ``sched_item_seconds_ewma{service=...}``, tracks the per-item
    service cost across all buckets — the admission controller's
    service-rate input.

    With a cost model attached (``perf.costmodel.CostModel`` —
    ``RequestScheduler`` attaches the process-wide one by default),
    ``estimate``/``item_seconds`` consult the model FIRST and fall back
    to the EWMA when it declines (cold for this service, or its recent
    error tripped the gate). Every answer is attributed
    (``sched_costmodel_requests_total{source=model|ewma}``) and every
    executed batch scores the model's prediction against the observed
    time (``sched_costmodel_error_ms``), so a regressing model is
    visible on the same scrape that shows its predictions. The EWMA
    keeps training regardless — the fallback is always warm.
    """

    def __init__(self, service: str, alpha: float = 0.25, registry=None,
                 cost_model=None):
        reg = registry if registry is not None else _default_registry
        self.service = service
        self.alpha = float(alpha)
        self.cost_model = cost_model
        self._g_bucket = reg.gauge(
            "sched_service_seconds_ewma",
            "EWMA batch service seconds, by service and padding bucket")
        self._g_item = reg.gauge(
            "sched_item_seconds_ewma",
            "EWMA per-item service seconds, by service")
        self._c_obs = reg.counter(
            "sched_service_observations_total",
            "service-time samples folded into the EWMA, by service/bucket")
        self._c_src = reg.counter(
            "sched_costmodel_requests_total",
            "service-time estimates answered, by service and source "
            "(model | ewma)")
        self._h_err = reg.histogram(
            "sched_costmodel_error_ms",
            "abs(cost-model predicted - observed) batch ms, by service")
        self._obs_n = 0
        self._lock = threading.Lock()

    def attach_cost_model(self, model) -> None:
        """Attach a learned cost model (``perf.costmodel.CostModel``);
        ``None`` detaches — pure-EWMA pricing again."""
        self.cost_model = model

    def observe(self, batch_size: int, seconds: float) -> None:
        """Fold one executed batch into the per-bucket and per-item
        EWMAs (read-modify-write under a lock: the executor thread and
        a bench reader may interleave). "Never observed" is encoded as
        the gauge's unset-series default of 0.0 — a real service time
        is strictly positive, so 0.0 is unambiguous and the counter
        stays an honest one-increment-per-sample series (no synthetic
        label values in the exposition, `sum by (service)` is exact)."""
        if batch_size <= 0:
            return
        cm = self.cost_model
        pred_ms = None
        if cm is not None:
            # score the model against what actually happened (read
            # only: must not bump the fallback counters)
            pred_ms = cm.predict_batch_ms(self.service, batch_size,
                                          count=False)
        b = bucket_of(batch_size)
        seconds = max(float(seconds), 1e-9)
        per_item = seconds / float(batch_size)
        with self._lock:
            cur = self._g_bucket.value(service=self.service, bucket=str(b))
            item_cur = self._g_item.value(service=self.service)
            if cur == 0.0:
                # cold bucket: seed from the per-item global estimate
                # scaled by batch size (when one exists) instead of the
                # raw sample — one outlier first batch must not
                # mis-price the whole bucket until it decays
                prior = item_cur * batch_size if item_cur > 0.0 else None
                new = seconds if prior is None else \
                    self.alpha * seconds + (1 - self.alpha) * prior
            else:
                new = self.alpha * seconds + (1 - self.alpha) * cur
            self._g_bucket.set(new, service=self.service, bucket=str(b))
            item_new = per_item if item_cur == 0.0 else \
                self.alpha * per_item + (1 - self.alpha) * item_cur
            self._g_item.set(item_new, service=self.service)
            self._c_obs.inc(1, service=self.service, bucket=str(b))
        if cm is not None:
            actual_ms = seconds * 1e3
            if pred_ms is not None:
                self._h_err.observe(abs(pred_ms - actual_ms),
                                    service=self.service)
            try:
                cm.observe(self.service, pred_ms, actual_ms)
                self._obs_n += 1
                if self._obs_n % 32 == 0:
                    # online refresh: serving traffic trains the model
                    # that prices serving traffic (cheap no-op until
                    # enough new FeatureLog rows accumulated)
                    cm.maybe_refresh()
            except Exception:
                _COSTMODEL_LOG.warning(
                    "cost-model bookkeeping failed", exc_info=True)

    def estimate(self, batch_size: int) -> float | None:
        """Expected service seconds for a batch of ``batch_size``:
        the learned cost model when it answers, else the EWMA registry
        read. Unobserved buckets extrapolate from the nearest observed
        bucket linearly in padded size — an overestimate on hardware
        with sublinear batch scaling, which errs toward closing batches
        early (latency-safe). ``None`` until any sample exists."""
        cm = self.cost_model
        if cm is not None:
            ms = cm.predict_batch_ms(self.service, batch_size)
            if ms is not None:
                self._c_src.inc(1, service=self.service, source="model")
                return ms / 1e3
        out = self._ewma_estimate(batch_size)
        if cm is not None and out is not None:
            # attribute only ANSWERED estimates: a double-cold None is
            # not an ewma-served request, and counting it would
            # understate model coverage during warmup
            self._c_src.inc(1, service=self.service, source="ewma")
        return out

    def _ewma_estimate(self, batch_size: int) -> float | None:
        want = bucket_of(batch_size)
        direct = self._read_bucket(want)
        if direct is not None:
            return direct
        # nearest observed bucket, preferring smaller (measured) shapes
        for shift in range(1, 12):
            for b in (want >> shift, want << shift):
                if b < 1:
                    continue
                got = self._read_bucket(b)
                if got is not None:
                    return got * (want / b)
        return None

    def item_seconds(self) -> float | None:
        """Per-item service seconds (admission's service rate): the
        cost model's per-item prediction at the observed operating
        point when it answers (marginal cost — NOT a batch-of-one,
        whose fixed dispatch intercept would inflate Little's-law
        drain estimates by the batching factor), else the per-item
        EWMA; ``None`` until any sample exists."""
        cm = self.cost_model
        if cm is not None:
            ms = cm.predict_item_ms(self.service)
            if ms is not None:
                return ms / 1e3
        v = self._g_item.value(service=self.service)
        return v if v > 0.0 else None

    def _read_bucket(self, b: int) -> float | None:
        v = self._g_bucket.value(service=self.service, bucket=str(b))
        return v if v > 0.0 else None


class Shed(Exception):
    """An admission (or in-queue expiry) rejection.

    ``status`` is the HTTP contract: hard queue overflow keeps the
    pre-existing 503 semantics; policy sheds (deadline budget,
    concurrency limit, in-queue expiry) answer 429 with ``retry_after``
    seconds — the client is asked to back off, not told the service is
    down."""

    def __init__(self, reason: str, retry_after: float = 1.0):
        super().__init__(f"shed: {reason}")
        self.reason = reason
        self.retry_after = max(1, int(math.ceil(retry_after)))

    @property
    def status(self) -> int:
        return 503 if self.reason == "queue_full" else 429


@dataclass
class AdmissionConfig:
    """Knobs for :class:`AdmissionController` (see docs/serving.md
    "Scheduling and overload")."""

    max_queue: int = 0        # bound on queued requests; 0 = unbounded
    max_inflight: int = 0     # per-route admitted-but-unanswered cap; 0 = off
    deadline: float = 0.0     # default per-request budget seconds; 0 = none


class AdmissionController:
    """Admit or shed at intake: bounded queue, per-route concurrency
    limits, and predictive deadline-budget shedding.

    The predictive rule is Little's-law arithmetic: with ``d`` requests
    queued and a learned per-item service time ``s`` (EWMA from the obs
    registry), a new arrival waits ``~d*s`` before its batch starts. If
    that predicted wait already exceeds the request's deadline budget,
    admitting it only manufactures a guaranteed timeout — shed now with
    ``Retry-After`` sized to the predicted drain time instead.
    """

    def __init__(self, service: str, config: AdmissionConfig,
                 estimator: ServiceTimeEstimator, registry=None,
                 tenancy=None):
        reg = registry if registry is not None else _default_registry
        self.service = service
        self.config = config
        self.estimator = estimator
        # optional per-tenant layer (sched.tenancy.Tenancy): quotas,
        # tiers, and the WFQ-aware wait estimate below
        self.tenancy = tenancy
        self._inflight: dict[str, int] = {}
        self._lock = threading.Lock()
        self._c_admitted = reg.counter(
            "sched_admitted_total", "requests admitted, by service/route")
        self._c_shed = reg.counter(
            "sched_shed_total",
            "requests shed, by service/route/reason "
            "(queue_full | deadline | inflight | expired)")
        self._g_inflight = reg.gauge(
            "sched_inflight",
            "admitted-but-unanswered requests, by service/route")

    def try_admit(self, route: str, depth: int,
                  deadline_budget: float | None = None,
                  tenant: str = "", tenant_depth: int = 0) -> None:
        """Raise :class:`Shed` unless the request should be queued.
        ``depth`` is the current queue depth; ``deadline_budget`` the
        request's remaining budget in seconds (None → config default);
        ``tenant``/``tenant_depth`` feed the per-tenant gates and the
        WFQ-aware wait estimate when a tenancy policy is attached."""
        cfg = self.config
        if cfg.max_queue and depth >= cfg.max_queue:
            self._shed(route, "queue_full", retry_after=1, tenant=tenant)
        if cfg.max_inflight:
            with self._lock:
                cur = self._inflight.get(route, 0)
            if cur >= cfg.max_inflight:
                self._shed(route, "inflight", retry_after=1,
                           tenant=tenant)
        budget = cfg.deadline if deadline_budget is None else deadline_budget
        item_s = self.estimator.item_seconds()
        if budget and item_s:
            # predicted completion = queue drain ahead of us plus our
            # own service — the deadline bounds the whole path, so a
            # request that cannot FINISH in budget is shed at the door
            ahead = depth + 1
            if self.tenancy is not None and tenant:
                # under weighted-fair dispatch a tenant does NOT wait
                # out the whole queue: by the time its (d_t+1)-th item
                # dispatches, total dispatches ≈ (d_t+1)/share — so a
                # gold arrival behind a best-effort backlog is admitted
                # on ITS predicted wait, not the queue's (capped at the
                # full-drain estimate; fairness can't make it worse)
                share = self.tenancy.share_for(tenant)
                ahead = min((tenant_depth + 1) / max(share, 1e-6),
                            depth + 1)
            predicted = ahead * item_s
            if predicted > budget:
                self._shed(route, "deadline",
                           retry_after=predicted - budget,
                           tenant=tenant)
        if self.tenancy is not None and tenant:
            # per-tenant gates LAST, so quota tokens are only consumed
            # by requests the global gates would actually queue
            try:
                self.tenancy.try_admit(tenant, route, tenant_depth,
                                       cfg.max_queue)
            except Shed as s:
                # the tenancy layer counted the per-tenant series; the
                # global reason-summed series must see the shed too
                self._c_shed.inc(1, service=self.service, route=route,
                                 reason=s.reason)
                raise
        self._c_admitted.inc(1, service=self.service, route=route)
        with self._lock:
            cur = self._inflight[route] = self._inflight.get(route, 0) + 1
        self._g_inflight.set(cur, service=self.service, route=route)

    def release(self, route: str, tenant: str = "") -> None:
        """A previously admitted request finished (replied, shed after
        queueing, or abandoned) — exactly-once per request, enforced by
        the caller's done-latch."""
        with self._lock:
            cur = max(self._inflight.get(route, 0) - 1, 0)
            self._inflight[route] = cur
        self._g_inflight.set(cur, service=self.service, route=route)
        if self.tenancy is not None and tenant:
            self.tenancy.release(tenant)

    def count_shed(self, route: str, reason: str,
                   tenant: str = "") -> None:
        """Record a shed decided elsewhere (in-queue expiry)."""
        self._c_shed.inc(1, service=self.service, route=route,
                         reason=reason)
        if self.tenancy is not None and tenant:
            self.tenancy.count_shed(tenant, reason)

    def inflight(self, route: str) -> int:
        with self._lock:
            return self._inflight.get(route, 0)

    def _shed(self, route: str, reason: str, retry_after: float,
              tenant: str = ""):
        self._c_shed.inc(1, service=self.service, route=route,
                         reason=reason)
        if self.tenancy is not None and tenant:
            self.tenancy.count_shed(tenant, reason)
        raise Shed(reason, retry_after)


class BatchPolicy:
    """The adaptive batch-close decision (one brain for online and
    offline batching).

    :meth:`decide` is called each time the forming batch could either
    dispatch or keep growing, and returns ``(action, wait_seconds,
    reason)``:

    - ``GROW``: more work is immediately available — take it.
    - ``CLOSE``: dispatch now. Reasons: ``full`` (hit max_batch),
      ``deadline`` (the oldest request's slack no longer covers the
      estimated service time), ``bucket`` (the batch sits on a padding
      bucket boundary and growing into the next bucket is estimated to
      cost more added service time than the remaining wait budget —
      waiting longer costs more than it gains), ``linger`` (the wait
      budget ran out), ``drain`` (no wait budget configured; take what
      accumulated — the reference policy).
    - ``WAIT``: pay up to ``wait_seconds`` of latency for more work
      (the caller waits on its queue's condition variable, so an
      arrival cuts the wait short).
    """

    def __init__(self, max_batch: int = 1024, linger: float = 0.0,
                 estimator: ServiceTimeEstimator | None = None):
        self.max_batch = max(int(max_batch), 1)
        self.linger = max(float(linger), 0.0)
        self.estimator = estimator

    def decide(self, n: int, queue_empty: bool,
               oldest_slack: float | None = None,
               linger_remaining: float | None = None
               ) -> tuple[str, float, str]:
        if n >= self.max_batch:
            return CLOSE, 0.0, "full"
        if not queue_empty:
            return GROW, 0.0, ""
        est = self.estimator.estimate(n) if self.estimator else None
        # wait budget: the remaining linger, clamped by the oldest
        # request's deadline slack less the time the batch itself needs
        budget = self.linger if linger_remaining is None \
            else max(linger_remaining, 0.0)
        if oldest_slack is not None:
            slack_budget = oldest_slack - (est or 0.0)
            if slack_budget <= 0:
                return CLOSE, 0.0, "deadline"
            budget = min(budget, slack_budget)
        if budget <= 0:
            # "linger" = a configured wait budget ran out; "drain" = no
            # budget was configured (the reference's take-what-accumulated)
            return CLOSE, 0.0, ("linger" if self.linger > 0 else "drain")
        if n >= 1 and (n & (n - 1)) == 0 and self.estimator is not None:
            # on a bucket boundary: one more request doubles the padded
            # shape; close when that jump is estimated to cost more than
            # the wait budget we would spend to fill it
            cur, nxt = self.estimator.estimate(n), \
                self.estimator.estimate(2 * n)
            if cur is not None and nxt is not None \
                    and (nxt - cur) >= budget:
                return CLOSE, 0.0, "bucket"
        return WAIT, budget, ""


def now() -> float:
    """The scheduler's clock (monotonic; one definition so deadlines
    set at intake and checked at dispatch can never mix clock bases)."""
    return time.monotonic()
