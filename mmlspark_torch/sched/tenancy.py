"""Multi-tenant quotas, SLO tiers, and weighted-fair scheduling (the
port's own copy of the JAX package's ``sched/tenancy.py``).

One serving surface fronting many heterogeneous workloads is the
reference's own pitch (web-service featurizers, GBDTs, deep models
behind Spark Serving, arXiv:1804.04031) — and on shared accelerators
those workloads live or die by *isolation*: without per-tenant limits,
one runaway client fills the queue and every other tenant's SLO dies
with it. This module makes isolation a contract:

- :class:`TenantQuota` — per-tenant admission limits: a token-bucket
  **rate** (shed ``tenant_rate`` with ``Retry-After`` derived from that
  tenant's own refill time, never the global EWMA), a **max_inflight**
  cap (``tenant_inflight``), and a **queue_share** bound — the fraction
  of the scheduler's ``max_queue`` one tenant may occupy
  (``tenant_queue``), so a best-effort flood cannot squeeze gold out of
  the queue. All tenant sheds answer 429 (the service is fine; *you*
  are over quota).
- **SLO tiers** (``gold`` / ``silver`` / ``best_effort``): a tier names
  a completion-deadline default (configured per service via
  ``tier_deadlines``) and a dispatch weight. A tenant's tier deadline
  caps its request budgets — gold requests become deadline-carrying
  even when the client sends none, so expiry shedding and the
  predictive admission shed enforce the tier's latency contract.
- :class:`WeightedFairQueue` — the dispatch half: per-tenant FIFO
  sub-queues drained by virtual-time weighted fair queueing (each pop
  advances the winning tenant's virtual time by ``1/weight``), so under
  contention each tenant gets its weight's share of dispatches and an
  overloaded best-effort tenant cannot delay gold. Re-queued replays
  (``appendleft``) keep their jump-the-queue contract via an urgent
  lane.
- **Bounded cardinality**: every per-tenant series carries a ``tenant``
  label, and tenants are unbounded identities — so idle tenants are
  evicted (state AND their ``sched_*`` / ``serving_*`` series, via
  ``obs.Metric.remove_matching``) after ``idle_evict_s`` of silence,
  mirroring the mesh's per-worker breaker eviction. 1k ephemeral
  tenants must leave the exposition flat (regression-tested).

Import is stdlib + obs only — no torch, no HTTP. The clock is
:func:`policy.now` (monotonic): refill arithmetic and idle timeouts must
never jump with wall-clock steps.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from dataclasses import dataclass

from ..obs import registry as _default_registry
from .policy import Shed, now

# tier names + their default dispatch weights: gold outweighs silver
# outweighs best-effort 8:4:1 — proportions, not absolute priority, so
# nothing starves (a starved best-effort tenant would just time out and
# retry, deepening the overload it caused)
GOLD = "gold"
SILVER = "silver"
BEST_EFFORT = "best_effort"
TIER_WEIGHTS = {GOLD: 8.0, SILVER: 4.0, BEST_EFFORT: 1.0}

#: per-tier error budgets — the fraction of a tenant's requests allowed
#: to shed/fail before its SLO is breached. The fleet health plane
#: (obs.fleet.BurnRateMonitor) divides observed shed rates by these to
#: get burn multiples: burn 1.0 = consuming budget exactly at the SLO
#: rate, 10x = paging. Gold's budget is 100x tighter than best-effort's.
TIER_ERROR_BUDGETS = {GOLD: 0.001, SILVER: 0.01, BEST_EFFORT: 0.1}

#: the bucket requests land in when tenancy is on but no (valid)
#: ``X-Tenant`` header arrived — shares the default quota
DEFAULT_TENANT = "default"

# label-safe tenant names: bounded charset and length so a hostile
# header cannot mint arbitrary bytes into Prometheus label values
# (cardinality itself is handled by idle eviction, not the charset)
_TENANT_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.\-]{0,63}")


def clean_tenant(value) -> str:
    """An ``X-Tenant`` header value as a safe label, or ``""`` (→ the
    default tenant) when absent/invalid — a junk header must degrade to
    the default bucket, never into the exposition."""
    if not value:
        return ""
    s = str(value).strip()
    return s if _TENANT_RE.fullmatch(s) else ""


@dataclass
class TenantQuota:
    """One tenant's admission limits and tier (all limits off by 0).

    ``rate`` is sustained admissions/second through a token bucket of
    capacity ``burst`` (default ``max(rate, 1)``); ``queue_share`` is
    the fraction of the scheduler's ``max_queue`` this tenant may hold
    queued; ``deadline``/``weight`` override the tier defaults."""

    tier: str = BEST_EFFORT
    rate: float = 0.0
    burst: float = 0.0
    max_inflight: int = 0
    queue_share: float = 0.0
    deadline: float = 0.0
    weight: float = 0.0


class _TenantState:
    """Mutable per-tenant runtime state (guarded by Tenancy._lock)."""

    __slots__ = ("tokens", "refilled", "last_seen", "inflight",
                 "lat_ewma", "lat_seen")

    def __init__(self, t: float, burst: float):
        self.tokens = burst       # a fresh tenant starts with full burst
        self.refilled = t
        self.last_seen = t
        self.inflight = 0
        self.lat_ewma = 0.0
        self.lat_seen = False


class Tenancy:
    """Per-service tenant policy: quotas, tiers, fairness weights, and
    the per-tenant observability that rides with them.

    Plug one into :class:`~.scheduler.RequestScheduler` (``tenancy=``)
    and the scheduler becomes tenant-aware end to end: admission runs
    the per-tenant gates (rate / inflight / queue share), dispatch runs
    weighted-fair across tenants, tier deadlines cap request budgets,
    and every decision lands in ``sched_tenant_*`` series.

    ``quotas`` maps tenant name → :class:`TenantQuota`; unknown tenants
    (and the header-less :data:`DEFAULT_TENANT`) use ``default``.
    ``tier_deadlines`` maps tier name → completion-budget seconds (the
    SLO the tier promises). ``idle_evict_s`` > 0 evicts tenants idle
    that long — state and series both (cardinality bound).
    """

    def __init__(self, service: str,
                 quotas: dict[str, TenantQuota] | None = None,
                 default: TenantQuota | None = None, *,
                 tier_deadlines: dict[str, float] | None = None,
                 idle_evict_s: float = 0.0, registry=None):
        reg = registry if registry is not None else _default_registry
        self.service = service
        self.quotas = dict(quotas or {})
        self.default = default if default is not None else TenantQuota()
        self.tier_deadlines = dict(tier_deadlines or {})
        self.idle_evict_s = float(idle_evict_s)
        self._registry = reg
        self._lock = threading.Lock()
        self._states: dict[str, _TenantState] = {}
        self._depth_reported: set[str] = set()
        self._next_sweep = 0.0
        self._c_admitted = reg.counter(
            "sched_tenant_admitted_total",
            "requests admitted, by service/tenant")
        self._c_shed = reg.counter(
            "sched_tenant_shed_total",
            "requests shed, by service/tenant/reason (tenant_rate | "
            "tenant_inflight | tenant_queue | the global shed reasons)")
        self._g_inflight = reg.gauge(
            "sched_tenant_inflight",
            "admitted-but-unanswered requests, by service/tenant")
        self._g_depth = reg.gauge(
            "sched_tenant_queue_depth",
            "queued requests, by service/tenant")
        self._g_lat = reg.gauge(
            "sched_tenant_latency_seconds_ewma",
            "EWMA request latency, by service/tenant (the autoscaler's "
            "SLO-pressure input)")
        self._c_evicted = reg.counter(
            "sched_tenant_evicted_total",
            "idle tenants evicted (state + series), by service")

    # -- config reads (construction-time data: lock-free) -------------------
    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default)

    def deadline_for(self, tenant: str) -> float:
        """The tenant's SLO completion budget in seconds (its quota
        override, else its tier's configured deadline; 0 = none)."""
        q = self.quota_for(tenant)
        return q.deadline or self.tier_deadlines.get(q.tier, 0.0)

    def weight_for(self, tenant: str) -> float:
        q = self.quota_for(tenant)
        return q.weight or TIER_WEIGHTS.get(q.tier, 1.0)

    def error_budget_for(self, tenant: str) -> float:
        """The tenant's SLO error budget (allowed shed/fail fraction)
        from its tier — the burn-rate denominator
        (``obs.fleet.BurnRateMonitor``; wired by the serving fronts via
        ``FleetHealth.attach_tenancy``)."""
        q = self.quota_for(tenant)
        return TIER_ERROR_BUDGETS.get(q.tier,
                                      TIER_ERROR_BUDGETS[BEST_EFFORT])

    def share_for(self, tenant: str) -> float:
        """This tenant's weighted share of dispatches among the tenants
        currently known (seen since startup/last eviction) — the
        admission controller's WFQ wait-time estimate divides by it."""
        w = self.weight_for(tenant)
        with self._lock:
            names = set(self._states)
        names.add(tenant)
        total = sum(self.weight_for(n) for n in names)
        return w / total if total > 0 else 1.0

    # -- admission gates -----------------------------------------------------
    def try_admit(self, tenant: str, route: str, tenant_depth: int,
                  max_queue: int) -> None:
        """Run the per-tenant gates; raise :class:`~.policy.Shed`
        (429) on violation. ``tenant_depth`` is this tenant's current
        queued count (the fair queue's bucket), ``max_queue`` the
        scheduler's global bound that ``queue_share`` is a fraction of.
        Tokens are only consumed on success — a request the global
        gates then reject never charged the bucket (the caller runs
        this gate last)."""
        q = self.quota_for(tenant)
        t = now()
        with self._lock:
            st = self._state_locked(tenant, t, q)
            st.last_seen = t
            if q.queue_share and max_queue and \
                    tenant_depth >= q.queue_share * max_queue:
                self._shed_locked(tenant, "tenant_queue", 1.0)
            if q.max_inflight and st.inflight >= q.max_inflight:
                self._shed_locked(tenant, "tenant_inflight", 1.0)
            if q.rate > 0:
                cap = q.burst or max(q.rate, 1.0)
                st.tokens = min(cap,
                                st.tokens + (t - st.refilled) * q.rate)
                st.refilled = t
                if st.tokens < 1.0:
                    # Retry-After from THIS tenant's refill time: the
                    # bucket knows exactly when the next token lands —
                    # the global service-time EWMA says nothing about
                    # one tenant's quota
                    self._shed_locked(tenant, "tenant_rate",
                                      retry_after_for_refill(q,
                                                             st.tokens))
                st.tokens -= 1.0
            st.inflight += 1
            cur = st.inflight
        self._c_admitted.inc(1, service=self.service, tenant=tenant)
        self._g_inflight.set(cur, service=self.service, tenant=tenant)
        # NO eviction sweep here: this gate runs under the scheduler's
        # condition variable, and a sweep scans every sched_*/serving_*
        # metric — it rides update_queue_gauges instead, which the
        # scheduler calls after releasing the cv

    def release(self, tenant: str) -> None:
        """A previously admitted request reached a terminal state."""
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                return
            st.inflight = max(st.inflight - 1, 0)
            cur = st.inflight
        self._g_inflight.set(cur, service=self.service, tenant=tenant)

    def count_shed(self, tenant: str, reason: str) -> None:
        """Record a shed decided elsewhere (global gates, in-queue
        expiry) against the tenant's series."""
        self._c_shed.inc(1, service=self.service, tenant=tenant,
                         reason=reason)

    # -- runtime signals -----------------------------------------------------
    def observe_latency(self, tenant: str, seconds: float) -> None:
        """Fold one served request's latency into the tenant's EWMA
        (the autoscaler's SLO-pressure input)."""
        with self._lock:
            st = self._state_locked(tenant, now(), self.quota_for(tenant))
            st.lat_ewma = seconds if not st.lat_seen else \
                0.2 * seconds + 0.8 * st.lat_ewma
            st.lat_seen = True
            cur = st.lat_ewma
        self._g_lat.set(cur, service=self.service, tenant=tenant)

    def slo_pressure(self) -> float:
        """max over SLO-bearing tenants of (EWMA latency / tier
        deadline) — > 1 means some tenant is past its SLO. The
        autoscaler's scale-up trigger."""
        with self._lock:
            seen = [(t, st.lat_ewma) for t, st in self._states.items()
                    if st.lat_seen]
        pressure = 0.0
        for tenant, ewma in seen:
            dl = self.deadline_for(tenant)
            if dl:
                pressure = max(pressure, ewma / dl)
        return pressure

    def update_queue_gauges(self, depths: dict[str, int]) -> None:
        """Refresh ``sched_tenant_queue_depth`` from the fair queue's
        per-tenant depths (called by the scheduler OUTSIDE its cv —
        registry writes must not ride the dispatch lock). Tenants that
        emptied since the last report are zeroed — the fair queue drops
        empty buckets (its own cardinality bound), so absence from
        ``depths`` means drained, not unknown."""
        with self._lock:
            stale = self._depth_reported - set(depths)
            self._depth_reported = set(depths)
        for tenant, depth in depths.items():
            self._g_depth.set(depth, service=self.service, tenant=tenant)
        for tenant in stale:
            self._g_depth.set(0, service=self.service, tenant=tenant)
        # the idle-tenant sweep rides here — the one per-admission hook
        # that runs OUTSIDE the scheduler's condition variable (a sweep
        # scans every sched_*/serving_* metric and must never stall
        # submitters or dispatch)
        self.maybe_evict_idle()

    # -- cardinality bound ---------------------------------------------------
    def maybe_evict_idle(self, t: float | None = None) -> list[str]:
        """Evict tenants idle for ``idle_evict_s``: their runtime state
        AND every ``sched_*``/``serving_*`` series carrying their
        ``tenant`` label (``obs.Metric.remove_matching``) — 1k ephemeral
        tenants must leave the exposition flat, exactly like the mesh's
        per-worker breaker eviction. Swept at most every quarter
        timeout; in-flight tenants are never evicted."""
        if not self.idle_evict_s:
            return []
        t = now() if t is None else t
        with self._lock:
            if t < self._next_sweep:
                return []
            self._next_sweep = t + max(self.idle_evict_s / 4.0, 0.05)
            cutoff = t - self.idle_evict_s
            gone = [name for name, st in self._states.items()
                    if st.last_seen < cutoff and st.inflight <= 0]
            for name in gone:
                del self._states[name]
        for name in gone:
            evict_tenant_series(name, self._registry)
            self._c_evicted.inc(1, service=self.service)
        return gone

    # -- internals -----------------------------------------------------------
    def _state_locked(self, tenant: str, t: float,
                      q: TenantQuota) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            st = self._states[tenant] = _TenantState(
                t, q.burst or max(q.rate, 1.0))
        return st

    def _shed_locked(self, tenant: str, reason: str,
                     retry_after: float):
        self._c_shed.inc(1, service=self.service, tenant=tenant,
                         reason=reason)
        raise Shed(reason, retry_after)


def evict_tenant_series(tenant: str, registry=None,
                        prefixes: tuple[str, ...] = ("sched_",
                                                     "serving_",
                                                     "slo_")) -> None:
    """Drop every ``sched_*``/``serving_*``/``slo_*`` series labeled
    with this tenant from the registry — the metric-side half of
    idle-tenant eviction (the state half lives in
    :meth:`Tenancy.maybe_evict_idle`). ``slo_`` covers the burn-rate
    gauges the fleet health plane derives from this tenant's counters.
    """
    reg = registry if registry is not None else _default_registry
    for prefix in prefixes:
        for metric in reg.metrics(prefix):
            metric.remove_matching(tenant=tenant)


class WeightedFairQueue:
    """Deque-compatible multi-tenant queue: per-tenant FIFOs drained by
    virtual-time weighted fair queueing.

    The scheduler holds its condition variable around every call, so
    this class carries NO lock of its own. ``append`` buckets by the
    item's ``tenant`` attribute (:data:`DEFAULT_TENANT` when absent);
    ``popleft`` takes from the active tenant with the smallest virtual
    time, then advances that tenant's clock by ``1/weight`` — over any
    contended interval tenant dispatch counts converge to the weight
    ratio. ``appendleft`` (replays/requeues) goes to an urgent lane
    served before everything: replayed work already waited through the
    queue once and is racing its remaining deadline.

    A tenant going idle must not bank credit: when its queue
    re-activates, its virtual time catches up to the minimum active
    virtual time (standard WFQ re-activation), so returning tenants
    compete fairly instead of monopolizing the next N pops.
    """

    def __init__(self, tenancy: Tenancy):
        self._tenancy = tenancy
        self._queues: dict[str, deque] = {}
        self._vtime: dict[str, float] = {}
        self._urgent: deque = deque()
        self._len = 0

    def append(self, item) -> None:
        tenant = getattr(item, "tenant", "") or DEFAULT_TENANT
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
        if not q:
            floor = min((self._vtime.get(n, 0.0)
                         for n, qq in self._queues.items() if qq),
                        default=0.0)
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0),
                                      floor)
        q.append(item)
        self._len += 1

    def appendleft(self, item) -> None:
        self._urgent.appendleft(item)
        self._len += 1

    def popleft(self):
        if self._urgent:
            self._len -= 1
            return self._urgent.popleft()
        active = [n for n, q in self._queues.items() if q]
        if not active:
            raise IndexError("pop from an empty WeightedFairQueue")
        # ties break on the tenant name so dispatch order is a pure
        # function of queue state (reproducible scenarios)
        best = min(active, key=lambda n: (self._vtime.get(n, 0.0), n))
        q = self._queues[best]
        item = q.popleft()
        self._len -= 1
        if q:
            self._vtime[best] = self._vtime.get(best, 0.0) \
                + 1.0 / max(self._tenancy.weight_for(best), 1e-9)
        else:
            # drop the emptied bucket AND its clock: per-tenant state
            # here must not outlive the tenant's queued work (1k
            # ephemeral tenants would grow these dicts forever), and
            # the re-activation catch-up above makes a kept clock
            # redundant for fairness
            del self._queues[best]
            self._vtime.pop(best, None)
        return item

    def depth(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        base = len(q) if q is not None else 0
        if self._urgent:
            base += sum(1 for i in self._urgent
                        if (getattr(i, "tenant", "") or DEFAULT_TENANT)
                        == tenant)
        return base

    def depths(self) -> dict[str, int]:
        """Per-tenant queued counts for every known bucket (zeros
        included, so gauges fall back to 0 after a drain)."""
        out = {n: len(q) for n, q in self._queues.items()}
        for i in self._urgent:
            t = getattr(i, "tenant", "") or DEFAULT_TENANT
            out[t] = out.get(t, 0) + 1
        return out

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0


def retry_after_for_refill(quota: TenantQuota, tokens: float) -> float:
    """Seconds until a tenant's bucket next holds a whole token — the
    ``Retry-After`` a ``tenant_rate`` shed carries
    (:meth:`Tenancy.try_admit` calls this; one formula, one place)."""
    if quota.rate <= 0:
        return 1.0
    return max((1.0 - tokens) / quota.rate, 0.0)
