"""The admission-controlled request scheduler (the port's own copy of
the JAX package's ``sched/scheduler.py``).

``RequestScheduler`` sits between the HTTP fronts and the model
executors: intake passes the admission controller (bounded queue,
per-route concurrency, predictive deadline-budget shedding — 429 +
Retry-After), queued requests carry absolute deadlines, and the
executor pulls batches through the adaptive :class:`~.policy.BatchPolicy`
instead of a fixed ``max_wait`` sleep.

The wait machinery is ONE condition variable: an idle executor blocks in
``next_batch`` and burns no CPU; an arriving request notifies and is
dispatched immediately (no mandatory linger floor); ``wake``/``close``
unblock waiters for shutdown.

The class is deliberately **queue-compatible** (``put_nowait`` /
``get_nowait`` / ``get`` / ``qsize`` / ``empty``) so existing callers —
the distributed mesh's ``__lease__`` drain, replay, and tests that poke
``server.queue`` — keep working unchanged while the serving fronts talk
to the richer ``submit``/``next_batch`` surface.

Items are any objects; two optional attributes integrate deeper:
``deadline`` (absolute seconds on :func:`policy.now`'s clock) enables
expiry shedding and deadline-aware batch closes, and the scheduler's
``on_shed(item, reason, retry_after)`` callback lets the owner answer
shed items (the serving layer replies 429 there). No torch, no HTTP —
policy code stays usable with no device.
"""

from __future__ import annotations

import queue as _queue
import threading
from collections import deque

from ..obs import registry as _default_registry
from ..obs.tracing import tracer as _obs_tracer
from .policy import (GROW, WAIT, AdmissionConfig, AdmissionController,
                     BatchPolicy, ServiceTimeEstimator, Shed, now)
from .tenancy import DEFAULT_TENANT, WeightedFairQueue

__all__ = ["RequestScheduler", "Shed"]


class RequestScheduler:
    """Deadline-aware bounded request queue with adaptive batching.

    With a :class:`~.tenancy.Tenancy` attached (``tenancy=``) the
    scheduler becomes multi-tenant: intake runs the per-tenant gates
    (rate / inflight / queue-share quotas, tier-deadline budgets) and
    the backing queue becomes a :class:`~.tenancy.WeightedFairQueue`,
    so dispatch interleaves tenants by tier weight instead of strict
    arrival order. Without one, behavior is exactly the single-queue
    scheduler it always was."""

    def __init__(self, service: str, *, max_queue: int = 0,
                 max_inflight: int = 0, deadline: float = 0.0,
                 on_shed=None, registry=None,
                 estimator: ServiceTimeEstimator | None = None,
                 tenancy=None):
        reg = registry if registry is not None else _default_registry
        self.service = service
        self.default_deadline = float(deadline)
        self.on_shed = on_shed
        self.tenancy = tenancy
        self.estimator = estimator or ServiceTimeEstimator(
            service, registry=reg)
        if self.estimator.cost_model is None and registry is None:
            # the learned-performance loop: serving-path
            # schedulers price with the process-wide cost model, which
            # answers only once FeatureLog traffic trained it for this
            # service — until then (and whenever its error gate trips)
            # estimates come from the EWMA exactly as before. Only on
            # the DEFAULT registry: a caller passing its own registry
            # is isolating (tests, scenarios), and the shared model's
            # metrics/gate state live on the default registry — a
            # half-attached split family would be worse than no model.
            # Lazy import: policy code must stay importable without
            # perf (and perf imports sched.policy).
            try:
                from ..perf.costmodel import enabled, shared_cost_model
                if enabled():
                    self.estimator.attach_cost_model(shared_cost_model())
            except Exception:  # pragma: no cover - perf layer optional
                pass
        self.admission = AdmissionController(
            service,
            AdmissionConfig(max_queue=max_queue, max_inflight=max_inflight,
                            deadline=deadline),
            self.estimator, registry=reg, tenancy=tenancy)
        self._cv = threading.Condition()
        self._items = (WeightedFairQueue(tenancy)
                       if tenancy is not None else deque())
        self._enq_at: dict[int, float] = {}   # id(item) -> enqueue time
        self._closed = False
        self._gen = 0     # wake() generation: lets waiters observe a poke
        self._g_depth = reg.gauge(
            "sched_queue_depth", "queued requests, by service")
        self._h_wait = reg.histogram(
            "sched_queue_wait_seconds",
            "seconds a request spent queued before dispatch, by service")
        self._c_close = reg.counter(
            "sched_batch_close_total",
            "batch dispatches, by service and close reason")

    # -- intake ------------------------------------------------------------
    def submit(self, item, route: str = "/",
               deadline: float | None = None,
               tenant: str = "") -> None:
        """Admission-controlled intake. ``deadline`` is the request's
        budget in SECONDS from now (None → the configured default; 0 →
        no deadline); ``tenant`` selects the quota/tier bucket when a
        tenancy policy is attached (empty → :data:`DEFAULT_TENANT`).
        Raises :class:`Shed` on rejection — the caller answers the
        client (``Shed.status``: 503 for hard queue overflow, 429 +
        ``retry_after`` for policy sheds)."""
        tenancy = self.tenancy
        if tenancy is not None:
            tenant = tenant or DEFAULT_TENANT
        budget = self.default_deadline if deadline is None else deadline
        if tenancy is not None:
            # the tier's SLO deadline CAPS the budget: a gold request
            # becomes deadline-carrying even when the client sent no
            # budget at all — the tier contract is the service's, not
            # the client's, to loosen
            tier_dl = tenancy.deadline_for(tenant)
            if tier_dl:
                budget = min(budget, tier_dl) if budget else tier_dl
        with self._cv:
            # depth check and append are ONE critical section: checked
            # outside the cv, N racing submitters could all read
            # depth < max_queue and overshoot the hard bound the old
            # queue.Queue(maxsize) enforced strictly. try_admit's
            # registry locks nest inside the cv; nothing that holds a
            # registry lock ever takes the cv, so the order is safe.
            tdepth = self._items.depth(tenant) \
                if tenancy is not None else 0
            self.admission.try_admit(route, len(self._items),
                                     deadline_budget=budget or None,
                                     tenant=tenant, tenant_depth=tdepth)
            # decorate BEFORE the item becomes executor-reachable: once
            # appended, a reply (and so the done-callback releasing the
            # in-flight slot) can fire at any moment. The tenant stamp
            # must land before the append — the fair queue buckets by it.
            try:
                item.route = route
                item.tenant = tenant
                if budget:
                    item.deadline = now() + budget
                item.on_done = lambda: self.admission.release(
                    route, tenant=tenant)
            except AttributeError:
                # slotted/frozen items cannot carry the accounting
                # hooks: give the just-taken in-flight slot back here,
                # or every such request would leak one until the route
                # sheds "inflight" forever
                self.admission.release(route, tenant=tenant)
            self._append_locked(item)
            # snapshot under the cv (the fair queue has no lock of its
            # own); the registry writes happen outside it below
            depths = self._items.depths() if tenancy is not None else None
        if depths is not None:
            tenancy.update_queue_gauges(depths)

    # -- queue-compatible surface ------------------------------------------
    def put_nowait(self, item) -> None:
        """Bound-checked enqueue with NO admission math — the replay and
        lease-return paths re-queue already-admitted work."""
        with self._cv:
            if self.admission.config.max_queue and \
                    len(self._items) >= self.admission.config.max_queue:
                raise _queue.Full
            self._append_locked(item)

    def put_front(self, item) -> None:
        """Bound-checked enqueue at the FRONT (no admission math):
        replayed/requeued work already waited through the queue once —
        parking it behind the whole standing backlog again would double
        its latency and burn what deadline budget the retry has left
        (the resilience subsystem's lease-replay path uses this)."""
        with self._cv:
            if self.admission.config.max_queue and \
                    len(self._items) >= self.admission.config.max_queue:
                raise _queue.Full
            self._append_locked(item, front=True)

    def get_nowait(self):
        with self._cv:
            if not self._items:
                raise _queue.Empty
            return self._pop_locked()

    def get(self, block: bool = True, timeout: float | None = None):
        with self._cv:
            if not block:
                timeout = 0.0
            gen = self._gen
            end = None if timeout is None else now() + timeout
            while not self._items:
                # honor wake() here too (the documented contract): a
                # poked waiter raises Empty so its owner can re-check
                # a stop flag instead of sleeping through the poke
                if self._closed or self._gen != gen:
                    raise _queue.Empty
                remaining = None if end is None else end - now()
                if remaining is not None and remaining <= 0:
                    raise _queue.Empty
                self._cv.wait(remaining)
            return self._pop_locked()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    # -- executor surface --------------------------------------------------
    def next_batch(self, max_batch: int = 1024, linger: float = 0.0,
                   max_wait: float | None = None) -> list:
        """Pull the next batch under the adaptive close policy.

        Blocks on the condition variable until work arrives (zero idle
        CPU), ``max_wait`` elapses (None = wait indefinitely), or
        :meth:`wake`/:meth:`close` pokes the waiter — both of the last
        two return ``[]`` so the caller can re-check its stop flag.
        Expired items (deadline already passed) are shed here, BEFORE
        execution, through ``on_shed``.
        """
        policy = BatchPolicy(max_batch=max_batch, linger=linger,
                             estimator=self.estimator)
        batch: list = []
        shed: list = []
        waits: list = []   # queue-wait samples, observed after the cv
        with self._cv:
            gen = self._gen
            end = None if max_wait is None else now() + max_wait
            while not self._items:
                if self._closed or self._gen != gen:
                    return []
                remaining = None if end is None else end - now()
                if remaining is not None and remaining <= 0:
                    return []
                self._cv.wait(remaining)
            first_at = now()
            linger_end = first_at + linger
            while True:
                # take available work, shedding at pop anything that can
                # no longer finish inside its deadline: the item's
                # remaining slack must still cover the estimated service
                # time of the batch it will actually join (everything
                # already drained plus what stands in the queue, capped)
                # — not a batch of one, or early pops pass a check their
                # final batch violates. One estimate per drain round:
                # while the cv is held no new item can arrive, so the
                # target only shrinks (by expiries) and the estimate
                # stays a safe overestimate — per-item registry reads
                # here would serialize every submitter behind O(batch)
                # lock traffic.
                target = min(len(batch) + len(self._items), max_batch)
                est = self.estimator.estimate(target) or 0.0
                while self._items and len(batch) < max_batch:
                    item = self._pop_locked(waits)
                    if self._expired(item, est):
                        shed.append(item)
                    else:
                        batch.append(item)
                if not batch:
                    if shed:
                        # everything pulled had expired: return now so
                        # the shed replies fire IMMEDIATELY (the caller
                        # loops back in) instead of parking expired
                        # clients behind the next arrival
                        break
                    if self._closed or self._gen != gen:
                        break
                    remaining = None if end is None else end - now()
                    if remaining is not None and remaining <= 0:
                        break
                    self._cv.wait(remaining)
                    continue
                t = now()
                action, wait_s, reason = policy.decide(
                    len(batch), queue_empty=not self._items,
                    oldest_slack=self._oldest_slack(batch, t),
                    linger_remaining=linger_end - t)
                if action == GROW:
                    continue
                if action == WAIT and not self._closed:
                    self._cv.wait(wait_s)
                    continue
                # a WAIT interrupted by close() dispatches what
                # accumulated — that IS a drain, and keeping the label
                # inside the documented set (full/deadline/bucket/
                # linger/drain) lets dashboards sum reasons to totals
                self._c_close.inc(1, service=self.service,
                                  reason=reason or "drain")
                break
            self._g_depth.set(len(self._items), service=self.service)
            depths = self._items.depths() \
                if self.tenancy is not None else None
        # registry writes happen OUTSIDE the cv: per-item label
        # rendering + registry locking inside the drain loop would
        # stall every submitter for the whole O(batch) drain
        if depths is not None:
            self.tenancy.update_queue_gauges(depths)
        for w in waits:
            self._h_wait.observe(w, service=self.service)
        for item in shed:
            self._shed_item(item, "expired")
        self.annotate_queue_spans(batch)
        return batch

    def wake(self) -> None:
        """Poke blocked ``next_batch``/``get`` waiters (they return
        empty so their owner can re-check a stop flag)."""
        with self._cv:
            self._gen += 1
            self._cv.notify_all()

    def close(self) -> None:
        """Terminal: waiters drain what is queued and then return
        empty forever."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def release(self, route: str = "/") -> None:
        """Forward to admission accounting (a request finished)."""
        self.admission.release(route)

    def annotate_queue_spans(self, items) -> None:
        """Emit a ``sched.queue`` child span (obs subsystem) for every
        just-dispatched item that carries a request span — the measured
        queue wait becomes a node in the request's cross-process tree.
        Called OUTSIDE the cv by both drain paths (``next_batch`` and
        the mesh ``__lease__`` drain); span emission does registry/sink
        work that must never run under the scheduler lock."""
        for item in items:
            sp = getattr(item, "span", None)
            qw = getattr(item, "queue_wait", None)
            if sp is not None and qw is not None:
                _obs_tracer.emit_span("sched.queue", parent=sp,
                                      seconds=qw, service=self.service)

    def shed_if_expired(self, item) -> bool:
        """Expiry check for drain paths that bypass :meth:`next_batch`
        (the mesh lease drain): if the item's deadline has passed, shed
        it through ``on_shed`` (counted ``expired``) and return True —
        the caller must NOT execute or forward it."""
        if not self._expired(item):
            return False
        self._shed_item(item, "expired")
        return True

    # -- internals ---------------------------------------------------------
    def _append_locked(self, item, front: bool = False) -> None:
        if front:
            self._items.appendleft(item)
        else:
            self._items.append(item)
        self._enq_at[id(item)] = now()
        self._g_depth.set(len(self._items), service=self.service)
        self._cv.notify()

    def _pop_locked(self, waits: list | None = None):
        """Pop one item under the cv. With ``waits`` given (the batch
        drain), the queue-wait sample is deferred into it and the depth
        gauge is left to the caller's once-per-drain update — per-item
        registry traffic inside the drain loop would serialize every
        submitter behind it."""
        item = self._items.popleft()
        t0 = self._enq_at.pop(id(item), None)
        if t0 is not None:
            wait = now() - t0
            try:
                # stamp the wait on the item: the serving layer's trace
                # annotation (sched.queue spans) and cost-model feature
                # log read it back outside the cv. Slotted items simply
                # don't carry it.
                item.queue_wait = wait
            except AttributeError:
                pass
            if waits is None:
                self._h_wait.observe(wait, service=self.service)
            else:
                waits.append(wait)
        if waits is None:
            self._g_depth.set(len(self._items), service=self.service)
        return item

    @staticmethod
    def _oldest_slack(batch: list, t: float) -> float | None:
        slack = None
        for item in batch:
            dl = getattr(item, "deadline", None)
            if dl is not None:
                s = dl - t
                slack = s if slack is None else min(slack, s)
        return slack

    @staticmethod
    def _expired(item, est_service: float = 0.0) -> bool:
        dl = getattr(item, "deadline", None)
        return dl is not None and dl < now() + est_service

    def _shed_item(self, item, reason: str) -> None:
        self.admission.count_shed(getattr(item, "route", "/"), reason,
                                  tenant=getattr(item, "tenant", ""))
        if self.on_shed is not None:
            try:
                self.on_shed(item, reason, 1.0)
            except Exception:  # a shed reply must never kill the executor
                pass
