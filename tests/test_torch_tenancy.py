"""The port's tenancy (``mmlspark_torch/sched/tenancy.py``) against the JAX
package's.

Every scenario of ``test_tenancy.py`` that needs no serving mesh runs
against the port (the load generator's per-tenant split and its
``X-Tenant`` stamping included) on the same inputs and with the same
assertions (``torch_obs_port``); the excluded ones are named below by
ROADMAP item. Then both packages run the same scripted inputs under one
scripted clock per package (``policy``, ``scheduler`` and ``tenancy`` read
``now`` from it) and must agree exactly: ``Tenancy``'s per-tenant gates
(rate with its refill ``Retry-After``, inflight, queue share), tier
deadlines and idle eviction; ``WeightedFairQueue``'s dispatch order with
re-activation and the urgent lane; and a tenant-aware
``RequestScheduler``'s admits, sheds, batches and registry series over a
scripted arrival list of gold, silver and best-effort requests.
"""

import numpy as np
import pytest

import mmlspark_torch.sched as tsched
import mmlspark_tpu.sched as jsched
from test_torch_sched import ScriptItem, run_both, scripted  # noqa: F401
from torch_obs_port import port_reference_tests

globals().update(port_reference_tests("test_tenancy.py", (
    # the serving mesh's lease payload (ROADMAP item 9d-2)
    "TestServingTenancy.test_tenant_rides_the_lease_payload",), rewrites=(
    # TestServingTenancy: the port's threaded front with tenancy=;
    # TestLoadgenTenants: the port's load generator (loadgen.cpp)
    ("mmlspark_tpu.serving", "mmlspark_torch.serving"),
    ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
    ("mmlspark_tpu.native", "mmlspark_torch.native"))))


def test_tier_tables_equal_reference():
    for name in ("GOLD", "SILVER", "BEST_EFFORT", "DEFAULT_TENANT"):
        assert getattr(tsched, name) == getattr(jsched, name)
    assert tsched.tenancy.TIER_WEIGHTS == jsched.tenancy.TIER_WEIGHTS
    assert tsched.tenancy.TIER_ERROR_BUDGETS == \
        jsched.tenancy.TIER_ERROR_BUDGETS


def _tenancy(pkg, reg, idle_evict_s=0.0):
    q = pkg.TenantQuota
    return pkg.Tenancy(
        "tparity",
        quotas={"g": q(tier=pkg.GOLD),
                "s": q(tier=pkg.SILVER, max_inflight=3),
                "b": q(tier=pkg.BEST_EFFORT, queue_share=0.25),
                "w": q(weight=3.0, rate=2.5)},
        default=q(tier=pkg.BEST_EFFORT),
        tier_deadlines={pkg.GOLD: 0.05, pkg.SILVER: 0.2},
        idle_evict_s=idle_evict_s, registry=reg)


class TestTenancyGateParity:
    def test_admit_shed_and_retry_after_equal(self, scripted):
        rng = np.random.default_rng(3)
        names = ["g", "s", "b", "w", "x"]
        script = [(float(rng.exponential(0.02)),
                   names[int(rng.integers(0, 5))],
                   int(rng.integers(0, 12)), bool(rng.random() < 0.3))
                  for _ in range(200)]

        def run(pkg, Registry, clock):
            reg = Registry()
            ten = _tenancy(pkg, reg, idle_evict_s=0.5)
            out = []
            admitted = []
            for dt, tenant, depth, release in script:
                clock.advance(dt)
                try:
                    ten.try_admit(tenant, "/", depth, 16)
                    admitted.append(tenant)
                    out.append((tenant, "admitted"))
                except pkg.Shed as e:
                    out.append((tenant, e.reason, e.status, e.retry_after))
                if release and admitted:
                    ten.release(admitted.pop(0))
                ten.observe_latency(tenant, dt)
                out.append((ten.share_for(tenant), ten.deadline_for(tenant),
                            ten.error_budget_for(tenant),
                            ten.maybe_evict_idle()))
            out.append(ten.slo_pressure())
            return out, reg.snapshot()
        j, t = run_both(scripted, run)
        assert j == t
        reasons = {o[1] for o in j[0] if isinstance(o, tuple)
                   and len(o) == 4 and isinstance(o[1], str)}
        assert {"tenant_rate", "tenant_inflight", "tenant_queue"} <= reasons


class TestWeightedFairQueueParity:
    def test_dispatch_order_equal(self):
        rng = np.random.default_rng(11)
        tenants = ["g", "s", "b", "w", ""]
        ops = [("push" if rng.random() < 0.6 else "pop",
                tenants[int(rng.integers(0, 5))], bool(rng.random() < 0.05))
               for _ in range(400)]

        def run(pkg, Registry, _):
            q = pkg.WeightedFairQueue(_tenancy(pkg, Registry()))
            out = []
            for i, (op, tenant, urgent) in enumerate(ops):
                if op == "push":
                    it = ScriptItem(f"{tenant}{i}")
                    it.tenant = tenant
                    (q.appendleft if urgent else q.append)(it)
                elif q:
                    out.append(q.popleft().tag)
                out.append((len(q), q.depth("g"), q.depths()))
            while q:
                out.append(q.popleft().tag)
            return out
        j, t = run_both({"jax": None, "torch": None}, run)
        assert j == t
        assert sum(isinstance(o, str) for o in j) > 200


class TestSchedulerTenancyParity:
    def test_gold_silver_best_effort_equal(self, scripted):
        rng = np.random.default_rng(5)
        names = ["g", "s", "b", "b", "b", "w"]
        script = []
        for i in range(240):
            script.append((float(rng.exponential(0.0015)), "submit",
                           names[int(rng.integers(0, 6))], i))
            if i % 12 == 11:
                script.append((0.0, "batch", int(rng.integers(4, 17)), i))

        def run(pkg, Registry, clock):
            reg = Registry()
            shed = []
            ten = _tenancy(pkg, reg)
            s = pkg.RequestScheduler(
                "tparity", max_queue=40, deadline=0.5, tenancy=ten,
                registry=reg,
                on_shed=lambda it, reason, ra: shed.append(
                    (it.tag, it.tenant, reason)))
            s.estimator.observe(1, 0.004)
            out = []
            for dt, op, arg, i in script:
                clock.advance(dt)
                if op == "submit":
                    it = ScriptItem(f"{arg}{i}")
                    try:
                        s.submit(it, tenant=arg)
                        out.append(("queued", it.tag, it.deadline
                                    if hasattr(it, "deadline") else None))
                    except pkg.Shed as e:
                        out.append((it.tag, e.reason, e.status,
                                    e.retry_after))
                else:
                    batch = s.next_batch(max_batch=arg, max_wait=0)
                    clock.advance(0.003 * len(batch))
                    s.estimator.observe(max(len(batch), 1),
                                        0.003 * max(len(batch), 1))
                    out.append(("batch", [b.tag for b in batch]))
                    for b in batch:
                        b.reply()
            return out, shed, reg.snapshot()
        j, t = run_both(scripted, run)
        assert j == t
        reasons = {o[1] for o in j[0] if len(o) == 4} | \
            {r for _, _, r in j[1]}
        assert {"tenant_queue", "expired"} <= reasons
        first = [o[1] for o in j[0] if o[0] == "batch" and o[1]]
        assert any(tag.startswith("g") for b in first for tag in b)


@pytest.mark.parametrize("value", ["gold", "team-a", "", None, "a b",
                                   "A" * 65, "über", "x" * 64])
def test_clean_tenant_equal(value):
    assert tsched.clean_tenant(value) == jsched.clean_tenant(value)
