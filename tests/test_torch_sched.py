"""The port's request scheduler, admission control and service-time
estimator (``mmlspark_torch/sched``) against the JAX package's.

Every scenario of ``test_sched.py`` that needs no serving front, load
generator or JAX model runs against the port on the same inputs and with
the same assertions (``torch_obs_port``: the overload benchmark, the
batching brain through the port's ``DynamicBufferedBatcher`` and the
no-JAX import included); the excluded ones are named below by ROADMAP
item. Then both packages run the same scripted inputs under one scripted
clock (each package's ``policy``, ``scheduler`` and ``tenancy`` modules
read ``now`` from it; the scheduler imports ``now`` by name, so its copy
is patched too) and must agree exactly: the admission controller's
admit/shed decisions, reasons, statuses and ``Retry-After``, and a
``RequestScheduler``'s batches, expiry sheds, deadlines, queue waits and
registry series over a scripted arrival list.
"""

import pytest

import mmlspark_torch.sched as tsched
import mmlspark_tpu.sched as jsched
from mmlspark_torch.obs.metrics import MetricsRegistry as TRegistry
from mmlspark_tpu.obs.metrics import MetricsRegistry as JRegistry
from torch_obs_port import port_reference_tests

globals().update(port_reference_tests("test_sched.py", (
    # the serving fronts and the mesh's least-loaded routing (ROADMAP
    # item 9d)
    "TestServingIntegration",
    "TestLeastLoadedRouting",
    # the JAX dl imports: the JAX ContinuousGenerator drives the JAX
    # package's SlotScheduler (the port's engine is held in
    # test_torch_textgen.py and test_torch_llm_serving.py)
    "TestContinuousBatching.test_continuous_matches_generate_greedy",
    "TestContinuousBatching.test_continuous_validates_prompts",
    # the load generator (item 9d)
    "TestLoadgenShaping")))


class Clock:
    def __init__(self, t: float = 500.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def scripted(monkeypatch):
    """One scripted clock per package, read by its policy, scheduler and
    tenancy modules."""
    clocks = {}
    for name, pkg in (("jax", jsched), ("torch", tsched)):
        clock = clocks[name] = Clock()
        for mod in (pkg.policy, pkg.scheduler, pkg.tenancy):
            monkeypatch.setattr(mod, "now", clock)
    return clocks


def run_both(scripted, fn):
    out = []
    for name, pkg, Registry in (("jax", jsched, JRegistry),
                                ("torch", tsched, TRegistry)):
        out.append(fn(pkg, Registry, scripted[name]))
    return out


class ScriptItem:
    def __init__(self, tag):
        self.tag = tag
        self.on_done = None

    def reply(self):
        cb, self.on_done = self.on_done, None
        if cb:
            cb()


def test_all_equals_reference():
    assert tsched.__all__ == jsched.__all__
    for name in ("GROW", "WAIT", "CLOSE"):
        assert getattr(tsched.policy, name) == getattr(jsched.policy, name)


class TestAdmissionParity:
    def test_decisions_reasons_and_retry_after_equal(self):
        script = [("admit", "/", 0, None), ("observe", 1, 0.07),
                  ("admit", "/", 1, None), ("admit", "/", 2, None),
                  ("admit", "/a", 0, 10.0), ("admit", "/a", 0, 10.0),
                  ("admit", "/a", 0, 10.0), ("admit", "/a", 0, 10.0),
                  ("release", "/a"), ("admit", "/a", 0, 10.0),
                  ("observe", 8, 0.9), ("admit", "/", 0, 0.3),
                  ("admit", "/", 3, 0.25), ("count_shed", "/", "expired"),
                  ("observe", 3, 0.05), ("admit", "/b", 1, 1.0)]

        def run(pkg, Registry, _):
            reg = Registry()
            est = pkg.ServiceTimeEstimator("svc", registry=reg)
            adm = pkg.AdmissionController(
                "svc", pkg.AdmissionConfig(max_queue=3, max_inflight=3,
                                           deadline=0.1), est,
                registry=reg)
            out = []
            for op in script:
                if op[0] == "admit":
                    try:
                        adm.try_admit(op[1], depth=op[2],
                                      deadline_budget=op[3])
                        out.append("admitted")
                    except pkg.Shed as s:
                        out.append((s.reason, s.status, s.retry_after))
                elif op[0] == "observe":
                    est.observe(op[1], op[2])
                elif op[0] == "release":
                    adm.release(op[1])
                else:
                    adm.count_shed(op[1], op[2])
                out.append((est.estimate(4), est.item_seconds(),
                            adm.inflight("/"), adm.inflight("/a")))
            return out, reg.snapshot()
        j, t = run_both({"jax": None, "torch": None}, run)
        assert j == t
        reasons = {o[0] for o in j[0] if isinstance(o, tuple)
                   and isinstance(o[0], str)}
        assert {"queue_full", "deadline", "inflight"} <= reasons


class TestSchedulerParity:
    # (seconds to advance, action): submits carry (tag, route, deadline
    # budget), batches (max_batch), observes (batch, seconds)
    SCRIPT = ([(0.0, ("observe", 1, 0.004))]
              + [(0.001, ("submit", f"a{i}", "/", None)) for i in range(6)]
              + [(0.0, ("batch", 4)), (0.002, ("observe", 4, 0.012))]
              + [(0.0005, ("submit", f"b{i}", "/r", 0.05))
                 for i in range(10)]
              + [(0.03, ("batch", 8)), (0.0, ("submit", "late", "/", 0.0)),
                 (0.2, ("batch", 16)), (0.0, ("submit", "c0", "/", 0.5)),
                 (0.0, ("front", "replay")), (0.0, ("get",)),
                 (0.001, ("batch", 2))]
              + [(0.0002, ("submit", f"d{i}", "/", 2.0))
                 for i in range(30)]
              + [(0.001, ("batch", 8)), (0.0, ("observe", 8, 0.02))]
              + [(0.0002, ("submit", f"e{i}", "/", 0.02))
                 for i in range(4)]
              + [(0.001, ("batch", 32)), (0.05, ("batch", 32))])

    def test_batches_sheds_and_series_equal(self, scripted):
        def run(pkg, Registry, clock):
            reg = Registry()
            shed = []
            s = pkg.RequestScheduler(
                "parity", max_queue=24, deadline=0.1, registry=reg,
                on_shed=lambda it, reason, ra: shed.append(
                    (it.tag, reason, ra)))
            out = []
            items = {}
            for dt, op in self.SCRIPT:
                clock.advance(dt)
                if op[0] == "submit":
                    it = items[op[1]] = ScriptItem(op[1])
                    try:
                        s.submit(it, route=op[2], deadline=op[3])
                        out.append(("queued", op[1], getattr(
                            it, "deadline", None)))
                    except pkg.Shed as e:
                        out.append((op[1], e.reason, e.status,
                                    e.retry_after))
                elif op[0] == "observe":
                    s.estimator.observe(op[1], op[2])
                elif op[0] == "front":
                    s.put_front(ScriptItem(op[1]))
                elif op[0] == "get":
                    out.append(("got", s.get_nowait().tag))
                else:
                    batch = s.next_batch(max_batch=op[1], max_wait=0)
                    out.append(("batch", [(b.tag, b.queue_wait)
                                          for b in batch]))
                    for b in batch:
                        b.reply()
                out.append((s.qsize(), s.admission.inflight("/")))
            return out, shed, reg.snapshot()
        j, t = run_both(scripted, run)
        assert j[0] == t[0]
        assert j[1] == t[1]
        assert j[2] == t[2]
        # the script meets every shed reason and real batches
        reasons = {o[1] for o in j[0] if len(o) == 4} | \
            {r for _, r, _ in j[1]}
        assert reasons == {"queue_full", "deadline", "expired"}
        assert sum(len(o[1]) for o in j[0] if o[0] == "batch") >= 20
