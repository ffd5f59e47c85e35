"""The port's resilience plane (``mmlspark_torch/resilience``) against the
JAX package's.

Every scenario of ``test_resilience.py`` that needs no cognitive service
or serving mesh runs against the port (the HTTP client's deadline budget
and the load generator's retry split included) on the same inputs and with the same assertions (``torch_obs_port``); the
excluded ones are named below by ROADMAP item. Then both packages run the
same inputs and must agree exactly: ``RetryPolicy(seed=...)`` delay
sequences (under one scripted clock where a deadline gates them), the
realized ``FaultInjector`` schedule of one seed and rule set, and a
``CircuitBreaker``'s states over a scripted record/clock sequence, with
their registry series. Last, the port's ``CheckpointManager`` under a
``checkpoint.write`` drop: the torn save raises ``InjectedDrop`` and leaves
the store, the listing and ``restore()`` as they were (the port's
counterpart of the reference's ``TestAtomicCheckpoint``, whose
``mmlspark_tpu.dl`` imports the rewrite leaves on the JAX package).
"""

import os
import types

import pytest
import torch

import mmlspark_torch.resilience as tres
import mmlspark_tpu.resilience as jres
from mmlspark_torch.obs.metrics import MetricsRegistry as TRegistry
from mmlspark_torch.resilience import retry as tretry
from mmlspark_tpu.obs.metrics import MetricsRegistry as JRegistry
from mmlspark_tpu.resilience import retry as jretry
from torch_obs_port import port_reference_tests

globals().update(port_reference_tests("test_resilience.py", (
    # the cognitive services (item 11)
    "TestCognitiveBreaker",
    # the JAX dl imports: the JAX CheckpointManager probes the JAX
    # package's injector and counts in its registry; the port's manager
    # is held to the same contract below (TestPortAtomicCheckpoint)
    "TestAtomicCheckpoint",
    # the serving registry, mesh and chaos harness (item 9d-2)
    "TestFailureDetection",
    "TestChaosLeaseReplay",
    "TestChaosScenario"), rewrites=(
    # TestSendRequestDeadline: the port's HTTP client (io/http); and
    # TestLoadgenRetrySplit: the port's load generator (loadgen.cpp)
    ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
    ("mmlspark_tpu.serving.loadgen", "mmlspark_torch.serving.loadgen"),
    ("mmlspark_tpu.native", "mmlspark_torch.native"))))

PKGS = ((jres, JRegistry, jretry), (tres, TRegistry, tretry))


class Clock:
    """One scripted monotonic clock: ``advance`` moves it, reading never
    does."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def both(fn):
    return [fn(*pkg) for pkg in PKGS]


# ------------------------------------------------------------- RetryPolicy
class TestRetryParity:
    @pytest.mark.parametrize("seed", [0, 1, 7, 12345])
    def test_jittered_delays_equal(self, seed):
        def run(res, Registry, _):
            slept = []
            reg = Registry()
            pol = res.RetryPolicy(seed=seed, max_attempts=12,
                                  base_delay=0.05, max_delay=2.0,
                                  registry=reg, sleep=slept.append)
            for _ in range(3):
                call = pol.start(op="p")
                while call.backoff(status=503):
                    pass
            return slept, reg.snapshot()
        (js, jsnap), (ts, tsnap) = both(run)
        assert len(js) == 3 * 11
        assert js == ts
        assert jsnap == tsnap

    def test_ladder_retry_after_and_statuses_equal(self):
        outcomes = [(503, None), (429, 0.7), (500, None), (404, None),
                    (None, None), (429, 3.0), (502, 0.01)]

        def run(res, Registry, _):
            slept, steps = [], []
            reg = Registry()
            for pol in (res.RetryPolicy(seed=3, registry=reg,
                                        sleep=slept.append),
                        res.RetryPolicy(delays=(0.1, 0.5, 1.0), seed=3,
                                        registry=reg,
                                        sleep=slept.append),
                        res.RetryPolicy(delays=(), registry=reg,
                                        sleep=slept.append)):
                call = pol.start(op="mix")
                for status, ra in outcomes:
                    steps.append((call.backoff(status=status,
                                               retry_after=ra),
                                  call.attempt, call.give_up_cause))
            return slept, steps, reg.snapshot()
        j, t = both(run)
        assert j == t
        assert any(s[0] for s in j[1]) and not all(s[0] for s in j[1])

    def test_deadline_budget_equal_under_scripted_clock(self, monkeypatch):
        def run(res, Registry, retry_mod):
            clock = Clock()
            monkeypatch.setattr(retry_mod, "time",
                                types.SimpleNamespace(monotonic=clock))
            slept, trace = [], []
            reg = Registry()

            def sleep(d):
                slept.append(d)
                clock.advance(d)
            pol = res.RetryPolicy(seed=11, max_attempts=20,
                                  base_delay=0.05, max_delay=0.8,
                                  registry=reg, sleep=sleep)
            call = pol.start(deadline=2.5, op="budget")
            while True:
                trace.append(round(call.attempt_timeout(1.0), 12))
                clock.advance(0.1)      # the attempt itself
                if not call.backoff(status=503):
                    break
            return slept, trace, call.give_up_cause, reg.snapshot()
        j, t = both(run)
        assert j == t
        assert j[2] == "deadline"


# ----------------------------------------------------------- FaultInjector
class TestFaultInjectorParity:
    RULES = (("http.send", "error", 0.3, 0, None, ""),
             ("http.send", "latency", 0.5, 2, 4, ""),
             ("worker.death", "kill", 1.0, 3, 1, "w2"),
             ("checkpoint.write", "drop", 0.6, 1, 3, ""),
             ("worker.slow", "slow", 1.0, 0, None, "w1"))
    PROBES = [(p, k) for i in range(60)
              for p, k in (("http.send", f"url{i % 3}"),
                           ("worker.death", f"w{i % 4}"),
                           ("checkpoint.write", str(i)),
                           ("worker.slow", f"w{i % 2}"))]

    @pytest.mark.parametrize("seed", [0, 5, 99])
    def test_same_seed_same_schedule_in_both(self, seed):
        def run(res, Registry, _):
            inj = res.FaultInjector(registry=Registry())
            slept = []
            inj._sleep = slept.append
            rules = [res.FaultRule(point=p, kind=kd, p=pr, after=a,
                                   times=tm, match=m, latency_s=0.01,
                                   factor=3.0)
                     for p, kd, pr, a, tm, m in self.RULES]
            out = []
            with res.faults(seed, rules, inj):
                for point, key in self.PROBES:
                    try:
                        act = inj.apply(point, key)
                        out.append(None if act is None else act.kind)
                    except res.InjectedDrop:
                        out.append("raised drop")
                    except res.WorkerKilled:
                        out.append("raised kill")
                out.append(inj.degradation("w1"))
                sched = inj.schedule()
            return out, sched, slept, inj._reg.snapshot()
        j, t = both(run)
        assert j == t
        assert len(j[1]) > 10


# ---------------------------------------------------------- CircuitBreaker
class TestBreakerParity:
    SCRIPT = ([("record", False)] * 3 + [("allow",), ("record", True),
              ("record", False), ("record", False), ("allow",),
              ("advance", 1.0), ("allow",), ("advance", 1.5), ("allow",),
              ("allow",), ("record", False), ("allow",), ("advance", 2.5),
              ("allow",), ("record", True), ("allow",)]
              + [("record", ok) for ok in
                 (True, False, True, False, False, True, False)]
              + [("advance", 9.0), ("allow",), ("record", True),
                 ("check",)])

    def test_state_sequence_equal(self):
        def run(res, Registry, _):
            clock = Clock()
            reg = Registry()
            b = res.CircuitBreaker("ep-parity", min_calls=4,
                                   failure_threshold=0.5, window=6,
                                   reset_timeout=2.0, half_open_probes=1,
                                   registry=reg, clock=clock)
            out = []
            for op in self.SCRIPT:
                if op[0] == "record":
                    b.record(op[1])
                elif op[0] == "allow":
                    out.append(b.allow())
                elif op[0] == "advance":
                    clock.advance(op[1])
                else:
                    try:
                        b.check()
                        out.append("passed")
                    except res.BreakerOpen as e:
                        out.append(("open", e.retry_after))
                out.append(b.state)
            return out, reg.snapshot()
        j, t = both(run)
        assert j == t
        assert {"open", "half_open", "closed"} <= set(j[0])


# ------------------------------------------------------ atomic checkpoint
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch: tier-1 runs several worker processes at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(step: int, seed: int):
    from mmlspark_torch.dl import TrainState
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    return TrainState(model, opt, step)


class TestPortAtomicCheckpoint:
    def test_crash_mid_save_leaves_store_consistent(self, tmp_path):
        from mmlspark_torch.dl.checkpoint import CheckpointManager
        root = tmp_path / "ck"
        mgr = CheckpointManager(str(root))
        first = _state(1, seed=0)
        mgr.save(first, step=1)
        listing = sorted(os.listdir(root))
        with tres.faults(1, [tres.FaultRule(point="checkpoint.write",
                                            kind="drop", times=1)]) as inj:
            with pytest.raises(tres.InjectedDrop):
                mgr.save(_state(2, seed=1), step=2)
            assert inj.schedule() == [("checkpoint.write", 0, 1, "drop")]
        # the torn save left no step dir and no temp dir
        assert mgr.all_steps() == [1]
        assert sorted(os.listdir(root)) == listing
        assert not [d for d in os.listdir(root) if d.startswith(".tmp-")]
        target = _state(0, seed=7)
        restored = mgr.restore(target=target)
        assert restored.step == 1
        for a, b in zip(first.model.state_dict().values(),
                        restored.model.state_dict().values()):
            assert torch.equal(a, b)
        assert str(first.optimizer.state_dict()) == \
            str(restored.optimizer.state_dict())
        # disarmed, the next save lands
        mgr.save(_state(2, seed=1), step=2)
        assert mgr.all_steps() == [1, 2]

    def test_fault_keyed_by_step(self, tmp_path):
        """The point's key is the step: a ``match`` rule tears only the
        save of the step it names."""
        from mmlspark_torch.dl.checkpoint import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=5)
        with tres.faults(0, [tres.FaultRule(point="checkpoint.write",
                                            kind="drop", match="3")]):
            for step in (1, 2, 3, 4):
                if step == 3:
                    with pytest.raises(tres.InjectedDrop):
                        mgr.save(_state(step, seed=step), step=step)
                else:
                    mgr.save(_state(step, seed=step), step=step)
        assert mgr.all_steps() == [1, 2, 4]

    def test_latency_fault_saves_normally(self, tmp_path):
        from mmlspark_torch.dl.checkpoint import CheckpointManager
        mgr = CheckpointManager(str(tmp_path / "ck"))
        slept = []
        with tres.faults(0, [tres.FaultRule(point="checkpoint.write",
                                            kind="latency",
                                            latency_s=0.25)]) as inj:
            inj._sleep = slept.append
            mgr.save(_state(1, seed=0), step=1)
        assert slept == [0.25] and mgr.all_steps() == [1]


def test_all_equals_reference():
    assert tres.__all__ == jres.__all__
    assert (tres.CLOSED, tres.OPEN, tres.HALF_OPEN) == \
        (jres.CLOSED, jres.OPEN, jres.HALF_OPEN)
    assert tres.breaker.STATE_VALUES == jres.breaker.STATE_VALUES
    assert tres.RETRY_STATUSES == jres.RETRY_STATUSES
