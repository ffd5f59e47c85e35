"""Deterministic fault injection: one seeded fault plane, named points
(the port's own copy of the JAX package's ``resilience/faults.py``; the
same seed and rules realize the same schedule in both packages).

Testing resilience by monkeypatching internals couples every chaos test
to private attributes and cannot run against the native front or a
subprocess worker. Instead the production code itself carries **named
injection points** — one-line probes that are a single attribute check
when no faults are armed — and tests/chaos scenarios arm a seeded
schedule against the process-wide :data:`injector`:

======================  ====================================================
point                   where it fires
======================  ====================================================
``http.send``           ``io/http/clients.send_request``, per attempt
``mesh.lease``          ingest-side ``__lease__`` handler (worker pull hop)
``mesh.reply``          ingest-side ``__reply__`` handler (reply hop)
``worker.heartbeat``    mesh heartbeats (compute-worker loop + ingest load
                        reporter), once per beat
``worker.death``        compute-worker loop, after it takes a non-empty
                        lease (a ``kill`` here strands the batch mid-flight)
``worker.slow``         compute-worker loops, once per leased batch (a
                        ``slow`` rule arms the persistent degradation)
``checkpoint.write``    ``dl/checkpoint.CheckpointManager.save``, after the
                        temp-dir write, **before** the atomic rename
``model.bad``           serving executor (``ServingQuery._execute_group``),
                        once per version sub-batch at execute time, keyed
                        by the model version name — an ``error`` rule makes
                        that version answer injected 5xx, a ``corrupt``
                        rule flips its output bytes under a healthy status
                        (what shadow comparison catches). The deploy
                        plane's rollback acceptance seeds a bad canary
                        through this point.
======================  ====================================================

In the port, ``checkpoint.write`` is probed by
``dl/checkpoint.CheckpointManager.save`` and ``http.send`` by
``io/http/clients.send_request``; the mesh, worker and serving-executor
(``model.bad``) points arrive with those layers (ROADMAP.md §1 items 9d-2
and 11), and the names stay the reference's so one rule set arms both.

Fault kinds: ``latency`` (sleep then continue), ``error`` (the hook
returns/serves an injected HTTP status), ``corrupt`` (the hook mangles
its otherwise-healthy output — wrong bytes, right status), ``drop``
(raises
:class:`InjectedDrop`, an ``OSError`` — existing transport-failure
handling takes over), ``kill`` (raises :class:`WorkerKilled` — the
worker loop dies as if SIGKILLed), ``slow`` (arms a PERSISTENT
per-key service-time multiplier — read back via
:meth:`FaultInjector.degradation` — modeling a sick-but-alive worker:
thermal throttling, a noisy neighbor, a failing disk. Distinct from a
one-shot ``latency`` spike: the degradation stays until the schedule
is cleared, which is exactly what autoscaling and load-aware routing
must route around; the ``worker.slow`` point in the compute loops
probes it once per leased batch).

**Determinism.** Each rule draws from its own RNG stream seeded by
``(seed, point, rule index)``, and fires as a pure function of the
rule's *matching-probe count* — so for a fixed seed, the k-th probe at
a point always gets the same decision, regardless of wall clock or
thread interleaving across points. :meth:`FaultInjector.schedule`
returns the realized schedule; re-running the same workload with the
same seed reproduces it (the chaos acceptance asserts exactly this).

Import is stdlib + obs only (no torch, no HTTP).
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from random import Random

from ..obs import registry as _default_registry


class InjectedFault(Exception):
    """Base for exceptions raised by armed fault rules."""


class InjectedDrop(InjectedFault, ConnectionResetError):
    """An injected connection drop. Subclasses ``ConnectionResetError``
    so every existing transport-failure handler (``except OSError``,
    ``except URLError``, the serving fronts' quiet disconnect
    tolerance…) treats it exactly like a real peer vanishing
    mid-exchange."""


class WorkerKilled(InjectedFault):
    """An injected worker death: the loop that probes it must exit
    immediately, abandoning any leased work (the SIGKILL analog)."""


@dataclass
class FaultRule:
    """One armed fault.

    ``p`` is the per-matching-probe firing probability (drawn from the
    rule's own seeded stream); ``after`` skips the first N matching
    probes (arm "later in the run"); ``times`` bounds total firings
    (``times=1`` = exactly one kill); ``match`` is a substring filter
    on the probe's key (e.g. a worker id or URL)."""

    point: str
    kind: str       # latency | error | corrupt | drop | kill | slow
    p: float = 1.0
    after: int = 0
    times: int | None = None
    latency_s: float = 0.0
    status: int = 503
    retry_after: float | None = None
    match: str = ""
    factor: float = 1.0             # slow: persistent service multiplier


@dataclass
class FaultAction:
    """What a fired rule asks the hook to do."""

    point: str
    kind: str
    latency_s: float = 0.0
    status: int = 503
    retry_after: float | None = None
    factor: float = 1.0


class FaultInjector:
    """Seeded, process-wide fault plane (see module docstring).

    Disarmed cost is one attribute read per probe — safe to leave the
    hooks in production paths permanently.
    """

    def __init__(self, registry=None):
        self._reg = registry if registry is not None else _default_registry
        self._lock = threading.Lock()
        self._armed = False
        self._seed = 0
        self._rules: list[FaultRule] = []
        self._rngs: dict[int, Random] = {}
        self._match_counts: dict[int, int] = {}
        self._fired: dict[int, int] = {}
        self._schedule: list[tuple] = []
        self._degraded: dict[str, float] = {}
        self._c_injected = None
        self._sleep = time.sleep

    @property
    def armed(self) -> bool:
        return self._armed

    def configure(self, seed: int, rules: list[FaultRule]) -> None:
        """Arm a fault schedule. Replaces any previous configuration;
        all counters/streams restart, so the same (seed, rules,
        workload) triple realizes the same schedule."""
        with self._lock:
            self._seed = int(seed)
            self._rules = list(rules)
            # one independent, process-stable stream per rule (str
            # seeding hashes via sha512 — identical across processes)
            self._rngs = {
                i: Random(f"{self._seed}/{r.point}/{i}")
                for i, r in enumerate(self._rules)}
            self._match_counts = {}
            self._fired = {}
            self._schedule = []
            self._degraded = {}
            self._c_injected = self._reg.counter(
                "resilience_faults_injected_total",
                "faults fired by the injector, by point and kind")
            self._armed = True

    def clear(self) -> None:
        """Disarm (production state). Probes return to one-attr-read."""
        with self._lock:
            self._armed = False
            self._rules = []
            self._rngs = {}
            self._degraded = {}

    def probe(self, point: str, key: str = "") -> FaultAction | None:
        """Ask whether a fault fires at ``point`` for ``key``. First
        matching rule wins (rule order is priority). Returns the action
        or None; never sleeps or raises — :meth:`apply` adds that."""
        if not self._armed:
            return None
        with self._lock:
            if not self._armed:
                return None
            for idx, rule in enumerate(self._rules):
                if rule.point != point:
                    continue
                if rule.match and rule.match not in key:
                    continue
                n = self._match_counts.get(idx, 0) + 1
                self._match_counts[idx] = n
                if n <= rule.after:
                    continue
                if rule.times is not None and \
                        self._fired.get(idx, 0) >= rule.times:
                    continue
                if rule.p < 1.0 and self._rngs[idx].random() >= rule.p:
                    continue
                self._fired[idx] = self._fired.get(idx, 0) + 1
                self._schedule.append((point, idx, n, rule.kind))
                self._c_injected.inc(1, point=point, kind=rule.kind)
                return FaultAction(point=point, kind=rule.kind,
                                   latency_s=rule.latency_s,
                                   status=rule.status,
                                   retry_after=rule.retry_after,
                                   factor=rule.factor)
        return None

    def apply(self, point: str, key: str = "") -> FaultAction | None:
        """Probe AND act with the standard semantics: ``latency``
        sleeps here and returns None (execution continues); ``drop``
        raises :class:`InjectedDrop`; ``kill`` raises
        :class:`WorkerKilled`; ``error`` and ``corrupt`` return the
        action — the hook turns it into its layer's failure shape (an
        HTTP status, an error row, mangled output bytes…)."""
        act = self.probe(point, key)
        if act is None:
            return None
        if act.kind == "latency":
            if act.latency_s > 0:
                self._sleep(act.latency_s)
            return None
        if act.kind == "drop":
            raise InjectedDrop(f"injected drop at {point}")
        if act.kind == "kill":
            raise WorkerKilled(f"injected worker death at {point}")
        if act.kind == "slow":
            # persistent degradation: the KEY (a worker id) stays slow
            # until the schedule is cleared — hooks read the multiplier
            # back via degradation() on every subsequent batch
            with self._lock:
                self._degraded[key] = max(act.factor,
                                          self._degraded.get(key, 1.0))
            return None
        return act

    def degradation(self, key: str = "") -> float:
        """The armed service-time multiplier for ``key`` (1.0 = healthy
        or disarmed). Production hooks multiply their measured service
        time by this — one dict read when armed, one attribute read
        when not."""
        if not self._armed:
            return 1.0
        with self._lock:
            return self._degraded.get(key, 1.0)

    def schedule(self) -> list[tuple]:
        """The realized fault schedule so far:
        ``(point, rule_index, matching_probe_index, kind)`` tuples in
        firing order. Two runs of the same workload with the same seed
        realize the same schedule."""
        with self._lock:
            return list(self._schedule)


# THE process-wide fault plane. Production hooks probe this instance;
# tests arm it (usually through :func:`faults`).
injector = FaultInjector()


@contextlib.contextmanager
def faults(seed: int, rules: list[FaultRule], inj: FaultInjector = None):
    """``with faults(seed, [...]):`` — arm the process-wide injector
    for the block, disarm on exit (exception-safe; chaos tests must
    never leak an armed schedule into the next test)."""
    target = inj if inj is not None else injector
    target.configure(seed, rules)
    try:
        yield target
    finally:
        target.clear()
