"""Per-endpoint circuit breakers (the port's own copy of the JAX
package's ``resilience/breaker.py``).

A dead or drowning endpoint fails *slowly* — every call burns a full
socket timeout before reporting the failure everyone upstream already
knows about. The breaker converts that to a fast local decision: after
the recent failure rate crosses a threshold the circuit **opens** and
callers are refused instantly; after ``reset_timeout`` it moves to
**half-open** and lets a bounded number of probe calls through; a probe
success **closes** it again, a probe failure re-opens it and re-arms
the timer. (The reference had no equivalent — ``FaultToleranceUtils``
retries forever; arXiv:2605.25645 frames endpoint death as steady-state
for accelerator serving meshes.)

State and every transition are registry-visible:
``resilience_breaker_state{endpoint=}`` (0 closed / 1 open /
2 half-open), ``resilience_breaker_transitions_total{endpoint,from,to}``
and ``resilience_breaker_rejected_total{endpoint}``.

Import is stdlib + obs only (no torch, no HTTP).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..obs import registry as _default_registry

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding for resilience_breaker_state
STATE_VALUES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class BreakerOpen(Exception):
    """Raised by :meth:`CircuitBreaker.check` when the circuit refuses
    the call; carries a retry hint sized to the reset timeout."""

    def __init__(self, endpoint: str, retry_after: float):
        super().__init__(f"circuit open: {endpoint}")
        self.endpoint = endpoint
        self.retry_after = retry_after


class CircuitBreaker:
    """Failure-rate circuit breaker over a sliding outcome window.

    Thread-safe; ``clock`` is injectable so tests drive the reset timer
    without sleeping. The window is *count*-based (last ``window``
    outcomes), which keeps decisions O(1) and independent of call rate.
    """

    def __init__(self, endpoint: str, *, failure_threshold: float = 0.5,
                 min_calls: int = 5, window: int = 20,
                 reset_timeout: float = 5.0, half_open_probes: int = 1,
                 registry=None, clock=time.monotonic):
        reg = registry if registry is not None else _default_registry
        self.endpoint = endpoint
        self.failure_threshold = float(failure_threshold)
        self.min_calls = max(int(min_calls), 1)
        self.reset_timeout = float(reset_timeout)
        self.half_open_probes = max(int(half_open_probes), 1)
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: deque[bool] = deque(maxlen=max(int(window), 1))
        self._state = CLOSED
        self._opened_at = 0.0
        self._probes = 0       # half-open probes currently admitted
        self._g_state = reg.gauge(
            "resilience_breaker_state",
            "breaker state by endpoint (0 closed, 1 open, 2 half-open)")
        self._c_transitions = reg.counter(
            "resilience_breaker_transitions_total",
            "breaker state transitions, by endpoint/from/to")
        self._c_rejected = reg.counter(
            "resilience_breaker_rejected_total",
            "calls refused while the circuit was open, by endpoint")
        self._g_state.set(0, endpoint=endpoint)

    @property
    def state(self) -> str:
        with self._lock:
            return self._check_reset_locked()

    def allow(self) -> bool:
        """True when the call may proceed. A refused call is counted;
        the caller answers locally (error row, 503, skip-peer…)."""
        with self._lock:
            state = self._check_reset_locked()
            if state == CLOSED:
                return True
            if state == HALF_OPEN and self._probes < self.half_open_probes:
                self._probes += 1
                return True
            self._c_rejected.inc(1, endpoint=self.endpoint)
            return False

    def check(self) -> None:
        """:meth:`allow` with an exception contract (for call sites
        that prefer raising over branching)."""
        if not self.allow():
            with self._lock:
                wait = max(self._opened_at + self.reset_timeout
                           - self._clock(), 0.0)
            raise BreakerOpen(self.endpoint, wait or self.reset_timeout)

    def record(self, ok: bool) -> None:
        """Fold one call outcome in (True = the endpoint behaved)."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes = max(self._probes - 1, 0)
                if ok:
                    self._to(CLOSED)
                    self._outcomes.clear()
                else:
                    self._to(OPEN)
                    self._opened_at = self._clock()
                return
            self._outcomes.append(ok)
            if self._state == CLOSED and \
                    len(self._outcomes) >= self.min_calls:
                fails = self._outcomes.count(False)
                if fails / len(self._outcomes) >= self.failure_threshold:
                    self._to(OPEN)
                    self._opened_at = self._clock()
                    self._outcomes.clear()

    def record_success(self) -> None:
        self.record(True)

    def record_failure(self) -> None:
        self.record(False)

    # -- internals (call under self._lock) ---------------------------------
    def _check_reset_locked(self) -> str:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout:
            self._to(HALF_OPEN)
            self._probes = 0
        return self._state

    def _to(self, new: str) -> None:
        # registry locks nest inside the breaker lock; nothing holding a
        # registry lock ever takes a breaker lock, so the order is safe
        self._c_transitions.inc(1, endpoint=self.endpoint,
                                **{"from": self._state, "to": new})
        self._state = new
        self._g_state.set(STATE_VALUES[new], endpoint=self.endpoint)


# -- per-endpoint breaker registry ------------------------------------------
_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(endpoint: str, **config) -> CircuitBreaker:
    """Process-wide get-or-create breaker keyed by endpoint name (the
    same idempotence contract as the metrics registry: every caller
    hitting one endpoint shares one failure view). ``config`` applies
    only on first creation."""
    with _breakers_lock:
        b = _breakers.get(endpoint)
        if b is None:
            b = _breakers[endpoint] = CircuitBreaker(endpoint, **config)
        return b


def drop_breaker(endpoint: str) -> None:
    """Evict one endpoint's breaker and EVERY registry series labeled
    with it (state gauge, transition and rejection counters). For
    endpoints that are per-process identities (mesh worker ids): a mesh
    with worker churn would otherwise retain a breaker object and
    labeled series for every worker that ever existed."""
    with _breakers_lock:
        b = _breakers.pop(endpoint, None)
        if b is not None:
            for metric in (b._g_state, b._c_transitions, b._c_rejected):
                metric.remove_matching(endpoint=endpoint)


def reset_breakers() -> None:
    """Drop every registered breaker (test isolation only)."""
    with _breakers_lock:
        _breakers.clear()
