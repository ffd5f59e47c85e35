"""Retry policy: exponential backoff, decorrelated jitter, deadline budget
(the port's own copy of the JAX package's ``resilience/retry.py``: one
seed draws the same delays in both packages).

The reference retries transient HTTP failures with a fixed sleep ladder
(``HTTPClients.scala`` advanced handler; our seed copied it as
``(0.1, 0.5, 1.0)`` in ``io/http/clients.py``). A fixed ladder has two
production failure modes: synchronized clients retry in lockstep
(retry storms against a recovering peer), and sleeps are taken even when
the caller's deadline is already spent — the retry outlives the request
it was meant to save. :class:`RetryPolicy` fixes both:

- **decorrelated jitter** (the AWS architecture-blog scheme): each delay
  is ``uniform(base, prev * 3)`` capped at ``max_delay``, so a fleet of
  clients spreads its re-offered load instead of pulsing it;
- **deadline budget**: every sleep AND every attempt is gated on the
  remaining budget — a retry that cannot leave time for its own attempt
  is not taken, and per-attempt socket timeouts shrink to the remainder;
- **Retry-After**: a 429/503 carrying ``Retry-After`` (the sched
  subsystem's sheds emit these) sets the FLOOR for the next delay — the
  peer said when it wants to be called back; hammering it sooner only
  deepens the overload. A ``Retry-After`` beyond the remaining budget
  means the call cannot succeed in time: give up now.

Import is stdlib + obs only (no torch, no HTTP).
"""

from __future__ import annotations

import random
import threading
import time

from ..obs import registry as _default_registry

# statuses worth re-offering: throttles and transient server errors
# (the reference's retry set, HTTPClients.scala)
RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})


def parse_retry_after(value) -> float | None:
    """``Retry-After`` header → seconds (delta-seconds form only; an
    HTTP-date from a real-world peer is ignored rather than parsed —
    the jittered backoff still applies)."""
    if value is None:
        return None
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if v >= 0 else None


class RetryPolicy:
    """Shared, thread-safe retry policy (one instance per client stack).

    ``delays`` pins an explicit ladder instead of decorrelated jitter —
    the legacy ``send_request(retries=(0.1, 0.5, 1.0))`` surface maps
    onto it; deadline gating applies either way. ``seed`` makes the
    jitter reproducible (tests, chaos runs); by default each policy
    draws from its own unseeded stream.
    """

    def __init__(self, *, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 2.0,
                 retry_statuses: frozenset = RETRY_STATUSES,
                 delays: tuple[float, ...] | None = None,
                 honor_retry_after: bool = True, seed: int | None = None,
                 registry=None, sleep=time.sleep):
        reg = registry if registry is not None else _default_registry
        # an EXPLICIT empty ladder means "one attempt, no retries" —
        # it must not fall through to the jittered default policy
        self.delays = (tuple(float(d) for d in delays)
                       if delays is not None else None)
        self.max_attempts = (len(self.delays) + 1
                             if self.delays is not None
                             else max(int(max_attempts), 1))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.retry_statuses = frozenset(retry_statuses)
        self.honor_retry_after = honor_retry_after
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._sleep = sleep
        self._c_retry = reg.counter(
            "resilience_retry_total",
            "re-attempts taken after backoff, by op and reason")
        self._c_give_up = reg.counter(
            "resilience_retry_give_up_total",
            "calls that stopped retrying, by op and cause "
            "(attempts | deadline)")
        self._h_backoff = reg.histogram(
            "resilience_retry_backoff_seconds",
            "backoff sleep taken before a re-attempt, by op")

    def retryable_status(self, status: int) -> bool:
        return status in self.retry_statuses

    def start(self, deadline: float | None = None,
              op: str = "call") -> "RetryCall":
        """Begin one retryable call with ``deadline`` seconds of total
        budget (None = unbounded)."""
        return RetryCall(self, deadline, op)

    def _next_delay(self, prev: float) -> float:
        with self._rng_lock:
            u = self._rng.uniform(self.base_delay, max(prev, self.base_delay) * 3)
        return min(self.max_delay, u)


class RetryCall:
    """Per-call retry state: attempt count + deadline clock.

    The caller's loop shape::

        call = policy.start(deadline=timeout, op="http.send")
        while True:
            t = call.attempt_timeout(per_attempt)
            if t is not None and t <= 0:
                return last            # budget spent before the attempt
            resp = attempt(timeout=t)
            if done(resp) or not call.backoff(status=..., retry_after=...):
                return resp
    """

    __slots__ = ("policy", "op", "deadline_at", "attempt", "_prev_delay",
                 "give_up_cause")

    def __init__(self, policy: RetryPolicy, deadline: float | None,
                 op: str):
        self.policy = policy
        self.op = op
        self.deadline_at = (None if not deadline
                            else time.monotonic() + float(deadline))
        self.attempt = 0          # completed attempts
        self._prev_delay = policy.base_delay
        self.give_up_cause: str | None = None

    def remaining(self) -> float | None:
        """Budget seconds left (None = unbounded)."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.monotonic()

    def attempt_timeout(self, default: float) -> float:
        """Socket/attempt timeout for the NEXT attempt: the caller's
        per-attempt value, shrunk to the remaining budget — an attempt
        never outlives the call's deadline."""
        rem = self.remaining()
        if rem is None:
            return float(default)
        return min(float(default), rem)

    def backoff(self, status: int | None = None,
                retry_after: float | None = None,
                retryable: bool = True) -> bool:
        """Decide, sleep, and account for one more attempt.

        Returns True after sleeping the backoff (the caller loops);
        False when the call must stop: outcome not retryable, attempts
        exhausted, or the sleep + one more attempt no longer fits the
        deadline budget. Never sleeps when returning False.
        """
        pol = self.policy
        self.attempt += 1
        if not retryable or (status is not None
                             and not pol.retryable_status(status)):
            return False
        if self.attempt >= pol.max_attempts:
            self.give_up_cause = "attempts"
            pol._c_give_up.inc(1, op=self.op, cause="attempts")
            return False
        if pol.delays is not None:
            delay = pol.delays[self.attempt - 1]
        else:
            delay = pol._next_delay(self._prev_delay)
            self._prev_delay = delay
        if pol.honor_retry_after and retry_after is not None:
            # the peer named its recovery time: never call back sooner
            delay = max(delay, float(retry_after))
        rem = self.remaining()
        if rem is not None and delay >= rem:
            # the sleep alone would eat the rest of the budget — there
            # is no room left for the attempt the sleep would buy
            self.give_up_cause = "deadline"
            pol._c_give_up.inc(1, op=self.op, cause="deadline")
            return False
        reason = "transport" if status is None else str(status)
        pol._c_retry.inc(1, op=self.op, reason=reason)
        pol._h_backoff.observe(delay, op=self.op)
        if delay > 0:
            pol._sleep(delay)
        return True
