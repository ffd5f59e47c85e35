"""Resilience subsystem: one failure policy for the whole stack (the
port's own copy of the JAX package's ``resilience``, with the same
``__all__``, series and injection points).

The reference frames its serving layer as fault-tolerant by
construction (``FaultToleranceUtils``, epoch-tagged lease replay in
``HTTPSourceV2.scala``); production accelerator serving treats worker loss and
transient RPC failure as the steady state (arXiv:2605.25645). This
package turns the repo's scattered ad-hoc error handling into one
observable, testable layer:

- :class:`RetryPolicy` — exponential backoff with decorrelated jitter,
  a per-call deadline budget (retries never outlive the request), and
  ``Retry-After`` honored from the sched subsystem's 429/503 sheds.
- :class:`CircuitBreaker` / :func:`breaker_for` — per-endpoint
  closed → open → half-open breakers with state and transitions in the
  obs registry, so a dead endpoint degrades fast instead of serially
  timing out.
- :data:`injector` / :class:`FaultInjector` — a seeded, deterministic
  fault plane with named injection points (``http.send``,
  ``mesh.lease``, ``mesh.reply``, ``worker.heartbeat``,
  ``worker.death``, ``checkpoint.write``) that injects latency, error
  statuses, connection drops, and worker death from tests and chaos
  scenarios without monkeypatching.

Import is stdlib + obs only: no torch, no HTTP, no device
(``tests/test_torch_isolation.py`` asserts it).
"""

from .breaker import (CLOSED, HALF_OPEN, OPEN, BreakerOpen, CircuitBreaker,
                      breaker_for, drop_breaker, reset_breakers)
from .faults import (FaultAction, FaultInjector, FaultRule, InjectedDrop,
                     InjectedFault, WorkerKilled, faults, injector)
from .retry import (RETRY_STATUSES, RetryCall, RetryPolicy,
                    parse_retry_after)

__all__ = ["RetryPolicy", "RetryCall", "RETRY_STATUSES",
           "parse_retry_after",
           "CircuitBreaker", "BreakerOpen", "breaker_for",
           "drop_breaker", "reset_breakers", "CLOSED", "OPEN",
           "HALF_OPEN",
           "FaultInjector", "FaultRule", "FaultAction", "injector",
           "faults", "InjectedFault", "InjectedDrop", "WorkerKilled"]
