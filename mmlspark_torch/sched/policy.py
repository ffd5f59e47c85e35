"""The adaptive batch-close decision: the batching brain shared by
offline pipelines (``stages.DynamicBufferedBatcher``) and online serving.

The port of ``mmlspark_tpu/sched/policy.py``'s ``BatchPolicy``. The
reference's ``DynamicBufferedBatcher``/``MiniBatchTransformer``
(arXiv:1804.04031) encoded one policy — "take whatever accumulated" — which
is optimal only when service time is size-independent. Under padded batch
buckets service cost is a step function of the bucket, and the close
decision weighs the oldest request's deadline slack, the padding-bucket
fill and a service-time estimate (any object with ``estimate(n)``). The
registry-backed estimator, admission control and the request scheduler of
the JAX package's ``sched`` come with ROADMAP.md §1 item 9.

Stdlib only: no device and no torch.
"""

from __future__ import annotations

import time

# close-decision outcomes (returned by BatchPolicy.decide)
GROW = "grow"     # more work is queued: take it
WAIT = "wait"     # pay latency to grow the batch (bounded wait)
CLOSE = "close"   # dispatch now


def bucket_of(n: int) -> int:
    """The padded batch size ``n`` executes as: the next power of two (one
    compiled program per bucket)."""
    return 1 << max(int(n) - 1, 0).bit_length()


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
                 estimator=None):
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
