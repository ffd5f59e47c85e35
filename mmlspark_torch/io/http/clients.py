"""HTTP client stack: single-threaded and buffered-async execution.

Reference ``io/http/Clients.scala:12-63`` (``BaseClient``,
``SingleThreadedClient``, ``AsyncClient`` over ``AsyncUtils.bufferedAwait``)
and ``HTTPClients.scala`` (retry on 429/5xx with backoff). urllib-based —
no external HTTP dependency.

Retries run through the resilience subsystem's :class:`RetryPolicy`
(decorrelated jitter instead of the old fixed ``(0.1, 0.5, 1.0)``
ladder): every sleep and every attempt is gated on the caller's
``timeout`` budget — the whole call, retries included, finishes inside
it — and a 429/503 carrying ``Retry-After`` (the sched subsystem's
sheds) floors the next backoff instead of hammering the overloaded
peer. Each attempt passes the ``http.send`` fault-injection point, so
chaos tests drive this path without monkeypatching.

Trace propagation (obs subsystem): every send opens an ``http.send``
span and injects its W3C-style ``traceparent`` into the outgoing
headers, so a server on the other end parents its request span into
the CALLER's trace — the head-node→worker hop stops severing the tree.
Retries re-send under the same span: one logical exchange, one span.
"""

from __future__ import annotations

import functools
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from ...core.utils import StopWatch
from ...obs.propagation import inject as _inject
from ...obs.tracing import tracer as _tracer
from ...resilience import RetryPolicy, parse_retry_after
from ...resilience.faults import injector as _faults
from .schema import HTTPRequestData, HTTPResponseData

RETRY_STATUSES = {429, 500, 502, 503, 504}

# the stack-wide default policy; callers with their own budget/ladder
# pass policy= (or the legacy retries= tuple, which pins the ladder)
DEFAULT_POLICY = RetryPolicy(max_attempts=4, base_delay=0.1, max_delay=2.0,
                             retry_statuses=frozenset(RETRY_STATUSES))


def _retry_after_of(resp: HTTPResponseData) -> float | None:
    for k, v in (resp.headers or {}).items():
        if k.lower() == "retry-after":
            return parse_retry_after(v)
    return None


def send_request(req: HTTPRequestData, timeout: float = 60.0,
                 retries: tuple[float, ...] | None = None,
                 policy: RetryPolicy | None = None) -> HTTPResponseData:
    """One HTTP exchange with retry/backoff (the reference's
    ``HTTPClients.scala`` advanced handler, rebuilt on
    :class:`~mmlspark_torch.resilience.RetryPolicy`).

    ``timeout`` is the call's TOTAL deadline budget: per-attempt socket
    timeouts shrink to the remaining budget, and no backoff sleep is
    taken that the budget cannot cover — the old ladder slept and
    re-attempted even with the caller's budget already spent, and
    retried ``URLError``s against no budget at all. ``retries`` (legacy)
    pins an explicit delay ladder; ``policy`` overrides wholesale.
    """
    pol = policy if policy is not None else (
        RetryPolicy(delays=retries,
                    retry_statuses=frozenset(RETRY_STATUSES))
        if retries is not None else DEFAULT_POLICY)
    call = pol.start(deadline=timeout, op="http.send")
    with _tracer.span("http.send", url=req.url,
                      method=req.method) as send_span:
        resp = _send_with_retries(req, timeout, call, send_span)
        send_span.set_attr("status", resp.status_code)
        return resp


def _send_with_retries(req: HTTPRequestData, timeout: float, call,
                       send_span) -> HTTPResponseData:
    # one traceparent for the whole logical exchange: a retry is the
    # same request, so the server-side spans of every attempt join the
    # same tree under the one http.send span
    headers = _inject(dict(req.headers or {}), send_span)
    last: HTTPResponseData | None = None
    while True:
        try:
            # the fault hook runs BEFORE the remaining budget is read:
            # an injected latency spike (apply sleeps here) is charged
            # against the call's deadline like any real stall, and an
            # injected drop flows into the transport-failure branch
            act = _faults.apply("http.send", key=req.url)
            attempt_timeout = call.attempt_timeout(timeout)
            if attempt_timeout <= 0:
                break
            if act is not None:  # injected error status
                resp = HTTPResponseData(
                    status_code=act.status, reason="injected fault",
                    headers=({"Retry-After": str(act.retry_after)}
                             if act.retry_after is not None else {}),
                    entity=None)
            else:
                r = urllib.request.Request(
                    req.url, data=req.entity, method=req.method,
                    headers=headers)
                with urllib.request.urlopen(
                        r, timeout=attempt_timeout) as ok:
                    return HTTPResponseData(
                        status_code=ok.status, reason=ok.reason or "",
                        headers=dict(ok.headers.items()),
                        entity=ok.read())
        except urllib.error.HTTPError as e:
            resp = HTTPResponseData(status_code=e.code,
                                    reason=str(e.reason),
                                    headers=dict(e.headers.items()),
                                    entity=e.read())
        except (urllib.error.URLError, OSError) as e:
            # transport failure (timeout, refused, injected drop):
            # retryable, but ONLY against remaining budget
            last = HTTPResponseData(
                status_code=0,
                reason=str(getattr(e, "reason", None) or e), entity=None)
            if not call.backoff(status=None):
                return last
            continue
        last = resp
        if not call.backoff(status=resp.status_code,
                            retry_after=_retry_after_of(resp)):
            return resp
    return last if last is not None else HTTPResponseData(
        status_code=0, reason="no attempt succeeded")


class SingleThreadedClient:
    """Sequential sender (reference ``SingleThreadedClient``)."""

    def __init__(self, timeout: float = 60.0, sender=send_request,
                 policy: RetryPolicy | None = None):
        self.timeout = timeout
        if policy is not None and sender is send_request:
            sender = functools.partial(send_request, policy=policy)
        self.sender = sender

    def send(self, requests: list[HTTPRequestData]) -> \
            list[HTTPResponseData]:
        return [self.sender(r, self.timeout) for r in requests]


class AsyncClient:
    """Bounded-concurrency sender — the reference's ``AsyncClient`` with
    ``bufferedAwait`` (``core/utils/AsyncUtils``): at most ``concurrency``
    requests in flight, results in submission order, per-request
    ``concurrent_timeout``. ``policy`` threads a shared
    :class:`RetryPolicy` through the default sender."""

    def __init__(self, concurrency: int = 8, timeout: float = 60.0,
                 concurrent_timeout: float | None = None,
                 sender=send_request, policy: RetryPolicy | None = None):
        self.concurrency = concurrency
        self.timeout = timeout
        self.concurrent_timeout = concurrent_timeout
        if policy is not None and sender is send_request:
            sender = functools.partial(send_request, policy=policy)
        self.sender = sender

    def send(self, requests: list[HTTPRequestData]) -> \
            list[HTTPResponseData]:
        watch = StopWatch()
        with watch, ThreadPoolExecutor(self.concurrency) as pool:
            futures = [pool.submit(self.sender, r, self.timeout)
                       for r in requests]
            out = []
            for f in futures:
                try:
                    out.append(f.result(timeout=self.concurrent_timeout))
                except TimeoutError:
                    out.append(HTTPResponseData(
                        status_code=0, reason="concurrent timeout"))
        return out
