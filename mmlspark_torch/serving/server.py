"""The serving engine: HTTP front, dynamic batcher, pipeline executor.

The port of ``mmlspark_tpu/serving/server.py``; both fronts, the route
table, the scheduler's admission and the executor's replay are the same
code paths, over the port's ``obs``, ``sched``, ``resilience`` and
``core.aot``.

Reference mapping:
- ``WorkerServer`` (``continuous/HTTPSourceV2.scala:475+``): per-process
  HTTP server enqueueing ``CachedRequest``s → :class:`ServingServer`.
- micro-batch/continuous readers (:259-326): the executor thread pulling
  batches from the queue and running the pipeline.
- ``HTTPSourceStateHolder`` (:337-428): the module-level ``_SERVICES``
  registry, keyed by service name (used by reply UDFs).
- epoch replay on task retry (:488-517): failed batches are re-enqueued
  with a bounded retry count.

The reference's deploy-plane hooks (the version router's admission
stamp, ``X-Model-Version``, shadow mode, the ``model.bad`` fault probe
and ``/debug/deploy``) come with ``serving/deploy.py`` in ROADMAP.md §1
item 9d-2.

The executor thread calls the transform from its own thread. Grad mode
and the current CUDA device are thread-local in PyTorch, so nothing here
sets them for the transform: a stage names its device through its
``device`` Param, and one with parameters enters inference mode itself
(``TextEncoderFeaturizer``, ``TPUModel``).
"""

from __future__ import annotations

import math
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

import logging

from ..core import DataFrame
from ..io.http.schema import HTTPRequestData, HTTPResponseData
from ..obs import registry as _obs
from ..obs.attribution import cost_attribution as _cost_attribution
from ..obs.export import debug_trace_payload, flight_recorder as _flight
from ..obs.fleet import (fleet_aggregator as _fleet_agg,
                         fleet_health as _fleet_health)
from ..obs.memory import memory_profiler as _memory
from ..obs.profile import feature_log as _features
from ..obs.propagation import extract as _extract
from ..obs.timeseries import (recorder as _recorder,
                              timeline_payload as _timeline)
from ..obs.tracing import tracer as _tracer
from ..sched import RequestScheduler, Shed
from ..sched.policy import bucket_of
from ..sched.tenancy import clean_tenant

_LOG = logging.getLogger("mmlspark_torch.serving")

_SERVICES: dict[str, "ServingServer"] = {}


class LowLatencyHandlerMixin:
    """Shared handler posture for every serving-plane HTTP handler:
    HTTP/1.1 keep-alive, responses coalesced into one TCP segment
    (buffered wfile) with Nagle off — the unbuffered default interacts
    with the peer's delayed-ACK timer (40 ms on Linux) for a stall per
    request — and quiet logs."""

    protocol_version = "HTTP/1.1"
    wbufsize = -1
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass


class QuietHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that treats dead-client disconnects as routine.

    With a buffered response stream (``wbufsize = -1``) a client that
    hangs up early raises BrokenPipeError at the post-handler flush —
    outside any in-handler guard — and stock socketserver would dump a
    traceback per flaky client. The reference tolerates these silently
    (``HTTPv2Suite`` flaky-connection test); so do we."""

    # socketserver's default listen backlog is 5: a 16-way client burst
    # overflows it, and a dropped SYN waits out TCP's initial retransmit
    # timeout (1 s) before the loaded tail sees it. The native front
    # listens at 1024.
    request_queue_size = 128

    def handle_error(self, request, client_address):
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            TimeoutError)):
            return  # routine client disconnect
        super().handle_error(request, client_address)


def get_service(name: str) -> "ServingServer":
    """Reference ``HTTPSourceStateHolder.getServer``."""
    return _SERVICES[name]


def bucket_pad(xs: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad a serving batch's leading dim UP to the next power of two;
    returns ``(padded, real_count)`` — score the padded array, slice
    results to ``real_count``.

    Why this exists: a dynamic-batching front produces every batch size
    up to the in-flight count, and whatever is keyed on the batch shape
    (a traced program, a tuned tile, an allocator block size) is made
    anew for each novel size at request latency. Buckets bound the
    count of distinct shapes to log2(max_batch)."""
    n = len(xs)
    b = 1 << max(n - 1, 0).bit_length()
    if b == n:
        return xs, n
    pad = np.zeros((b - n,) + xs.shape[1:], xs.dtype)
    return np.concatenate([xs, pad]), n


@dataclass
class CachedRequest:
    """An in-flight request (reference ``CachedRequest``): body + the
    machinery to reply exactly once.

    The reply latch is now an atomic check-and-set under a per-request
    lock, with a second terminal transition — :meth:`abandon` — taken
    when the waiting client gives up (handler timeout): a later
    pipeline ``reply`` then returns False and is dropped cleanly
    instead of racing the latch, and ``on_done`` (the scheduler's
    in-flight release) fires exactly once on whichever transition wins.
    """
    id: str
    request: HTTPRequestData
    _event: threading.Event = field(default_factory=threading.Event)
    _response: HTTPResponseData | None = None
    retries: int = 0
    # intake timestamp (perf_counter) — the native front measures
    # request latency from here at reply time; the threaded front times
    # in-handler instead (same series either way)
    created: float = field(default_factory=time.perf_counter)
    # absolute deadline on the scheduler's monotonic clock (None = no
    # deadline) and the route label — set at admission (sched subsystem)
    deadline: float | None = None
    route: str = "/"
    # quota/tier bucket from the X-Tenant header (sched.tenancy); ""
    # when the service runs without a tenancy policy
    tenant: str = ""
    # fired exactly once when the request reaches ANY terminal state
    # (reply or abandon); the serving layer hangs the scheduler's
    # in-flight release here
    on_done: object = None
    abandoned: bool = False
    # the request's span in the cross-process trace (obs subsystem) and
    # the queue wait the scheduler stamped at pop — both None until set
    span: object = None
    queue_wait: float | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def reply(self, response: HTTPResponseData) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._response = response
            self._event.set()
        self._fire_done()
        return True

    def abandon(self, response: HTTPResponseData | None = None) -> bool:
        """Terminal no-client-listening state (handler wait timed out):
        marks the slot dead so a later ``reply`` is dropped cleanly.
        Returns False when a real reply won the race."""
        with self._lock:
            if self._event.is_set():
                return False
            self.abandoned = True
            self._response = response or HTTPResponseData(
                status_code=504, reason="pipeline timeout")
            self._event.set()
        self._fire_done()
        return True

    def wait(self, timeout: float) -> HTTPResponseData:
        if not self._event.wait(timeout):
            # mark abandoned; on a lost race the landed reply stands
            self.abandon()
        return self._response

    def _fire_done(self) -> None:
        cb, self.on_done = self.on_done, None
        if cb is not None:
            try:
                cb()
            except Exception:
                _LOG.warning("request done-callback failed: %s",
                             traceback.format_exc())


class ServingServer:
    """HTTP server + request queue for one named service."""

    def _init_shared_state(self, name: str, api_path: str,
                           reply_timeout: float, max_retries: int,
                           max_queue: int, deadline: float = 0.0,
                           max_inflight: int = 0,
                           tenancy=None) -> None:
        """State shared by every front (threaded Python and native epoll —
        ``native_front.NativeServingServer`` calls this too, so the two
        cannot drift): the scheduler, replay bookkeeping, and route table
        that ``next_batch``/``replay``/``_new_id`` operate on."""
        self.name = name
        self.api_path = api_path.rstrip("/") or "/"
        self.reply_timeout = reply_timeout
        self.max_retries = max_retries
        # the admission-controlled scheduler (sched subsystem) replaces
        # the plain FIFO: bounded intake still answers 503 on hard
        # overflow, and the deadline budget adds
        # predictive load shedding (429 + Retry-After) plus expiry sheds
        # before execution. Queue-compatible, so the mesh lease drain,
        # replay, and queue-poking tests work unchanged.
        self.scheduler = RequestScheduler(
            name, max_queue=max_queue or 0, max_inflight=max_inflight,
            deadline=deadline, on_shed=self._shed_reply,
            tenancy=tenancy)
        self.queue = self.scheduler
        self.history: dict[str, CachedRequest] = {}
        self._lock = threading.Lock()
        # internal sub-path handlers (distributed mode registers
        # __reply__/__lease__ here): path -> fn(body) -> (status, bytes)
        self._routes: dict[str, callable] = {}
        # -- observability (process-wide registry: obs subsystem) ----------
        # per-route request/error/latency series + a Prometheus text
        # exposition endpoint. Registered in shared state so BOTH fronts
        # (threaded python and native epoll) and distributed mode serve
        # and record identically.
        self._m_requests = _obs.counter(
            "serving_requests_total",
            "requests answered, by service/route/status code")
        self._m_errors = _obs.counter(
            "serving_errors_total",
            "requests answered with status >= 400, by service/route")
        self._m_latency = _obs.histogram(
            "serving_request_seconds",
            "request wall seconds from intake to reply, by service/route")
        self._m_queue = _obs.gauge(
            "serving_queue_depth", "queued requests awaiting the executor")
        self._m_lat_ewma = _obs.gauge(
            "serving_request_seconds_ewma",
            "EWMA request latency, by service (load-aware routing input)")
        # per-tenant outcome series (sched.tenancy): label cardinality
        # is bounded by the tenancy policy's idle-tenant eviction
        self._m_tenant_requests = _obs.counter(
            "serving_tenant_requests_total",
            "requests answered, by service/tenant/status code")
        self._lat_ewma = 0.0
        self._lat_seen = False
        self._routes["/metrics"] = self._metrics_route
        if self.api_path != "/":
            self._routes[f"{self.api_path}/metrics"] = self._metrics_route
        # flight recorder + trace debug surface (obs subsystem): the
        # recorder collects every span once installed; requests report
        # their outcome through _finish_request so the N slowest /
        # errored keep their full cross-process trees, served at
        # GET /debug/trace by BOTH fronts (shared route table)
        _flight.install()
        self._routes["/debug/trace"] = self._debug_trace_route
        if self.api_path != "/":
            self._routes[f"{self.api_path}/debug/trace"] = \
                self._debug_trace_route
        # AOT store introspection (core/aot.py): what the process's
        # executable store holds vs what compiled at runtime — served
        # by BOTH fronts (shared route table), like /metrics
        self._routes["/debug/aot"] = self._debug_aot_route
        if self.api_path != "/":
            self._routes[f"{self.api_path}/debug/aot"] = \
                self._debug_aot_route
        # fleet telemetry plane (obs.fleet): the fleet-scoped
        # exposition ("?scope=fleet" is a LITERAL route key — both
        # fronts try the query-preserving key before the stripped
        # path), the per-source debug view, and the SLO-burn /healthz
        # verdict. Shared route table → identical on both fronts.
        self._routes["/metrics?scope=fleet"] = self._fleet_metrics_route
        self._routes["/debug/fleet"] = self._debug_fleet_route
        self._routes["/healthz"] = self._healthz_route
        if self.api_path != "/":
            for suffix in ("/metrics?scope=fleet", "/debug/fleet",
                           "/healthz"):
                self._routes[f"{self.api_path}{suffix}"] = \
                    self._routes[suffix]
        # telemetry history plane (obs.timeseries): the
        # timeline query surface. Its query VALUES vary per request
        # (series=<patterns>&window=<seconds>), so it cannot be a
        # literal ``path?query`` key — query routes are a second table
        # (path -> fn(query, body)) both fronts consult after the
        # literal lookups, keeping the existing routes byte-identical.
        self._query_routes: dict[str, callable] = {}
        self._query_routes["/debug/timeline"] = self._debug_timeline_route
        if self.api_path != "/":
            self._query_routes[f"{self.api_path}/debug/timeline"] = \
                self._debug_timeline_route
        # cost-attribution plane (obs.attribution/goodput/xprof): the
        # goodput ledger report is a literal route; /debug/xprof is a
        # QUERY route (list on empty query, capture on
        # ``duration_ms=``, download on ``fetch=``) so one path serves
        # the whole capture workflow on BOTH fronts. The distributed
        # server overrides the xprof handler with the pod-fanout
        # variant.
        self._routes["/debug/goodput"] = self._debug_goodput_route
        self._query_routes["/debug/xprof"] = self._debug_xprof_route
        if self.api_path != "/":
            self._routes[f"{self.api_path}/debug/goodput"] = \
                self._debug_goodput_route
            self._query_routes[f"{self.api_path}/debug/xprof"] = \
                self._debug_xprof_route
        if tenancy is not None:
            _fleet_health.attach_tenancy(tenancy)

    def _debug_aot_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /debug/aot``: active store stats + the CompileTracker
        steady-state view (runtime compiles since mark_steady — the
        functions an operator must add to the AOT build)."""
        import json as _json

        from ..core import aot
        from ..obs.profile import compile_tracker
        store = aot.active_store()
        payload = {
            "store": store.stats() if store is not None else None,
            "steady": compile_tracker.steady,
            "runtime_compiles": compile_tracker.runtime_compiled(),
        }
        return 200, _json.dumps(payload, indent=1).encode()

    def _debug_goodput_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /debug/goodput``: tick the fleet goodput ledger
        against the live registry and report the ratio plus the
        itemized waste taxonomy (obs.goodput)."""
        from ..obs.goodput import goodput_payload
        return 200, goodput_payload()

    def _debug_xprof_route(self, query: str,
                           body: bytes) -> tuple[int, bytes]:
        """``GET/POST /debug/xprof``: list captures (empty query),
        run a bounded device-profiler capture (``?duration_ms=``), or
        download one (``?fetch=``) — obs.xprof (a ``torch.profiler``
        capture in the port)."""
        from ..obs.xprof import xprof_captures
        return xprof_captures.handle_query(query, body)

    def _metrics_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /metrics``: Prometheus text exposition of the
        process-wide registry (every subsystem's series, not just this
        server's — one scrape surface per process)."""
        return 200, _obs.exposition().encode()

    def _debug_trace_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /debug/trace``: the flight recorder's retained span
        trees (slowest + errored requests) as Chrome-trace/Perfetto
        JSON with per-trace summaries — save as ``.json``, open in
        Perfetto, find the trace_id the load generator printed."""
        return 200, debug_trace_payload()

    def _fleet_metrics_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /metrics?scope=fleet``: the local exposition plus
        every merged remote source's samples (pod ranks, heartbeating
        mesh workers, pulled peers) — one scrape for the whole fleet.
        Memory gauges refresh on scrape so they are never staler than
        the reading."""
        _memory.update()
        return 200, _fleet_agg.exposition().encode()

    def _debug_fleet_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /debug/fleet``: verdict + per-source staleness/size,
        flagged stragglers, and per-tenant burn rates as JSON."""
        return 200, _fleet_health.debug_payload()

    def _healthz_route(self, body: bytes) -> tuple[int, bytes]:
        """``GET /healthz``: the fleet health verdict. 200 for
        ok/degraded (a slow fleet must not be drained by its load
        balancer), 503 only when critical (SLO burn is paging)."""
        return _fleet_health.healthz_payload()

    def _debug_timeline_route(self, query: str,
                              body: bytes) -> tuple[int, bytes]:
        """``GET /debug/timeline?series=&window=``: the history
        store's recorded series as JSON — ``series`` is a
        comma-separated name/prefix list, ``window`` trailing seconds
        (default 300); without ``series`` an index of recorded series.
        Served by BOTH fronts via the shared query-route table."""
        return _timeline(query)

    def _start_request_span(self, cached: "CachedRequest",
                            route: str) -> None:
        """Open the request's span: parented into the CLIENT's trace
        when the request carries a traceparent header (the HTTP client
        stack injects one), a fresh root otherwise. ``current=False``:
        handler/poller threads serve many requests concurrently, so the
        ambient context must stay untouched — children name this span
        explicitly (scheduler queue spans, executor execute spans)."""
        ctx = _extract(cached.request.headers)
        cached.span = _tracer.start_span(
            "serving.request", parent=ctx, current=False,
            service=self.name, route=route, worker=self._worker_label())

    def _worker_label(self) -> str:
        """Distributed mode overrides identity via worker_id; the
        single-process server labels spans with its service name."""
        return getattr(self, "worker_id", "") or self.name

    def _finish_request(self, cached: "CachedRequest",
                        status: int) -> None:
        """Close the request span and report the outcome to the flight
        recorder (which decides whether the tree is retained). ONE site
        for both fronts; idempotent via end_span's done-latch."""
        # only with a tenancy policy attached: its idle-tenant eviction
        # is what bounds this label's cardinality — without one, a
        # client spraying X-Tenant values could grow the exposition
        # forever (same rationale as the <unmatched> route collapse)
        if cached.tenant and self.scheduler.tenancy is not None:
            self._m_tenant_requests.inc(1, service=self.name,
                                        tenant=cached.tenant,
                                        code=str(int(status)))
        span = cached.span
        if span is None:
            return
        already = getattr(span, "_done", False)
        span.set_attr("status", int(status))
        _tracer.end_span(span)
        if not already:
            _flight.note_request(span.trace_id, span.seconds or 0.0,
                                 status=int(status))

    def _observe_request(self, route: str, status: int,
                         seconds: float) -> None:
        """ONE recording site for both fronts: count + latency, by route.

        Only known routes become label values — anything else collapses
        to ``<unmatched>`` so a client spraying distinct paths cannot
        grow the registry (and the /metrics exposition) without bound.
        """
        if route != self.api_path and route not in self._routes:
            route = "<unmatched>"
        self._m_requests.inc(1, service=self.name, route=route,
                             code=str(status))
        if status >= 400:
            self._m_errors.inc(1, service=self.name, route=route)
        self._m_latency.observe(seconds, service=self.name, route=route)
        # EWMA latency for load-aware routing (ServiceInfo carries it to
        # the mesh's registry); a float read-modify-write race here only
        # smears the smoothing, never corrupts the series
        self._lat_ewma = seconds if not self._lat_seen else \
            0.2 * seconds + 0.8 * self._lat_ewma
        self._lat_seen = True
        self._m_lat_ewma.set(self._lat_ewma, service=self.name)

    def _shed_reply(self, cached: "CachedRequest", reason: str,
                    retry_after: float) -> None:
        """Scheduler ``on_shed`` callback: answer a request shed AFTER
        queueing (deadline expired before execution). Works through
        ``CachedRequest.reply``, so both fronts (threaded wait and
        native reactor) deliver it the same way."""
        resp = HTTPResponseData(
            status_code=429, reason=f"shed: {reason}",
            headers={"Retry-After": str(max(1, int(retry_after)))})
        cached.reply(resp)

    def _admit(self, cached: "CachedRequest", route: str) -> None:
        """Shared admission path for both fronts: a client can tighten
        its budget with an ``X-Deadline-Ms`` header (capped at the
        service default when one is configured — a client cannot ask
        for MORE queueing than the service allows) and names its quota
        bucket with ``X-Tenant`` (sanitized; junk values collapse to
        the default tenant); raises :class:`~..sched.Shed` when the
        scheduler rejects."""
        budget = None
        tenant = ""
        for k, v in (cached.request.headers or {}).items():
            lk = k.lower()
            if lk == "x-deadline-ms":
                try:
                    # clamp to a positive finite floor: a 0/negative
                    # header must read as "already out of budget"
                    # (immediate shed), NOT as "no deadline", and
                    # "nan"/"inf" parse without ValueError but would
                    # sail through every deadline comparison — all of
                    # them would loosen the budget the contract says
                    # can only be tightened
                    budget = float(v) / 1e3
                    budget = max(budget, 1e-6) \
                        if math.isfinite(budget) else None
                except (TypeError, ValueError):
                    budget = None
                if budget is not None and self.scheduler.default_deadline:
                    budget = min(budget, self.scheduler.default_deadline)
            elif lk == "x-tenant":
                tenant = clean_tenant(v)
        self.scheduler.submit(cached, route=route, deadline=budget,
                              tenant=tenant)

    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout: float = 30.0,
                 max_retries: int = 2, max_queue: int = 0,
                 deadline: float = 0.0, max_inflight: int = 0,
                 tenancy=None):
        self._init_shared_state(name, api_path, reply_timeout,
                                max_retries, max_queue, deadline=deadline,
                                max_inflight=max_inflight,
                                tenancy=tenancy)

        serving = self

        class Handler(LowLatencyHandlerMixin,
                      BaseHTTPRequestHandler):
            def _serve(self):
                # every exit records into the shared per-route series
                # (requests/errors/latency) — same recording site the
                # native front uses, so the two fronts cannot drift
                t0 = time.perf_counter()
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                status = self._serve_inner(path)
                serving._observe_request(path, status,
                                         time.perf_counter() - t0)

            def _serve_inner(self, path: str) -> int:
                # route on the service path like the reference WorkerServer
                # (continuous/HTTPSourceV2.scala PublicHandler): anything
                # not addressed to this service's api_path is 404, never
                # queued.
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else None
                # query-scoped routes first ("/metrics?scope=fleet" is
                # a literal key), then the query-stripped path, then
                # the query-route table (variable query values —
                # /debug/timeline?series=&window=)
                route = None
                query = ""
                if "?" in self.path:
                    query = self.path.split("?", 1)[1]
                    route = serving._routes.get(f"{path}?{query}")
                if route is None:
                    route = serving._routes.get(path)
                if route is None:
                    qroute = serving._query_routes.get(path)
                    if qroute is not None:
                        def route(b, _q=query, _h=qroute):
                            return _h(_q, b)
                if route is not None:
                    status, out = route(body or b"")
                    self.send_response(status)
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                    return status
                if path != serving.api_path:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return 404
                req = HTTPRequestData(
                    url=self.path, method=self.command,
                    headers=dict(self.headers.items()), entity=body)
                cached = CachedRequest(id=serving._new_id(), request=req)
                # span opens BEFORE admission so a queue span (and the
                # shed outcome) lands inside the request's trace
                serving._start_request_span(cached, path)
                with serving._lock:
                    serving.history[cached.id] = cached
                try:
                    serving._admit(cached, path)
                except Shed as s:
                    # hard queue overflow keeps the 503 contract; policy
                    # sheds (deadline budget, concurrency) answer 429 —
                    # both carry Retry-After sized to the predicted drain
                    with serving._lock:
                        serving.history.pop(cached.id, None)
                    serving._finish_request(cached, s.status)
                    self.send_response(s.status)
                    self.send_header("Retry-After", str(s.retry_after))
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return s.status
                resp = cached.wait(serving.reply_timeout)
                with serving._lock:
                    serving.history.pop(cached.id, None)
                serving._finish_request(cached, resp.status_code or 500)
                try:
                    self.send_response(resp.status_code or 500)
                    body = resp.entity or b""
                    for k, v in resp.headers.items():
                        if k.lower() != "content-length":
                            self.send_header(k, v)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # flaky client; reference tolerates these too
                return resp.status_code or 500

            do_GET = do_POST = do_PUT = _serve

        self._httpd = QuietHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        _SERVICES[name] = self

    def _new_id(self) -> str:
        """Request id; distributed mode embeds the owning worker."""
        return str(uuid.uuid4())

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._server_thread.start()
        return self

    def stop(self):
        self.scheduler.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        _SERVICES.pop(self.name, None)

    # -- batch intake (called by the query loop) ---------------------------
    def next_batch(self, max_wait: float | None = 0.005,
                   max_batch: int = 1024,
                   linger: float = 0.0) -> list[CachedRequest]:
        """Dynamic batching through the sched subsystem's adaptive
        policy: small batches under light load (a lone request is
        dispatched immediately — condition-variable wakeup, no poll
        floor), large under heavy load, with closes decided by deadline
        slack / padding-bucket fill / the learned service-time EWMA.
        ``max_wait`` bounds the idle wait (None = block until work or a
        ``wake()``/``close()`` — the zero-idle-CPU mode ServingQuery
        uses); ``linger`` is the micro-batch wait budget; ``max_batch=1``
        is strict record-at-a-time (continuous mode)."""
        batch = self.scheduler.next_batch(max_batch=max_batch,
                                          linger=linger, max_wait=max_wait)
        # depth AFTER the drain = standing backlog the executor can't
        # keep up with (qsize is approximate under concurrency; a gauge
        # tolerates that)
        self._m_queue.set(self.queue.qsize(), service=self.name)
        return batch

    def replay(self, cached: CachedRequest) -> None:
        """Reference epoch replay (``recoveredPartitions``,
        ``HTTPSourceV2.scala:488-517``): requeue an in-flight request whose
        processing failed."""
        cached.retries += 1
        if cached.retries > self.max_retries:
            cached.reply(HTTPResponseData(
                status_code=500, reason="pipeline failed after retries"))
            return
        try:
            # non-blocking: with a bounded queue a blocking put here could
            # deadlock the very consumer that would drain it. Replays go
            # to the FRONT: this request already waited through the
            # queue once, and a replay is racing what is left of its
            # deadline budget (resilience: detection-driven requeue)
            self.queue.put_front(cached)
        except queue.Full:
            cached.reply(HTTPResponseData(
                status_code=503, reason="replay rejected: queue full"))


class ServingQuery:
    """The 'streaming query': a thread that pulls request batches through
    the pipeline and replies. ``transform_fn`` receives a DataFrame with
    ``id`` and ``request`` (HTTPRequestData) columns and must either call
    ``send_reply_udf`` itself or return a DataFrame with ``id`` and
    ``reply`` (HTTPResponseData) columns."""

    def __init__(self, server: ServingServer, transform_fn,
                 name: str | None = None, *, max_batch: int = 1024,
                 linger: float = 0.0):
        self.server = server
        self.transform_fn = transform_fn
        self.name = name or server.name
        # max_batch=1 = record-at-a-time (reference continuous mode);
        # linger > 0 = micro-batch throughput mode (wait to grow batches)
        self.max_batch = max_batch
        self.linger = linger
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.exception: Exception | None = None

    def start(self):
        # AOT warm boot for a transform_fn handed to serving_query
        # directly (a CompiledPipeline, or anything exposing its
        # stages): executables load BEFORE the executor thread can pull
        # a batch, so the first request never pays a compile. The DSL
        # path (ServingStream.start) warms the same way.
        from ..core import aot
        aot.maybe_warm(self.transform_fn, service=self.name)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        # close (not wake) the scheduler: close is sticky, so the
        # executor cannot miss it in the window between checking the
        # stop flag and re-entering next_batch — a wake() generation
        # bump is only visible to an already-parked waiter, and losing
        # it would stall this join for its full timeout
        self.server.scheduler.close()
        self._thread.join(timeout=5)
        self.server.stop()

    def await_termination(self, timeout: float | None = None):
        self._thread.join(timeout)

    def _annotate_batch(self, batch, execute_s: float) -> None:
        """Per-request trace + cost-model bookkeeping for one executed
        batch (obs subsystem): a ``serving.execute`` child span under
        each request's span (the whole batch's transform time — the
        latency each rider actually paid), and one feature-log record
        per request (route, batch/bucket, queue/execute ms, entity
        bytes) — the learned scheduler model's training rows."""
        n = len(batch)
        bucket = bucket_of(n)
        # standing backlog at annotate time: the queue-depth feature the
        # cost model trains on (what admission saw is gone by now; the
        # post-drain depth is the stationary load signal)
        queue_depth = self.server.scheduler.qsize()
        tenancy = self.server.scheduler.tenancy
        # fused-pipeline transparency: a CompiledPipeline transform_fn
        # (or a DSL chain that compiled one) reports how many fused
        # segments — i.e. device dispatches for the traced portion —
        # served this request; None = plain host path
        segments = getattr(self.transform_fn, "compiled_segments", None)
        # schema v6: the service's summed analytic cost from
        # the attribution table — 0.0 until something compiled for it
        a_flops, a_bytes = _cost_attribution.service_cost(self.name)
        for c in batch:
            sp = getattr(c, "span", None)
            if sp is not None:
                _tracer.emit_span("serving.execute", parent=sp,
                                  seconds=execute_s, service=self.name,
                                  rows=n)
            tenant = getattr(c, "tenant", "")
            queue_s = getattr(c, "queue_wait", None) or 0.0
            _features.record(
                service=self.name,
                route=getattr(c, "route", "/"),
                tenant=tenant,
                batch=n, bucket=bucket,
                # schema v2: the post-bucket padded batch
                # shape the executor actually ran, and the queue depth
                # — the cost model's missing features (schema_version
                # and platform are stamped by FeatureLog.record)
                padded_batch=bucket,
                queue_depth=queue_depth,
                queue_ms=round(queue_s * 1e3, 4),
                execute_ms=round(execute_s * 1e3, 4),
                entity_bytes=len(getattr(c.request, "entity", b"")
                                 or b""),
                compiled_segments=segments,
                analytic_flops=a_flops, analytic_bytes=a_bytes,
                trace_id=(sp.trace_id if sp is not None else None))
            if tenancy is not None and tenant:
                # the tenant's EWMA latency (queue + execute — what the
                # rider actually paid): the autoscaler's SLO pressure
                tenancy.observe_latency(tenant, queue_s + execute_s)

    def _run(self):
        batch_rows = _obs.histogram(
            "serving_batch_rows", "requests per executor batch",
            buckets=tuple(float(1 << k) for k in range(11)))
        batch_seconds = _obs.histogram(
            "serving_batch_seconds", "transform wall seconds per batch")
        batch_failures = _obs.counter(
            "serving_batch_failures_total",
            "executor batches that raised and were replayed")
        while not self._stop.is_set():
            # max_wait=None: block on the scheduler's condition variable
            # until work arrives (zero idle CPU; stop() wakes us)
            batch = self.server.next_batch(max_wait=None,
                                           max_batch=self.max_batch,
                                           linger=self.linger)
            if not batch:
                if self.server.scheduler.closed:
                    # scheduler torn down under us (server.stop()
                    # called before query.stop()): nothing more can
                    # arrive, and next_batch no longer blocks — looping
                    # would busy-spin a full core
                    break
                continue
            batch_rows.observe(len(batch), service=self.name)
            self._execute(batch, batch_seconds, batch_failures)

    def _execute(self, batch, batch_seconds, batch_failures) -> None:
        """Run one pulled batch through ``transform_fn`` and reply;
        replay the whole batch when the transform raises."""
        ids = np.empty(len(batch), object)
        reqs = np.empty(len(batch), object)
        ids[:] = [c.id for c in batch]
        reqs[:] = [c.request for c in batch]
        df = DataFrame({"id": ids, "request": reqs})
        try:
            # the span roots here (the executor thread has no ambient
            # context); batch latency also lands in the registry
            with batch_seconds.time(service=self.name) as bt, \
                    _tracer.span("serving.batch", parent=None,
                                 service=self.name, rows=len(batch)):
                out = self.transform_fn(df)
            # feed the scheduler's service-time model (EWMA per
            # padding bucket, stored in the obs registry): this is
            # what admission's predictive shed and the batcher's
            # close decision read back
            self.server.scheduler.estimator.observe(
                len(batch), bt.seconds)
            self._annotate_batch(batch, bt.seconds)
            if out is not None and "reply" in getattr(
                    out, "columns", []):
                by_id = {c.id: c for c in batch}
                for rid, reply in zip(out["id"], out["reply"]):
                    c = by_id.get(rid)
                    if c is not None:
                        c.reply(reply)
        except Exception as e:  # replay the whole failed batch
            self.exception = e
            batch_failures.inc(1, service=self.name)
            _LOG.warning("serving batch failed, replaying: %s",
                         traceback.format_exc())
            for c in batch:
                self.server.replay(c)


def serving_query(name: str, transform_fn, host: str = "127.0.0.1",
                  port: int = 0, reply_timeout: float = 30.0,
                  backend: str = "auto", max_queue: int = 0,
                  deadline: float = 0.0,
                  max_inflight: int = 0, tenancy=None) -> ServingQuery:
    """One-call setup: server + query, started.

    ``backend``: ``"auto"`` (the DEFAULT: the native front when its host
    library builds, else the Python front), ``"native"`` (C++ epoll
    reactor, ``native_front.py``; a failed build raises
    :class:`~mmlspark_torch.native.loader.NativeBuildError` with g++'s
    output), or ``"python"`` (threaded http.server front). The native
    front keeps request parsing and socket writes out of the GIL.
    Saturated closed-loop latency is conc/throughput by Little's law —
    sub-ms tails under load need either moderate load or more than one
    transform executor."""
    cls = ServingServer
    if backend in ("native", "auto"):
        from .native_front import NativeServingServer
        from ..native.loader import get_httpfront
        # "native" lets NativeServingServer raise the build error;
        # "auto" keeps the reference's quiet fallback
        if backend == "native" or get_httpfront() is not None:
            cls = NativeServingServer
    server = cls(name, host=host, port=port, reply_timeout=reply_timeout,
                 max_queue=max_queue, deadline=deadline,
                 max_inflight=max_inflight, tenancy=tenancy)
    server.start()
    # history plane (obs.timeseries): a served process records its own
    # trajectory — the sentinel's windowed p99 and the /debug/timeline
    # surface need points, not just instantaneous gauges. Idempotent;
    # bare ServingServer construction stays recorder-free so overhead
    # harnesses can measure the recorder-off baseline.
    _recorder.start()
    return ServingQuery(server, transform_fn).start()
