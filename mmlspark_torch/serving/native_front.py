"""Native serving front: the epoll HTTP server (httpfront.cpp) behind
the same ServingServer interface.

The Python front (``server.py``) spends a thread per connection and
several GIL hand-offs per request — that is the serving p99. Here one
C++ reactor thread owns all sockets; a single Python poller thread
converts ready requests into :class:`CachedRequest`s on the shared
queue, so :class:`ServingQuery`, replay, routing, and the distributed
worker mesh all work unchanged. Replies go straight to the reactor via
``hf_reply`` from whichever thread calls ``CachedRequest.reply``.

Opt in with ``serving_query(..., backend="native")``, which raises with
g++'s output when the front cannot be built (``backend="auto"``, the
default, falls back to the Python front instead).

Everything registered in ``ServingServer._init_shared_state`` rides
along unchanged — including the AOT executable-store surfaces
(``GET /debug/aot``, the ``aot_*`` metric family on ``/metrics``), and
the warm boot itself: ``ServingQuery.start`` loads store executables
before this front's poller delivers its first request, so a native
scale-up worker boots hot exactly like the threaded one
(``core/aot.py``).
"""

from __future__ import annotations

import ctypes
import logging
import threading
import time
import traceback
from collections import deque

from ..io.http.schema import HTTPRequestData, HTTPResponseData
from ..native.loader import require_httpfront
from ..sched import Shed
from .server import _SERVICES, CachedRequest, ServingServer

_LOG = logging.getLogger("mmlspark_torch.serving")

_POLL_BATCH = 256


class _NativeCachedRequest(CachedRequest):
    """Replies by id straight into the C++ reactor (exactly once)."""

    def __init__(self, id: str, request: HTTPRequestData, server,
                 native_id: int):
        super().__init__(id=id, request=request)
        self._server = server
        self._native_id = native_id

    def reply(self, response: HTTPResponseData) -> bool:
        # Build the wire bytes BEFORE marking the request answered: a
        # bad header value must fail while the 504 sweep can still take
        # over, not after the exactly-once latch is burned.
        srv = self._server
        body = response.entity or b""
        # every pipeline-set header rides through (Content-Length and
        # Connection are owned by the reactor). CR/LF are stripped from
        # names and values — embedded newlines would otherwise let a
        # header-echoing pipeline be used for response splitting.
        hdrs = dict(response.headers or {})
        hdrs.setdefault("Content-Type", "application/octet-stream")

        def clean(t):
            return str(t).replace("\r", "").replace("\n", "")

        blob = "".join(
            f"{clean(k)}: {clean(v)}\r\n" for k, v in hdrs.items()
            if k.lower() not in ("content-length", "connection")
        ).encode("latin-1", errors="replace")
        if not super().reply(response):
            return False
        srv._lib.hf_reply(srv._handle, self._native_id,
                          int(response.status_code or 500),
                          blob, body, len(body))
        srv.history.pop(self.id, None)
        # same per-route series the threaded front records (obs
        # subsystem); latency runs intake → reply. The request span
        # closes here too — reply() is this front's single exit, on
        # whichever thread delivered the answer (executor, mesh reply
        # hop, or the poller's 504 sweep).
        srv._observe_request(srv.api_path,
                             int(response.status_code or 500),
                             time.perf_counter() - self.created)
        srv._finish_request(self, int(response.status_code or 500))
        return True


class NativeServingServer(ServingServer):
    """ServingServer whose HTTP front is the native epoll reactor."""

    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout: float = 30.0,
                 max_retries: int = 2, max_queue: int = 0,
                 deadline: float = 0.0, max_inflight: int = 0,
                 tenancy=None):
        # raises NativeBuildError with g++'s output: never a quiet
        # fallback to the threaded front
        lib = require_httpfront()
        self._lib = lib
        out_port = ctypes.c_int(0)
        handle = lib.hf_start(host.encode(), port,
                              ctypes.byref(out_port))
        if handle <= 0:
            raise OSError(-handle, "hf_start failed")
        self._handle = handle
        self._init_shared_state(name, api_path, reply_timeout,
                                max_retries, max_queue, deadline=deadline,
                                max_inflight=max_inflight,
                                tenancy=tenancy)
        self.address = (host, out_port.value)
        self._stop = threading.Event()
        self._poller = threading.Thread(target=self._poll_loop,
                                        daemon=True)
        # (deadline, CachedRequest) for 504s, scanned by the poller
        self._deadlines: deque[tuple[float, CachedRequest]] = deque()
        _SERVICES[name] = self

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._poller.start()
        return self

    def stop(self):
        self.scheduler.close()
        self._stop.set()
        self._poller.join(timeout=5)
        self._lib.hf_stop(self._handle)
        _SERVICES.pop(self.name, None)

    # -- intake ------------------------------------------------------------
    def _poll_loop(self):
        lib, h = self._lib, self._handle
        ids = (ctypes.c_uint64 * _POLL_BATCH)()
        meth = ctypes.create_string_buffer(16)
        path_buf = ctypes.create_string_buffer(4096)
        blen = ctypes.c_int64(0)
        hlen = ctypes.c_int64(0)
        while not self._stop.is_set():
            try:
                self._poll_once(lib, h, ids, meth, path_buf, blen, hlen)
            except Exception:
                # one bad request (or route handler) must not kill the
                # single poller — that would brick the whole server,
                # where the threaded front loses only one connection
                _LOG.warning("native poll loop error: %s",
                             traceback.format_exc())

    def _poll_once(self, lib, h, ids, meth, path_buf, blen, hlen):
        n = lib.hf_poll(h, ids, _POLL_BATCH, 50)
        now = time.monotonic()
        # expire overdue requests (replaces the per-request wait()
        # timeout of the threaded front); also shed already-answered
        # entries from the front so the deque tracks in-flight work,
        # not reply_timeout's worth of history
        while self._deadlines and (
                self._deadlines[0][0] <= now
                or self._deadlines[0][1]._event.is_set()):
            _, cached = self._deadlines.popleft()
            cached.reply(HTTPResponseData(
                status_code=504, reason="pipeline timeout"))
        if len(self._deadlines) > 16384:
            # out-of-order completions behind one slow request:
            # compact answered entries wherever they sit
            self._deadlines = deque(
                e for e in self._deadlines
                if not e[1]._event.is_set())
        for i in range(max(int(n), 0)):
            try:
                self._handle_request(lib, h, ids[i], meth, path_buf,
                                     blen, hlen, now)
            except Exception:
                # contain failures per request (the threaded front loses
                # one connection; we answer 500 and keep polling)
                _LOG.warning("native request handling failed: %s",
                             traceback.format_exc())
                lib.hf_reply(h, ids[i], 500, b"", b"", 0)

    def _handle_request(self, lib, h, nid, meth, path_buf, blen, hlen,
                        now):
        if lib.hf_req_info(h, nid, meth, 16, path_buf, 4096,
                           ctypes.byref(blen), ctypes.byref(hlen)) != 0:
            return
        t0 = time.perf_counter()
        body = b""
        if blen.value:
            buf = ctypes.create_string_buffer(blen.value)
            lib.hf_req_body(h, nid, buf)
            body = buf.raw
        headers: dict = {}
        if hlen.value:
            hbuf = ctypes.create_string_buffer(hlen.value)
            lib.hf_req_headers(h, nid, hbuf)
            for line in hbuf.raw.decode("latin-1").split("\r\n"):
                k, sep, v = line.partition(":")
                if sep:
                    headers[k.strip()] = v.strip()
        raw_path = path_buf.value.decode(errors="replace")
        path = raw_path.split("?", 1)[0].rstrip("/") or "/"
        # query-scoped routes first ("/metrics?scope=fleet" is a
        # literal key — same order as the threaded front), then the
        # query-stripped path, then the query-route table (variable
        # query values — /debug/timeline?series=&window=)
        route = None
        query = ""
        if "?" in raw_path:
            query = raw_path.split("?", 1)[1]
            route = self._routes.get(f"{path}?{query}")
        if route is None:
            route = self._routes.get(path)
        if route is None:
            qroute = self._query_routes.get(path)
            if qroute is not None:
                def route(b, _q=query, _h=qroute):
                    return _h(_q, b)
        default_ct = b"Content-Type: application/octet-stream\r\n"
        if route is not None:
            status, out = route(body)
            lib.hf_reply(h, nid, status, default_ct, out, len(out))
            self._observe_request(path, status, time.perf_counter() - t0)
            return
        if path != self.api_path:
            lib.hf_reply(h, nid, 404, default_ct, b"", 0)
            # measured like every other exit — the threaded front records
            # real elapsed time for 404s, and the two series must agree
            self._observe_request(path, 404, time.perf_counter() - t0)
            return
        req = HTTPRequestData(
            url=raw_path, method=meth.value.decode(), headers=headers,
            entity=body or None)
        cached = _NativeCachedRequest(
            id=self._new_id(), request=req, server=self, native_id=nid)
        # span opens before admission (same ordering as the threaded
        # front); reply() closes it on every exit path
        self._start_request_span(cached, path)
        with self._lock:
            self.history[cached.id] = cached
            self._deadlines.append((now + self.reply_timeout, cached))
        try:
            self._admit(cached, path)
        except Shed as s:
            # same contract as the threaded front: 503 on hard queue
            # overflow, 429 + Retry-After on policy sheds
            cached.reply(HTTPResponseData(
                status_code=s.status, reason=f"shed: {s.reason}",
                headers={"Retry-After": str(s.retry_after)}))
