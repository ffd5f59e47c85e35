"""Native load generator binding — honest loaded-tail measurement.

A Python ``http.client`` worker holds the GIL for each request it
sends, so a 16-way closed loop from Python caps its rate CLIENT-side and
the "loaded p99" mostly measures the load generator (which also steals
the GIL from the very server under test). ``loadgen.cpp`` drives the same
closed loop from C++ threads (keep-alive, TCP_NODELAY, strict
request-response); this module shapes its raw latencies into the same
percentile summary the benches bank.

With ``retry=True`` the client honors ``Retry-After`` on 429/503 sheds
with ONE bounded re-attempt per request (the resilience contract: back
off as told, re-offer once). Retried requests come back with status
``+1000`` (1200 = 200 on the re-attempt) and are reported as their own
``retried`` / ``retried_ok`` columns — retry traffic never blends into
the first-offer percentiles.

Trace correlation (obs subsystem): every request carries a
DETERMINISTIC traceparent — trace id ``<prefix><conn:4hex><req:8hex>``
— so the summary can reconstruct the trace ids of the p99-slowest
requests (``slowest`` column) and a bench outlier becomes a lookup key
into the server's flight recorder (``GET /debug/trace``).

Multi-tenant loads (sched.tenancy): ``run_load(..., tenants=[...])``
stamps ``X-Tenant`` per connection (lg_run5) and splits the summary
per tenant — a gold tenant's p99 and a best-effort tenant's shed rate
never blend into one column.

The port of ``mmlspark_tpu/serving/loadgen.py``, over the port's own
copy of ``loadgen.cpp`` (``native/src``), built with g++ at first use.
"""

from __future__ import annotations

import ctypes
import uuid

import numpy as np

from ..native.loader import NativeLoader

_loader = NativeLoader("loadgen", ["loadgen.cpp"])

# statuses >= this mark a request answered on the bounded Retry-After
# re-attempt (loadgen.cpp encodes final_status + 1000)
_RETRIED_BASE = 1000


def trace_id_of(trace_prefix: str, conn: int, req: int) -> str:
    """The trace id loadgen.cpp stamped on request ``req`` of
    connection ``conn`` (the reconstruction contract both sides share)."""
    return f"{trace_prefix}{conn:04x}{req:08x}"


def _slowest_trace_ids(steady_lat: np.ndarray, ok: np.ndarray,
                       warmup_offset: int, trace_prefix: str,
                       top: int = 8) -> list[dict]:
    """Trace ids of the p99-slowest first-offer successes (at least the
    single slowest), slowest first — the flight-recorder lookup keys."""
    ci, ri = np.nonzero(ok)
    if not len(ci):
        return []
    lats = steady_lat[ci, ri]
    thr = float(np.percentile(lats, 99))
    order = np.argsort(-lats)
    picks = [j for j in order if lats[j] >= thr][:top] \
        or [int(order[0])]
    return [{"trace_id": trace_id_of(trace_prefix, int(ci[j]),
                                     int(ri[j]) + warmup_offset),
             "ms": round(float(lats[j]), 3)}
            for j in picks]


def summarize(lat: np.ndarray, status: np.ndarray, wall_s: float,
              warmup: int = 20, trace_prefix: str | None = None,
              tenants: list[str] | None = None,
              ttft: np.ndarray | None = None,
              versions=None) -> dict:
    """Shape raw per-request ``(latency_ms, http_status)`` matrices
    (connection-major ``[nconn, nreq]``; status -1 = transport failure,
    status >= 1000 = answered on a Retry-After re-attempt) into the
    bench summary. Split out so the shaping is testable without the
    native client.

    Success percentiles (``p50_ms``/``p99_ms``/``loaded_p99_ms``) cover
    ONLY first-offer 2xx round trips: a 429 shed answers in
    microseconds, so folding sheds into the latency columns would let
    an overloaded server look *faster* as it sheds more — and a retried
    request is not first-offer load, so it reports separately
    (``retried`` = re-attempts taken, ``retried_ok`` = re-attempts that
    landed 2xx). Non-2xx traffic is reported on its own — ``shed``
    (final outcome 429, whether on first offer or still shed on the
    re-attempt), ``rejected`` (other non-2xx), ``transport_errors`` —
    plus ``shed_rate`` over completed round trips; a shed that a
    re-attempt then answered counts in ``retried_ok``, not ``shed``.
    ``throughput_rps`` counts 2xx only (work actually served, retried
    or not); ``completed_rps`` keeps the old every-round-trip rate.

    ``tenants`` (one name per connection — lg_run5 stamps X-Tenant per
    connection) additionally splits the summary per tenant under a
    ``tenants`` key: mixed-workload bench numbers stay honest only if
    a gold tenant's p99 and a best-effort tenant's shed rate never
    blend into one column.

    ``ttft`` (generation mode — lg_run6's time-to-first-byte matrix,
    same connection-major shape and -1-on-failure convention as
    ``lat``) adds ``ttft_p50_ms``/``ttft_p99_ms`` over the SAME
    first-offer-success mask as the latency percentiles, globally and
    per tenant: an LLM front replies when the first token exists, so
    first-byte time is the client-observed time-to-first-token and the
    per-tenant split keeps a gold tenant's TTFT p99 honest under mixed
    load.

    ``versions`` (deploy plane — the ``X-Model-Version`` label each
    RESPONSE carried, connection-major like ``lat``; empty string =
    unversioned) splits p50/p99/error-rate per observed version under
    a ``versions`` key. Unlike the per-connection ``tenants`` row
    selection, a blue/green flip lands MID-connection, so this split
    is a per-request mask over the steady-state window — it is how a
    bench proves the flip from the client side (old version's
    percentiles before, new version's after, no error spike between)."""
    if not (status >= 0).any():
        raise RuntimeError("loadgen: every request failed")
    retried_all = status >= _RETRIED_BASE
    final = np.where(retried_all, status - _RETRIED_BASE, status)
    nreq = lat.shape[1]
    steady_lat = lat[:, warmup:] if nreq > warmup else lat
    steady_st = final[:, warmup:] if nreq > warmup else final
    steady_retried = retried_all[:, warmup:] if nreq > warmup \
        else retried_all
    ok = (steady_st >= 200) & (steady_st < 300) & ~steady_retried
    # an overloaded run can shed EVERYTHING: percentiles go NaN (there
    # is no success latency to report), the shed/rejected counts stand
    ok_lat = steady_lat[ok] if ok.any() else np.asarray([np.nan])
    ttft_ok = None
    if ttft is not None:
        steady_ttft = ttft[:, warmup:] if nreq > warmup else ttft
        good = ok & (steady_ttft >= 0)
        ttft_ok = steady_ttft[good] if good.any() \
            else np.asarray([np.nan])
    per_conn_p99 = [float(np.percentile(row[m], 99))
                    for row, m in zip(steady_lat, ok) if m.any()] \
        or [float("nan")]
    all_ok = (final >= 200) & (final < 300)
    completed = int((final >= 0).sum())
    # the FINAL outcome classifies: a request still shed on its bounded
    # re-attempt (1429) is a shed — excluding it would understate
    # shed_rate exactly when shedding is heaviest
    shed = int((final == 429).sum())
    slowest = [] if trace_prefix is None else _slowest_trace_ids(
        steady_lat, ok, warmup if nreq > warmup else 0, trace_prefix)
    by_tenant = {}
    if tenants:
        # tenant is constant per connection (lg_run5 stamps X-Tenant at
        # connect), so the split is a row selection on the
        # connection-major matrices — each tenant re-runs the same
        # shaping over its own rows (recursion bottoms out: the
        # sub-call passes tenants=None)
        for name in dict.fromkeys(tenants):   # stable unique order
            rows = [c for c, t in enumerate(tenants) if t == name]
            try:
                sub = summarize(lat[rows], status[rows], wall_s,
                                warmup=warmup,
                                ttft=None if ttft is None
                                else ttft[rows])
            except RuntimeError:
                # every one of this tenant's requests failed: report
                # the failure count rather than erasing the tenant
                sub = {"transport_errors":
                       int((status[rows] < 0).sum())}
            by_tenant[name] = {k: sub[k] for k in (
                "p50_ms", "p99_ms", "ttft_p50_ms", "ttft_p99_ms",
                "shed", "shed_rate", "retried", "retried_ok",
                "rejected", "throughput_rps",
                "transport_errors") if k in sub}
    by_version = {}
    if versions is not None:
        va = np.asarray(versions, dtype=object)
        steady_ver = va[:, warmup:] if nreq > warmup else va
        seen = dict.fromkeys(v for row in np.asarray(versions,
                                                     dtype=object)
                             for v in row if v)
        for name in seen:
            vmask = steady_ver == name
            v_ok = ok & vmask
            v_lat = steady_lat[v_ok] if v_ok.any() \
                else np.asarray([np.nan])
            v_final = steady_st[vmask]
            n = int((v_final >= 0).sum())
            # errors here = any non-2xx final outcome on this
            # version's responses (sheds included: a version that
            # sheds its riders is not serving them)
            errs = int(((v_final >= 0) & ((v_final < 200) |
                                          (v_final >= 300))).sum())
            by_version[name] = {
                "n": n,
                "p50_ms": float(np.percentile(v_lat, 50)),
                "p99_ms": float(np.percentile(v_lat, 99)),
                "errors": errs,
                "error_rate": errs / max(n, 1),
            }
    out_ttft = {} if ttft_ok is None else {
        "ttft_p50_ms": float(np.percentile(ttft_ok, 50)),
        "ttft_p99_ms": float(np.percentile(ttft_ok, 99)),
    }
    return {
        **out_ttft,
        "tenants": by_tenant,
        "versions": by_version,
        "slowest": slowest,
        "p50_ms": float(np.percentile(ok_lat, 50)),
        "p99_ms": float(np.percentile(ok_lat, 99)),
        "loaded_p99_ms": max(per_conn_p99),
        "throughput_rps": int(all_ok.sum()) / max(wall_s, 1e-9),
        "completed_rps": completed / max(wall_s, 1e-9),
        "shed": shed,
        "shed_rate": shed / max(completed, 1),
        "retried": int(retried_all.sum()),
        "retried_ok": int((retried_all & all_ok).sum()),
        "rejected": int(((final >= 0) & ~all_ok & (final != 429)).sum()),
        "transport_errors": int((final < 0).sum()),
        "errors": int(((final < 0) | ((final >= 0) & ~all_ok)).sum()),
    }


def run_load(host: str, port: int, payload: bytes, *, nconn: int = 16,
             nreq: int = 300, path: str = "/",
             warmup: int = 20, retry: bool = False,
             trace: bool = True,
             tenants: list[str] | None = None,
             ttft: bool = False) -> dict:
    """Closed-loop load: ``nconn`` keep-alive connections, ``nreq``
    serial POSTs each; see :func:`summarize` for the returned summary
    (success-only percentiles; 429 sheds and other non-2xx reported
    separately with ``shed_rate``). ``retry=True`` honors Retry-After
    on 429/503 with one bounded re-attempt per request, reported under
    ``retried``/``retried_ok``. ``trace=True`` (default) stamps every
    request with a deterministic traceparent and reports the
    p99-slowest requests' trace ids under ``slowest`` — look them up at
    the server's ``GET /debug/trace``. ``tenants`` assigns connection
    ``c`` the tenant ``tenants[c % len]``, stamped as ``X-Tenant`` on
    every request (lg_run5) and split out per tenant in the summary's
    ``tenants`` key. ``ttft=True`` (generation mode, lg_run6)
    additionally records each request's time-to-first-byte and adds
    ``ttft_p50_ms``/``ttft_p99_ms`` globally and per tenant. Raises
    when nothing could connect."""
    lib = _loader.load()
    # 20 hex prefix + 4 (conn) + 8 (req) = a 32-hex W3C-shaped trace id
    trace_prefix = uuid.uuid4().hex[:20] if trace else None
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.lg_run6.restype = ctypes.c_long
    lib.lg_run6.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
        dptr, ctypes.POINTER(ctypes.c_int), dptr, dptr]
    lat = np.empty(nconn * nreq, np.float64)
    status = np.empty(nconn * nreq, np.int32)
    first = np.empty(nconn * nreq, np.float64) if ttft else None
    wall = ctypes.c_double(0.0)
    errors = int(lib.lg_run6(
        host.encode(), int(port), int(nconn), int(nreq), path.encode(),
        payload, len(payload), 1 if retry else 0,
        (trace_prefix or "").encode(),
        ",".join(tenants or []).encode(),
        lat.ctypes.data_as(dptr),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        first.ctypes.data_as(dptr) if first is not None else None,
        ctypes.byref(wall)))
    if errors < 0:
        raise RuntimeError("loadgen: no connection could be "
                           "established")
    conn_tenants = [tenants[c % len(tenants)]
                    for c in range(nconn)] if tenants else None
    return summarize(lat.reshape(nconn, nreq),
                     status.reshape(nconn, nreq), wall.value,
                     warmup=warmup, trace_prefix=trace_prefix,
                     tenants=conn_tenants,
                     ttft=None if first is None
                     else first.reshape(nconn, nreq))
