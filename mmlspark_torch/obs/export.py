"""Span-tree export: Chrome-trace/Perfetto JSON + the flight recorder.

The port's own copy of the JAX package's ``obs/export.py`` (stdlib only;
no JAX import), with the same names, series and wire forms.

Spans emit as flat JSON events (one per ``end_span``); this module turns
them back into openable artifacts:

- :func:`chrome_trace` — Chrome trace-event JSON (``chrome://tracing``
  and Perfetto both load it): one complete ``"X"`` event per span,
  ``pid`` = emitting process, ``tid`` = trace id, so each request's
  cross-process tree renders as one track per process.

- :class:`SpanCollector` — a bounded tracer sink retaining EVERY
  finished span (tests and short captures; not for always-on use).

- :class:`FlightRecorder` — the always-on ring buffer: collects spans
  per trace, and when the serving layer reports a finished request
  (:meth:`FlightRecorder.note_request`) keeps the full cross-process
  tree for the N slowest and the N most recent errored requests,
  dropping everything else. ``GET /debug/trace`` on both serving fronts
  serves :func:`debug_trace_payload` — the retained trees as one
  Chrome trace plus per-trace summaries, so a p99 outlier's trace_id
  (printed by the load generator) can be looked up minutes later.

Stdlib-only, backend-free, bounded everywhere: an always-on server must
never grow an unbounded span store.
"""

from __future__ import annotations

import collections
import heapq
import json
import threading

from .metrics import registry as _registry
from .tracing import Span, tracer as _tracer

# spans a single trace may retain (a runaway span loop inside one
# request must not evict every other trace's tree)
MAX_SPANS_PER_TRACE = 512


def _span_dict(span) -> dict:
    return span.to_dict() if isinstance(span, Span) else dict(span)


def _tid_of(trace_id: str) -> int:
    """Stable positive int track id from a hex-ish trace id."""
    try:
        return int(trace_id[-8:], 16) % (1 << 31) or 1
    except (ValueError, TypeError):
        return abs(hash(trace_id)) % (1 << 31) or 1


def chrome_trace(spans, *, extra_metadata: dict | None = None) -> dict:
    """Chrome trace-event JSON from finished spans (Span objects or
    their ``to_dict`` forms). Timestamps are the spans' wall-derived
    ``startWall`` in microseconds; each span is a complete ``X`` event."""
    events: list[dict] = []
    procs: dict[str, int] = {}
    for sp in spans:
        d = _span_dict(sp)
        proc = str(d.get("proc") or "?")
        pid = procs.setdefault(proc, len(procs) + 1)
        seconds = d.get("seconds") or 0.0
        event = {
            "ph": "X",
            "name": d.get("name", ""),
            "cat": "span",
            "ts": float(d.get("startWall") or 0.0) * 1e6,
            "dur": float(seconds) * 1e6,
            "pid": pid,
            "tid": _tid_of(str(d.get("traceId", ""))),
            "args": {
                "traceId": d.get("traceId"),
                "spanId": d.get("spanId"),
                "parentId": d.get("parentId"),
                **(d.get("attrs") or {}),
            },
        }
        if d.get("error"):
            event["args"]["error"] = d["error"]
        events.append(event)
    for proc, pid in procs.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"proc {proc}"}})
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if extra_metadata:
        out["metadata"] = dict(extra_metadata)
    return out


class SpanCollector:
    """Bounded collect-everything sink for tests and short captures:
    ``with SpanCollector() as spans: ...`` then inspect/export."""

    def __init__(self, maxlen: int = 65536, tracer=None):
        self._tracer = tracer if tracer is not None else _tracer
        self._lock = threading.Lock()
        self._spans = collections.deque(maxlen=int(maxlen))

    def __enter__(self) -> "SpanCollector":
        self._tracer.add_sink(self._on_span)
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.remove_sink(self._on_span)

    def _on_span(self, span) -> None:
        with self._lock:
            self._spans.append(_span_dict(span))

    def ingest(self, span_dicts) -> None:
        """Fold remotely-collected spans (wire dicts) in."""
        with self._lock:
            for d in span_dicts:
                self._spans.append(dict(d))

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def by_trace(self) -> dict[str, list[dict]]:
        out: dict[str, list[dict]] = {}
        for d in self.spans():
            out.setdefault(str(d.get("traceId", "")), []).append(d)
        return out

    def names_by_trace(self) -> dict[str, set]:
        return {t: {d.get("name") for d in ds}
                for t, ds in self.by_trace().items()}


class FlightRecorder:
    """Always-on retention of the N slowest / errored requests' full
    cross-process span trees.

    Collection: :meth:`install` subscribes to the tracer, so every local
    span lands in a bounded pending bucket keyed by trace id; remote
    spans arrive through :meth:`ingest` (the mesh reply payload carries
    the worker's spans home). Retention: the serving layer calls
    :meth:`note_request` when a request finishes; errored requests and
    the slowest ``keep_slowest`` go to the kept store, everything else
    ages out of pending FIFO.
    """

    def __init__(self, keep_slowest: int = 32, keep_errored: int = 32,
                 max_pending: int = 1024, registry=None, tracer=None):
        reg = registry if registry is not None else _registry
        self.keep_slowest = int(keep_slowest)
        self.keep_errored = int(keep_errored)
        self.max_pending = int(max_pending)
        self._tracer = tracer if tracer is not None else _tracer
        self._lock = threading.Lock()
        self._installed = False
        #: trace_id -> list[span dict] (insertion-ordered, FIFO evicted)
        self._pending: collections.OrderedDict[str, list] = \
            collections.OrderedDict()
        #: kept trees: trace_id -> {"seconds","status","error","spans"}
        self._kept: dict[str, dict] = {}
        #: min-heap of (seconds, trace_id) over kept-for-slowness traces
        self._slow_heap: list[tuple[float, str]] = []
        #: errored trace ids, FIFO bounded
        self._errored: collections.deque = collections.deque()
        self._c_traces = reg.counter(
            "profile_flight_traces_total",
            "flight-recorder retention decisions, by outcome")

    # -- collection --------------------------------------------------------
    def install(self, tracer=None) -> "FlightRecorder":
        """Subscribe to the tracer (idempotent). The serving fronts call
        this from ``_init_shared_state``."""
        with self._lock:
            if self._installed:
                return self
            self._installed = True
        (tracer if tracer is not None else self._tracer) \
            .add_sink(self._on_span)
        return self

    def _on_span(self, span) -> None:
        self._add(_span_dict(span))

    def ingest(self, span_dicts) -> None:
        """Fold spans collected in ANOTHER process in (mesh replies
        carry the worker's spans; dedup by spanId per trace)."""
        for d in span_dicts or ():
            self._add(dict(d))

    def _add(self, d: dict) -> None:
        trace_id = str(d.get("traceId") or "")
        if not trace_id:
            return
        with self._lock:
            kept = self._kept.get(trace_id)
            if kept is not None:
                # late spans for a kept trace (a worker's reply payload
                # landing after note_request) complete the tree
                if len(kept["spans"]) < MAX_SPANS_PER_TRACE and \
                        not any(s.get("spanId") == d.get("spanId")
                                for s in kept["spans"]):
                    kept["spans"].append(d)
                return
            bucket = self._pending.get(trace_id)
            if bucket is None:
                bucket = self._pending[trace_id] = []
                while len(self._pending) > self.max_pending:
                    self._evict_one_pending_locked()
                    self._c_traces.inc(1, outcome="evicted")
            if len(bucket) < MAX_SPANS_PER_TRACE and \
                    not any(s.get("spanId") == d.get("spanId")
                            for s in bucket):
                bucket.append(d)

    def pending_spans(self, *, drain: bool = False,
                      max_spans: int = 256) -> list[dict]:
        """Flat copy of pending (not-yet-retained) spans, oldest trace
        first, bounded by ``max_spans``. With ``drain=True`` the copied
        spans are removed — a mesh worker's heartbeat flushes its local
        recorder home this way, so spans for a request that never
        replies (worker death) still reach the ingest-side recorder
        instead of rotting in the worker's pending ring."""
        out: list[dict] = []
        with self._lock:
            for tid in list(self._pending):
                if len(out) >= max_spans:
                    break
                bucket = self._pending[tid]
                take = bucket[:max_spans - len(out)]
                out.extend(dict(s) for s in take)
                if drain:
                    rest = bucket[len(take):]
                    if rest:
                        self._pending[tid] = rest
                    else:
                        del self._pending[tid]
        return out

    def mark_incomplete(self, trace_id: str,
                        reason: str = "worker lost") -> bool:
        """The process emitting part of this trace died mid-request
        (lease replay after worker death): promote whatever spans made
        it home into the kept store, flagged ``incomplete``, so
        ``/debug/trace`` shows a closed — not orphaned — tree. If the
        trace was already kept, just flags it. False when the trace is
        unknown on this recorder."""
        trace_id = str(trace_id or "")
        if not trace_id:
            return False
        with self._lock:
            kept = self._kept.get(trace_id)
            if kept is not None:
                kept["incomplete"] = True
                kept["note"] = reason
                return True
            spans = self._pending.pop(trace_id, None)
            if spans is None:
                return False
            self._kept[trace_id] = {
                "seconds": 0.0, "status": 0, "error": True,
                "incomplete": True, "note": reason, "spans": spans}
            self._errored.append(trace_id)
            if len(self._errored) > self.keep_errored:
                old = self._errored.popleft()
                self._kept.pop(old, None)
            self._c_traces.inc(1, outcome="kept_incomplete")
            return True

    def _evict_one_pending_locked(self) -> None:
        """Evict the oldest SINGLE-span pending trace first: the steady
        stream of lone root spans (an outbound ``http.send`` with no
        ambient parent opens a fresh one-span trace that will never see
        a ``note_request``) must not flush a multi-span request tree
        that is still in flight — exactly the slow request the recorder
        exists to keep. Falls back to plain FIFO when every pending
        trace is multi-span."""
        for tid, bucket in self._pending.items():
            if len(bucket) <= 1:
                del self._pending[tid]
                return
        self._pending.popitem(last=False)

    # -- retention ---------------------------------------------------------
    def note_request(self, trace_id: str, seconds: float, *,
                     status: int = 200, error: bool = False) -> None:
        """A request finished: decide whether its tree survives.
        Errored requests always keep (FIFO-bounded); others compete on
        ``seconds`` for the ``keep_slowest`` slots."""
        trace_id = str(trace_id or "")
        if not trace_id:
            return
        error = bool(error) or int(status) >= 500
        with self._lock:
            prior = self._kept.get(trace_id)
            if prior is not None:
                if prior.get("incomplete"):
                    # the replayed request completed elsewhere — record
                    # the real outcome, keep the incomplete flag
                    prior["seconds"] = float(seconds)
                    prior["status"] = int(status)
                return
            spans = self._pending.pop(trace_id, [])
            if error:
                self._kept[trace_id] = {
                    "seconds": float(seconds), "status": int(status),
                    "error": True, "spans": spans}
                self._errored.append(trace_id)
                if len(self._errored) > self.keep_errored:
                    old = self._errored.popleft()
                    self._kept.pop(old, None)
                self._c_traces.inc(1, outcome="kept_error")
                return
            if len(self._slow_heap) < self.keep_slowest:
                heapq.heappush(self._slow_heap,
                               (float(seconds), trace_id))
            elif self._slow_heap and \
                    float(seconds) > self._slow_heap[0][0]:
                _, evicted = heapq.heapreplace(
                    self._slow_heap, (float(seconds), trace_id))
                self._kept.pop(evicted, None)
                self._c_traces.inc(1, outcome="evicted")
            else:
                self._c_traces.inc(1, outcome="dropped")
                return
            self._kept[trace_id] = {
                "seconds": float(seconds), "status": int(status),
                "error": False, "spans": spans}
            self._c_traces.inc(1, outcome="kept_slow")

    # -- read surface ------------------------------------------------------
    def trees(self) -> list[dict]:
        """Kept trees, slowest first: ``{trace_id, seconds, status,
        error, spans}`` — ``spans`` are wire dicts."""
        with self._lock:
            items = [{"trace_id": t, "seconds": k["seconds"],
                      "status": k["status"], "error": k["error"],
                      "incomplete": bool(k.get("incomplete")),
                      "spans": [dict(s) for s in k["spans"]]}
                     for t, k in self._kept.items()]
        return sorted(items, key=lambda d: -d["seconds"])

    def tree(self, trace_id: str) -> dict | None:
        with self._lock:
            k = self._kept.get(str(trace_id))
            if k is None:
                return None
            return {"trace_id": str(trace_id), "seconds": k["seconds"],
                    "status": k["status"], "error": k["error"],
                    "incomplete": bool(k.get("incomplete")),
                    "spans": [dict(s) for s in k["spans"]]}

    def chrome(self) -> dict:
        """All retained trees as one Chrome trace."""
        trees = self.trees()
        spans = [s for t in trees for s in t["spans"]]
        return chrome_trace(spans, extra_metadata={
            "kept_traces": len(trees)})

    def clear(self) -> None:
        with self._lock:
            self._pending.clear()
            self._kept.clear()
            self._slow_heap.clear()
            self._errored.clear()


#: THE process-wide flight recorder (the serving fronts install + feed it).
flight_recorder = FlightRecorder()


def debug_trace_payload(recorder: FlightRecorder | None = None) -> bytes:
    """The ``GET /debug/trace`` body: retained-trace summaries plus the
    combined Chrome trace — save it as ``.json`` and open in Perfetto."""
    rec = recorder if recorder is not None else flight_recorder
    trees = rec.trees()
    payload = {
        "kept": len(trees),
        "traces": [{"trace_id": t["trace_id"],
                    "seconds": round(t["seconds"], 6),
                    "status": t["status"], "error": t["error"],
                    "incomplete": t.get("incomplete", False),
                    "spans": len(t["spans"])}
                   for t in trees],
        **rec.chrome(),
    }
    return json.dumps(payload).encode()
