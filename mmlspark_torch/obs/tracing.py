"""Spans and the process-wide tracer (the port's own copy of the JAX
package's ``obs/tracing.py``, with the same span names, ids and events).

The reference has no tracer — only the ``Timer`` transformer and VW's
stopwatches. This is the structured replacement: a
:class:`Span` is a named, timed region with a trace id, a span id, and a
parent id propagated through ``contextvars`` — nest ``tracer.span``
calls and the tree falls out. Spans emit as JSON events through the SAME
logger ``BasicLogging`` writes stage telemetry to
(``mmlspark_torch.telemetry``), so one sink carries both: a traced
LightGBM ``fit`` shows the stage event and its nested boosting-round
spans side by side.

Device time: a span with ``device=True`` additionally wraps the region
in ``torch.profiler.record_function`` so it shows up named in the
``torch.profiler`` captures of ``obs.profile.profile_trace`` and
``obs.xprof`` — wall time on the span, device time in the capture,
correlated by name. torch is imported lazily and only then; this module
imports with the standard library alone and never initializes CUDA.

Cross-thread propagation: ``contextvars`` do not cross ``threading``
boundaries, so hand the parent over explicitly —
``tracer.span("work", parent=parent_span)`` — exactly what the serving
worker pool does per batch.

Cross-PROCESS propagation lives in :mod:`.propagation` (W3C-style
``traceparent`` headers / lease metadata): ``start_span`` accepts any
parent carrying ``trace_id``/``span_id`` attributes, so an extracted
remote context parents a local span directly. Ids are pure lowercase
hex for exactly that reason — they must survive a ``-``-delimited
header field.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from .metrics import registry as _registry

# the BasicLogging sink, by name (NOT by import: core imports obs for
# span linkage, so obs importing core back would cycle)
_TELEMETRY = logging.getLogger("mmlspark_torch.telemetry")

_ids = itertools.count(1)
_id_lock = threading.Lock()
_PROC = f"{os.getpid():x}"

# Wall-clock anchor taken ONCE at import: span timestamps are civil time
# for trace viewers, but deriving them from the monotonic clock after
# this single read means an NTP step mid-run can never make a child span
# appear to start before its parent (and no deadline-path code ever
# reads time.time()).
_WALL0 = time.time()
_PERF0 = time.perf_counter()


def wall_now() -> float:
    """Epoch seconds derived from the monotonic clock (one wall read at
    import, monotonic deltas after) — the timestamp base for every span."""
    return _WALL0 + (time.perf_counter() - _PERF0)


def _new_id() -> str:
    # pure hex (no separators): ids travel inside W3C-style traceparent
    # headers where "-" delimits fields. The zero-padded counter keeps
    # pid-prefix + counter concatenation collision-free per process.
    with _id_lock:
        return f"{_PROC}{next(_ids):06x}"


@dataclass
class Span:
    """One named, timed region. ``seconds`` is None until the span ends."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    attrs: dict = field(default_factory=dict)
    start_wall: float = 0.0       # epoch seconds (event timestamps)
    seconds: float | None = None  # wall duration, set at end
    error: str | None = None
    proc: str = ""                # emitting process (hex pid)
    _t0: float = 0.0              # perf_counter anchor

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def to_dict(self) -> dict:
        """Wire/export form — the same field names ``Tracer._emit``
        writes to the telemetry log, so a span serialized into a mesh
        reply and a span grepped from the log read identically."""
        payload = {
            "event": "span",
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startWall": self.start_wall,
            "seconds": self.seconds,
            "proc": self.proc or _PROC,
        }
        if self.attrs:
            payload["attrs"] = {k: v for k, v in self.attrs.items()
                                if isinstance(v, (str, int, float, bool,
                                                  type(None)))}
        if self.error is not None:
            payload["error"] = self.error
        return payload


_current_span: contextvars.ContextVar[Span | None] = \
    contextvars.ContextVar("mmlspark_torch_obs_span", default=None)

_UNSET = object()


class Tracer:
    """Creates spans, propagates parentage, emits span events.

    ``metric`` (a histogram name) records each span's wall seconds into
    the metrics registry labeled by span name — tracing and metrics stay
    one subsystem, not two."""

    def __init__(self, registry=None, metric: str | None = None):
        self.registry = registry if registry is not None else _registry
        self.metric = metric
        # finished-span sinks (the flight recorder / test collectors):
        # called on EVERY end_span regardless of the logging gate
        self._sinks: list = []

    # -- context -----------------------------------------------------------
    def current_span(self) -> Span | None:
        return _current_span.get()

    # -- sinks -------------------------------------------------------------
    def add_sink(self, sink) -> None:
        """Register ``sink(span)`` to receive every finished span
        (idempotent). Sinks run on the ending thread and must be cheap
        and never raise — the flight recorder's collection hook."""
        if sink not in self._sinks:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        try:
            self._sinks.remove(sink)
        except ValueError:
            pass

    # -- span lifecycle ----------------------------------------------------
    def start_span(self, name: str, *, parent=_UNSET,
                   current: bool = True, **attrs) -> Span:
        """Begin a span. Prefer the ``span(...)`` context manager; this
        begin/end surface exists for regions that cannot nest a ``with``
        block (e.g. a loop body with breaks). Every ``start_span`` must
        be paired with ``end_span``. ``current=False`` records parentage
        without touching the ambient context — children must then name
        this span as ``parent=`` explicitly, but an unpaired end can
        never corrupt the context of unrelated spans."""
        if parent is _UNSET:
            parent = _current_span.get()
        # duck-typed parentage: a Span OR any context carrying
        # trace_id/span_id (a propagation.TraceContext extracted from a
        # remote hop) parents this span into its trace
        tid = getattr(parent, "trace_id", None)
        if tid is not None:
            trace_id, parent_id = tid, getattr(parent, "span_id", None)
        else:
            trace_id, parent_id = _new_id(), None
        span = Span(name=name, trace_id=trace_id, span_id=_new_id(),
                    parent_id=parent_id, attrs=dict(attrs),
                    start_wall=wall_now(), proc=_PROC,
                    _t0=time.perf_counter())
        if current:
            span._token = _current_span.set(span)
        return span

    def end_span(self, span: Span, error: BaseException | None = None,
                 emit: bool = True) -> Span:
        if getattr(span, "_done", False):
            return span  # already ended (loop break + fallthrough)
        span._done = True
        span.seconds = time.perf_counter() - span._t0
        if error is not None:
            span.error = repr(error)
        token = getattr(span, "_token", None)
        if token is not None:
            span._token = None
            try:
                _current_span.reset(token)
            except ValueError:
                # ended from a different context than it started in
                # (cross-thread hand-off); parentage is already recorded
                pass
        if emit:
            self._emit(span)
        if self.metric is not None:
            self.registry.histogram(
                self.metric, "span wall seconds").observe(
                    span.seconds, span=span.name)
        return span

    @contextlib.contextmanager
    def span(self, name: str, *, parent=_UNSET, device: bool = False,
             **attrs):
        """``with tracer.span("stage.fit", rows=n) as sp: ...``

        ``parent``: explicit parent Span (or None to force a new root) —
        required when crossing a thread boundary. ``device=True`` also
        annotates the region for ``torch.profiler`` captures."""
        span = self.start_span(name, parent=parent, **attrs)
        ann = None
        if device:
            try:
                import torch.profiler
                ann = torch.profiler.record_function(name)
                ann.__enter__()
            except Exception:
                ann = None
        try:
            yield span
        except BaseException as e:
            self.end_span(span, error=e)
            raise
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self.end_span(span)

    # -- retroactive spans -------------------------------------------------
    def emit_span(self, name: str, *, parent, seconds: float,
                  start_wall: float | None = None,
                  error: str | None = None, **attrs) -> Span:
        """Synthesize an already-measured span — for durations observed
        after the fact (a queue wait known only at pop time, a worker's
        share of a batch). ``parent`` is a Span / TraceContext / None;
        ``start_wall`` defaults to ``now - seconds``."""
        tid = getattr(parent, "trace_id", None)
        if tid is not None:
            trace_id, parent_id = tid, getattr(parent, "span_id", None)
        else:
            trace_id, parent_id = _new_id(), None
        seconds = max(float(seconds), 0.0)
        span = Span(name=name, trace_id=trace_id, span_id=_new_id(),
                    parent_id=parent_id, attrs=dict(attrs),
                    start_wall=(wall_now() - seconds
                                if start_wall is None else start_wall),
                    seconds=seconds, error=error, proc=_PROC)
        span._done = True
        self._emit(span)
        if self.metric is not None:
            self.registry.histogram(
                self.metric, "span wall seconds").observe(
                    span.seconds, span=span.name)
        return span

    # -- emission ----------------------------------------------------------
    def _emit(self, span: Span) -> None:
        # sinks first, and unconditionally: the flight recorder must see
        # spans even when nobody listens to the telemetry log
        for sink in self._sinks:
            try:
                sink(span)
            except Exception:
                pass  # a broken sink must never kill the traced code
        # same gate BasicLogging rides on: when nothing listens at INFO
        # the span costs two clock reads and a few dict ops, no json
        if not _TELEMETRY.isEnabledFor(logging.INFO):
            return
        _TELEMETRY.info(json.dumps(span.to_dict()))


# THE process-wide tracer (parallel to ``metrics.registry``).
tracer = Tracer()


class StageTimer:
    """Accumulate named wall-clock spans (the VW ``TrainingStats``
    nanosecond-timing surface, reference ``vw/VowpalWabbitBase.scala:27-49``).

    Subsumed by the obs tracer: each ``span`` both nests in the ambient
    trace (so it shows up in the telemetry sink with parentage) and
    accumulates into ``totals_ns`` — the original surface callers keep.
    """

    def __init__(self, tracer_: Tracer | None = None):
        self.totals_ns: dict[str, int] = {}
        self._tracer = tracer_ or tracer

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            with self._tracer.span(name):
                yield
        finally:
            self.totals_ns[name] = self.totals_ns.get(name, 0) + \
                time.perf_counter_ns() - t0

    def as_dict(self) -> dict[str, float]:
        return {k: v / 1e9 for k, v in self.totals_ns.items()}
