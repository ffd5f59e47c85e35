"""Telemetry logging wrapped around stage entry points.

Role of reference ``logging/BasicLogging.scala:26-92``: every stage logs a
JSON event ``{uid, className, method, buildVersion}`` on construction and on
each fit/transform/predict, plus error events with the exception. Here it is a
context manager so the wrapped region is timed as well (the reference pairs
this with its ``Timer`` stage; we fold wall time into the event).

Each ``log_call`` region is also an obs tracer span (``obs.tracing``)
named ``Class.method``: the event carries ``traceId``/``spanId``/``parentId``,
and any spans opened inside the call — boosting rounds, profiled steps —
nest under it in the same JSON sink. The span itself emits no separate
line here (the stage event IS the span record), so consumers see one event
per call, with trace linkage, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

from ..obs.tracing import tracer as _tracer

logger = logging.getLogger("mmlspark_torch.telemetry")

BUILD_VERSION = "0.1.0"


class BasicLogging:
    def _log_event(self, method: str, **extra) -> None:
        payload = {
            "uid": getattr(self, "uid", None),
            "className": type(self).__name__,
            "method": method,
            "buildVersion": BUILD_VERSION,
            **extra,
        }
        logger.info(json.dumps(payload))

    def log_class(self) -> None:
        self._log_event("constructor")

    @contextlib.contextmanager
    def log_call(self, method: str):
        start = time.perf_counter()
        # the span carries parentage for anything traced inside the call;
        # emission stays with _log_event below (one line per call)
        span = _tracer.start_span(f"{type(self).__name__}.{method}",
                                  uid=getattr(self, "uid", None))
        link = {"traceId": span.trace_id, "spanId": span.span_id,
                "parentId": span.parent_id}
        try:
            yield
        except BaseException as e:
            # BaseException, not Exception: a KeyboardInterrupt thrown
            # into the region must still end the span, or the ambient
            # contextvar keeps pointing at it and every later span in
            # this thread parents under a dead trace
            _tracer.end_span(span, error=e, emit=False)
            self._log_event(method, error=repr(e),
                            seconds=time.perf_counter() - start, **link)
            raise
        else:
            _tracer.end_span(span, emit=False)
            self._log_event(method, seconds=time.perf_counter() - start,
                            **link)
