"""Telemetry logging wrapped around stage entry points.

Role of reference ``logging/BasicLogging.scala:26-92``: every stage logs a
JSON event ``{uid, className, method, buildVersion}`` on construction and on
each fit/transform/predict, plus error events with the exception. Here it is a
context manager so the wrapped region is timed as well (the reference pairs
this with its ``Timer`` stage; we fold wall time into the event).

The JAX package also opens a tracer span per call; the port's tracing plane
comes with the observability slice, so events here carry no trace ids.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

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
        try:
            yield
        except BaseException as e:
            self._log_event(method, error=repr(e),
                            seconds=time.perf_counter() - start)
            raise
        else:
            self._log_event(method, seconds=time.perf_counter() - start)
