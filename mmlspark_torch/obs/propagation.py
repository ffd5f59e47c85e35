"""Cross-process trace propagation: W3C-style ``traceparent`` carriers.

The port's own copy of the JAX package's ``obs/propagation.py`` (stdlib only;
no JAX import), with the same names, series and wire forms.

A request that crosses the front→worker mesh used to lose its trace at
every process boundary: the HTTP client, the lease pull, and the reply
hop each started fresh roots. This module is the one place the wire
format lives:

- :func:`inject` writes ``traceparent: 00-<trace_id>-<parent_span_id>-01``
  into a headers dict (the HTTP client stack calls it on every send);
- :func:`extract` parses it back into a :class:`TraceContext`, which
  ``tracer.start_span(parent=ctx)`` accepts directly (duck-typed
  ``trace_id``/``span_id``), so one request yields ONE cross-process
  span tree;
- :func:`span_from_dict` rebuilds a finished remote span from the
  ``Span.to_dict`` wire form (mesh replies carry the worker's spans
  home to the ingest server's flight recorder).

Ids are opaque lowercase-hex tokens (``tracing._new_id`` guarantees it
for in-process spans; the native load generator synthesizes compatible
ones), so the four ``-``-delimited traceparent fields parse
unambiguously. Not byte-for-byte W3C (ids are variable-length, not
16/32 hex chars) — the STRUCTURE matches, which is what interop inside
this mesh needs.

Stdlib-only and backend-free, like the rest of ``obs``.
"""

from __future__ import annotations

import dataclasses

from .tracing import Span, tracer as _tracer

TRACEPARENT = "traceparent"
_VERSION = "00"
_FLAGS = "01"
_HEX = set("0123456789abcdef")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A remote span's coordinates — everything a child span needs.
    Shape-compatible with ``Span`` where parentage is concerned, so it
    can be passed anywhere a parent span is accepted."""

    trace_id: str
    span_id: str

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}


def context_of(span) -> TraceContext | None:
    """The propagatable context of a span (or None for None — callers
    chain off ``tracer.current_span()`` without a guard)."""
    if span is None:
        return None
    return TraceContext(trace_id=span.trace_id, span_id=span.span_id)


def _hexish(token: str) -> bool:
    return bool(token) and all(c in _HEX for c in token)


def format_traceparent(ctx) -> str:
    """``00-<trace_id>-<span_id>-01`` for a Span/TraceContext."""
    return f"{_VERSION}-{ctx.trace_id}-{ctx.span_id}-{_FLAGS}"


def inject(headers: dict, span=None) -> dict:
    """Write the traceparent header for ``span`` (default: the ambient
    current span) into ``headers`` (mutated AND returned). No ambient
    trace → no header: propagation never invents a root."""
    ctx = span if span is not None else _tracer.current_span()
    if ctx is not None and getattr(ctx, "trace_id", None):
        headers[TRACEPARENT] = format_traceparent(ctx)
    return headers


def extract(headers) -> TraceContext | None:
    """Parse the traceparent header (case-insensitive lookup) back into
    a :class:`TraceContext`; None when absent or malformed — a garbled
    header degrades to a fresh root, never an error."""
    if not headers:
        return None
    value = None
    for k, v in headers.items():
        if str(k).lower() == TRACEPARENT:
            value = str(v)
            break
    if value is None:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if not (_hexish(trace_id.lower()) and _hexish(span_id.lower())):
        return None
    return TraceContext(trace_id=trace_id.lower(), span_id=span_id.lower())


def trace_of(headers) -> str | None:
    """Just the trace id from a headers dict (log/lookup convenience)."""
    ctx = extract(headers)
    return ctx.trace_id if ctx is not None else None


def span_from_dict(d: dict) -> Span:
    """Rebuild a finished span from its ``Span.to_dict`` wire form (the
    mesh reply payload). Unknown/missing fields default safely."""
    span = Span(
        name=str(d.get("name", "")),
        trace_id=str(d.get("traceId", "")),
        span_id=str(d.get("spanId", "")),
        parent_id=d.get("parentId"),
        attrs=dict(d.get("attrs") or {}),
        start_wall=float(d.get("startWall") or 0.0),
        seconds=(None if d.get("seconds") is None
                 else float(d["seconds"])),
        error=d.get("error"),
        proc=str(d.get("proc", "")),
    )
    span._done = True
    return span
