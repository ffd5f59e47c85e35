"""Reply UDFs.

Reference ``streaming/ServingUDFs.scala:22-51``: ``makeReplyUDF`` (typed
value → HTTPResponseData) and ``sendReplyUDF`` (side-effecting reply via
the state holder, returning a success bool).
"""

from __future__ import annotations

import json

import numpy as np

from ..io.http.schema import HTTPResponseData, string_to_response
from .server import get_service


def make_reply_udf(value) -> HTTPResponseData:
    """Typed data → response (reference ``makeReplyUDF``)."""
    if isinstance(value, HTTPResponseData):
        return value
    if isinstance(value, (bytes, bytearray)):
        return HTTPResponseData(status_code=200, entity=bytes(value))
    if isinstance(value, str):
        return string_to_response(value)
    if isinstance(value, np.ndarray):
        value = value.tolist()
    return string_to_response(json.dumps(value),
                              content_type="application/json")


def send_reply_udf(service_name: str, request_id: str, value) -> bool:
    """Reply from anywhere in the pipeline (reference ``sendReplyUDF``):
    looks up the service registry, replies once, returns success."""
    try:
        server = get_service(service_name)
    except KeyError:
        return False
    with server._lock:
        cached = server.history.get(request_id)
    if cached is None:
        return False
    return cached.reply(make_reply_udf(value))
