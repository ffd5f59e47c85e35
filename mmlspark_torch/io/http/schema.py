"""HTTP request/response as typed row values.

Reference ``io/http/HTTPSchema.scala`` (~350 LoC): ``HTTPRequestData`` /
``HTTPResponseData`` case classes with ``SparkBindings`` codecs so HTTP
messages travel inside DataFrames. Here they are dataclasses stored in
object columns; the codec layer is ``to_dict``/``from_dict``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class HTTPRequestData:
    url: str = ""
    method: str = "POST"
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    entity: bytes | None = None

    def to_dict(self) -> dict:
        return {"url": self.url, "method": self.method,
                "headers": dict(self.headers),
                "entity": self.entity.decode("utf-8", "replace")
                if self.entity is not None else None}

    @classmethod
    def from_dict(cls, d: dict) -> "HTTPRequestData":
        e = d.get("entity")
        return cls(url=d.get("url", ""), method=d.get("method", "POST"),
                   headers=dict(d.get("headers", {})),
                   entity=e.encode() if isinstance(e, str) else e)


@dataclasses.dataclass
class HTTPResponseData:
    status_code: int = 200
    reason: str = ""
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    entity: bytes | None = None

    def json(self) -> Any:
        return json.loads(self.entity.decode()) if self.entity else None

    def to_dict(self) -> dict:
        return {"status_code": self.status_code, "reason": self.reason,
                "headers": dict(self.headers),
                "entity": self.entity.decode("utf-8", "replace")
                if self.entity is not None else None}

    @classmethod
    def from_dict(cls, d: dict) -> "HTTPResponseData":
        e = d.get("entity")
        return cls(status_code=int(d.get("status_code", 200)),
                   reason=d.get("reason", ""),
                   headers=dict(d.get("headers", {})),
                   entity=e.encode() if isinstance(e, str) else e)


def string_to_response(s: str, status: int = 200,
                       content_type: str = "text/plain") -> HTTPResponseData:
    """Reference ``HTTPSchema.string_to_response`` UDF."""
    return HTTPResponseData(status_code=status,
                            headers={"Content-Type": content_type},
                            entity=s.encode())


def request_to_string(r: HTTPRequestData) -> str:
    """Reference ``HTTPSchema.request_to_string`` UDF (entity as text)."""
    return r.entity.decode("utf-8", "replace") if r.entity else ""
