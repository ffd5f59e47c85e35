"""HTTPTransformer / SimpleHTTPTransformer + parsers.

Reference ``io/http/HTTPTransformer.scala:86-150`` (request column →
response column through a shared client, ``concurrency``/``timeout``/
``concurrentTimeout`` params at :34-70) and ``SimpleHTTPTransformer.scala``
(JSON in → request → response → parsed output + error column), with
``Parsers.scala`` (JSONInputParser, CustomInput/OutputParser).
"""

from __future__ import annotations

import json

import numpy as np

from ...core import Transformer, Param, TypeConverters as TC, UDFParam
from ...core.contracts import HasInputCol, HasOutputCol
from .clients import AsyncClient, SingleThreadedClient, \
    send_request
from .schema import HTTPRequestData, HTTPResponseData
from .shared import SharedVariable


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Column of HTTPRequestData → column of HTTPResponseData."""

    concurrency = Param("concurrency", "requests in flight per batch",
                        TC.toInt, default=1)
    timeout = Param("timeout", "per-request timeout (s)", TC.toFloat,
                    default=60.0)
    concurrentTimeout = Param("concurrentTimeout",
                              "await timeout for async mode (s)",
                              TC.toFloat, default=None, has_default=True)
    handler = UDFParam("handler",
                       "custom request strategy fn(request, timeout) -> "
                       "HTTPResponseData (reference UDFParam 'handler'; "
                       "default = the retry/backoff sender)",
                       default=None, has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="request", outputCol="response")

    @property
    def _client_holder(self) -> SharedVariable:
        # one client per transformer instance, shared across calls
        # (reference SharedVariable per JVM, HTTPTransformer.scala:97-106);
        # lazy so instances reconstructed by load_stage (which bypasses
        # __init__) still get one. Keyed by the client-shaping params so
        # a later set("handler", ...) (or concurrency change) rebuilds
        # instead of silently serving the stale strategy.
        key = (self.get("concurrency"), self.get("timeout"),
               self.get("concurrentTimeout"), id(self.get("handler")))
        cached = self.__dict__.get("_client_holder_v")
        if cached is None or cached[0] != key:
            cached = (key, SharedVariable(self._make_client))
            self.__dict__["_client_holder_v"] = cached
        return cached[1]

    def _make_client(self):
        c = self.get("concurrency")
        sender = self.get("handler") or send_request
        if c and c > 1:
            return AsyncClient(concurrency=c, timeout=self.get("timeout"),
                               concurrent_timeout=self.get(
                                   "concurrentTimeout"),
                               sender=sender)
        return SingleThreadedClient(timeout=self.get("timeout"),
                                    sender=sender)

    def _transform(self, df):
        reqs = [r if isinstance(r, HTTPRequestData)
                else HTTPRequestData.from_dict(r)
                for r in df[self.getInputCol()]]
        responses = self._client_holder.get().send(reqs)
        col = np.empty(len(responses), object)
        col[:] = responses
        return df.with_column(self.getOutputCol(), col)


class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Value column → HTTPRequestData with JSON body (reference
    ``Parsers.scala`` JSONInputParser)."""

    url = Param("url", "target url", TC.toString)
    method = Param("method", "HTTP method", TC.toString, default="POST")
    headers = Param("headers", "extra headers", TC.identity, default={},
                    has_default=True)

    def _transform(self, df):
        out = np.empty(len(df), object)
        headers = {"Content-Type": "application/json",
                   **self.get("headers")}
        for i, v in enumerate(df[self.getInputCol()]):
            if isinstance(v, np.generic):
                v = v.item()
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            body = json.dumps(v).encode()
            out[i] = HTTPRequestData(url=self.getUrl(),
                                     method=self.get("method"),
                                     headers=headers, entity=body)
        return df.with_column(self.getOutputCol(), out)


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    udf = UDFParam("udf", "value -> HTTPRequestData")

    def _transform(self, df):
        fn = self.get("udf")
        out = np.empty(len(df), object)
        out[:] = [fn(v) for v in df[self.getInputCol()]]
        return df.with_column(self.getOutputCol(), out)


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """HTTPResponseData → parsed JSON body."""

    def _transform(self, df):
        out = np.empty(len(df), object)
        for i, r in enumerate(df[self.getInputCol()]):
            out[i] = r.json() if isinstance(r, HTTPResponseData) else None
        return df.with_column(self.getOutputCol(), out)


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    udf = UDFParam("udf", "HTTPResponseData -> value")

    def _transform(self, df):
        fn = self.get("udf")
        out = np.empty(len(df), object)
        out[:] = [fn(r) for r in df[self.getInputCol()]]
        return df.with_column(self.getOutputCol(), out)


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """JSON-in/JSON-out service call with error column (reference
    ``SimpleHTTPTransformer.scala``: input parser → HTTPTransformer →
    output parser, ``ErrorUtils`` error schema)."""

    url = Param("url", "service url", TC.toString)
    concurrency = Param("concurrency", "in-flight requests", TC.toInt,
                        default=1)
    timeout = Param("timeout", "request timeout (s)", TC.toFloat,
                    default=60.0)
    errorCol = Param("errorCol", "column for HTTP errors", TC.toString,
                     default="errors")
    flattenOutputBatches = Param("flattenOutputBatches", "inert (batches "
                                 "handled by MiniBatchTransformer)",
                                 TC.toBoolean, default=False)

    def _transform(self, df):
        req_col = "_shtt_request"
        resp_col = "_shtt_response"
        step = JSONInputParser(inputCol=self.getInputCol(),
                               outputCol=req_col, url=self.getUrl()) \
            .transform(df)
        step = HTTPTransformer(inputCol=req_col, outputCol=resp_col,
                               concurrency=self.get("concurrency"),
                               timeout=self.get("timeout")).transform(step)
        responses = step[resp_col]
        parsed = np.empty(len(responses), object)
        errors = np.empty(len(responses), object)
        for i, r in enumerate(responses):
            if isinstance(r, HTTPResponseData) and 200 <= r.status_code < 300:
                try:
                    parsed[i] = r.json()
                    errors[i] = None
                except Exception as e:
                    parsed[i] = None
                    errors[i] = f"parse error: {e}"
            else:
                parsed[i] = None
                errors[i] = (f"HTTP {r.status_code} {r.reason}"
                             if isinstance(r, HTTPResponseData)
                             else "no response")
        return (step.drop(req_col, resp_col)
                .with_column(self.getOutputCol(), parsed)
                .with_column(self.get("errorCol"), errors))
