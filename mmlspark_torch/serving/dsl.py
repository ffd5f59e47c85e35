"""Serving DSL — the reader/writer chain of the reference.

Reference ``io/IOImplicits.scala:20-100``:

    spark.readStream.server().address(host, port, api).load()
      ...pipeline...
    .writeStream.server().replyTo(api).start()

Here:

    (read_stream().server().address(host, port, "api")
       .load()                       # -> ServingStream
       .transform(stage_or_fn)       # any Transformer or df->df callable
       .with_reply(fn)               # row value -> reply body
       .start())                     # -> ServingQuery
"""

from __future__ import annotations

import numpy as np

from ..core import DataFrame
from ..io.http.schema import request_to_string
from .server import ServingQuery, ServingServer
from .udfs import make_reply_udf


_MESH = "ROADMAP.md §1 item 9d-2"


def _default_registry():
    """The process-wide ``DriverRegistry`` of distributed loads: the
    serving mesh comes with ROADMAP.md §1 item 9d-2."""
    raise NotImplementedError(
        f"the serving mesh's DriverRegistry comes with {_MESH}")


class _ReadStreamBuilder:
    def __init__(self):
        self._mode = "server"

    def server(self):
        self._mode = "server"
        return self

    def distributedServer(self):
        """Worker-mesh mode (reference ``distributedServer()``): the
        serving mesh comes with ROADMAP.md §1 item 9d-2."""
        raise NotImplementedError(
            f"distributedServer() needs the serving mesh: {_MESH}")

    def continuousServer(self):
        self._mode = "continuous"
        return self

    def address(self, host: str, port: int, api: str):
        self._host, self._port, self._api = host, port, api
        return self

    def option(self, key: str, value):
        setattr(self, f"_{key}", value)
        return self

    def load(self) -> "ServingStream":
        kwargs = dict(
            host=getattr(self, "_host", "127.0.0.1"),
            port=int(getattr(self, "_port", 0)),
            api_path="/" + getattr(self, "_api", ""),
            reply_timeout=float(getattr(self, "_replyTimeout", 30.0)),
            max_queue=int(getattr(self, "_maxQueue", 0)),
            # sched subsystem knobs: per-request deadline budget
            # (seconds; drives 429 load shedding + adaptive batch
            # closes) and per-route concurrency limit
            deadline=float(getattr(self, "_deadline", 0.0)),
            max_inflight=int(getattr(self, "_maxInflight", 0)))
        name = getattr(self, "_api", "default")
        server = ServingServer(name, **kwargs)
        return ServingStream(server, mode=self._mode,
                             max_batch=int(getattr(self, "_maxBatch", 0)),
                             linger=float(getattr(self, "_linger", 0.0)))


def read_stream() -> _ReadStreamBuilder:
    return _ReadStreamBuilder()


class ServingStream:
    """A composable request stream: chain transforms, then reply.

    ``continuousServer()`` loads run record-at-a-time (``max_batch=1``,
    the reference's continuous-trigger semantics); other modes use
    dynamic batching, optionally with a micro-batch ``linger``."""

    def __init__(self, server: ServingServer, mode: str = "server",
                 max_batch: int = 0, linger: float = 0.0):
        self.server = server
        self.mode = mode
        self.max_batch = max_batch or (1 if mode == "continuous" else 1024)
        self.linger = linger
        self._stages: list = []
        self._reply_fn = None
        self._reply_col = "reply"

    def transform(self, stage):
        self._stages.append(stage)
        return self

    def compile_pipeline(self, example_df, aot_buckets=None,
                         **compile_kw):
        """Lower the transform chain added so far into ONE
        :class:`~mmlspark_torch.core.compile.CompiledPipeline`: maximal
        runs of traceable stages fuse into single device segments (one
        upload a column, one pinned fetch), host-bound stages keep
        running eagerly between them. ``example_df`` must look like the frames
        the executor will build (typically ``{"id", "request"}`` plus
        whatever ``parse_request`` produces) — it drives the schema
        propagation that decides segment boundaries.

        ``aot_buckets``: padding-bucket row counts to register with the
        AOT executable store's build CLI (``python -m
        mmlspark_torch.core.aot build``) — compilation becomes a build
        step, and ``start()`` warm-loads the store so a fresh worker's
        first request never pays a compile."""
        from ..core.compile import compile_pipeline
        compile_kw.setdefault("service", "serving")
        pre_stages = list(self._stages)
        self._stages = [compile_pipeline(pre_stages, example_df,
                                         **compile_kw)]
        if aot_buckets:
            from ..core import aot
            service = self.server.name
            buckets = tuple(int(b) for b in aot_buckets)
            aot.register_buildable(
                service,
                lambda: {"stages": pre_stages, "example": example_df,
                         "buckets": buckets,
                         "mesh": compile_kw.get("mesh"),
                         "rules": compile_kw.get("rules")})
        return self

    def parse_request(self, parser=None):
        """Add a stage turning the raw request into a value column
        (reference ``ServingImplicits.parseRequest``). Default: body text →
        'value' column."""
        parser = parser or (lambda r: request_to_string(r))

        def stage(df):
            col = np.empty(len(df), object)
            col[:] = [parser(r) for r in df["request"]]
            return df.with_column("value", col)
        self._stages.append(stage)
        return self

    def with_reply(self, fn, input_col: str = "value"):
        """Final stage: fn(row value) → reply body
        (reference ``makeReply``)."""
        self._reply_fn = (fn, input_col)
        return self

    def start(self, name: str | None = None) -> ServingQuery:
        stages = list(self._stages)
        reply = self._reply_fn

        def run(df: DataFrame) -> DataFrame:
            for s in stages:
                df = s.transform(df) if hasattr(s, "transform") else s(df)
            if reply is not None:
                fn, col = reply
                out = np.empty(len(df), object)
                out[:] = [make_reply_udf(fn(v)) for v in df[col]]
                df = df.with_column("reply", out)
            return df

        # surface fused-pipeline dispatch counts to the executor's
        # FeatureLog rows (ServingQuery reads transform_fn.compiled_segments).
        # None = compile_pipeline never ran; 0 = it ran and everything
        # stayed host-bound — operators auditing fusion coverage need
        # the distinction
        segs = [s.compiled_segments for s in stages
                if hasattr(s, "compiled_segments")]
        run.compiled_segments = sum(segs) if segs else None
        # the warm helpers (core/aot.maybe_warm) and introspection walk
        # the chain through this attribute — the closure hides it.
        # ServingQuery.start() below owns the AOT warm boot (it follows
        # run.stages to the fused segments), so the chain loads its
        # store executables before the first request on either path.
        run.stages = stages

        self.server.start()
        return ServingQuery(self.server, run, name=name,
                            max_batch=self.max_batch,
                            linger=self.linger).start()
