"""Spark-Serving equivalent for the port: pipelines as low-latency web
services, and the paged LLM engine.

Reference L9 (SURVEY §2.7): HTTP sources/sinks over structured streaming,
continuous mode with epoch replay (``continuous/HTTPSourceV2.scala``) and
``ServingUDFs.makeReplyUDF/sendReplyUDF``. One process = one server:
requests flow through the admission-controlled scheduler into the pipeline
on the executor thread, and replies are routed back by request id; a failed
batch is replayed (``HTTPSourceV2.scala:488-517``).

- ``server.py``: :class:`ServingServer` (the threaded Python front),
  :class:`~.server.ServingQuery` (the executor), :func:`serving_query`,
  :func:`bucket_pad`, the metrics and debug routes both fronts share.
- ``native_front.py``: ``NativeServingServer``, the same interface over the
  C++ epoll front (``native/src/httpfront.cpp``, built with g++ at first
  use).
- ``dsl.py``: :func:`read_stream` and ``ServingStream`` (with
  ``compile_pipeline(example_df, aot_buckets=)``).
- ``udfs.py``: :func:`make_reply_udf`, :func:`send_reply_udf`.
- ``loadgen.py``: the closed-loop load generator (``native/src/loadgen.cpp``)
  and its percentile summary.
- ``llm.py``: the paged LLM engine.

The serving mesh, the autoscaler and the deploy plane
(``distributed.py``, ``autoscale.py``, ``deploy.py``) come with ROADMAP.md
§1 item 9d-2: their names exist here and raise ``NotImplementedError``
naming that item when called.
"""

from .llm import (DecodeExecutor, HandoffQueue, LLMEngine, PrefillExecutor,
                  pack_handoff, unpack_handoff)
from .server import ServingServer, bucket_pad, serving_query
from .udfs import make_reply_udf, send_reply_udf
from .dsl import read_stream


def _later(name: str):
    def entry(*args, **kwargs):
        raise NotImplementedError(
            f"{name} comes with the serving mesh, the autoscaler and the "
            "deploy plane: ROADMAP.md §1 item 9d-2")
    entry.__name__ = entry.__qualname__ = name
    entry.__doc__ = ("Not ported yet: ROADMAP.md §1 item 9d-2 (the serving "
                     "mesh, the autoscaler and the deploy plane).")
    return entry


Autoscaler = _later("Autoscaler")
AutoscaleConfig = _later("AutoscaleConfig")
AutoscaleSignals = _later("AutoscaleSignals")
ComputeWorkerPool = _later("ComputeWorkerPool")
ModelRegistry = _later("ModelRegistry")
ModelVersion = _later("ModelVersion")
RolloutConfig = _later("RolloutConfig")
RolloutController = _later("RolloutController")
VersionRouter = _later("VersionRouter")
DistributedServingServer = _later("DistributedServingServer")
NativeDistributedServingServer = _later("NativeDistributedServingServer")
DriverRegistry = _later("DriverRegistry")
RegistryClient = _later("RegistryClient")
ServiceInfo = _later("ServiceInfo")
pick_least_loaded = _later("pick_least_loaded")
remote_worker_loop = _later("remote_worker_loop")

__all__ = ["bucket_pad",
           "LLMEngine", "PrefillExecutor", "DecodeExecutor",
           "HandoffQueue", "pack_handoff", "unpack_handoff",
           "ServingServer", "serving_query", "make_reply_udf",
           "send_reply_udf", "read_stream"]
