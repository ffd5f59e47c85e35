"""Mini-batching transformers — the serving/DL throughput trick.

Reference ``stages/MiniBatchTransformer.scala:15-225`` + ``Batchers.scala``:
batch rows into list-valued rows so downstream stages amortize per-call cost
(one device call per batch instead of per row), then ``FlattenBatch``
un-batches. ``DynamicBufferedBatcher`` adaptively sizes batches from a
producer queue — the key serving-latency mechanism.

The port of ``mmlspark_tpu/stages/batching.py``'s eager paths: batching
slices host views of the columns and un-batching concatenates on the host
in each column's own dtype, as there. Its fused-segment reshapes
(``_trace``) belong to the compile slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np

from ..core import DataFrame, Transformer, Param, TypeConverters as TC
from ..core.dataframe import (argsort_host, concat_host, object_column,
                              repeat_rows, to_host)


def _batch_df(df: DataFrame, bounds: list[tuple[int, int]]) -> DataFrame:
    """Rows → one row per (start, end) batch; each cell becomes an array.
    Cells are views of the source columns (slicing, no scratch buffer);
    the object column wrapper is the one host allocation."""
    data = {}
    for col in df.columns:
        arr = df[col]
        data[col] = object_column([arr[a:b] for a, b in bounds])
    out = DataFrame(data)
    out.num_partitions = df.num_partitions
    return out


class FixedMiniBatchTransformer(Transformer):
    batchSize = Param("batchSize", "rows per batch", TC.toInt, default=10)
    maxBufferSize = Param("maxBufferSize", "kept for API parity", TC.toInt,
                          default=1 << 20)

    def _transform(self, df):
        size = self.getBatchSize()
        n = df.num_rows
        bounds = [(i, min(i + size, n)) for i in range(0, n, size)]
        return _batch_df(df, bounds)


class DynamicMiniBatchTransformer(Transformer):
    """One batch per partition (the dynamic batcher consumes whatever is
    available — in columnar form, a partition is 'what's available').
    The batch cells are views of the columns, wrapped in an object
    column."""

    maxBatchSize = Param("maxBatchSize", "upper bound on batch size",
                         TC.toInt, default=1 << 30)

    def _transform(self, df):
        size = min(self.getMaxBatchSize(), max(df.num_rows, 1))
        n = df.num_rows
        bounds = [(i, min(i + size, n)) for i in range(0, n, size)] or []
        return _batch_df(df, bounds)


class TimeIntervalMiniBatchTransformer(Transformer):
    """Batch by arrival-time windows. On a materialized frame this groups by
    a timestamp column into ``millisToWait`` windows (reference streams rows;
    columnar equivalent uses the recorded arrival time)."""

    millisToWait = Param("millisToWait", "window length in ms", TC.toInt,
                         default=1000)
    timestampCol = Param("timestampCol",
                         "epoch-millis column; absent → single batch",
                         TC.toString)
    maxBatchSize = Param("maxBatchSize", "upper bound on batch size",
                         TC.toInt, default=1 << 30)

    def _transform(self, df):
        n = df.num_rows
        if not self.isSet("timestampCol"):
            bounds = [(0, n)] if n else []
            return _batch_df(df, bounds)
        ts = df[self.getTimestampCol()].astype(np.int64)
        # stable host argsort: epoch-millis are int64 and must sort
        # exactly (a 32-bit copy would wrap at 2**31); the windowing loop
        # below relies on stability
        order = argsort_host(ts)
        sorted_df = df.take(order)
        ts = ts[order]
        window = self.getMillisToWait()
        max_size = self.getMaxBatchSize()
        bounds, start = [], 0
        for i in range(1, n + 1):
            if (i == n or ts[i] - ts[start] >= window
                    or i - start >= max_size):
                bounds.append((start, i))
                start = i
        return _batch_df(sorted_df, bounds)


class FlattenBatch(Transformer):
    """Inverse of the mini-batchers: list-valued rows → one row per element."""

    def _transform(self, df):
        cols = df.columns
        if not cols or df.num_rows == 0:
            return df
        lengths = None
        for c in cols:
            cells = df[c]
            if cells.dtype == object and len(cells) and \
                    hasattr(cells[0], "__len__"):
                lengths = [len(v) for v in cells]
                break
        if lengths is None:
            return df
        data = {}
        for c in cols:
            cells = df[c]
            if cells.dtype == object and hasattr(cells[0], "__len__") and \
                    not isinstance(cells[0], str):
                parts = [to_host(v) for v in cells]
                if parts and parts[0].dtype != object and \
                        all(p.ndim == parts[0].ndim for p in parts):
                    # numeric cells: concatenate on host in the cells'
                    # own dtype — int64 epoch millis from the
                    # time-interval batcher stay exact
                    data[c] = concat_host(parts)
                else:
                    data[c] = object_column(
                        item for v in cells for item in v)
            else:
                data[c] = repeat_rows(cells, lengths)
        out = DataFrame(data)
        out.num_partitions = df.num_partitions
        return out


class DynamicBufferedBatcher:
    """Queue-based adaptive batcher (reference ``stages/Batchers.scala:1-152``).

    A producer thread fills a bounded queue; ``__iter__`` yields batches
    sized by the SAME close policy online serving uses
    (``sched.BatchPolicy`` — one batching brain for offline pipelines
    and the serving fronts): under light load batches are small (low
    latency), under heavy load they grow (high throughput), and with a
    ``linger`` budget the policy's padding-bucket / service-time logic
    decides whether waiting longer costs more than it gains. The default
    (``max_batch=None``, ``linger=0``) reproduces the reference's
    take-what-accumulated behavior exactly.
    """

    def __init__(self, it: Iterator, max_buffer_size: int = 1024,
                 max_batch: int | None = None, linger: float = 0.0,
                 policy=None):
        from ..sched import BatchPolicy

        self._it = it
        self._queue: queue.Queue = queue.Queue(maxsize=max_buffer_size)
        self._policy = policy or BatchPolicy(
            max_batch=max_batch or max_buffer_size, linger=linger)
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._it:
                self._queue.put(item)
        finally:
            self._done.set()

    def __iter__(self):
        from ..sched.policy import CLOSE, GROW
        while True:
            batch = []
            try:
                batch.append(self._queue.get(timeout=0.01))
            except queue.Empty:
                if self._done.is_set() and self._queue.empty():
                    return
                continue
            linger_end = time.monotonic() + self._policy.linger
            while True:
                action, wait_s, _reason = self._policy.decide(
                    len(batch), queue_empty=self._queue.empty(),
                    linger_remaining=linger_end - time.monotonic())
                if action == GROW:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        pass  # producer raced us; policy re-decides
                    continue
                if action == CLOSE:
                    break
                if self._done.is_set():
                    # producer exhausted: nothing can arrive, so paying
                    # the remaining linger would only delay the final
                    # partial batch
                    break
                try:  # WAIT: pay bounded latency to grow the batch
                    batch.append(self._queue.get(timeout=wait_s))
                except queue.Empty:
                    pass
            yield batch


class PartitionConsolidator(Transformer):
    """Funnel many partitions through one consolidated stream (reference
    ``stages/PartitionConsolidator.scala:21-143``) — used to respect
    per-process rate limits on HTTP services. Columnar equivalent: collapse
    to a single partition while preserving rows."""

    def _transform(self, df):
        return df.repartition(1)
