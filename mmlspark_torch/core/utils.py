"""Core utilities: fault tolerance, timing, device topology, schema helpers.

The port of ``mmlspark_tpu/core/utils.py``: the reference's ``core/utils`` +
``downloader/ModelDownloader.scala`` retry wrapper +
``core/utils/ClusterUtil.scala`` topology discovery. "Cluster topology" here
is the torch view: the CUDA devices of this process and the ranks of an
initialized ``torch.distributed`` group.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Callable, Sequence, TypeVar

import numpy as np

T = TypeVar("T")

# Reference downloader/ModelDownloader.scala:37-60 backoff sequence.
DEFAULT_BACKOFFS_MS: tuple[int, ...] = (0, 100, 200, 500)


def retry_with_timeout(fn: Callable[[], T],
                       timeout_s: float | None = None,
                       backoffs_ms: Sequence[int] = DEFAULT_BACKOFFS_MS) -> T:
    """Retry ``fn`` over a backoff schedule; optional per-attempt timeout.

    As with the reference's ``Await.result``-based wrapper, a timed-out
    attempt's thread keeps running in the background, so with ``timeout_s``
    the ``fn`` must tolerate concurrent invocations.
    """
    if not backoffs_ms:
        raise ValueError("backoffs_ms must contain at least one entry")
    last: Exception | None = None
    for backoff in backoffs_ms:
        if backoff:
            time.sleep(backoff / 1000.0)
        try:
            if timeout_s is None:
                return fn()
            # No `with`: __exit__ would join the worker and defeat the timeout.
            ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            try:
                return ex.submit(fn).result(timeout=timeout_s)
            finally:
                ex.shutdown(wait=False)
        except Exception as e:  # noqa: BLE001 — retry wrapper by design
            last = e
    assert last is not None  # loop ran ≥ once since backoffs_ms is non-empty
    raise last


class StopWatch:
    """Nanosecond accumulator (reference ``core/utils/StopWatch.scala``)."""

    def __init__(self):
        self.elapsed_ns = 0
        self._start: int | None = None

    def start(self) -> None:
        self._start = time.perf_counter_ns()

    def stop(self) -> None:
        if self._start is not None:
            self.elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def measure(self, fn: Callable[[], T]) -> T:
        with self:
            return fn()


class ClusterUtil:
    """Device-topology discovery — the GPU analogue of executor counting.

    Reference ``core/utils/ClusterUtil.scala:13-291`` asks Spark how many
    executors × cores are available; here the process asks torch for its
    CUDA devices and, when ``torch.distributed`` is initialized, for the
    group's size and rank. A group is taken to run one process per device,
    the torch convention (JAX's "process" is a rank here).
    """

    @staticmethod
    def _group():
        import torch.distributed as dist
        return dist if dist.is_available() and dist.is_initialized() \
            else None

    @staticmethod
    def get_num_local_devices() -> int:
        import torch
        return torch.cuda.device_count()

    @staticmethod
    def get_num_devices() -> int:
        dist = ClusterUtil._group()
        return dist.get_world_size() if dist \
            else ClusterUtil.get_num_local_devices()

    @staticmethod
    def get_num_hosts() -> int:
        dist = ClusterUtil._group()
        return dist.get_world_size() if dist else 1

    @staticmethod
    def get_host_index() -> int:
        dist = ClusterUtil._group()
        return dist.get_rank() if dist else 0

    @staticmethod
    def default_mesh(axis_name: str = "dp"):
        """A one-axis ``DeviceMesh`` over every rank of the initialized
        process group (``torch.distributed.init_process_group`` first), on
        the devices its backend serves: CUDA for NCCL, the CPU for gloo."""
        from torch.distributed.device_mesh import init_device_mesh
        dist = ClusterUtil._group()
        if dist is None:
            raise RuntimeError("default_mesh needs an initialized "
                               "torch.distributed process group")
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device_type, (dist.get_world_size(),),
                                mesh_dim_names=(axis_name,))

    @staticmethod
    def get_jvm_cpus() -> int:
        import os
        return os.cpu_count() or 1


def find_unused_column_name(prefix: str, df) -> str:
    """Reference ``core/schema/DatasetExtensions.findUnusedColumnName``."""
    name = prefix
    i = 0
    while name in df.columns:
        i += 1
        name = f"{prefix}_{i}"
    return name


def stable_sigmoid(x: np.ndarray) -> np.ndarray:
    """Overflow-free logistic: exp is only ever taken of a non-positive
    argument."""
    x = np.asarray(x)
    e = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def as_2d_features(df, features_col: str) -> np.ndarray:
    """Features column → dense float32 [n, d] matrix."""
    arr = df[features_col]
    if arr.dtype == object:
        arr = np.stack([np.asarray(v, dtype=np.float32) for v in arr])
    if arr.ndim == 1:
        arr = arr[:, None]
    return np.ascontiguousarray(arr, dtype=np.float32)


def using(resources: Sequence, fn: Callable):
    """RAII helper (reference ``core/env/StreamUtilities.using``)."""
    try:
        return fn(*resources)
    finally:
        for r in resources:
            close = getattr(r, "close", None)
            if close:
                close()
