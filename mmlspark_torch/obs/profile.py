"""Continuous compile/device profiler + the cost-model feature log.

The port's own copy of the JAX package's ``obs/profile.py``, with the same
series, spans, feature schema and env switch. Three instruments, all
always-on-capable (bounded, registry-backed, no trace files to rotate):

- :class:`CompileTracker` — wraps a step function (``tracker.track``) so
  every new input signature (tensor shapes, dtypes, devices) is counted
  as one compile, as a ``jax.jit`` retrace is in the JAX package, and
  the wall time of the call that met it lands in a histogram, per
  function. Steady-state serving must show zero misses.

- :class:`StepProfiler` — attributes wall time into host-dispatch vs
  device-execute per pipeline stage: dispatch returns as soon as the
  work is queued on the card; the remainder until
  ``torch.cuda.synchronize`` of every CUDA device the result lives on
  (or the caller names) completes is device time. Pass ``flops`` and
  ``profile_mfu{stage=...}`` updates per step.

- :class:`FeatureLog` — a bounded structured log appending one record
  per served request (route, batch/bucket, dtype/shapes when known,
  queue ms, execute ms, device ms): the training data for a learned
  scheduler cost model.

:func:`profile_trace` and :func:`profiled` capture and annotate
``torch.profiler`` traces.

Import is stdlib-only; torch is imported lazily, and ``torch.cuda`` and
``torch.distributed`` are read only where they are already initialized.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import sys
import threading
import time

from .attribution import cuda_initialized, peak_spec
from .metrics import registry as _registry
from .tracing import tracer as _tracer, wall_now


# dtype -> its name: ``str`` of a numpy dtype takes microseconds, and a
# tracked decode step keys on five arrays
_DTYPE_NAMES: dict = {}


def _dtype_name(dtype) -> str:
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype)
    return name


def _signature(args, kwargs) -> tuple:
    """What a ``jax.jit`` retrace keys on, for eager torch: each tensor's
    shape, dtype and device, each array's shape and dtype, containers by
    structure, and other values by type alone (a Python scalar is traced,
    not baked in)."""
    def leaf(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            dev = getattr(x, "device", None)
            return (tuple(x.shape), _dtype_name(x.dtype),
                    None if dev is None else str(dev))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(leaf(v) for v in x))
        if isinstance(x, dict):
            # sorted by key alone: str() of an item would format its
            # value, and formatting a CUDA tensor copies it to the host
            return ("dict", tuple((k, leaf(v)) for k, v in sorted(
                x.items(), key=lambda kv: str(kv[0]))))
        return type(x).__name__
    return (tuple(leaf(a) for a in args),
            tuple((k, leaf(v)) for k, v in sorted(kwargs.items())))


class CompileTracker:
    """Counts compiles (new input signatures) and their time per tracked
    function.

    ``tracker.track(fn, name=...)`` returns a callable that runs ``fn``
    and keys each call on its input signature (:func:`_signature`): a
    signature met for the first time is a miss (what a ``jax.jit``
    retrace and compile is), a known one a hit. Per-call outcomes and
    the misses' wall seconds go to the obs registry:

    - ``profile_compiles_total{fn=...}`` — new-signature count (>= 2 on a
      shape-unstable function),
    - ``profile_jit_calls_total{fn=...,outcome=hit|miss}``,
    - ``profile_compile_seconds{fn=...}`` — wall time of the missing
      call.
    """

    def __init__(self, registry=None):
        reg = registry if registry is not None else _registry
        self._lock = threading.Lock()
        self._traces: dict[str, int] = {}
        self._calls: dict[str, int] = {}
        self._seen: dict[str, set] = {}
        # signatures first met after mark_steady(), per function
        self._late: dict[str, list] = {}
        # steady-state assertion mode: after mark_steady(), every
        # further compile is a violation — counted separately so "did
        # the warm worker compile?" is one scrape of
        # profile_runtime_compiles_total, which must stay 0.
        self._steady = False
        self._steady_base: dict[str, int] = {}
        self._c_compiles = reg.counter(
            "profile_compiles_total",
            "jit retraces (compiles) per tracked function")
        self._c_runtime = reg.counter(
            "profile_runtime_compiles_total",
            "compiles AFTER steady state was declared (mark_steady) — "
            "an AOT-warmed server must hold this at 0")
        self._c_calls = reg.counter(
            "profile_jit_calls_total",
            "tracked jit calls, by function and cache outcome")
        self._h_compile = reg.histogram(
            "profile_compile_seconds",
            "trace+compile wall seconds per tracked function")

    def _note(self, label: str, sig) -> bool:
        """Whether ``sig`` is new for ``label`` (then counted)."""
        with self._lock:
            seen = self._seen.setdefault(label, set())
            if sig in seen:
                return False
            seen.add(sig)
            self._traces[label] = self._traces.get(label, 0) + 1
            if self._steady:
                self._late.setdefault(label, []).append(sig)
        self._c_compiles.inc(1, fn=label)
        if self._steady:
            self._c_runtime.inc(1, fn=label)
        return True

    def track(self, fn=None, *, name: str | None = None):
        """Wrap ``fn`` with compile tracking. Usable as a decorator
        (``@tracker.track`` / ``@tracker.track(name=...)``) or
        call-form; the result and exceptions pass through."""
        if fn is None:
            return functools.partial(self.track, name=name)
        label = name or getattr(fn, "__name__", None) or "<fn>"

        @functools.wraps(fn)
        def call(*args, **kwargs):
            miss = self._note(label, _signature(args, kwargs))
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if miss:
                self._h_compile.observe(time.perf_counter() - t0,
                                        fn=label)
            self._c_calls.inc(1, fn=label,
                              outcome="miss" if miss else "hit")
            with self._lock:
                self._calls[label] = self._calls.get(label, 0) + 1
            return out

        call.__tracked_label__ = label
        return call

    # -- read surface ------------------------------------------------------
    def compiles(self, name: str) -> int:
        """Compile count for a tracked function (0 if never called)."""
        return self._traces.get(name, 0)

    def calls(self, name: str) -> int:
        return self._calls.get(name, 0)

    def stats(self) -> dict[str, dict[str, int]]:
        return {label: {"compiles": n,
                        "calls": self._calls.get(label, 0)}
                for label, n in sorted(self._traces.items())}

    def unstable(self, min_compiles: int = 2) -> dict[str, int]:
        """Functions that recompiled — the runtime recompile-hazard
        flags. A steady-state serving process must return ``{}`` here
        (after warmup); a shape-unstable fn shows its compile count."""
        return {label: n for label, n in sorted(self._traces.items())
                if n >= min_compiles}

    # -- steady-state assertion mode --------------------------------------
    def mark_steady(self) -> None:
        """Declare warmup over: from here, every compile is a
        violation (``profile_runtime_compiles_total`` counts it). Call
        after a deliberate warmup sweep."""
        with self._lock:
            self._steady_base = dict(self._traces)
            self._late = {}
            self._steady = True

    def unmark_steady(self) -> None:
        self._steady = False

    @property
    def steady(self) -> bool:
        return self._steady

    def runtime_compiled(self) -> dict[str, int]:
        """Per-function compiles since :meth:`mark_steady` — the
        signatures an operator must add to the warmup."""
        if not self._steady:
            return {}
        return {label: n - self._steady_base.get(label, 0)
                for label, n in sorted(self._traces.items())
                if n > self._steady_base.get(label, 0)}

    def runtime_signatures(self) -> dict[str, list]:
        """The input signatures first met since :meth:`mark_steady`, per
        function, in arrival order."""
        with self._lock:
            return {label: list(sigs)
                    for label, sigs in sorted(self._late.items())}

    def runtime_compiles(self) -> int:
        """Total compiles since steady state was declared (0 = the
        warmup covered every signature)."""
        return sum(self.runtime_compiled().values())

    def assert_steady_state(self) -> None:
        """Raise (loudly, with the offending functions) if anything
        compiled after :meth:`mark_steady`."""
        bad = self.runtime_compiled()
        if bad:
            raise AssertionError(
                f"{sum(bad.values())} runtime compile(s) in steady "
                f"state: {bad} — warm these (fn × shape) before "
                "mark_steady()")


#: THE process-wide tracker.
compile_tracker = CompileTracker()


class _StepHandle:
    """Yielded by :meth:`StepProfiler.step`: call ``done(result)`` with
    whatever the stage produced so the profiler can measure the
    device-execute tail (the synchronize of every CUDA device a tensor
    of ``result`` lives on, and of ``devices``). Without it the whole
    step is attributed to host dispatch. After the ``with`` block
    exits, ``seconds`` / ``dispatch_seconds`` / ``device_seconds`` /
    ``synced`` carry the measured split (callers like ``stages.Timer``
    re-surface them)."""

    __slots__ = ("result", "devices", "seconds", "dispatch_seconds",
                 "device_seconds", "synced")

    def __init__(self):
        self.result = None
        self.devices = ()
        self.seconds = 0.0
        self.dispatch_seconds = 0.0
        self.device_seconds = 0.0
        self.synced = False

    def done(self, result, devices=()):
        """``devices``: CUDA devices to wait on besides those the
        result's tensors live on (a stage whose output went to the
        host, named by its ``device`` params)."""
        self.result = result
        self.devices = tuple(devices)
        return result


def _cuda_devices_in(obj, found: set) -> None:
    """Add the CUDA devices of every tensor in ``obj`` (a tensor, a
    tuple/list/dict of them, or a DataFrame's columns) to ``found``."""
    if obj is None or isinstance(obj, (str, bytes, int, float, bool)):
        # scalars hold no device memory, and a str ITERATES TO ITSELF —
        # without this cut a single text cell recurses forever
        return
    dev = getattr(obj, "device", None)
    if dev is not None and hasattr(obj, "data_ptr"):
        if getattr(dev, "type", None) == "cuda":
            found.add(dev)
        return
    # numeric numpy arrays cannot hold device handles: skip before the
    # generic __iter__ branch walks a million rows in Python
    dt = getattr(obj, "dtype", None)
    if dt is not None and getattr(dt, "kind", "O") != "O":
        return
    cols = getattr(obj, "columns", None)
    if cols is not None and hasattr(obj, "__getitem__"):
        for c in cols:  # DataFrame-shaped: column by column
            _cuda_devices_in(obj[c], found)
        return
    if isinstance(obj, dict):
        obj = obj.values()
    if isinstance(obj, (list, tuple)) or hasattr(obj, "__iter__"):
        try:
            for leaf in obj:
                _cuda_devices_in(leaf, found)
        except TypeError:
            pass


def _block_on(obj, devices=()) -> bool:
    """Synchronize every CUDA device a tensor of ``obj`` lives on, and
    ``devices``. Returns whether anything was actually synced — a
    pure-host stage records device_seconds ~0 with ``synced=False``."""
    found: set = set()
    _cuda_devices_in(obj, found)
    if devices:
        import torch
        found.update(torch.device(d) for d in devices)
    if not found:
        return False
    import torch
    for dev in found:
        torch.cuda.synchronize(dev)
    return True


def process_label() -> str | None:
    """This worker's ``process`` metric label, or None when the label
    should not be attached. Single-process runs get None so their sample
    names stay exactly as before; only a live ``torch.distributed``
    group of more than one rank yields ``"0"``/``"1"``/… so per-worker
    series stay distinguishable when N workers push to one aggregation
    point. Never imports torch, never initializes a process group."""
    mod = sys.modules.get("torch")
    if mod is None:
        return None
    try:
        dist = mod.distributed
        if not (dist.is_available() and dist.is_initialized()):
            return None     # don't cache: the group may come later
        if int(dist.get_world_size()) <= 1:
            return None
        return str(int(dist.get_rank()))
    except Exception:
        return None


class StepProfiler:
    """Host-dispatch vs device-execute attribution per pipeline stage.

    ``with profiler.step("featurize", flops=f) as h: h.done(stage(x))``
    records:

    - ``profile_step_seconds{stage=...,phase=dispatch|device}`` — the
      host time until dispatch returned vs the synchronize tail,
    - ``profile_steps_total{stage=...}``,
    - ``profile_mfu{stage=...}`` when ``flops`` is given (always-on MFU:
      flops / total seconds / peak),

    and emits ``profile.dispatch`` / ``profile.device`` child spans
    under the ambient trace (or an explicit ``parent=``), so a request's
    flame graph shows where host↔device time went per stage.
    """

    def __init__(self, service: str = "", registry=None, tracer=None,
                 peak_flops: float | None = None):
        reg = registry if registry is not None else _registry
        self.service = service
        # None (default) = resolve the live platform's PeakSpec per
        # call — the platform may only initialize after construction
        self.peak_flops = None if peak_flops is None \
            else float(peak_flops)
        self._tracer = tracer if tracer is not None else _tracer
        self._h_step = reg.histogram(
            "profile_step_seconds",
            "per-stage wall seconds, split host-dispatch vs device")
        self._c_steps = reg.counter(
            "profile_steps_total", "profiled stage executions")
        self._g_mfu = reg.gauge(
            "profile_mfu",
            "achieved FLOP/s over peak per stage (always-on MFU)")

    _AMBIENT = object()

    @contextlib.contextmanager
    def step(self, stage: str, *, parent=_AMBIENT,
             flops: float | None = None, features: dict | None = None):
        handle = _StepHandle()
        if parent is StepProfiler._AMBIENT:
            parent = self._tracer.current_span()
        # lazy: memory imports this module for process_label
        from .memory import memory_profiler
        mem0 = memory_profiler.watermark()
        w0 = wall_now()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            t1 = time.perf_counter()
            synced = False
            if handle.result is not None or handle.devices:
                try:
                    synced = _block_on(handle.result, handle.devices)
                except Exception:
                    synced = False
            t2 = time.perf_counter()
            dispatch_s, device_s = t1 - t0, t2 - t1
            handle.dispatch_seconds = dispatch_s
            handle.device_seconds = device_s
            handle.seconds = t2 - t0
            handle.synced = synced
            # on a pod worker the step/mfu families carry a `process`
            # label; single-process series keep their exact names
            pl = process_label()
            plab = {"process": pl} if pl is not None else {}
            self._h_step.observe(dispatch_s, stage=stage,
                                 phase="dispatch", **plab)
            self._h_step.observe(device_s, stage=stage, phase="device",
                                 **plab)
            self._c_steps.inc(1, stage=stage, **plab)
            # live-buffer delta this stage left behind (device-memory
            # profiler; absent with no CUDA context)
            memory_profiler.segment_delta(
                stage, mem0, memory_profiler.watermark())
            if flops:
                self.record_mfu(stage, flops, t2 - t0)
            dspan = self._tracer.emit_span(
                "profile.dispatch", parent=parent, seconds=dispatch_s,
                start_wall=w0, stage=stage)
            self._tracer.emit_span(
                "profile.device", parent=dspan, seconds=device_s,
                start_wall=w0 + dispatch_s, stage=stage, synced=synced)
            if features is not None:
                feature_log.record(
                    stage=stage, dispatch_ms=dispatch_s * 1e3,
                    device_ms=device_s * 1e3, **features)

    def record_mfu(self, stage: str, flops: float,
                   seconds: float) -> float:
        """Set the always-on MFU gauge from an externally measured
        (flops, seconds) pair — a benchmark's sweep and the step
        context both land here. The peak divided by is the resolved PeakSpec's
        (env-overridable; obs.attribution) unless the profiler was
        built with an explicit ``peak_flops``, and the gauge carries
        the platform it was computed against."""
        if self.peak_flops is not None:
            peak, platform = self.peak_flops, device_platform()
        else:
            spec = peak_spec()
            peak, platform = spec.peak_flops, spec.platform
        mfu = float(flops) / max(float(seconds), 1e-12) / peak
        labels = {"stage": stage, "platform": platform}
        pl = process_label()
        if pl is not None:
            labels["process"] = pl
        self._g_mfu.set(mfu, **labels)
        return mfu


#: THE process-wide step profiler (serving, pipelines, benches share it
#: so the mfu/step series stay one family).
step_profiler = StepProfiler()


#: Feature-row schema version, the JAX package's: v2 added
#: ``padded_batch``, ``queue_depth``, ``compiled_segments`` and the device
#: ``platform``; v3 the ``process`` index; v4 the generation-row fields
#: ``decode_steps`` and ``prefill_tokens``; v5 ``context_blocks`` (KV
#: blocks resident at completion); v6 the analytic-cost pair
#: ``analytic_flops`` / ``analytic_bytes`` (``obs.attribution``). Fields
#: absent in a row train as 0.
FEATURE_SCHEMA_VERSION = 6

_platform_cache: str | None = None


def device_platform() -> str:
    """Best-effort device platform for feature rows WITHOUT importing
    torch OR initializing CUDA — a host-only serving process must not
    drag context creation into its executor thread. ``"none"`` until
    something else imports torch, ``"cpu"`` while no CUDA context
    exists, and ``"gpu"`` (cached) once one does."""
    global _platform_cache
    if _platform_cache is not None:
        return _platform_cache
    if sys.modules.get("torch") is None:
        return "none"       # don't cache: torch may import later
    if cuda_initialized():
        _platform_cache = "gpu"
        return _platform_cache
    return "cpu"            # don't cache: CUDA may initialize later


class FeatureLog:
    """Bounded in-memory log of per-request cost-model features.

    One dict per served request, appended by the serving executor
    (route, batch, padding bucket, queue/execute ms) and enriched by
    model transforms through :meth:`record` or
    ``StepProfiler.step(features=...)`` (op shapes, dtype, device ms).
    This is TRAINING DATA for a learned performance model that prices
    admission and batch-close decisions — bounded (ring buffer) so an always-on
    server never grows it past ``maxlen`` records.

    Every record is stamped with :data:`FEATURE_SCHEMA_VERSION` and the
    device ``platform`` unless the caller supplies them;
    :attr:`total_recorded` counts monotonically past the ring bound
    (the cost model's refresh trigger).
    """

    def __init__(self, maxlen: int = 4096, registry=None):
        reg = registry if registry is not None else _registry
        self._lock = threading.Lock()
        self._records = collections.deque(maxlen=int(maxlen))
        self._total = 0
        self._c_records = reg.counter(
            "profile_feature_records_total",
            "cost-model feature records appended, by service")

    def record(self, **fields) -> None:
        fields.setdefault("schema_version", FEATURE_SCHEMA_VERSION)
        fields.setdefault("platform", device_platform())
        fields.setdefault("process", process_label())
        with self._lock:
            self._records.append(dict(fields))
            self._total += 1
        self._c_records.inc(1, service=str(fields.get("service", "")))

    @property
    def total_recorded(self) -> int:
        """Monotone append count (NOT bounded by the ring)."""
        with self._lock:
            return self._total

    def snapshot(self) -> list[dict]:
        """Copy of the retained records, oldest first."""
        with self._lock:
            return [dict(r) for r in self._records]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


#: THE process-wide feature log.
feature_log = FeatureLog()


# ------------------------------------------------- pipeline profiling hook
# PipelineModel.transform consults this: None (the default) keeps the
# async-dispatch pipeline untouched; enabling it syncs per stage (that
# is the point — attribution requires the synchronize delta).
_pipeline_profiler: StepProfiler | None = None
_env_checked = False


def enable_pipeline_profiling(profiler: StepProfiler | None = None
                              ) -> StepProfiler:
    """Turn on per-stage host/device attribution for every
    ``PipelineModel.transform`` (also via MMLSPARK_TPU_PROFILE_PIPELINE=1).
    Costs one device sync per stage — measurement, not a free lunch."""
    global _pipeline_profiler
    _pipeline_profiler = profiler if profiler is not None \
        else step_profiler
    return _pipeline_profiler


def disable_pipeline_profiling() -> None:
    global _pipeline_profiler, _env_checked
    _pipeline_profiler = None
    _env_checked = True  # an explicit disable beats the env default


def pipeline_profiler() -> StepProfiler | None:
    """The active pipeline profiler or None (the hot-path check)."""
    global _env_checked
    if _pipeline_profiler is None and not _env_checked:
        _env_checked = True
        if os.environ.get("MMLSPARK_TPU_PROFILE_PIPELINE") == "1":
            enable_pipeline_profiling()
    return _pipeline_profiler


# ------------------------------------------------ torch.profiler traces
@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a host+device trace of the enclosed region with
    ``torch.profiler`` and write it to ``log_dir/trace.json`` (Chrome
    trace format; open in Perfetto). Device activity is recorded only
    where a CUDA context already exists; the capture never creates one.
    Yields the profiler."""
    import torch.profiler as tp
    acts = [tp.ProfilerActivity.CPU]
    if cuda_initialized():
        acts.append(tp.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tp.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profiled(name: str | None = None):
    """Decorator: annotate a function in ``torch.profiler`` traces
    (``torch.profiler.record_function``)."""
    def wrap(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            import torch.profiler
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner
    return wrap
