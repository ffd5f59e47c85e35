"""Whole-pipeline compilation for the port: fuse runs of traceable stages
into segments that cross the host↔device boundary once.

The port of ``mmlspark_tpu/core/compile.py``. What the reference's fused
segment is for is one host↔device round trip per segment instead of one
per stage; the reference gets it by lowering a run of stages into one
jitted XLA program. The port gets it without compiling anything: a
:class:`FusedSegment` uploads each numeric column to its device once, runs
every stage's traced form (``Transformer._trace``, torch on device
tensors) in turn, and brings every output back in one batched
device→host copy — one synchronisation per segment. There is no
``torch.compile`` and no CUDA graph here: the kernels are eager launches,
and capturing them is work for a PR that makes the port faster.

How: :func:`compile_pipeline` walks the stage list with an example
frame, asking each stage :meth:`~.pipeline.Transformer.supports_trace`
for the frame's schema at that point (schema propagation runs the
example through each stage once — grouping needs every stage's OUTPUT
schema). Maximal runs of traceable stages become :class:`FusedSegment`\\ s
(tracked by the obs :class:`~..obs.profile.CompileTracker` under the
segment's name: the first call of an argument signature is its
"compile"). Host-bound stages (tokenizer string loops, string encodings)
split the run and execute eagerly, exactly as the un-compiled pipeline
would.

Segments run on one device, resolved as every entry point of the port
resolves it (``mmlspark_torch/device.py``): CUDA, or a raise when there is
no GPU, unless the caller asks for ``"cpu"``. Partition rules (``mesh`` /
``rules``) come with ROADMAP.md §1 item 10 and raise until then.

Import is torch-free; planning and running a segment import torch.
"""

from __future__ import annotations

import logging

import numpy as np

from .dataframe import DataFrame, jittable_dtype as jittable
from .pipeline import PipelineModel, Transformer

_LOG = logging.getLogger("mmlspark_torch.core.compile")


def _registry():
    from ..obs.metrics import registry
    return registry


def _no_partition_rules(what: str):
    raise NotImplementedError(
        f"{what}: partition rules over a mesh (the JAX package's "
        "parallel/partition.py) come with ROADMAP.md §1 item 10")


def trace_columns(df: DataFrame) -> dict:
    """The numeric column dict a fused segment operates on."""
    return {c: df[c] for c in df.columns if jittable(df[c].dtype)}


def is_device_error(exc: BaseException) -> bool:
    """A CUDA error (``torch.AcceleratorError``, or a ``RuntimeError``
    whose text names CUDA) or a failed kernel build, anywhere in the
    exception's chain: never absorbed into an eager fallback, which could
    only hide it or fail the same way later."""
    import torch

    from ..native.loader import KernelBuildError
    accel = getattr(torch, "AcceleratorError", None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, KernelBuildError):
            return True
        if accel is not None and isinstance(exc, accel):
            return True
        if isinstance(exc, RuntimeError) and "CUDA" in str(exc):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def device_constant(values, dtype, device):
    """A traced form's constant (levels, weights, indices) as a tensor on
    ``device``, copied without a synchronisation (``non_blocking``: a
    blocking host→device copy waits on the stream, which a traced form
    must not)."""
    import torch
    host = torch.from_numpy(np.ascontiguousarray(np.asarray(values, dtype)))
    return host.to(device, non_blocking=True)


def tensor_lattice(x):
    """``core.dataframe.device_lattice`` on a device tensor: int64 →
    int32 (wrapping) and float64 → float32, the dtypes a stage's eager
    path gives a host column before it becomes a tensor."""
    import torch
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    if x.dtype == torch.float64:
        return x.to(torch.float32)
    return x


# ------------------------------------------------- the host↔device crossing
# torch computes on few unsigned types: uint16/uint32/uint64 columns ride
# as the bits of the signed type of their width (a view, exact), and a
# column that leaves the segment as a view of such an upload goes back to
# its own dtype. No traced form reads one (``dataframe.readable_dtype``).
_AS_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
              np.dtype(np.uint64): np.int64}


def upload(cols: dict, device) -> tuple[dict, dict]:
    """Host columns → device tensors, one copy each. Returns the tensors
    and a lookup of every upload (its host array by tensor, its host
    dtype by storage and device dtype), which :func:`download` uses to
    hand back the host array of a column the segment passed through
    unchanged and to restore the dtype of an unsigned one."""
    import torch
    out, origin = {}, {}
    for c, v in cols.items():
        arr = np.ascontiguousarray(v)
        dev = arr.view(_AS_SIGNED[arr.dtype]) if arr.dtype in _AS_SIGNED \
            else arr
        # non_blocking: no wait per column (a pageable source is staged
        # before the call returns); the segment's one wait is the fetch
        t = torch.from_numpy(dev).to(device, non_blocking=True)
        out[c] = t
        origin[id(t)] = (arr, t)
        origin[("ptr", t.untyped_storage().data_ptr(), t.dtype)] = arr.dtype
    return out, origin


def download(out: dict, origin: dict, device) -> dict:
    """Every tensor of ``out`` → host numpy in ONE device→host copy: the
    outputs' bytes are packed into one device buffer and fetched into one
    host buffer (pinned on CUDA: a copy to pageable memory runs at a
    fraction of the link's rate), with one synchronisation for the whole
    segment, then cut into per-column views. A column that is the very
    tensor a column was uploaded as takes the host array it came from (no
    copy); a view of an upload keeps the uploaded column's host dtype."""
    import torch
    host: dict = {}
    pending = []
    for c, v in out.items():
        if not isinstance(v, torch.Tensor):
            host[c] = np.asarray(v)
            continue
        same = origin.get(id(v))
        if same is not None and same[1] is v:
            host[c] = same[0]
            continue
        pending.append((c, v))
    if not pending:
        return host
    flat = [v.detach().contiguous().reshape(-1).view(torch.uint8)
            if v.dtype != torch.bool else
            v.detach().contiguous().reshape(-1).to(torch.uint8)
            for _, v in pending]
    packed = flat[0] if len(flat) == 1 else torch.cat(flat)
    if packed.device.type == "cuda":
        host_buf = torch.empty(packed.shape, dtype=torch.uint8,
                               pin_memory=True)
        host_buf.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(packed.device).synchronize()
        buf = host_buf.numpy()
    else:
        buf = packed.numpy()
    off = 0
    for (c, v), f in zip(pending, flat):
        n = f.numel()
        np_dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        arr = buf[off:off + n].view(np_dtype).reshape(tuple(v.shape))
        off += n
        ptr_key = ("ptr", v.untyped_storage().data_ptr(), v.dtype)
        if ptr_key in origin and arr.dtype != origin[ptr_key]:
            arr = arr.view(origin[ptr_key])
        host[c] = arr
    return host


def run_traced(stage, cols: dict, device) -> dict:
    """A stage's eager transform through its traced form: ``cols`` (host
    columns of readable dtypes, prepared as the stage's eager path
    prepares them) uploaded to ``device`` once, ``stage._trace`` on the
    tensors, every column it returns brought back in one copy. So a stage
    has one body for its eager transform and a fused segment."""
    dev, origin = upload(cols, device)
    return download(stage._trace(dev), origin, device)


class _EagerStage:
    """Plan item: a host-bound stage (or raw ``df -> df`` callable)
    executed exactly as the un-compiled pipeline would."""

    __slots__ = ("stage", "name")

    def __init__(self, stage):
        self.stage = stage
        self.name = type(stage).__name__

    def run(self, df: DataFrame, profiler=None) -> DataFrame:
        fn = getattr(self.stage, "transform", None) or self.stage
        if profiler is None:
            return fn(df)
        from .pipeline import cuda_devices
        with profiler.step(self.name) as h:
            return h.done(fn(df), cuda_devices(self.stage))


def _on_device(stage, device):
    """``stage`` itself, or a copy computing on ``device`` when it has a
    ``device`` Param set elsewhere (the eager fallback runs on the
    segment's device)."""
    params = {p.name for p in type(stage).params()}
    if "device" not in params or str(stage.get("device")) == str(device):
        return stage
    return stage.copy({"device": str(device)})


class FusedSegment:
    """Plan item: a maximal run of traceable stages executed as ONE
    device round trip over the frame's numeric columns.

    ``run`` uploads each numeric column once, calls the tracked body
    (every stage's ``_trace`` in turn, on the segment's device) and
    fetches all outputs in one batched copy. The body goes through the
    obs :class:`~..obs.profile.CompileTracker` under the segment's name,
    so the first call of an argument signature counts as its compile.

    ``donate`` and ``no_donate`` keep the reference's donation split in
    the segment and its fingerprint; in an eager program they have no
    effect (torch frees an intermediate when its last reference goes).

    A segment that fails at execution time (a shape the static contract
    could not foresee — e.g. a mini-batcher hitting a non-divisible row
    count) falls back to eager per-stage execution for that call, on the
    segment's device, counted in ``pipeline_fused_fallback_total``. A CUDA
    error or a failed kernel build is raised instead (see
    :func:`is_device_error`).
    """

    def __init__(self, stages, name: str, donate: bool = True,
                 mesh=None, rules=None, expected_host=frozenset(),
                 no_donate=frozenset(), device=None):
        if mesh is not None or rules is not None:
            _no_partition_rules("FusedSegment(mesh=, rules=)")
        from ..device import resolve_device
        self.stages = list(stages)
        self.name = name
        self.donate = donate
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device(device)
        # host (non-numeric) column names the EXAMPLE frame carried at
        # segment entry: the compile-time grouping contracts were
        # checked against exactly this set, so a runtime frame with a
        # different host-column set voids them (run() re-checks)
        self.expected_host = frozenset(expected_host)
        # input columns the segment DROPS or reshapes (per the example
        # propagation): the reference's donation split
        self.no_donate = frozenset(no_donate)
        self._fn = None
        self._eager_stages = None
        # per-bucket store entries: arg_sig -> meta dict (store-loaded or
        # backfilled, warmed on zeros) or None (bucket known ineligible).
        # Filled by core.aot warm loading and the first-call store lookup
        self._exes: dict = {}
        reg = _registry()
        self._c_calls = reg.counter(
            "pipeline_fused_calls_total",
            "fused-segment executions, by segment")
        self._c_fallback = reg.counter(
            "pipeline_fused_fallback_total",
            "fused-segment calls that fell back to eager execution")

    # -- the tracked body --------------------------------------------------
    def _body(self, donated: dict, dropped: dict) -> dict:
        cols = dict(donated)
        cols.update(dropped)
        for stage in self.stages:
            cols = stage._trace(cols)
        return cols

    def _split(self, num: dict) -> tuple[dict, dict]:
        """Columns the segment's outputs can alias vs columns it drops."""
        donated = {c: v for c, v in num.items() if c not in self.no_donate}
        dropped = {c: v for c, v in num.items() if c in self.no_donate}
        return donated, dropped

    def _ensure_fn(self):
        if self._fn is None:
            from ..obs.profile import compile_tracker
            self._fn = compile_tracker.track(self._body, name=self.name)
        return self._fn

    def call_device(self, donated: dict, dropped: dict) -> dict:
        """The tracked body on device tensors → device tensors."""
        return self._ensure_fn()(donated, dropped)

    def _aot_entry(self, donated: dict, dropped: dict):
        """The ahead-of-time path: on the first call of a novel bucket
        with a store installed, look the bucket up (a hit loads the
        entry's kernel libraries; a miss is counted loudly and backfills
        the store). Failures degrade to the runtime path — the store is
        an accelerator, never a correctness gate; a CUDA error or a
        failed kernel build is raised."""
        from . import aot
        store = aot.active_store()
        if store is None:
            return None
        sig = aot.arg_sig(donated, dropped)
        if sig in self._exes:
            return self._exes[sig]
        try:
            entry = store.load_or_compile(self, donated, dropped)
        except Exception as e:
            if is_device_error(e):
                raise
            _LOG.warning("aot lookup failed for segment %s; using the "
                         "runtime path", self.name, exc_info=True)
            entry = None
        self._exes[sig] = entry
        return entry

    # -- execution ---------------------------------------------------------
    def _eager(self, df: DataFrame) -> DataFrame:
        self._c_fallback.inc(1, segment=self.name)
        if self._eager_stages is None:
            self._eager_stages = [_on_device(s, self.device)
                                  for s in self.stages]
        cur = df
        for stage in self._eager_stages:
            cur = stage.transform(cur)
        return cur

    def run(self, df: DataFrame, profiler=None) -> DataFrame:
        num = trace_columns(df)
        carry = [(c, df[c]) for c in df.columns if c not in num]
        if {c for c, _ in carry} != self.expected_host:
            # the compile-time grouping contracts (row-change veto,
            # drop/select/rename completeness) were checked against the
            # EXAMPLE's host columns; this frame carries a different
            # host-column set, so the traced forms — which never see
            # host columns — could silently diverge from eager
            # semantics. Eager is the reference behavior; run it.
            _LOG.warning("fused segment %s: host columns %s differ "
                         "from the compile example's %s, running "
                         "eagerly", self.name,
                         sorted(c for c, _ in carry),
                         sorted(self.expected_host))
            return self._eager(df)
        donated, dropped = self._split(num)
        self._aot_entry(donated, dropped)
        try:
            d_dev, origin = upload(donated, self.device)
            p_dev, p_origin = upload(dropped, self.device)
            origin.update(p_origin)
            if profiler is None:
                out = self.call_device(d_dev, p_dev)
            else:
                # the one device round trip that replaced N per-stage
                # ones, attributed to THIS segment
                with profiler.step(self.name) as h:
                    out = h.done(self.call_device(d_dev, p_dev))
            # ONE batched device→host copy for the whole segment output;
            # merging stays inside the fallback boundary so a shape the
            # static contract could not foresee degrades to eager
            # execution instead of a corrupt frame
            merged = _merge_traced(df, download(out, origin, self.device),
                                   carry, self.stages)
        except Exception as e:
            if is_device_error(e):
                raise
            _LOG.warning("fused segment %s fell back to eager "
                         "execution", self.name, exc_info=True)
            return self._eager(df)
        self._c_calls.inc(1, segment=self.name)
        return merged

    def run_sharded(self, columns: dict) -> dict:
        """Execute the fused body on device tensors the caller holds and
        return device tensors (no host crossing, no eager fallback). The
        reference runs this over GLOBAL arrays of a multi-process mesh;
        a segment with a mesh raises until ROADMAP.md §1 item 10."""
        if self.mesh is not None:
            _no_partition_rules("FusedSegment.run_sharded over a mesh")
        donated, dropped = self._split(dict(columns))
        out = self.call_device(donated, dropped)
        self._c_calls.inc(1, segment=self.name)
        return out


def _merge_traced(df: DataFrame, out: dict, carry,
                  stages) -> DataFrame:
    """Traced output columns (host arrays, or tensors materialised here)
    + host-carried columns → DataFrame. Column order follows the input
    frame, renamed/new columns append in ``_trace`` output order. Host
    metadata hooks (partition counts, column metadata) apply last."""
    from .dataframe import to_host
    host = {c: to_host(v) for c, v in out.items()}
    data: dict[str, np.ndarray] = {}
    carried = dict(carry)
    for c in df.columns:
        if c in host:
            data[c] = host.pop(c)
        elif c in carried:
            data[c] = carried[c]
    data.update(host)
    # DataFrame.__new__ below skips __init__'s validation — re-check the
    # one invariant that matters so a row-count mismatch (traced columns
    # reshaped, a carried column not) raises into the eager fallback
    # instead of building a silently mis-aligned frame
    lengths = {len(v) for v in data.values()}
    if len(lengths) > 1:
        raise ValueError(
            f"fused segment produced ragged column lengths {lengths}")
    new = DataFrame.__new__(DataFrame)
    new._data = data
    new.num_partitions = df.num_partitions
    for stage in stages:
        hooked = stage._post_host(new)
        # explicit None check: a 0-row DataFrame is falsy, and the
        # hook's result (metadata attach, repartition) must not be
        # dropped on legitimately empty runtime frames
        if hooked is not None:
            new = hooked
    return new


class CompiledPipeline:
    """A lowered pipeline: an ordered plan of :class:`FusedSegment` and
    :class:`_EagerStage` items. Duck-types a Transformer (``transform``
    / ``__call__``), so it drops in anywhere a stage fits."""

    def __init__(self, plan, service: str = "pipeline"):
        self.plan = list(plan)
        self.service = service

    # -- introspection -----------------------------------------------------
    @property
    def compiled_segments(self) -> int:
        """Fused-segment count — the device round trips per call for the
        traced portion."""
        return sum(1 for p in self.plan if isinstance(p, FusedSegment))

    @property
    def fused_stages(self) -> int:
        return sum(len(p.stages) for p in self.plan
                   if isinstance(p, FusedSegment))

    @property
    def eager_stages(self) -> int:
        return sum(1 for p in self.plan if isinstance(p, _EagerStage))

    def describe(self) -> list[dict]:
        """Human/bench-readable plan: one dict per item."""
        out = []
        for p in self.plan:
            if isinstance(p, FusedSegment):
                out.append({"kind": "fused", "segment": p.name,
                            "stages": [type(s).__name__
                                       for s in p.stages]})
            else:
                out.append({"kind": "eager", "stage": p.name})
        return out

    def warm_aot(self, store=None) -> int:
        """Warm every store-resident bucket of this plan's fused segments
        (the scale-up warm boot, ``core/aot.py``): each runs once on
        zeros, after its kernel libraries load from the store. Returns
        the buckets warmed; 0 when no store is installed/on disk."""
        from . import aot
        if store is not None:
            aot.install(store)
        loaded = aot.maybe_warm(self, service=self.service)
        if loaded:
            # device-memory watermark after the warm boot (obs.memory)
            from ..obs.memory import memory_profiler
            memory_profiler.note_event("aot_warm")
        self.attribute_costs()
        return loaded

    def attribute_costs(self) -> int:
        """Export the roofline placement of every store-resident bucket
        (obs.attribution) from the cost its entry carries. Returns
        programs attributed (one bucket prices a segment)."""
        from ..obs.attribution import cost_attribution
        n = 0
        for item in self.plan:
            if not isinstance(item, FusedSegment):
                continue
            for meta in item._exes.values():
                cost = meta.get("cost") if isinstance(meta, dict) else None
                if not isinstance(cost, dict):
                    continue
                cost_attribution.record_program(
                    item.name, cost.get("flops", 0.0),
                    cost.get("bytes", 0.0),
                    service=item.name.split(":", 1)[0],
                    platform=meta.get("platform") or None)
                n += 1
                break
        return n

    # -- execution ---------------------------------------------------------
    def transform(self, df: DataFrame) -> DataFrame:
        from ..obs.profile import pipeline_profiler
        prof = pipeline_profiler()
        cur = df
        for item in self.plan:
            cur = item.run(cur, profiler=prof)
        return cur

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


def _propagate(stage, cur: DataFrame, device) -> DataFrame:
    """The example through ``stage``'s TRACED form on ``device``: the
    fused layout (e.g. a mini-batcher's [nb, size] numeric output vs its
    eager object cells) is what the next stage's contract must see."""
    num = trace_columns(cur)
    carry = [(c, cur[c]) for c in cur.columns if c not in num]
    dev, origin = upload(num, device)
    return _merge_traced(cur, download(stage._trace(dev), origin, device),
                         carry, [stage])


def compile_pipeline(model_or_stages, example_df: DataFrame, *,
                     mesh=None, rules=None, donate: bool = True,
                     service: str = "pipeline",
                     device=None) -> CompiledPipeline:
    """Lower a ``PipelineModel`` (or stage list) into a
    :class:`CompiledPipeline` whose segments run on ``device`` (CUDA
    unless ``"cpu"`` is asked for; no GPU raises).

    Walks the stages with ``example_df``, greedily grouping maximal
    runs of stages whose :meth:`supports_trace` accepts the schema AT
    THAT POINT in the pipeline (the example runs through each stage once
    to propagate schemas). Stages whose ``_trace`` changes the row
    count only join a segment when every column is numeric — a
    host-carried string column cannot be re-attached to a reshaped
    frame. An all-host pipeline degrades to per-stage execution
    exactly (plan of eager items, zero segments).
    """
    if mesh is not None or rules is not None:
        _no_partition_rules("compile_pipeline(mesh=, rules=)")
    from ..device import resolve_device
    device = resolve_device(device)
    if isinstance(model_or_stages, PipelineModel):
        stages = list(model_or_stages.getOrDefault("stages"))
    else:
        stages = list(model_or_stages)
    plan: list = []
    run: list = []
    run_host: frozenset = frozenset()
    run_entry_cols: dict = {}
    seg_idx = 0
    cur = example_df

    def flush():
        nonlocal seg_idx, run
        if not run:
            return
        # only an entry column that reaches the segment output with the
        # SAME shape and dtype could alias an output buffer — anything
        # dropped, renamed, or reshaped (mini-batchers) is excluded
        exit_cols = {c: (v.shape, v.dtype)
                     for c, v in trace_columns(cur).items()}
        plan.append(FusedSegment(
            run, f"{service}:seg{seg_idx}", donate=donate,
            expected_host=run_host,
            no_donate=frozenset(
                c for c, sig in run_entry_cols.items()
                if exit_cols.get(c) != sig),
            device=device))
        seg_idx += 1
        run = []

    for stage in stages:
        ok = isinstance(stage, Transformer) and \
            stage.supports_trace(cur.schema, cur.num_rows)
        if ok and getattr(stage, "_trace_changes_rows", False):
            # row-count-changing stages need the WHOLE frame in the
            # traced dict; any host-carried column vetoes fusion here
            ok = all(jittable(dt) for dt, _ in cur.schema.values())
        if ok:
            if not run:
                # the host-column set the grouping contracts are being
                # checked against — run() re-validates it per call —
                # and the numeric entry set of the donation split
                run_host = frozenset(
                    c for c, (dt, _) in cur.schema.items()
                    if not jittable(dt))
                run_entry_cols = {c: (v.shape, v.dtype)
                                  for c, v in trace_columns(cur).items()}
            run.append(stage)
            cur = _propagate(stage, cur, device)
        else:
            flush()
            plan.append(_EagerStage(stage))
            cur = (stage.transform(cur) if hasattr(stage, "transform")
                   else stage(cur))
    flush()
    return CompiledPipeline(plan, service=service)
