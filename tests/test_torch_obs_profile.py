"""The port's profiler plane (``mmlspark_torch/obs/profile.py``, propagation
and export) against the JAX package's.

Every scenario of ``test_obs_profile.py`` that needs no serving front,
load generator or chaos harness runs against the port (the scheduler's
trace handoff included) on the
same inputs and with the same assertions (``torch_obs_port``). The
scenarios whose subject is ``jax.jit`` or a jax array have port versions
here: ``CompileTracker.track`` keyed on torch input signatures (the
engine's tracked steps, steady state included), ``StepProfiler``'s
synchronize of the CUDA devices a result lives on (on stand-ins of CUDA
tensors, ``torch.cuda.synchronize`` recorded), the opt-in pipeline hook on
the port's stages, and ``torch.profiler`` captures. Both packages' step
profilers and feature logs must agree on the same inputs.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import mmlspark_torch.obs as tobs
import mmlspark_tpu.obs as jobs
from mmlspark_torch.core import DataFrame
from mmlspark_torch.core.pipeline import PipelineModel
from mmlspark_torch.obs import profile as tprofile
from mmlspark_torch.obs.profile import (CompileTracker, StepProfiler,
                                        _block_on, profile_trace, profiled)
from mmlspark_torch.stages import RenameColumn, SelectColumns
from torch_obs_port import port_reference_tests

globals().update(port_reference_tests("test_obs_profile.py", (
    # jax.jit call sites, jax arrays and flax: the port's versions of the
    # three scenarios are TestCompileTracker below
    "TestCompileTracker.test_flags_shape_unstable_fn_and_counts_hits",
    "TestCompileTracker.test_jit_kwargs_and_result_pass_through",
    "TestCompileTracker.test_train_step_is_tracked",
    # jax arrays and the JAX stages: port versions below
    "TestStepProfiler.test_dispatch_device_split_and_spans",
    "TestStepProfiler.test_pipeline_profiling_hook",
    # the serving fronts and the load generator (item 9d)
    "TestFeatureLog.test_serving_executor_records_features",
    "TestLoadgenTraceIds.test_summarize_reports_p99_slowest_trace_ids",
    "TestLoadgenTraceIds.test_summarize_trace_ids_respect_warmup_offset",
    "TestLoadgenTraceIds.test_summarize_without_prefix_keeps_quiet",
    # the JAX package's deprecated utils.profiling path: no counterpart
    "TestDeprecationShim.test_utils_profiling_warns_and_reexports",
    "TestDeprecationShim.test_utils_package_import_does_not_warn",
    # the JAX package's benchmark harness (item 9d)
    "TestOverheadGuard.test_tracing_profiler_overhead_within_5pct",
    "TestChaosTraceAcceptance.test_chaos_run_yields_complete_span_trees")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch: tier-1 runs several worker processes at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def synced(monkeypatch):
    """``torch.cuda.synchronize`` recorded instead of run."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    return calls


def _on_card(index=0):
    """A stand-in of a CUDA tensor: what ``_block_on`` reads of one."""
    return types.SimpleNamespace(device=torch.device("cuda", index),
                                 data_ptr=lambda: 0)


# ---------------------------------------------------------- CompileTracker
class TestPortCompileTracker:
    def test_flags_shape_unstable_fn_and_counts_hits(self):
        reg = tobs.MetricsRegistry()
        tracker = CompileTracker(registry=reg)
        unstable = tracker.track(lambda x: (x * 2).sum(), name="unstable")
        stable = tracker.track(lambda x: x + 1, name="stable")
        for n in (4, 8, 16):                # a new shape every call
            unstable(torch.ones(n))
        for _ in range(3):
            stable(torch.ones(4))
        assert tracker.compiles("unstable") == 3
        assert tracker.unstable() == {"unstable": 3}
        assert tracker.compiles("stable") == 1
        assert tracker.stats() == {"stable": {"compiles": 1, "calls": 3},
                                   "unstable": {"compiles": 3,
                                                "calls": 3}}
        snap = reg.snapshot()
        assert snap['profile_jit_calls_total{fn="stable",'
                    'outcome="hit"}'] == 2
        assert snap['profile_jit_calls_total{fn="stable",'
                    'outcome="miss"}'] == 1
        assert snap['profile_compiles_total{fn="unstable"}'] == 3
        assert snap['profile_compile_seconds_count{fn="unstable"}'] == 3

    def test_signature_is_shape_dtype_and_device(self):
        tracker = CompileTracker(registry=tobs.MetricsRegistry())
        f = tracker.track(lambda *a, **k: None, name="sig")
        f(torch.ones(2, 3), 1, k=np.zeros(4, np.int64))
        f(torch.zeros(2, 3), 7, k=np.ones(4, np.int64))   # values differ
        assert tracker.compiles("sig") == 1
        f(torch.ones(2, 3, dtype=torch.float64), 1, k=np.zeros(4))
        f(torch.ones(2, 3), 1.0, k=np.zeros(4, np.int64))  # a float arg
        f(torch.ones(2, 3), 1, k=[np.zeros(4, np.int64)])  # a list
        assert tracker.compiles("sig") == 4

    def test_dict_signature_never_formats_values(self):
        """A dict argument's signature sorts by key alone: formatting a
        CUDA tensor value to sort would copy it to the host (the fused
        segments' bodies take dicts of device tensors)."""
        class Unprintable:
            shape, dtype, device = (3,), torch.float32, "cuda:0"

            def __repr__(self):
                raise AssertionError("a value was formatted")
        sig = tprofile._signature(({"b": Unprintable(), "a": 1},), {})
        assert sig == ((("dict", (("a", "int"),
                                  ("b", ((3,), "torch.float32",
                                         "cuda:0")))),),
                       ())

    def test_result_and_errors_pass_through(self):
        tracker = CompileTracker(registry=tobs.MetricsRegistry())
        f = tracker.track(name="passthrough")(lambda x: x * 2)
        torch.testing.assert_close(f(torch.tensor([1.0, 2.0])),
                                   torch.tensor([2.0, 4.0]))
        assert f.__tracked_label__ == "passthrough"

        def boom(x):
            raise ValueError("nope")
        g = tracker.track(boom)
        with pytest.raises(ValueError):
            g(torch.ones(1))
        assert tracker.compiles("boom") == 1

    def test_steady_state_names_late_signatures(self):
        reg = tobs.MetricsRegistry()
        tracker = CompileTracker(registry=reg)
        f = tracker.track(lambda x: x, name="step")
        f(torch.ones(4))
        tracker.mark_steady()
        f(torch.ones(4))
        tracker.assert_steady_state()
        f(torch.ones(5))
        assert tracker.runtime_compiled() == {"step": 1}
        assert tracker.runtime_compiles() == 1
        assert tracker.runtime_signatures() == {
            "step": [((((5,), "torch.float32", "cpu"),), ())]}
        with pytest.raises(AssertionError, match="step"):
            tracker.assert_steady_state()
        assert reg.snapshot()[
            'profile_runtime_compiles_total{fn="step"}'] == 1
        tracker.unmark_steady()
        assert tracker.runtime_compiled() == {}


class TestCompileTracker:
    """``test_obs_profile.py``'s three scenarios on the port: the
    decorator form, the process-wide tracker behind the port's compiled
    call sites (a fused segment, the train step), results passing
    through."""

    def test_flags_shape_unstable_fn_and_counts_hits(self):
        reg = tobs.MetricsRegistry()
        tracker = CompileTracker(registry=reg)

        @tracker.track(name="unstable")
        def unstable(x):
            return (x * 2).sum()

        @tracker.track
        def stable(x):
            return x + 1
        for n in (4, 8, 16):  # novel shape every call
            unstable(torch.ones(n))
        for _ in range(3):
            stable(torch.ones(4))
        assert tracker.compiles("unstable") >= 2
        assert tracker.unstable() == {"unstable":
                                      tracker.compiles("unstable")}
        assert tracker.compiles("stable") == 1
        snap = reg.snapshot()
        assert snap['profile_jit_calls_total{fn="stable",'
                    'outcome="hit"}'] == 2
        assert snap['profile_jit_calls_total{fn="stable",'
                    'outcome="miss"}'] == 1
        assert snap['profile_compiles_total{fn="unstable"}'] >= 2
        assert snap['profile_compile_seconds_count{fn="unstable"}'] \
            >= 2
        # a fused segment routes through the process-wide tracker with
        # the same semantics (the call-site surface the compiler uses)
        from mmlspark_torch.core import compile_pipeline
        from mmlspark_torch.stages import UDFTransformer
        df = DataFrame({"v": np.ones(2, np.float32)})
        cp = compile_pipeline([UDFTransformer(
            inputCol="v", outputCol="o", jitSafe=True,
            udf=lambda x: x * 3)], df, service="compat_smoke_fn",
            device="cpu")
        cp.transform(df)
        assert tobs.compile_tracker.compiles("compat_smoke_fn:seg0") == 1

    def test_jit_kwargs_and_result_pass_through(self):
        tracker = CompileTracker(registry=tobs.MetricsRegistry())

        def double(x, *, scale=2.0):
            return x * scale
        f = tracker.track(double, name="passthrough")
        out = f(torch.tensor([1.0, 2.0]))
        assert np.allclose(np.asarray(out), [2.0, 4.0])
        assert np.allclose(np.asarray(f(torch.ones(1), scale=3.0)), [3.0])
        # the escape hatch: the wrapped function itself
        assert f.__wrapped__ is double

    def test_train_step_is_tracked(self):
        """``dl.make_train_step`` routes through the tracker: one compile,
        then hits — steady-state training shows zero recompiles."""
        from mmlspark_torch.dl import TrainState, make_train_step

        class Tiny(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.dense = torch.nn.Linear(5, 3)

            def forward(self, x, train=True):
                return self.dense(x)

        net = Tiny()
        opt = torch.optim.SGD(net.parameters(), lr=0.1)
        state = TrainState(net, opt)
        step = make_train_step(net, opt)
        before = tobs.compile_tracker.compiles("train_step")
        x = torch.zeros(4, 5)
        y = torch.zeros(4, dtype=torch.int64)
        state, _ = step(state, x, y)
        state, _ = step(state, x, y)
        assert tobs.compile_tracker.compiles("train_step") == before + 1


def test_engine_steps_are_tracked_and_steady():
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   make_attention_fn)
    from mmlspark_torch.serving import LLMEngine
    g = torch.Generator().manual_seed(1)
    lm = MaskedLMModel(TextEncoder(
        vocab=32, width=16, depth=1, heads=2, mlp_dim=32,
        dtype=torch.float32, generator=g,
        attention_fn=make_attention_fn("pallas", causal=True)), g)
    eng = LLMEngine(lm, slots=2, block_len=4, max_seq_len=16,
                    service="tracked", registry=tobs.MetricsRegistry(),
                    device="cpu")
    ct = tobs.compile_tracker
    try:
        eng.warm(prefill_windows=(4,))
        assert ct.steady
        names = ("llm_prefill_tracked_w4_b2",
                 "llm_decode_paged_tracked_S2_k0")
        assert {n: ct.compiles(n) for n in names} == dict.fromkeys(names, 1)
        for i, n in enumerate((3, 4, 2)):       # windows 4, 4 and 2
            eng.submit(i, np.arange(2, 2 + n, dtype=np.int32), 3)
        eng.run_until_drained()
        assert ct.compiles("llm_decode_paged_tracked_S2_k0") == 1
        assert ct.calls("llm_decode_paged_tracked_S2_k0") > 2
        late = ct.runtime_compiled()
        assert late == {"llm_prefill_tracked_w2_b2": 1}
        assert list(ct.runtime_signatures()) == ["llm_prefill_tracked_w2_b2"]
    finally:
        ct.unmark_steady()


# ------------------------------------------------------------ StepProfiler
class TestPortStepProfiler:
    def test_dispatch_device_split_and_spans(self, synced):
        reg = tobs.MetricsRegistry()
        prof = StepProfiler(service="t", registry=reg)
        with tobs.SpanCollector() as col:
            with tobs.tracer.span("request") as root:
                with prof.step("matmul", flops=2 * 32 ** 3) as h:
                    out = torch.ones(32, 32) @ torch.ones(32, 32)
                    h.done({"out": out, "card": [_on_card(0)]})
        assert synced == [torch.device("cuda", 0)]
        assert h.synced and h.seconds == pytest.approx(
            h.dispatch_seconds + h.device_seconds)
        snap = reg.snapshot()
        assert snap['profile_steps_total{stage="matmul"}'] == 1
        assert snap['profile_step_seconds_count{phase="device",'
                    'stage="matmul"}'] == 1
        assert snap['profile_mfu{platform="cpu",stage="matmul"}'] > 0
        spans = {s["name"]: s for s in col.spans()}
        assert spans["profile.dispatch"]["parentId"] == root.span_id
        assert spans["profile.device"]["parentId"] == \
            spans["profile.dispatch"]["spanId"]
        assert spans["profile.device"]["attrs"]["synced"] is True

    def test_block_on_finds_cuda_tensors_everywhere(self, synced):
        frame = types.SimpleNamespace(columns=["a", "b"])
        cols = {"a": np.arange(3), "b": [_on_card(1), "text", None]}
        frame.__getitem__ = cols.__getitem__
        holder = type("Frame", (), {"columns": ["a", "b"],
                                    "__getitem__": lambda s, c: cols[c]})()
        assert _block_on(holder) is True
        assert _block_on([np.zeros(3), ("x", 1)]) is False
        assert _block_on(torch.ones(3)) is False        # a CPU tensor
        assert _block_on(None, devices=["cuda:0"]) is True
        assert synced == [torch.device("cuda", 1), torch.device("cuda", 0)]

    def test_named_devices_sync_a_host_result(self, synced):
        prof = StepProfiler(registry=tobs.MetricsRegistry())
        with prof.step("to_host") as h:
            h.done(np.zeros(4), devices={"cuda"})
        assert h.synced and synced == [torch.device("cuda")]

    def test_step_series_match_jax(self):
        """The same steps, host-only, give the same series in both
        packages (counts and MFU label set; the seconds are measured)."""
        out = []
        for obs in (jobs, tobs):
            reg = obs.MetricsRegistry()
            prof = obs.StepProfiler(service="x", registry=reg)
            for stage in ("a", "b", "a"):
                with prof.step(stage, flops=1e6) as h:
                    h.done([1, 2])
            out.append(sorted(k for k in reg.snapshot()
                              if "_sum" not in k and "_bucket" not in k))
        assert out[0] == out[1]


def test_pipeline_profiling_hook(monkeypatch):
    df = DataFrame({"a": np.arange(4), "b": np.arange(4)})
    model = PipelineModel([RenameColumn(inputCol="a", outputCol="c"),
                           SelectColumns(cols=["c"])])
    reg = tobs.MetricsRegistry()
    prof = StepProfiler(registry=reg)
    try:
        tprofile.enable_pipeline_profiling(prof)
        out = model.transform(df)
    finally:
        tprofile.disable_pipeline_profiling()
    assert out.columns == ["c"]
    snap = reg.snapshot()
    assert snap['profile_steps_total{stage="RenameColumn"}'] == 1
    assert snap['profile_steps_total{stage="SelectColumns"}'] == 1
    model.transform(df)                       # disabled: nothing new
    assert reg.snapshot() == snap
    # the env switch turns it on at the first check
    monkeypatch.setenv("MMLSPARK_TPU_PROFILE_PIPELINE", "1")
    monkeypatch.setattr(tprofile, "_env_checked", False)
    try:
        assert tprofile.pipeline_profiler() is tobs.step_profiler
    finally:
        tprofile.disable_pipeline_profiling()


# ------------------------------------------------------------- FeatureLog
def test_feature_rows_match_jax_on_a_host_process():
    rows = []
    for obs in (jobs, tobs):
        log = obs.FeatureLog(maxlen=3, registry=obs.MetricsRegistry())
        for i in range(5):
            log.record(service="s", route="decode", batch=i,
                       analytic_flops=1.5 * i, analytic_bytes=2.0)
        rows.append((log.snapshot(), log.total_recorded))
    assert rows[0][1] == rows[1][1] == 5
    # the platform stamp is each package's: JAX's pinned CPU backend, the
    # port's CPU (no CUDA context)
    strip = [[{k: v for k, v in r.items() if k != "platform"}
              for r in snap] for snap, _ in rows]
    assert strip[0] == strip[1]
    assert {r["platform"] for r in rows[1][0]} == {"cpu"}


def test_process_label_reads_an_initialized_group(monkeypatch):
    assert tprofile.process_label() is None
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 2)
    assert tprofile.process_label() == "2"
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
    assert tprofile.process_label() is None


# ------------------------------------------------------- torch.profiler
def test_profile_trace_and_profiled_annotate(tmp_path):
    @profiled("obs.profiled.fn")
    def work():
        return torch.ones(16, 16) @ torch.ones(16, 16)

    with profile_trace(str(tmp_path)):
        work()
        with tobs.tracer.span("obs.span.device", device=True):
            work()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"obs.profiled.fn", "obs.span.device"} <= names
