"""The port's observability plane (``mmlspark_torch/obs``) against the JAX
package's ``obs``: metrics, tracing, propagation, export, memory and cost
attribution, and their wiring into the GBDT fit, every stage call and
``Timer``.

Every scenario of ``test_obs.py``, ``test_obs_memory.py`` and
``test_attribution.py`` that needs no serving mesh or autoscaler runs
against the port (the serving fronts' scenarios through the port's
``serving`` and ``io.http``) (the cost model and the attribution
scenario included, through the port's ``perf`` and ``testing``) on the
same inputs and with the same assertions (``torch_obs_port``); the ones
whose subject differs in the port (JAX's backend guard, the TPU peak rows,
``cost_analysis``) have port versions here, and the rest are listed in
ROADMAP.md. Then both packages run the same inputs and must agree
exactly: exposition text, span trees under an injected clock, Chrome-trace
JSON, traceparent round trips, shared peak rows and rooflines, and the GBDT
fit's span tree and round histogram (the JAX fit at ``scanChunk=1``, its
per-iteration path). The cost counts of the K1-K3 wrappers must be equal
on the plain route and on a stand-in of the CUDA route.
"""

import ctypes
import json
import logging
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import mmlspark_torch.obs as tobs
import mmlspark_tpu.obs as jobs
from mmlspark_torch.core import DataFrame, Pipeline, Transformer
from mmlspark_torch.core.contracts import HasDevice
from mmlspark_torch.dl import flash_attention as k2
from mmlspark_torch.dl import paged_attention as k3
from mmlspark_torch.lightgbm import LightGBMClassifier, LightGBMRegressor
from mmlspark_torch.lightgbm import hist as k1
from mmlspark_torch.obs import attribution as attr_mod
from mmlspark_torch.obs import memory as memmod
from mmlspark_torch.obs import tracing as ttracing
from mmlspark_torch.obs import xprof as xprof_mod
from mmlspark_torch.obs.attribution import count_cost
from mmlspark_torch.stages import Timer
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core import Pipeline as JPipeline
from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier
from mmlspark_tpu.lightgbm import LightGBMRegressor as JRegressor
from mmlspark_tpu.obs import tracing as jtracing
from test_torch_head_dims import kernel_route  # noqa: F401 (fixture)
from test_torch_paged import decode_route, paged_inputs  # noqa: F401
from torch_obs_port import port_reference_tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

globals().update(port_reference_tests("test_obs.py", (
    # the JAX package's deprecated utils.profiling path: no counterpart
    "TestTracing.test_profiling_reexport",
    # the port's fit: test_fit_span_tree_matches_jax below
    "TestLightGBMSpans.test_fit_produces_nested_boosting_round_spans"),
    rewrites=(
    # TestServingEndToEnd serves through the port's threaded front
    ("mmlspark_tpu.serving", "mmlspark_torch.serving"),
    ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"))))
globals().update(port_reference_tests("test_obs_memory.py", (
    # JAX's backend guard: the port's is CUDA's, tested below
    "TestDegradation.test_no_jax_import_returns_empty_never_raises",
    "TestDegradation.test_cpu_devices_without_memory_stats_skipped",
    "TestDegradation.test_raising_memory_stats_tolerated",
    # the autoscaler (item 9d-2)
    "TestHooks.test_scale_up_notes_memory_event")))
globals().update(port_reference_tests("test_attribution.py", (
    # the TPU rows: the port's table has the H100's (TestPortPeakSpec)
    "TestPeakSpec.test_table_rows_resolve_by_name",
    "TestPeakSpec.test_tpu_family_defaults_to_v5e",
    "TestPeakSpec.test_env_overrides_win_over_table",
    # XLA cost_analysis: the port counts a call (record_call, below)
    "TestCostAttribution.test_matmul_bound_segment_cpu_analytic_path",
    # the JAX engine: the port's engine below
    "TestLLMWarmAttribution.test_warm_records_prefill_and_decode_programs",
    # JAX's backend guard: a port capture records host activity instead
    "TestXprofCaptures.test_no_jax_degrades_to_503_with_reason"),
    rewrites=(
    # TestDebugRoutesBothFronts serves through both of the port's fronts
    ("mmlspark_tpu.serving", "mmlspark_torch.serving"),
    ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
    ("mmlspark_tpu.native", "mmlspark_torch.native"),
    # TestAotCostPersistence builds and warms the port's AOT store
    ("mmlspark_tpu.core", "mmlspark_torch.core"),
    ("mmlspark_tpu.featurize", "mmlspark_torch.featurize"))))

PKGS = (jobs, tobs)


@pytest.fixture(autouse=True)
def _aot_scenario_on_cpu(request, monkeypatch):
    """TestAotCostPersistence compiles at the port's default device:
    point ``resolve_device`` at the CPU for it (the CUDA default itself
    is held in ``test_torch_compile.py``)."""
    if request.cls is not None and \
            request.cls.__name__ == "TestAotCostPersistence":
        import mmlspark_torch.device as tdevice
        real = tdevice.resolve_device

        def on_cpu(device=None):
            if device is None or torch.device(device).type == "cuda":
                return torch.device("cpu")
            return real(device)
        monkeypatch.setattr(tdevice, "resolve_device", on_cpu)
    yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch: tier-1 runs several worker processes at
    once, and intra-op threads in each oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(fn):
    return [fn(obs) for obs in PKGS]


class _Events:
    """Telemetry JSON events of one package's logger."""

    def __init__(self, name):
        self.logger = logging.getLogger(name)
        self.records = []

    def __enter__(self):
        outer = self

        class Capture(logging.Handler):
            def emit(self, record):
                outer.records.append(json.loads(record.getMessage()))

        self.handler = Capture(level=logging.INFO)
        self.level = self.logger.level
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self.records

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def _normalized(events):
    """Span/stage events with ids replaced by the order they appear in,
    so two packages' trees compare exactly; ids from outside the list
    read ``"outside"``."""
    ids = {}
    for e in events:
        ids.setdefault(e.get("spanId"), len(ids))
    out = []
    for e in events:
        e = dict(e)
        for key in ("spanId", "parentId", "traceId"):
            if key in e and e[key] is not None:
                e[key] = ids.get(e[key], "outside")
        out.append(e)
    return out


# ------------------------------------------------ exact across packages
def test_exposition_text_matches_jax():
    def run(obs):
        reg = obs.MetricsRegistry()
        c = reg.counter("req_total", "requests served")
        for i in range(20):
            c.inc(i % 3 + 1, route=f"/r{i % 4}", code="200")
        reg.gauge("depth", "queue depth").set(2.5, queue="a")
        h = reg.histogram("lat_seconds", "latency",
                          buckets=obs.DEFAULT_LATENCY_BUCKETS)
        for v in np.random.default_rng(0).lognormal(-5, 2, 200):
            h.observe(float(v), route="/")
        reg.counter("c").inc(1, path='a"b\\c\nd')
        return reg.exposition(), reg.snapshot(), h.quantile(0.9, route="/")
    jx, pt = both(run)
    assert jx == pt


class _FakeClock:
    """A perf_counter that advances 1 ms each read."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.001
        return self.t

    def perf_counter_ns(self):
        return int(self.perf_counter() * 1e9)


def _trace_scenario(obs, tracing, monkeypatch):
    monkeypatch.setattr(tracing, "time", _FakeClock())
    monkeypatch.setattr(tracing, "_WALL0", 1.7e9)
    monkeypatch.setattr(tracing, "_PERF0", 100.0)
    tr = obs.Tracer(registry=obs.MetricsRegistry(), metric="span_seconds")
    with obs.SpanCollector(tracer=tr) as col:
        with tr.span("outer", rows=3) as outer:
            with tr.span("inner", device=False):
                pass
            t = threading.Thread(target=lambda: tr.end_span(
                tr.start_span("child", parent=outer, current=False)))
            t.start()
            t.join()
            tr.emit_span("queued", parent=outer, seconds=0.25, stage="q")
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("nope")
        st = obs.StageTimer(tr)
        with st.span("stage"):
            pass
        detached = tr.start_span("detached", current=False)
        tr.end_span(detached)
    return (_normalized(col.spans()), tr.registry.exposition(),
            round(st.as_dict()["stage"], 9))


def test_span_tree_with_injected_clock_matches_jax(monkeypatch):
    jx = _trace_scenario(jobs, jtracing, monkeypatch)
    pt = _trace_scenario(tobs, ttracing, monkeypatch)
    assert jx == pt
    assert [s["name"] for s in pt[0]] == ["inner", "child", "queued",
                                          "outer", "boom", "stage",
                                          "detached"]


def _spans(rng, n=12):
    out = []
    for i in range(n):
        out.append({"event": "span", "name": f"s{i % 4}",
                    "traceId": f"t{i % 3}", "spanId": f"{i:04x}",
                    "parentId": None if i < 3 else f"{i - 3:04x}",
                    "startWall": 1.7e9 + float(rng.uniform(0, 1)),
                    "seconds": float(rng.uniform(0, 0.1)),
                    "proc": f"p{i % 2}", "attrs": {"i": i}})
    out[5]["error"] = "RuntimeError('x')"
    return out


def test_chrome_trace_and_debug_payload_match_jax():
    spans = _spans(np.random.default_rng(1))

    def run(obs):
        from importlib import import_module
        export = import_module(obs.__name__ + ".export")
        fr = obs.FlightRecorder(keep_slowest=2, keep_errored=2,
                                registry=obs.MetricsRegistry())
        fr.ingest(spans)
        return (json.dumps(obs.chrome_trace(spans), sort_keys=True),
                export.debug_trace_payload(fr))
    jx, pt = both(run)
    assert jx == pt


def test_traceparent_round_trips_across_packages():
    jsp = jobs.tracer.start_span("j", current=False)
    tsp = tobs.tracer.start_span("t", current=False)
    for src, dst, sp in ((jobs, tobs, jsp), (tobs, jobs, tsp)):
        headers = src.inject({}, span=sp)
        ctx = dst.extract(headers)
        assert (ctx.trace_id, ctx.span_id) == (sp.trace_id, sp.span_id)
        child = dst.tracer.start_span("child", parent=ctx, current=False)
        assert child.trace_id == sp.trace_id
        assert child.parent_id == sp.span_id
        for h in ({"TraceParent": headers["traceparent"]},
                  {"traceparent": "junk"}, {}):
            assert (src.extract(h) is None) == (dst.extract(h) is None)
    jobs.tracer.end_span(jsp, emit=False)
    tobs.tracer.end_span(tsp, emit=False)


def test_shared_peak_rows_and_rooflines_match_jax():
    jx, pt = both(lambda obs: obs.peak_spec("cpu"))
    assert (jx.platform, jx.peak_flops, jx.hbm_bytes_per_s) == \
        (pt.platform, pt.peak_flops, pt.hbm_bytes_per_s)
    for flops, nbytes in ((1e12, 0.0), (3e9, 7e8), (0.0, 1e11)):
        assert jx.roofline_seconds(flops, nbytes) == \
            pt.roofline_seconds(flops, nbytes)


# ------------------------------------------------------------- the fit
def _frame(seed=3, n=300, F=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    return x, y


def _round_count(obs):
    return obs.registry.histogram(
        "lightgbm_boosting_round_seconds").count(mode="fused")


FITS = {
    "binary": lambda x, y: (dict(features=x, label=y),
                            dict(numIterations=3, numLeaves=7)),
    "regression_early_stop": lambda x, y: (
        dict(features=x, label=x[:, 0] - x[:, 1],
             val=np.arange(len(y)) % 5 == 0),
        dict(numIterations=30, numLeaves=7, learningRate=0.3,
             earlyStoppingRound=2, validationIndicatorCol="val")),
    "multiclass": lambda x, y: (
        dict(features=x, label=np.digitize(x[:, 0], [-0.5, 0.5])
             .astype(np.float32)),
        dict(objective="multiclass", numIterations=2, numLeaves=5)),
}


@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_span_tree_matches_jax(case):
    """One ``lightgbm.fit`` span with its attributes, one
    ``boosting_round`` child per iteration (``iteration``, ``mode``), the
    round histogram filled once a round, early stopping included."""
    x, y = _frame()
    cols, params = FITS[case](x, y)
    jest = JRegressor if case.startswith("regression") else JClassifier
    test = LightGBMRegressor if case.startswith("regression") \
        else LightGBMClassifier
    out = []
    for obs, est, frame, extra in (
            (jobs, jest, JDataFrame, dict(scanChunk=1)),
            (tobs, test, DataFrame, dict(device="cpu"))):
        before = _round_count(obs)
        with obs.SpanCollector() as col:
            est(**params, **extra).fit(frame(dict(cols)))
        spans = [{k: v for k, v in s.items()
                  if k not in ("seconds", "startWall")}
                 for s in col.spans()
                 if s["name"] in ("lightgbm.fit", "boosting_round")]
        out.append((_normalized(spans), _round_count(obs) - before))
    assert out[0] == out[1]
    spans, rounds = out[1]
    fit = spans[-1]
    assert fit["name"] == "lightgbm.fit" and fit["parentId"] == "outside"
    K = 3 if case == "multiclass" else 1
    assert rounds == len(spans) - 1 == fit["attrs"]["trees"] // K
    assert all(s["parentId"] == fit["spanId"] for s in spans[:-1])
    if case == "regression_early_stop":
        assert rounds < 30 and fit["attrs"]["best_iteration"] >= 0


def test_fit_span_sums_within_fit():
    x, y = _frame()
    with tobs.SpanCollector() as col:
        LightGBMClassifier(device="cpu", numIterations=4,
                           numLeaves=7).fit(DataFrame({"features": x,
                                                       "label": y}))
    fit = [s for s in col.spans() if s["name"] == "lightgbm.fit"][0]
    rounds = [s for s in col.spans() if s["name"] == "boosting_round"]
    assert len(rounds) == 4
    assert sum(r["seconds"] for r in rounds) <= fit["seconds"]


def _stage_events(records):
    calls = [e for e in records if "className" in e and "spanId" in e]
    spans = {e["spanId"]: e for e in calls}
    return [(e["className"], e["method"],
             spans[e["parentId"]]["className"]
             if e["parentId"] in spans else None, "error" in e)
            for e in calls]


def test_stage_events_carry_trace_ids_like_jax():
    x, y = _frame()
    out = []
    for logger, pipe, est, frame, extra in (
            ("mmlspark_tpu.telemetry", JPipeline, JClassifier, JDataFrame,
             {}),
            ("mmlspark_torch.telemetry", Pipeline, LightGBMClassifier,
             DataFrame, dict(device="cpu"))):
        with _Events(logger) as records:
            model = pipe(stages=[est(numIterations=2, numLeaves=5,
                                     **extra)]).fit(
                frame({"features": x, "label": y}))
            model.transform(frame({"features": x}))
            with pytest.raises(Exception):
                est(numIterations=2, **extra).fit(frame({"features": x}))
            assert all(e["traceId"] for e in records if "spanId" in e)
        out.append(_stage_events(records))
    assert out[0] == out[1]
    assert ("LightGBMClassifier", "fit", "Pipeline", False) in out[1]
    assert out[1][-1] == ("LightGBMClassifier", "fit", None, True)
    assert tobs.tracer.current_span() is None


# ------------------------------------------------------------ the Timer
class _OnCard(Transformer, HasDevice):
    """A stage that claims a CUDA device and computes nothing."""

    def _transform(self, df):
        return df


def test_timer_runs_through_the_step_profiler(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    df = DataFrame({"x": np.arange(4.0)})
    with _Events("mmlspark_torch.telemetry") as records, \
            tobs.SpanCollector() as col:
        before = tobs.registry.histogram("profile_step_seconds").count(
            stage="_OnCard", phase="device")
        host = Timer(stage=_OnCard(device="cpu"))
        host.transform(df)
        card = Timer(stage=_OnCard(device="cuda:0"))
        card.transform(df)
    assert host.lastSynced is False and card.lastSynced is True
    assert synced == [torch.device("cuda:0")]
    for t in (host, card):
        assert t.lastDuration == pytest.approx(
            t.lastDispatch + t.lastDevice)
    assert tobs.registry.histogram("profile_step_seconds").count(
        stage="_OnCard", phase="device") == before + 2
    timer_spans = {e["spanId"] for e in records
                   if e.get("className") == "Timer"
                   and e["method"] == "transform"}
    dispatch = [s for s in col.spans() if s["name"] == "profile.dispatch"]
    assert len(dispatch) == 2
    assert {s["parentId"] for s in dispatch} == timer_spans
    timed = [e for e in records if e.get("method") == "timer"]
    assert [e["synced"] for e in timed] == [False, True]


# ---------------------------------------------------------- device memory
SCRAPE = r"""
import sys
import torch
import mmlspark_torch.obs as obs
from mmlspark_torch.obs.profile import device_platform
assert obs.device_memory_stats() == []
assert obs.memory_profiler.update() == []
assert obs.memory_profiler.watermark() is None
assert obs.memory_profiler.note_event("boot") is None
obs.fleet_health.tick()
snap = obs.local_fleet_snapshot()
text = obs.registry.exposition()
assert not any(k.startswith("mem_hbm_") for k in obs.registry.snapshot())
assert obs.peak_spec().platform == "cpu" and device_platform() == "cpu"
assert obs.xprof_captures.list_captures()["available"] is False
assert not torch.cuda.is_initialized()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mmlspark_tpu"))
assert not bad, bad
print("OK")
"""


def test_scrape_never_initializes_cuda():
    """A host-only process's scrape: absent mem gauges, no CUDA context
    created, no JAX imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRAPE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "OK"


@pytest.fixture
def fake_cuda(monkeypatch):
    """A CUDA context of two devices whose allocator stats the test sets."""
    stats = {}
    monkeypatch.setattr(memmod, "_LIMITS", {})
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def memory_stats(i):
        v = stats.get(i)
        if isinstance(v, Exception):
            raise v
        return v

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (10 ** 9, 8 * 10 ** 10))
    return stats


@pytest.mark.parametrize("second", ["full", "none", "empty", "raises"])
def test_device_memory_stats_reads_the_allocator(fake_cuda, second):
    fake_cuda[0] = {"allocated_bytes.all.current": 100,
                    "allocated_bytes.all.peak": 150, "other": 1}
    fake_cuda[1] = {"full": {"allocated_bytes.all.current": 50,
                             "allocated_bytes.all.peak": 60},
                    "none": None, "empty": {},
                    "raises": RuntimeError("no stats")}[second]
    want = [{"device": "0", "bytes_in_use": 100, "peak_bytes_in_use": 150,
             "bytes_limit": 8 * 10 ** 10}]
    if second == "full":
        want.append({"device": "1", "bytes_in_use": 50,
                     "peak_bytes_in_use": 60, "bytes_limit": 8 * 10 ** 10})
    assert tobs.device_memory_stats() == want
    reg = tobs.MetricsRegistry()
    prof = memmod.MemoryProfiler(registry=reg)
    prof.update()
    snap = reg.snapshot()
    assert snap['mem_hbm_bytes_in_use{device="0"}'] == 100
    assert snap['mem_hbm_limit_bytes{device="0"}'] == 8 * 10 ** 10
    assert ('mem_hbm_bytes_in_use{device="1"}' in snap) == \
        (second == "full")
    assert prof.watermark() == 100 + (50 if second == "full" else 0)


# ---------------------------------------------------------- attribution
class TestPortPeakSpec:
    def test_h100_row_from_the_data_sheet(self):
        h100 = tobs.PEAK_SPECS["gpu-h100"]
        assert (h100.peak_flops, h100.hbm_bytes_per_s) == (989e12, 3.35e12)
        assert tobs.peak_spec("gpu-h100") == h100

    def test_gpu_family_defaults_to_h100_without_a_context(self):
        assert not torch.cuda.is_initialized()
        for key in ("gpu", "cuda", "GPU"):
            assert tobs.peak_spec(key).platform == "gpu-h100"
        assert tobs.peak_spec("tpu").platform == "cpu"

    @pytest.mark.parametrize("name,row", [
        ("NVIDIA H100 80GB HBM3", "gpu-h100"),
        ("NVIDIA A100-SXM4-40GB", "gpu-h100")])
    def test_live_part_resolves_by_name(self, monkeypatch, name, row):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: name)
        monkeypatch.setattr(tobs.profile, "_platform_cache", None)
        assert tobs.profile.device_platform() == "gpu"
        monkeypatch.setattr(tobs.profile, "_platform_cache", None)
        assert tobs.peak_spec().platform == row

    def test_env_overrides_win_over_table(self, monkeypatch):
        monkeypatch.setenv(attr_mod.ENV_PEAK_FLOPS, "5e12")
        spec = tobs.peak_spec("gpu-h100")
        assert spec.peak_flops == 5e12
        assert spec.hbm_bytes_per_s == 3.35e12
        monkeypatch.setenv(attr_mod.ENV_PEAK_BYTES, "2e11")
        assert tobs.peak_spec("cpu").hbm_bytes_per_s == 2e11


def test_record_call_counts_a_matmul_as_compute_bound():
    reg = tobs.MetricsRegistry()
    ca = tobs.CostAttribution(registry=reg)
    m = torch.ones(256, 256)
    info = ca.record_call("mm256", lambda a: a @ a, m, service="attr-t",
                          platform="cpu")
    assert info["flops"] == 2 * 256 ** 3
    assert info["bytes"] == 3 * 256 * 256 * 4     # two reads, one write
    assert info["bound"] == "compute"
    assert ca.program_cost("mm256") == info
    snap = reg.snapshot()
    assert snap['profile_roofline_utilization{bound="compute",'
                'program="mm256"}'] == 1.0


def _attention_step(q, k, v, mask, **pos):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with count_cost() as c:
        out = k2.flash_attention(*leaves, mask, **pos)
        (out.float() ** 2).sum().backward()
    with count_cost() as c_lse:
        o, lse = k2.flash_attention_lse(*leaves, mask, **pos)
        (o.float().sum() + lse.sum()).backward()
    return (c.flops, c.bytes, c.analytic_flops, c_lse.flops, c_lse.bytes)


ATTN_CASES = {"masked": {}, "causal": dict(causal=True),
              "causal_offsets": dict(causal=True, q_offset=5, k_offset=2)}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_counts_equal_on_both_routes(case, request):
    """K2b/K2c-lse forward and K2d/K2e backward under grad: the plain route
    and the CUDA route's wrappers (on a stand-in of the compiled
    libraries) count the same FLOPs and bytes, the kernels' formulas."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 2, 24, 32, generator=g) for _ in range(3))
    mask = torch.ones(2, 24, dtype=torch.bool)
    mask[1, 17:] = False
    pos = ATTN_CASES[case]
    plain = _attention_step(q, k, v, mask, impl="torch", **pos)
    launches = k2.flash_lse_cuda.launches + k2.flash_lse_cuda.causal_launches
    request.getfixturevalue("kernel_route")
    card = _attention_step(q, k, v, mask, **pos)
    assert k2.flash_lse_cuda.launches + k2.flash_lse_cuda.causal_launches \
        == launches + 2
    assert plain == card
    pairs = k2.allowed_pairs(q, mask, **pos)
    assert plain[2] == (4 + 6 + 8) * pairs * 32


@pytest.mark.parametrize("w", [1, 5, 20])
def test_paged_counts_equal_on_both_routes(w, request):
    args = [torch.from_numpy(a) for a in paged_inputs(
        S=4, hd=32, w=w, BL=4, MB=12, seed=w)]
    with count_cost() as plain:
        k3.paged_torch(*args)
    request.getfixturevalue("decode_route")
    with count_cost() as card:
        k3.paged_window_attention(*args)
    assert (plain.flops, plain.bytes) == (card.flops, card.bytes)
    S, H, _, hd = args[0].shape
    p = args[4].long()
    assert plain.flops == 4 * hd * H * int((w * (p + 1)
                                            + w * (w - 1) // 2).sum())


class _FakeHist:
    """Stands in for K1's compiled library on CPU tensors: the launch
    rebuilds bins and values from the pointers it is handed and writes
    the plain histogram."""

    def __init__(self):
        self.calls = 0

    def mmlspark_hist_launch(self, bins, bin_bytes, vals, part, out, n, F,
                             B, fb, grid_x, rows_per_cta, stage_rows,
                             count_host, count_dev, *_):
        self.calls += 1
        ctype, dtype = ((ctypes.c_uint8, np.uint8) if bin_bytes == 1
                        else (ctypes.c_int32, np.int32))
        b = np.ctypeslib.as_array((ctype * (n * F)).from_address(bins))
        v = np.ctypeslib.as_array((ctypes.c_float * (n * 3))
                                  .from_address(vals))
        h = k1.hist_torch(torch.from_numpy(b.view(dtype).reshape(n, F)
                                           .copy()),
                          torch.from_numpy(v.reshape(n, 3).copy()),
                          num_bins=B, count=count_host)
        o = np.ctypeslib.as_array((ctypes.c_float * (F * B * 3))
                                  .from_address(out))
        o[...] = h.reshape(-1).numpy()
        return 0


@pytest.fixture
def hist_route(monkeypatch):
    fake = _FakeHist()
    monkeypatch.setattr(k1, "_check_card", lambda bins: None)
    monkeypatch.setattr(k1, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return fake


def test_hist_and_fit_counts_equal_on_both_routes(hist_route):
    from mmlspark_torch.lightgbm.trainer import TrainConfig, train
    g = torch.Generator().manual_seed(0)
    bins = torch.randint(0, 16, (300, 5), dtype=torch.uint8, generator=g)
    vals = torch.randn(300, 3, generator=g)
    counts = []
    for impl in ("torch", "cuda"):
        with count_cost() as c:
            h = k1.hist(bins, vals, num_bins=16, impl=impl, count=250)
        counts.append((c.flops, c.bytes, h))
    assert counts[0][:2] == counts[1][:2] == (
        3 * 250 * 5, 250 * 5 + 250 * 12 + 5 * 16 * 12)
    torch.testing.assert_close(counts[0][2], counts[1][2])
    x, y = _frame(n=400)
    cfg = TrainConfig(objective="binary", num_iterations=2, num_leaves=5)
    fits = []
    for impl in ("torch", "cuda"):
        with count_cost() as c:
            train(x, y, None, cfg, device="cpu", hist_impl=impl)
        fits.append((c.flops, c.bytes))
    assert hist_route.calls > 2
    assert fits[0] == fits[1] and fits[0][0] > 0


def test_engine_warm_records_prefill_and_decode_programs():
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   make_attention_fn)
    from mmlspark_torch.serving import LLMEngine
    g = torch.Generator().manual_seed(0)
    lm = MaskedLMModel(TextEncoder(
        vocab=32, width=16, depth=1, heads=2, mlp_dim=32,
        dtype=torch.float32, generator=g,
        attention_fn=make_attention_fn("pallas", causal=True)), g)
    eng = LLMEngine(lm, slots=2, block_len=4, max_seq_len=16,
                    service="attr-llm", registry=tobs.MetricsRegistry(),
                    device="cpu")
    fps = eng.warm(prefill_windows=(4,), mark_steady=False)
    assert sorted(fps) == ["llm_decode_paged_attr-llm_S2_k0",
                           "llm_prefill_attr-llm_w4_b2"]
    progs = tobs.cost_attribution.programs()
    prefill = [p for p in progs if p.startswith("llm_prefill_attr-llm")]
    decode = [p for p in progs
              if p.startswith("llm_decode_") and "attr-llm" in p]
    assert prefill == ["llm_prefill_attr-llm_w4_b2"]
    assert decode == ["llm_decode_paged_attr-llm_S2_k0"]
    for p in prefill + decode:
        assert progs[p]["flops"] > 0 and progs[p]["bytes"] > 0
        assert progs[p]["service"] == "attr-llm"
    flops, nbytes = tobs.cost_attribution.service_cost("attr-llm")
    assert flops == sum(progs[p]["flops"] for p in prefill + decode)
    before = tobs.feature_log.total_recorded
    eng.submit("a", np.array([3, 4, 5], np.int32), 3)
    eng.run_until_drained()
    row = tobs.feature_log.snapshot()[-1]
    assert tobs.feature_log.total_recorded == before + 1
    assert (row["service"], row["route"], row["schema_version"]) == (
        "attr-llm", "decode", 6)
    assert (row["analytic_flops"], row["analytic_bytes"]) == (flops, nbytes)
    assert row["decode_steps"] >= 1 and row["platform"] == "cpu"


# ----------------------------------------------------------- captures
def test_capture_without_cuda_records_host_activity(tmp_path):
    xc = tobs.XprofCaptures(root=str(tmp_path),
                            registry=tobs.MetricsRegistry())
    with xc.region("fit") as manifest:
        with tobs.tracer.span("obs.region.probe", device=True):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert manifest["device"] is False and manifest["reason"]
    assert manifest["activities"] == ["cpu"]
    with open(os.path.join(manifest["dir"], "manifest.json")) as f:
        assert json.load(f)["capture"] == manifest["capture"]
    with open(manifest["trace"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "obs.region.probe" in names
    assert manifest["capture"].startswith("capture-0001-fit")
    listing = xc.list_captures()
    assert listing["available"] is False
    assert [c["capture"] for c in listing["captures"]] == \
        [manifest["capture"]]
    with xc.region():
        with pytest.raises(xprof_mod.CaptureBusy):
            with xc.region():
                pass


def test_masked_lm_step_counts_equal_on_both_routes(request):
    """A whole pretraining step (forward, backward through K2b/K2d/K2e or
    their plain versions, AdamW) counts the same FLOPs and bytes on the
    plain route and on the stand-in of the CUDA route: what phase 33 of
    ``chip_smoke.py`` holds on the card at full width."""
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   make_attention_fn, mask_batch,
                                   masked_xent)
    from mmlspark_torch.dl.train import TrainState, make_train_step

    def counted():
        g = torch.Generator().manual_seed(2)
        model = MaskedLMModel(TextEncoder(
            vocab=64, width=64, depth=2, heads=2, mlp_dim=128,
            dtype=torch.float32, generator=g,
            attention_fn=make_attention_fn("pallas")), g)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        step = make_train_step(model, opt, loss_fn=masked_xent,
                               fetch="logits")
        rng = np.random.default_rng(0)
        ids = rng.integers(1, 63, (4, 32))
        ids[1, 20:] = 0
        x, y = (torch.from_numpy(a) for a in mask_batch(ids, rng,
                                                         mask_id=63))
        state, _ = step(TrainState(model=model, optimizer=opt), x, y)
        with count_cost() as c:
            step(state, x, y)
        return c.flops, c.bytes, c.analytic_flops
    plain = counted()
    launches = k2.flash_dkv_cuda.launches
    request.getfixturevalue("kernel_route")
    assert counted() == plain
    assert k2.flash_dkv_cuda.launches == launches + 4   # 2 steps x 2 blocks
    assert 0 < plain[2] < plain[0]
