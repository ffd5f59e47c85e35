"""The port's fleet, time-series, goodput and regression planes
(``mmlspark_torch/obs/{fleet,timeseries,goodput,regression}.py``) against the
JAX package's.

Every scenario of ``test_fleet.py``, ``test_timeseries.py`` and
``test_regression.py`` that needs no serving mesh or autoscaler runs
against the port (the served routes on both of the port's fronts, the
recorder's overhead guard and the regression chaos replay included) (tenancy and the cost model included) on the
same inputs and with the same assertions (``torch_obs_port``); the rest
are listed in ROADMAP.md. Then both packages run the same seeded inputs and their
answers must be equal exactly: timeseries queries and quantiles, CUSUM
decisions, ``compare_benches`` verdicts and the regression CLI's report,
goodput ledgers, ``parse_exposition`` and the fleet's merged exposition.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import mmlspark_torch.obs as tobs
import mmlspark_tpu.obs as jobs
from mmlspark_torch.obs import regression as treg
from mmlspark_tpu.obs import regression as jreg
from torch_obs_port import port_reference_tests

_SERVING = (("mmlspark_tpu.serving", "mmlspark_torch.serving"),
            ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
            ("mmlspark_tpu.native", "mmlspark_torch.native"))

globals().update(port_reference_tests("test_fleet.py", (
    # the serving mesh and the autoscaler (ROADMAP item 9d-2)
    "TestMeshFleetChannel.test_worker_heartbeat_pushes_fleet_source",
    "TestMeshFleetChannel.test_pick_least_loaded_avoids_flagged",
    "TestAutoscalerStragglerReplace.test_rising_edge_replaces_once",
    "TestAutoscalerStragglerReplace.test_read_signals_counts_flagged_ranks",
    "TestFlightRecorderMultiSource."
    "test_thread_worker_payload_never_drains_shared_recorder",
    # the fleet chaos harness needs the mesh and the autoscaler (9d-2)
    "TestFleetChaosScenario."
    "test_straggler_flag_replace_and_healthz_trajectory"),
    rewrites=_SERVING))
globals().update(port_reference_tests("test_timeseries.py",
                                      rewrites=_SERVING))
globals().update(port_reference_tests("test_regression.py"))

PKGS = (jobs, tobs)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch: tier-1 runs several worker processes at
    once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(fn):
    """``fn(obs)`` for the JAX package's obs and the port's."""
    return [fn(obs) for obs in PKGS]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# ------------------------------------------------------------ timeseries
def _store_answers(obs, seed):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    reg = obs.MetricsRegistry()
    store = obs.TimeSeriesStore(reg, clock=clock, default_maxlen=64)
    rec = obs.Recorder(store, registry=reg)
    c = reg.counter("profile_steps_total", "s")
    g = reg.gauge("sched_depth", "d")
    h = reg.histogram("serving_latency_seconds", "l",
                      buckets=(.001, .01, .1, 1.))
    for _ in range(80):
        clock.t += float(rng.uniform(0.5, 2.0))
        c.inc(int(rng.integers(0, 5)), stage="a")
        g.set(float(rng.normal()), tenant="t")
        for v in rng.lognormal(-4, 1.5, size=int(rng.integers(1, 6))):
            h.observe(float(v))
        rec.tick()
    ctr = 'profile_steps_total{stage="a"}'
    gauge = 'sched_depth{tenant="t"}'
    out = {"names": store.series_names(), "size": store.size(),
           "range": store.range(["profile_", "sched_"], window=30.0)}
    for w in (5.0, 20.0, 60.0):
        out[w] = (store.increase(ctr, w), store.rate(ctr, w),
                  store.avg_over_time(gauge, w),
                  store.min_over_time(gauge, w),
                  store.max_over_time(gauge, w),
                  store.mad_over_time(gauge, w),
                  [store.quantile_over_time("serving_latency_seconds", q, w)
                   for q in (0.5, 0.9, 0.99)])
    out["payload"] = store.timeline_payload(
        "series=serving_latency_seconds_bucket&window=40")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeseries_queries_and_quantiles_match_jax(seed):
    jx, pt = both(lambda obs: _store_answers(obs, seed))
    assert jx == pt


# ------------------------------------------------------------ regression
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cusum_decisions_match_jax(seed):
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.normal(1.0, 0.05, 40),
                         rng.normal(1.0 + 0.1 * seed, 0.05, 40)])

    def run(obs):
        det = obs.CusumDetector(warmup=8, k=0.5, h=4.0)
        return [det.update(float(x)) for x in xs]
    jx, pt = both(run)
    assert jx == pt


def _bench(rng, scale=1.0):
    return {"rows_per_s": float(rng.uniform(1e5, 2e5)) * scale,
            "p99_ms": float(rng.uniform(5, 9)) / scale,
            "mfu": float(rng.uniform(0.2, 0.4)) * scale,
            "compile_s": float(rng.uniform(1, 3)),
            "failed_metric": 0.0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_benches_verdicts_match_jax(seed):
    rng = np.random.default_rng(seed)
    old = _bench(rng)
    new = _bench(rng, scale=0.8 if seed else 1.0)
    hist = {k: [v * f for f in (0.97, 1.0, 1.02, 1.05)]
            for k, v in old.items()}
    jx, pt = both(lambda obs: obs.compare_benches(old, new, hist))
    assert jx == pt
    assert jreg.gate_verdict(jx) == treg.gate_verdict(pt)


def test_regression_cli_matches_jax_on_synthetic_files(tmp_path,
                                                       monkeypatch):
    """The CLI's ``gate`` over ``BENCH_r0*.json`` in the cwd: run only in a
    temp dir on synthetic files."""
    rng = np.random.default_rng(5)
    for i in range(4):
        with open(tmp_path / f"BENCH_r0{i + 1}.json", "w") as f:
            json.dump({"metrics": _bench(rng, 1.0 - 0.1 * (i == 3))}, f)
    monkeypatch.chdir(tmp_path)
    outs = []
    for mod in (jreg, treg):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["gate"])
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    assert sorted(os.listdir(tmp_path)) == [f"BENCH_r0{i}.json"
                                            for i in range(1, 5)]


# ------------------------------------------------------------- goodput
def test_goodput_ledger_matches_jax():
    def run(obs):
        clock = _Clock()
        reg = obs.MetricsRegistry()
        led = obs.GoodputLedger(registry=reg, clock=clock)
        rej = reg.counter("gen_spec_rejected_total", "t")
        dec = reg.histogram("gen_decode_attn_seconds", "t")
        tok = reg.counter("gen_tokens_total", "t")
        shed = reg.counter("sched_shed_total", "t")
        payloads = [led.tick()]
        rng = np.random.default_rng(11)
        for _ in range(6):
            clock.t += 2.0
            for v in rng.uniform(0.001, 0.004, 8):
                dec.observe(float(v))
            tok.inc(8)
            rej.inc(int(rng.integers(0, 6)))
            shed.inc(int(rng.integers(0, 3)), tenant="a")
            payloads.append(led.tick())
        return payloads, reg.exposition()
    jx, pt = both(run)
    assert jx == pt


# ------------------------------------------------ fleet and exposition
def _populated(obs):
    reg = obs.MetricsRegistry()
    reg.counter("profile_steps_total", "s").inc(3, stage="fit")
    reg.gauge("mem_hbm_bytes_in_use", "m").set(12345, device="0")
    h = reg.histogram("profile_step_seconds", "t", buckets=(0.01, 0.1, 1.))
    for v in (0.004, 0.05, 0.5, 2.0):
        h.observe(v, stage="fit", phase="device")
    reg.counter("c").inc(1, path='a"b\\c\nd')
    return reg


def test_parse_exposition_matches_jax_both_ways():
    jtext, ttext = both(lambda obs: _populated(obs).exposition())
    assert jtext == ttext
    assert jobs.parse_exposition(ttext) == tobs.parse_exposition(jtext) \
        == tobs.parse_exposition(ttext)


def test_fleet_merge_and_stragglers_match_jax():
    def run(obs):
        clock = _Clock()
        agg = obs.FleetAggregator(registry=obs.MetricsRegistry(),
                                  clock=clock)
        for rank, slow in ((0, 1.0), (1, 1.1), (2, 0.9), (3, 9.0)):
            agg.ingest_snapshot(
                {'profile_step_seconds_sum{stage="fit"}': 10.0 * slow,
                 'profile_step_seconds_count{stage="fit"}': 10.0},
                process=str(rank))
        det = obs.StragglerDetector(agg, registry=obs.MetricsRegistry())
        flagged = [sorted(det.tick()) for _ in range(3)]
        return agg.exposition(), flagged
    jx, pt = both(run)
    assert jx == pt
