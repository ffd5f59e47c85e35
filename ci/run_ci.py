#!/usr/bin/env python
"""One-command CI: style + per-package unit tests + examples + multichip.

The local engine behind ``ci/pipeline.yaml`` (which mirrors the
reference's per-package matrix, ``pipeline.yaml:323-384``).

    python ci/run_ci.py                # everything
    python ci/run_ci.py --only tests --package lightgbm2
    python ci/run_ci.py --only examples
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# package → test files (the reference splits slow packages into split1/2)
PACKAGES: dict[str, list[str]] = {
    "core": ["test_core_dataframe.py", "test_core_params_pipeline.py",
             "test_fuzzing.py", "test_longtail_io.py", "test_arrow.py"],
    "featurize": ["test_featurize.py", "test_stages.py",
              "test_vector_embedding.py"],
    "lightgbm1": ["test_lightgbm.py", "test_lightgbm_categorical.py", "test_pallas_hist.py"],
    "lightgbm2": ["test_lightgbm_sparse.py", "test_lightgbm_distributed.py",
                  "test_lightgbm_format_fixture.py"],
    "vw": ["test_vw.py"],
    "dl": ["test_text_encoder.py", "test_image_dl.py", "test_convert.py",
           "test_bert_convert.py", "test_transfer_learning.py",
           "test_checkpoint_profiling.py", "test_quantize.py",
           "test_parallel.py", "test_pipeline_moe.py",
           "test_sharding_analysis.py", "test_pallas_attention.py"],
    "serving": ["test_http_serving.py", "test_serving_distributed.py",
                "test_serving_native.py", "test_serving_model.py"],
    "cognitive": ["test_cognitive.py", "test_cognitive_speech.py",
                  "test_cognitive_breadth.py"],
    "learners": ["test_learners.py", "test_linear.py",
                 "test_recommendation_lime.py", "test_cyber.py"],
    "io": ["test_native_codegen.py", "test_benchmarks.py",
           "test_reference_parity.py", "test_out_of_core.py",
           "test_ci.py", "test_bench_banking.py", "test_rcheck.py"],
    "obs": ["test_obs.py", "test_obs_profile.py"],
    # fleet telemetry plane: federation + straggler/burn health + the
    # chaos trajectory, and the HBM memory profiler's degradation story
    "fleet": ["test_fleet.py", "test_obs_memory.py"],
    # telemetry history plane: the bounded time-series store, recorder,
    # /debug/timeline on both fronts, and the recorder overhead guard
    "timeseries": ["test_timeseries.py"],
    # perf-regression sentinel: offline bench-trajectory gate + live
    # CUSUM watch + seeded regression-chaos acceptance
    "regression": ["test_regression.py"],
    "analysis": ["test_analysis.py"],  # graftcheck passes + gate + clock
    "sched": ["test_sched.py"],  # admission/batching policy + scheduler
    "tenancy": ["test_tenancy.py"],  # quotas, SLO tiers, fair dispatch
    "autoscale": ["test_autoscale.py"],  # autoscaler + mixed-tenant chaos
    "resilience": ["test_resilience.py"],  # retry/breaker/faults/chaos
    "parallel": ["test_partition.py"],  # partition rules + pjit steps
    "compile": ["test_pipeline_compile.py"],  # whole-pipeline fusion
    "aot": ["test_aot.py"],  # AOT executable store + warm boot
    "perf": ["test_perf.py"],  # learned cost model + kernel autotuner
    # pod-scale SPMD harness: runs UNFILTERED (no -m 'not slow'), so
    # the 2-process CPU pods execute here under the package wall clock
    "multihost": ["test_multihost.py"],
    "text": ["test_text_transfer.py", "test_causal_lm.py",
             "test_speculative.py"],
    # LLM serving engine: paged KV bookkeeping (no-JAX half) +
    # disaggregated prefill/decode + in-batch speculation + the
    # paged-attention kernel equivalence suite
    "llm": ["test_paged_kv.py", "test_llm_serving.py",
            "test_paged_attention.py"],
    # zero-downtime model lifecycle: versioned registry + blue/green
    # router + canary burn-rate rollback, and the rollout acceptance
    "deploy": ["test_deploy.py"],
    # device cost-attribution plane: PeakSpec/rooflines, AOT cost
    # persistence, goodput ledger, xprof capture surface, schema v6
    "attribution": ["test_attribution.py"],
    # the PyTorch/CUDA port (mmlspark_torch) against this package on the
    # CPU; its cuda-marked kernel test skips without a GPU
    "torch": ["test_torch_binning.py", "test_torch_causal.py",
              "test_torch_compat.py",
              "test_torch_causal_train.py", "test_torch_core.py",
              "test_torch_engine.py", "test_torch_flash.py", "test_torch_flash_bwd.py",
              "test_torch_head_dims.py",
              "test_torch_hist.py", "test_torch_isolation.py",
              "test_torch_lightgbm.py", "test_torch_llm_serving.py",
              "test_torch_paged.py", "test_torch_pretrain.py",
              "test_torch_text_encoder.py", "test_torch_featurize.py",
              "test_torch_stages.py", "test_torch_text_featurize.py",
              "test_torch_word2vec.py", "test_torch_objectives.py",
              "test_torch_gbdt_breadth.py", "test_torch_gbdt_bands.py",
              "test_torch_gbdt_categorical.py", "test_torch_gbdt_sparse.py",
              "test_torch_ranker.py", "test_torch_gbdt_continuation.py",
              "test_torch_gbdt_shards.py", "test_torch_bert.py",
              "test_torch_checkpoint.py", "test_torch_textgen.py",
              "test_torch_vision_models.py", "test_torch_convert_vision.py",
              "test_torch_quantize.py", "test_torch_image.py",
              "test_torch_obs.py", "test_torch_obs_profile.py",
              "test_torch_obs_fleet.py", "test_torch_resilience.py",
              "test_torch_sched.py", "test_torch_tenancy.py",
              "test_torch_costmodel.py", "test_torch_compile.py",
              "test_torch_aot.py", "test_torch_autotune.py",
              "test_torch_http_serving.py", "test_torch_serving_native.py",
              "test_torch_serving.py"],
}

# traceable-count ratchet (ISSUE 10): the analysis gate fails if the
# regenerated traceability report classifies fewer stages TRACEABLE
# than the committed burn-down achieved — host ops must not creep back
# into stage transform/fit paths. Raise this as more stages convert;
# never lower it without a written justification in the PR.
# 36 → 38 (ISSUE 11): UnrollImage + IDFModel grew _trace forms, so the
# AOT executable store covers them too.
TRACEABLE_RATCHET = 38


def _run(cmd: list[str], **kw) -> int:
    print("+", " ".join(cmd), flush=True)
    return subprocess.call(cmd, cwd=REPO, **kw)


def style() -> int:
    rc = _run([sys.executable, "-m", "compileall", "-q",
               "mmlspark_tpu", "tests", "examples", "ci"])
    if rc:
        return rc
    # obs must import cleanly with no backend and no JAX import at all
    # (serving fronts scrape it from handler threads before/without any
    # device init; a JAX import sneaking in would drag backend setup
    # into every importer). The tracing data plane rides along: the
    # propagation/export/profile surfaces must inject+extract a
    # traceparent, retain a trace in the flight recorder, and render
    # Chrome-trace JSON — all with no JAX in the process.
    smoke = (
        "import sys; "
        "from mmlspark_tpu.obs import (registry, tracer, inject, "
        "extract, flight_recorder, compile_tracker, step_profiler, "
        "feature_log, chrome_trace); "
        "assert 'jax' not in sys.modules, 'obs import pulled in jax'; "
        "exec('with tracer.span(\"ci\") as sp:\\n    h = inject({}, sp)'); "
        "ctx = extract(h); assert ctx.trace_id == sp.trace_id; "
        "flight_recorder.install(); "
        "flight_recorder.note_request(sp.trace_id, 0.5, status=200); "
        "assert flight_recorder.tree(sp.trace_id) is not None; "
        "assert chrome_trace([sp])['traceEvents']; "
        "feature_log.record(service='ci', route='/', batch=1); "
        # the cost-attribution plane rides along: PeakSpec resolution,
        # a roofline record, a goodput ledger tick, and the xprof
        # capture surface must all answer jax-free — a capture request
        # degrades to 503-with-reason, it NEVER imports jax
        "from mmlspark_tpu.obs.attribution import (CostAttribution, "
        "peak_spec); "
        "from mmlspark_tpu.obs.goodput import GoodputLedger; "
        "from mmlspark_tpu.obs.xprof import XprofCaptures; "
        "from mmlspark_tpu.obs.metrics import MetricsRegistry; "
        "assert peak_spec().platform == 'cpu'; "
        "ca = CostAttribution(registry=MetricsRegistry()); "
        "assert ca.record_program('ci', 1e9, 1e3, "
        "platform='cpu')['bound'] == 'compute'; "
        "led = GoodputLedger(registry=MetricsRegistry()); "
        "assert led.tick()['goodput_ratio'] == 1.0; "
        "assert led.tick()['ticks'] == 2; "
        "xc = XprofCaptures(root='/tmp/mmlspark_tpu_ci_xprof', "
        "registry=MetricsRegistry()); "
        "status, body = xc.handle_query('duration_ms=10', b''); "
        "assert status == 503 and b'reason' in body, (status, body); "
        "assert 'jax' not in sys.modules, 'obs data plane pulled jax'; "
        "print('obs import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the fleet telemetry plane is control-plane code scraped from
    # handler threads: it must import, merge two ranks' snapshots into
    # one collision-free exposition, and answer a health tick with no
    # JAX at all — and the HBM memory gauges must be ABSENT (not zero,
    # not raising) in a backend-free process
    smoke = (
        "import sys\n"
        "from mmlspark_tpu.obs.fleet import (FleetAggregator, "
        "FleetHealth, fleet_aggregator)\n"
        "from mmlspark_tpu.obs.memory import (device_memory_stats, "
        "memory_profiler)\n"
        "from mmlspark_tpu.obs.metrics import MetricsRegistry\n"
        "assert 'jax' not in sys.modules, 'obs.fleet pulled in jax'\n"
        "agg = FleetAggregator(MetricsRegistry())\n"
        "agg.ingest_snapshot({'profile_step_seconds_sum"
        "{stage=\"x\"}': 1.0}, process='0')\n"
        "agg.ingest_snapshot({'profile_step_seconds_sum"
        "{stage=\"x\"}': 2.0}, process='1')\n"
        "text = agg.exposition()\n"
        "assert 'process=\"0\"' in text and 'process=\"1\"' in text\n"
        "merged = agg.merged_samples()\n"
        "assert len(merged) == 2, merged  # zero collisions\n"
        "h = FleetHealth(agg, registry=MetricsRegistry())\n"
        "assert h.tick() == 'ok'\n"
        "status, body = h.healthz_payload()\n"
        "assert status == 200 and b'\"ok\"' in body\n"
        "assert device_memory_stats() == []\n"
        "assert memory_profiler.update() == []\n"
        "from mmlspark_tpu.obs import registry\n"
        "assert not any(k.startswith('mem_hbm_') "
        "for k in registry.snapshot())\n"
        "assert 'jax' not in sys.modules, 'fleet health tick pulled jax'\n"
        "print('obs.fleet federation OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the telemetry history plane is control-plane code ticked from a
    # daemon thread and served from handler threads: the store must
    # record/query, the offline gate must diff a synthetic regression,
    # and the CUSUM sentinel must warm up and alarm — all stdlib-only,
    # with no JAX in the process
    smoke = (
        "import sys\n"
        "from mmlspark_tpu.obs.metrics import MetricsRegistry\n"
        "from mmlspark_tpu.obs.timeseries import Recorder, "
        "TimeSeriesStore, timeline_payload\n"
        "from mmlspark_tpu.obs.regression import (CusumDetector, "
        "compare_benches, gate_verdict)\n"
        "assert 'jax' not in sys.modules, 'history plane pulled in jax'\n"
        "reg = MetricsRegistry()\n"
        "g = reg.gauge('sched_ci_depth', 'smoke')\n"
        "store = TimeSeriesStore(reg)\n"
        "rec = Recorder(store, reg)\n"
        "for v in (1.0, 2.0, 3.0):\n"
        "    g.set(v)\n"
        "    rec.tick()\n"
        "assert [p[1] for p in store.points('sched_ci_depth')] == "
        "[1.0, 2.0, 3.0]\n"
        "status, body = timeline_payload('series=sched_&window=60', "
        "store=store)\n"
        "assert status == 200 and b'sched_ci_depth' in body\n"
        "rows = compare_benches({'m_per_sec': 100.0}, "
        "{'m_per_sec': 80.0})\n"
        "assert gate_verdict(rows).startswith('REGRESSION')\n"
        "det = CusumDetector(warmup=4, direction='lower_bad')\n"
        "for v in (0.42, 0.41, 0.43, 0.42, 0.42):\n"
        "    det.update(v)\n"
        "assert any(det.update(0.05) for _ in range(4))\n"
        "assert 'jax' not in sys.modules, 'history plane pulled in jax'\n"
        "print('obs history plane OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # sched (admission control + batch policy) is pure stdlib + obs:
    # it must import and schedule with no device and no JAX at all —
    # the serving fronts run it from handler threads, and offline
    # pipelines use the same BatchPolicy on machines with no TPU
    smoke = ("import sys; import mmlspark_tpu.sched as s; "
             "assert 'jax' not in sys.modules, 'sched import pulled jax'; "
             "s.RequestScheduler('ci-smoke').submit(type('I', (), {})()); "
             "print('sched import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the paged KV cache's bookkeeping half (block table, prefix index,
    # LRU, handoff payloads) is pure Python + numpy: the serving
    # control plane allocates/adopts/exports on machines with no
    # device, so the whole lifecycle must run with no JAX at all —
    # device pools only materialize when an executor gathers/scatters
    smoke = (
        "import sys\n"
        "from mmlspark_tpu.dl.paged_kv import (PagedKVManager, "
        "SequenceHandle, TRASH_BLOCK, blocks_for_hbm_budget)\n"
        "from mmlspark_tpu.obs.metrics import MetricsRegistry\n"
        "assert 'jax' not in sys.modules, 'paged_kv import pulled jax'\n"
        "m = PagedKVManager(9, 4, registry=MetricsRegistry(), "
        "service='ci')\n"
        "h = m.allocate('a', list(range(1, 9)))\n"
        "assert len(h.chain) == 2 and TRASH_BLOCK not in h.chain\n"
        "m.publish('a'); m.advance('a', 8)\n"
        "state = m.export_seq('a')\n"
        "assert m.adopt(state).length == 8\n"
        "m.release('a')\n"
        "assert m.allocate('b', list(range(1, 9))).reused_tokens == 8\n"
        "assert m.block_rows(['b', None], 3).shape == (2, 3)\n"
        "assert blocks_for_hbm_budget(1024, default=5) >= 0\n"
        # the paged-attention kill switch is control-plane too: the
        # executors read it at init on machines with no device, and
        # consulting it must not drag in the Pallas kernel module
        "from mmlspark_tpu.dl.paged_kv import paged_attention_enabled\n"
        "assert paged_attention_enabled() in (True, False)\n"
        "assert 'mmlspark_tpu.dl.pallas_paged_attention' not in "
        "sys.modules, 'paged kernel imported eagerly'\n"
        "assert 'jax' not in sys.modules, 'kv bookkeeping pulled jax'\n"
        "print('dl.paged_kv import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # tenancy (per-tenant quotas + SLO tiers + weighted-fair dispatch)
    # and the autoscaler are control-plane code: both must import AND
    # make decisions with no device and no JAX at all — admission runs
    # from handler threads, the autoscaler from its own control thread
    smoke = (
        "import sys\n"
        "from mmlspark_tpu.sched import Tenancy, TenantQuota, "
        "RequestScheduler, Shed, GOLD\n"
        "from mmlspark_tpu.serving.autoscale import Autoscaler, "
        "AutoscaleConfig, AutoscaleSignals\n"
        "assert 'jax' not in sys.modules, 'tenancy/autoscale pulled "
        "jax'\n"
        "t = Tenancy('ci', quotas={'g': TenantQuota(tier=GOLD, "
        "rate=1.0, burst=1.0)}, tier_deadlines={GOLD: 0.5})\n"
        "s = RequestScheduler('ci', tenancy=t)\n"
        "s.submit(type('I', (), {})(), tenant='g')\n"
        "try:\n"
        "    s.submit(type('I', (), {})(), tenant='g')\n"
        "except Shed as e:\n"
        "    assert e.status == 429 and e.retry_after >= 1\n"
        "class P:\n"
        "    n = 1\n"
        "    def count(self): return self.n\n"
        "    def scale_up(self): self.n += 1\n"
        "    def scale_down(self): self.n -= 1\n"
        "a = Autoscaler('ci', P(), AutoscaleConfig(up_stable=1))\n"
        "assert a.tick(AutoscaleSignals(queue_depth=99)) == 'up'\n"
        "assert 'jax' not in sys.modules, 'tenancy/autoscale pulled "
        "jax'\n"
        "print('tenancy+autoscale import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # resilience (retry policy + breakers + fault injector) is pure
    # stdlib + obs: it must import, back off, break, and arm a seeded
    # fault schedule with no device and no JAX at all — the HTTP client
    # stack and serving mesh run it from handler threads
    smoke = (
        "import sys; "
        "from mmlspark_tpu.resilience import (RetryPolicy, FaultRule, "
        "breaker_for, faults); "
        "assert 'jax' not in sys.modules, 'resilience import pulled jax'; "
        "p = RetryPolicy(seed=0, sleep=lambda s: None); "
        "c = p.start(deadline=1.0, op='ci'); "
        "assert c.backoff(status=503) and not c.backoff(status=404); "
        "b = breaker_for('ci-smoke', min_calls=1); b.record_failure(); "
        "assert b.state == 'open' and not b.allow(); "
        "exec('with faults(7, [FaultRule(point=\"p\", kind=\"error\")]) "
        "as inj:\\n    assert inj.probe(\"p\") is not None'); "
        "print('resilience import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the partition-rule engine must import, match, and register rule
    # sets with no JAX at all: model modules register their rules at
    # import time on device-less machines, and rule sets are plain
    # (regex, tuple) data until something shards for real
    smoke = (
        "import sys; "
        "from mmlspark_tpu.parallel.partition import ("
        "DtypePolicy, match_partition_rules, partition_rules_for, "
        "register_partition_rules); "
        "assert 'jax' not in sys.modules, 'partition import pulled jax'; "
        "register_partition_rules('ci-smoke', [(r'kernel', (None, 'tp'))]); "
        "assert partition_rules_for('ci-smoke'); "
        "assert DtypePolicy().param_dtype == 'float32'; "
        "assert 'jax' not in sys.modules, 'rule registration pulled jax'; "
        "print('parallel.partition import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the multi-host launcher is pure stdlib until a worker boots: the
    # coordinator side (port pick, env synthesis, target validation)
    # must work on the build/driver machine with no JAX at all — JAX
    # only loads inside the spawned worker processes
    smoke = (
        "import sys; "
        "from mmlspark_tpu.parallel.multihost import ("
        "free_port, launch_pod, worker_env); "
        "assert 'jax' not in sys.modules, 'multihost import pulled jax'; "
        "env = worker_env(process_id=1, num_processes=2, "
        "coordinator='127.0.0.1:1234', local_devices=4); "
        "assert env['MMLSPARK_TPU_COORDINATOR'] == '127.0.0.1:1234'; "
        "assert env['MMLSPARK_TPU_PROCESS_ID'] == '1'; "
        "assert env['JAX_CPU_COLLECTIVES_IMPLEMENTATION'] == 'gloo'; "
        "assert 'JAX_COMPILATION_CACHE_DIR' not in env; "
        "assert 0 < free_port() < 65536; "
        "assert 'jax' not in sys.modules, 'launcher plumbing pulled jax'; "
        "print('parallel.multihost import OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the pipeline compiler must import AND build an (all-host) plan
    # with no JAX in the process: plan construction is schema walking,
    # and fused segments only touch a backend on first execution — a
    # JAX import sneaking into compile/plan time would drag backend
    # setup into every control-plane importer of core
    smoke = (
        "import sys; import numpy as np; "
        "from mmlspark_tpu.core import (DataFrame, compile_pipeline, "
        "CompiledPipeline); "
        "from mmlspark_tpu.stages import TextPreprocessor; "
        "assert 'jax' not in sys.modules, 'core.compile pulled in jax'; "
        "df = DataFrame({'t': np.asarray(['A', 'B'], object)}); "
        "cp = compile_pipeline([TextPreprocessor(inputCol='t', "
        "outputCol='o', normFunc='lower')], df); "
        "assert isinstance(cp, CompiledPipeline); "
        "assert cp.compiled_segments == 0 and cp.eager_stages == 1; "
        "assert cp.transform(df)['o'].tolist() == ['a', 'b']; "
        "assert 'jax' not in sys.modules, 'host-only plan pulled jax'; "
        "print('core.compile import+plan OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the AOT store's fingerprint layer must compute keys with no JAX
    # in the process: the build CLI may need a backend, but key
    # computation runs in control-plane processes (gc tooling, store
    # audits, registries) that must never drag in device init
    smoke = (
        "import sys; "
        "from mmlspark_tpu.core import aot; "
        "from mmlspark_tpu.featurize.vector import OneHotEncoderModel; "
        "assert 'jax' not in sys.modules, 'aot import pulled in jax'; "
        "key = aot.segment_static_key([OneHotEncoderModel("
        "inputCol='c', outputCol='o', categorySize=3, "
        "handleInvalid='keep')], platform='cpu'); "
        "s, f = aot.fingerprints(key, [['c', 'int32', [8]]], []); "
        "assert len(s) == 64 and len(f) == 64 and s != f; "
        "import tempfile; "
        "store = aot.AotStore(tempfile.mkdtemp()); "
        "assert store.entries() == [] and store.stats()['entries'] == 0; "
        "assert 'jax' not in sys.modules, 'aot key/store pulled in jax'; "
        "print('core.aot fingerprint+store OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # the learned-performance layer (cost model + autotuner registry)
    # is control-plane code consulted from scheduler/handler threads:
    # it must import, train on synthetic FeatureLog rows, predict, and
    # answer winner lookups with no device and no JAX in the process
    smoke = (
        "import sys\n"
        "from mmlspark_tpu.obs.profile import FEATURE_SCHEMA_VERSION\n"
        "from mmlspark_tpu.perf import CostModel, autotune\n"
        "from mmlspark_tpu.sched.policy import ServiceTimeEstimator, "
        "bucket_of\n"
        "assert 'jax' not in sys.modules, 'perf import pulled in jax'\n"
        "rows = [dict(service='ci', route='/', batch=b, "
        "bucket=bucket_of(b), entity_bytes=b * 64.0, queue_depth=2.0, "
        "execute_ms=1.0 + 0.1 * bucket_of(b), "
        "schema_version=FEATURE_SCHEMA_VERSION) "
        "for b in (1, 2, 3, 4, 6, 8, 12, 16) * 8]\n"
        "m = CostModel(min_rows=16)\n"
        "assert m.predict_batch_ms('ci', 4) is None  # cold -> EWMA\n"
        "assert m.fit(rows) == len(rows)\n"
        "p = m.predict_batch_ms('ci', 4)\n"
        "assert p is not None and 1.0 < p < 3.0, p\n"
        "est = ServiceTimeEstimator('ci-est', cost_model=m)\n"
        "assert est.estimate(4) is None  # model cold for THIS service\n"
        "assert autotune.kernel_winner('hist', "
        "autotune.hist_key(1024, 8, 16), 'cpu') is None\n"
        "assert autotune.hist_candidates(1024, 8, 16)\n"
        "assert 'jax' not in sys.modules, 'perf data plane pulled jax'\n"
        "print('perf import OK (no jax)')")
    # isolated perf store: a developer's ambient /tmp autotune registry
    # (import-time maybe_load) would otherwise fail the winner-is-None
    # assert on a machine where the CLI was ever run at this shape
    import tempfile
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu",
                       MMLSPARK_TPU_PERF_STORE=tempfile.mkdtemp(
                           prefix="mmlspark_tpu_perf_smoke_")))
    if rc:
        return rc
    # the deploy plane is control-plane code (registry + router +
    # rollout controller): it must register versions, stage + flip
    # atomically, and answer a controller tick with no JAX in the
    # process — the serving fronts route every request through it from
    # handler threads, long before any device init
    smoke = (
        "import sys\n"
        "from mmlspark_tpu.serving.deploy import (ModelRegistry, "
        "RolloutConfig, RolloutController, VersionRouter)\n"
        "from mmlspark_tpu.obs.metrics import MetricsRegistry\n"
        "assert 'jax' not in sys.modules, 'deploy import pulled jax'\n"
        "reg = MetricsRegistry()\n"
        "m = ModelRegistry(service='smoke', registry=reg)\n"
        "m.register('v1', transform=lambda b: b)\n"
        "m.register('v2', transform=lambda b: b)\n"
        "r = VersionRouter(m, service='smoke', metrics=reg)\n"
        "r.set_active('v1')\n"
        "r.stage('v2', canary_share=0.25)\n"
        "assert r.assign('gold')[0] == 'v1'\n"
        "assert r.flip() == 'v2' and r.active == 'v2'\n"
        "assert r.draining_inflight() == 1\n"
        "r.release('v1')\n"
        "assert r.draining_inflight() == 0\n"
        "c = RolloutController(r, metrics=reg, "
        "config=RolloutConfig(rollback_windows=1))\n"
        "assert c.tick(burns={}) == 'idle'\n"
        "m.register('v3', transform=lambda b: b)\n"
        "r.stage('v3')\n"
        "assert c.tick(burns={'canary': {'fast': 9.0, 'slow': 9.0}}) "
        "== 'rollback'\n"
        "assert c.deploy_reasons(), 'rollback flap must degrade healthz'\n"
        "assert 'jax' not in sys.modules, 'deploy plane pulled jax'\n"
        "print('serving.deploy control plane OK (no jax)')")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # graftcheck (static analysis) is pure stdlib: it must import AND
    # analyze with no JAX at all — it runs as a gate on machines (and
    # in contexts) where importing the analyzed code is not an option
    smoke = ("import sys; from mmlspark_tpu.analysis import ("
             "Project, run_passes); "
             "assert 'jax' not in sys.modules, 'analysis import pulled "
             "jax'; "
             "p = Project.load('.', 'mmlspark_tpu'); "
             "assert len(p.modules) > 100, len(p.modules); "
             "run_passes(p); "
             "assert 'jax' not in sys.modules, 'analysis run pulled "
             "jax'; "
             "print('analysis import+run OK (no jax, "
             "%d modules)' % len(p.modules))")
    rc = _run([sys.executable, "-c", smoke],
              env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc:
        return rc
    # codegen reflection must walk every stage without error (the
    # reference's Style job runs codegen as part of the build)
    code = ("import os, tempfile, jax; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "from mmlspark_tpu.codegen import generate_all; "
            "d = tempfile.mkdtemp(); out = generate_all(d); "
            "assert out['stubs'] and out['r'] and out['pyspark'], out; "
            "print('codegen OK:', {k: len(v) if isinstance(v, list) else v"
            " for k, v in out.items()})")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return _run([sys.executable, "-c", code], env=env)


def tests(package: str | None, retries: int = 1) -> int:
    missing = [f for files in PACKAGES.values() for f in files
               if not os.path.exists(os.path.join(REPO, "tests", f))]
    if missing:
        print(f"pipeline references missing test files: {missing}")
        return 2
    untracked = sorted(
        f for f in os.listdir(os.path.join(REPO, "tests"))
        if f.startswith("test_") and f.endswith(".py")
        and not any(f in files for files in PACKAGES.values()))
    if untracked:
        print(f"test files not assigned to any CI package: {untracked}")
        return 2
    selected = ([package] if package else sorted(PACKAGES))
    for pkg in selected:
        files = [os.path.join("tests", f) for f in PACKAGES[pkg]]
        for attempt in range(retries + 1):
            rc = _run([sys.executable, "-m", "pytest", "-q", *files])
            if rc == 0:
                break
            if attempt < retries:
                print(f"package {pkg} failed (rc={rc}) — flaky retry")
        if rc != 0:
            return rc
    return 0


def analysis() -> int:
    """The graftcheck gate: zero unbaselined findings over the package,
    stale baseline entries fail too (--strict), and the traceability
    report is regenerated to a TEMP file and diffed against the
    committed copy — regenerating in place would overwrite the evidence
    and mask staleness from everything that runs after this stage.
    Budget: < 60 s — it runs pure ast, no JAX, so it actually finishes
    in a few seconds."""
    import filecmp
    import tempfile
    t0 = time.monotonic()
    committed = os.path.join(REPO, "mmlspark_tpu", "analysis",
                             "traceability.json")
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        fresh = f.name
    try:
        rc = _run([sys.executable, "-m", "mmlspark_tpu.analysis",
                   "--strict", "--traceability", fresh])
        if rc == 0 and not filecmp.cmp(fresh, committed, shallow=False):
            print("analysis: committed traceability.json is STALE — "
                  "regenerate it:\n  python -m mmlspark_tpu.analysis "
                  "--strict --traceability "
                  "mmlspark_tpu/analysis/traceability.json")
            rc = 1
        if rc == 0:
            # the traceable-count ratchet: a host op creeping back into
            # a converted stage silently shrinks the fused spans —
            # whole-pipeline compilation's work-list only burns DOWN
            import json
            with open(fresh, encoding="utf-8") as f:
                n = json.load(f)["summary"]["traceable"]
            if n < TRACEABLE_RATCHET:
                print(f"analysis: traceability ratchet broken — "
                      f"{n} stages TRACEABLE < committed floor "
                      f"{TRACEABLE_RATCHET}. A host op (numpy call, "
                      f".tolist) crept back into a stage transform/fit "
                      f"path; see the stage's 'reasons' in the report.")
                rc = 1
    finally:
        os.unlink(fresh)
    took = time.monotonic() - t0
    if took > 60:
        print(f"analysis gate exceeded its 60s budget ({took:.0f}s)")
        return rc or 3
    return rc


def regression_gate() -> int:
    """The perf-regression trajectory gate (ISSUE 16): diff the newest
    banked ``BENCH_r0*.json`` against its predecessor, the whole
    trajectory pricing each metric's noise. Exit 1 = a gated metric
    regressed beyond tolerance; a too-short trajectory (fresh clone,
    < 2 banked runs) is a pass with a note, not a failure. Budget:
    < 60 s — it is pure JSON diffing, no JAX, no benchmarks re-run."""
    t0 = time.monotonic()
    rc = _run([sys.executable, "-m", "mmlspark_tpu.obs.regression",
               "gate"], env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if rc == 2:
        print("regression gate: trajectory too short to judge — "
              "treating as pass")
        rc = 0
    took = time.monotonic() - t0
    if took > 60:
        print(f"regression gate exceeded its 60s budget ({took:.0f}s)")
        return rc or 3
    return rc


def aot_roundtrip() -> int:
    """Build-then-load round trip across two scrubbed processes: the
    store built by one process must warm-load in a fresh one with zero
    runtime compiles and bit-equal output (the AOT acceptance's
    cross-process half, as a standing CI job)."""
    return _run([sys.executable, "-m", "mmlspark_tpu.core.aot",
                 "selftest"])


def examples() -> int:
    return _run([sys.executable, os.path.join("examples", "run_all.py")])


def multichip() -> int:
    code = "import __graft_entry__ as g; g.dryrun_multichip(8)"
    return _run([sys.executable, "-c", code])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["style", "analysis",
                                       "regression_gate", "tests",
                                       "aot_roundtrip", "examples",
                                       "multichip"])
    ap.add_argument("--package", choices=sorted(PACKAGES))
    args = ap.parse_args()
    t0 = time.monotonic()
    stages = ([args.only] if args.only
              else ["style", "analysis", "regression_gate", "tests",
                    "aot_roundtrip", "examples", "multichip"])
    for stage in stages:
        rc = {"style": style, "analysis": analysis,
              "regression_gate": regression_gate,
              "aot_roundtrip": aot_roundtrip,
              "examples": examples, "multichip": multichip}.get(
                  stage, lambda: tests(args.package))()
        if rc:
            print(f"CI FAILED at {stage} (rc={rc})")
            return rc
    print(f"CI OK ({time.monotonic() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
