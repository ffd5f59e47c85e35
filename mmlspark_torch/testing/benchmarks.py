"""The scenario harness of the control plane's reference tests (the
port's own copy of the parts of the JAX package's ``testing/benchmarks.py``
that ROADMAP.md §1 items 9b and 9c's tests call): the synthetic overload
scenario of the request scheduler, the cost model's FeatureLog rows and
holdout scenario, the cost-attribution scenario, and the whole-pipeline
fusion scenario with the AOT store's benchmark spec. Each returns the same
dict, with the same keys, as the reference's on the same arguments.

The serving plane's scenarios of ROADMAP.md §1 item 9d-1 are here too:
the tracing and recorder overhead guards, the regression sentinel's chaos
replay and the LLM engine's serving and decode scenarios (on the port's
engine, at ``device=``). The scenarios that need the mesh or the
autoscaler exist and raise ``NotImplementedError`` naming the ROADMAP item
that brings them (9d-2).

Import is stdlib + obs only; numpy and torch are imported where a
scenario needs them.
"""

from __future__ import annotations

import threading
import time
from math import ceil as _ceil


class _SynthRequest:
    """A scheduler item for the overload scenario: carries the latch the
    arrival thread waits on plus the attributes the sched subsystem
    decorates (route/deadline/tenant/on_done)."""

    __slots__ = ("submitted", "done_at", "status", "route", "deadline",
                 "tenant", "cost", "on_done", "span", "queue_wait",
                 "_event")

    def __init__(self):
        self.submitted = time.monotonic()
        self.done_at = None
        self.status = None
        self.route = "/"
        self.deadline = None
        self.tenant = ""        # quota/tier bucket (sched.tenancy)
        self.cost = 0.0         # synthetic per-item service seconds
        self.on_done = None
        self.span = None        # request span (tracing scenarios)
        self.queue_wait = None  # stamped by the scheduler at pop
        self._event = threading.Event()

    def reply(self, status: int) -> bool:
        # reply-exactly-once latch, same contract as serving's
        # CachedRequest (the scheduler's expiry shed path calls this)
        if self._event.is_set():
            return False
        self.status = status
        self.done_at = time.monotonic()
        self._event.set()
        cb, self.on_done = self.on_done, None
        if cb is not None:
            cb()
        return True


def overload_scenario(*, service: str = "overload-bench",
                      deadline_s: float = 0.2,
                      item_service_s: float = 0.004,
                      max_queue: int = 64,
                      max_batch: int = 8,
                      rate_factor: float = 2.0,
                      n_requests: int = 400,
                      registry=None) -> dict:
    """Synthetic overload benchmark for the sched subsystem: offer load at ``rate_factor``× the sustainable rate
    into a :class:`~mmlspark_torch.sched.RequestScheduler` backed by a
    deterministic executor (``item_service_s`` seconds per request,
    batched up to ``max_batch``), then read the ``sched_*`` series back
    from the obs registry.

    A correct scheduler under 2× overload must (a) bound the queue —
    admission sheds BEFORE depth runs away, (b) keep the latency of
    requests it chose to admit within the deadline budget — expiry
    sheds fire before execution, never after — and (c) shed the excess
    as 429s rather than timing everyone out. The returned dict carries
    the measured p99/max depth plus the registry readings
    (``sched_admitted_total``, ``sched_shed_total`` by reason,
    ``sched_queue_wait_seconds`` count) so benches can bank and tests
    can assert on either surface.
    """
    from ..obs.metrics import registry as _default
    from ..sched import RequestScheduler, Shed

    reg = registry if registry is not None else _default
    shed_answered: list[_SynthRequest] = []
    sched = RequestScheduler(
        service, max_queue=max_queue, deadline=deadline_s, registry=reg,
        on_shed=lambda item, reason, retry_after:
            (shed_answered.append(item), item.reply(429)))
    done: list[_SynthRequest] = []
    stop = threading.Event()
    depth_high = [0]

    def executor():
        while not stop.is_set() or sched.qsize():
            batch = sched.next_batch(max_batch=max_batch, max_wait=0.05)
            if not batch:
                continue
            t0 = time.monotonic()
            time.sleep(item_service_s * len(batch))  # deterministic work
            sched.estimator.observe(len(batch),
                                    time.monotonic() - t0)
            for item in batch:
                item.reply(200)
                done.append(item)

    worker = threading.Thread(target=executor, daemon=True)
    worker.start()
    interval = item_service_s / rate_factor
    admitted = shed_at_intake = 0
    # prime the service-time EWMA so predictive admission has a model
    # from the first request (a cold registry sheds nothing until the
    # first batch lands)
    sched.estimator.observe(1, item_service_s)
    for _ in range(n_requests):
        req = _SynthRequest()
        try:
            sched.submit(req)
            admitted += 1
        except Shed:
            shed_at_intake += 1
        depth_high[0] = max(depth_high[0], sched.qsize())
        time.sleep(interval)
    stop.set()
    sched.wake()
    worker.join(timeout=10)
    lat = sorted((r.done_at - r.submitted) for r in done
                 if r.done_at is not None)
    snap = reg.snapshot()

    def _series(prefix: str) -> dict:
        return {k: v for k, v in snap.items()
                if k.startswith(prefix) and f'service="{service}"' in k}

    return {
        "offered": n_requests,
        "admitted": admitted,
        "answered_200": len(lat),
        "shed_at_intake": shed_at_intake,
        "shed_after_queueing": len(shed_answered),
        "deadline_s": deadline_s,
        "max_queue": max_queue,
        "max_depth_seen": depth_high[0],
        # nearest-rank percentiles: ceil(q*n)-1 — int(n*0.99)-1 would
        # sit one rank low and hide exactly the tail samples a
        # deadline-SLO acceptance check exists to catch
        "p50_s": lat[max(_ceil(0.50 * len(lat)) - 1, 0)]
        if lat else float("nan"),
        "p99_s": lat[max(_ceil(0.99 * len(lat)) - 1, 0)]
        if lat else float("nan"),
        "sched_admitted_total": _series("sched_admitted_total"),
        "sched_shed_total": _series("sched_shed_total"),
        "sched_queue_wait_count": _series("sched_queue_wait_seconds_count"),
    }


def _pctl(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return float("nan")
    return sorted_vals[max(_ceil(q * len(sorted_vals)) - 1, 0)]


# ------------------------------------------------- learned cost model
def synth_feature_rows(n_rows: int = 1200, *, seed: int = 5,
                       service: str = "costmodel-bench") -> list[dict]:
    """Deterministic FeatureLog-shaped rows with a known cost
    structure: three routes whose execute time depends on the padding
    bucket AND the entity size — the per-request signal a per-bucket
    EWMA cannot see, which is exactly where the learned model earns its
    keep. Noise is seeded; two calls produce identical rows."""
    import numpy as np

    from ..obs.profile import FEATURE_SCHEMA_VERSION
    from ..sched.policy import bucket_of

    rng = np.random.default_rng(seed)
    # route -> (base_ms, per-padded-row ms, per-KB ms)
    routes = {"/feat": (0.8, 0.05, 0.030),
              "/gbdt": (2.0, 0.15, 0.004),
              "/gen": (5.0, 0.40, 0.012)}
    names = sorted(routes)
    rows = []
    for i in range(n_rows):
        route = names[int(rng.integers(0, len(names)))]
        base, per_row, per_kb = routes[route]
        batch = int(rng.integers(1, 65))
        bucket = bucket_of(batch)
        entity_kb = float(rng.uniform(0.5, 200.0))
        depth = float(max(rng.normal(8.0, 4.0), 0.0))
        ms = (base + per_row * bucket + per_kb * entity_kb
              + float(rng.normal(0.0, 0.15)))
        rows.append({
            "service": service, "route": route, "batch": batch,
            "bucket": bucket, "padded_batch": bucket,
            "entity_bytes": entity_kb * 1024.0, "queue_depth": depth,
            "queue_ms": depth * 0.5, "execute_ms": max(ms, 0.05),
            "schema_version": FEATURE_SCHEMA_VERSION,
            "platform": "synthetic",
        })
    return rows


def costmodel_scenario(*, n_rows: int = 1200, seed: int = 5,
                       holdout: float = 0.25, registry=None) -> dict:
    """Learned-cost-model acceptance: train on the first
    (1 - holdout) of a synthetic FeatureLog stream, score BOTH brains
    on the held-out tail — the model predicts per row (bucket + entity
    bytes + depth), the EWMA baseline is a ``ServiceTimeEstimator`` fed
    the same training stream in arrival order, exactly as the scheduler
    trains it today. Banked: both MAEs and ``model_beats_ewma``."""
    from ..obs.metrics import registry as _default
    from ..perf.costmodel import CostModel
    from ..sched.policy import ServiceTimeEstimator

    reg = registry if registry is not None else _default
    service = "costmodel-bench"
    rows = synth_feature_rows(n_rows, seed=seed, service=service)
    n_train = int(len(rows) * (1.0 - holdout))
    train, held = rows[:n_train], rows[n_train:]

    model = CostModel(min_rows=32, registry=reg)
    used = model.fit(train)

    ewma = ServiceTimeEstimator(service, registry=reg)
    for r in train:
        ewma.observe(r["batch"], r["execute_ms"] / 1e3)

    model_abs, ewma_abs = [], []
    for r in held:
        actual = r["execute_ms"]
        pred = model.predict_batch_ms(
            service, r["batch"], route=r["route"],
            entity_bytes=r["entity_bytes"],
            queue_depth=r["queue_depth"], count=False)
        if pred is not None:
            model_abs.append(abs(pred - actual))
        est = ewma.estimate(r["batch"])
        if est is not None:
            ewma_abs.append(abs(est * 1e3 - actual))
    model_mae = (sum(model_abs) / len(model_abs)
                 if model_abs else float("nan"))
    ewma_mae = (sum(ewma_abs) / len(ewma_abs)
                if ewma_abs else float("nan"))

    # the fallback gate, exercised: a cold model must answer None
    cold = CostModel(min_rows=32, registry=reg)
    cold_pred = cold.predict_batch_ms(service, 8)
    return {
        "n_train": len(train), "n_holdout": len(held),
        "rows_used": used,
        "model_mae_ms": model_mae,
        "ewma_mae_ms": ewma_mae,
        "model_beats_ewma": bool(model_mae < ewma_mae),
        "model_covered": len(model_abs),
        "cold_falls_back": bool(cold_pred is None),
    }


def synth_attribution_rows(n_rows: int = 1200, *, seed: int = 29,
                           service: str = "attr-bench") -> list[dict]:
    """Schema-v6 FeatureLog-shaped rows where part of the cost rides
    the ANALYTIC columns: each row's ``analytic_flops``/``analytic_
    bytes`` vary with the program variant that served it (seeded,
    independent of the other features), and ``execute_ms`` includes a
    per-Tflop term — the signal only a v6-aware model can price.
    Deterministic: two calls with one seed produce identical rows."""
    import numpy as np

    from ..obs.profile import FEATURE_SCHEMA_VERSION
    from ..sched.policy import bucket_of

    rng = np.random.default_rng(seed)
    routes = {"/feat": (0.8, 0.05), "/gen": (5.0, 0.40)}
    names = sorted(routes)
    ms_per_tflop = 2.5
    rows = []
    for _ in range(n_rows):
        route = names[int(rng.integers(0, len(names)))]
        base, per_row = routes[route]
        batch = int(rng.integers(1, 65))
        bucket = bucket_of(batch)
        depth = float(max(rng.normal(8.0, 4.0), 0.0))
        tflops = float(rng.uniform(0.2, 6.0))
        gbytes = tflops * float(rng.uniform(0.05, 0.15))
        ms = (base + per_row * bucket + ms_per_tflop * tflops
              + float(rng.normal(0.0, 0.15)))
        rows.append({
            "service": service, "route": route, "batch": batch,
            "bucket": bucket, "padded_batch": bucket,
            "entity_bytes": 1024.0, "queue_depth": depth,
            "execute_ms": max(ms, 0.05),
            "analytic_flops": tflops * 1e12,
            "analytic_bytes": gbytes * 1e9,
            "schema_version": FEATURE_SCHEMA_VERSION,
            "platform": "synthetic",
        })
    return rows


def attribution_scenario(*, seed: int = 29, n_rows: int = 1200,
                         holdout: float = 0.25, ticks: int = 12,
                         registry=None) -> dict:
    """Cost-attribution acceptance, three banked pieces:

    1. **Roofline placement** — two real programs run once on the
       analytic path (a 256x256 matmul and a wide elementwise add),
       cost-analyzed and placed against the CPU :class:`PeakSpec`: the
       matmul must read compute-bound, the add memory-bound, and every
       utilization share <= 1.0 by construction.
    2. **Goodput under seeded chaos** — a private registry is driven
       through a deterministic tick schedule (useful step seconds
       every tick; seeded waste bursts: spec rejects, eager fallbacks,
       sheds, expirations, a runtime compile, a straggler window) and
       a :class:`~..obs.goodput.GoodputLedger` prices it. Banked: the
       final ratio, the itemized waste taxonomy, and the per-tick
       ratio trace (bit-identical per seed).
    3. **v6 model value** — the ridge cost model trained on rows whose
       cost partly rides the analytic columns must beat (or match) the
       SAME model trained with those columns stripped (the v5
       baseline) on held-out MAE.
    """
    import numpy as np

    from ..obs.attribution import CostAttribution, peak_spec
    from ..obs.goodput import GoodputLedger, WASTE_CAUSES
    from ..obs.metrics import MetricsRegistry
    from ..perf.costmodel import CostModel

    # -- 1: roofline placement off real programs -------------------------
    # The reference compiles these two programs with XLA and reads
    # cost_analysis; the port runs them once on the CPU under
    # obs.attribution.count_cost (record_call) and places what it counted.
    import torch

    reg = registry if registry is not None else MetricsRegistry()
    attr = CostAttribution(registry=reg)
    rooflines: dict[str, dict] = {}
    a = torch.ones((256, 256), dtype=torch.float32)
    big = torch.ones((4, 1 << 20), dtype=torch.float32)
    programs = {
        "attr_matmul_256": (lambda m: m @ m, a),
        "attr_add_wide": (lambda v: v + 1.0, big),
    }
    for name, (fn, arg) in programs.items():
        info = attr.record_call(name, fn, arg, service="attr-bench",
                                platform="cpu")
        rooflines[name] = {
            "bound": info["bound"],
            "flops": info["flops"],
            "bytes": info["bytes"],
            "utilization_compute": round(
                info["compute_seconds"]
                / max(info["roofline_seconds"], 1e-18), 6),
            "utilization_memory": round(
                info["memory_seconds"]
                / max(info["roofline_seconds"], 1e-18), 6),
        }

    # -- 2: goodput ledger under a seeded chaos schedule -----------------
    rng = np.random.default_rng(seed)
    greg = MetricsRegistry()
    ledger = GoodputLedger(registry=greg)
    h_step = greg.histogram("profile_step_seconds", "synthetic steps")
    h_decode = greg.histogram("gen_decode_attn_seconds", "synthetic")
    h_compile = greg.histogram("profile_compile_seconds", "synthetic")
    c_tokens = greg.counter("gen_tokens_total", "synthetic")
    c_spec = greg.counter("gen_spec_rejected_total", "synthetic")
    c_fallback = greg.counter("pipeline_fused_fallback_total",
                              "synthetic")
    c_shed = greg.counter("sched_shed_total", "synthetic")
    c_expired = greg.counter("sched_continuous_expired_total",
                             "synthetic")
    c_compiles = greg.counter("profile_runtime_compiles_total",
                              "synthetic")
    g_straggler = greg.gauge("fleet_straggler_score", "synthetic")
    ledger.tick()  # baseline
    ratio_trace = []
    for t in range(ticks):
        h_step.observe(0.010, stage="train")
        for _ in range(8):
            h_decode.observe(0.002, service="attr-bench")
            c_tokens.inc(1, service="attr-bench")
        if rng.random() < 0.5:
            c_spec.inc(int(rng.integers(1, 6)), service="attr-bench")
        if rng.random() < 0.3:
            c_fallback.inc(1, segment="seg0")
        if rng.random() < 0.3:
            c_shed.inc(int(rng.integers(1, 4)), reason="backpressure")
        if rng.random() < 0.2:
            c_expired.inc(1, service="attr-bench")
        if t == ticks // 2:
            c_compiles.inc(1, fn="late_fn")
            h_compile.observe(0.5, fn="late_fn")
        g_straggler.set(3.0 if t >= ticks - 3 else 0.0, worker="w1")
        payload = ledger.tick()
        ratio_trace.append(round(payload["goodput_ratio"], 6))
    waste = {c: round(payload["waste_seconds"][c], 6)
             for c in WASTE_CAUSES}

    # -- 3: v6 analytic columns vs the v5 baseline on held-out MAE -------
    service = "attr-bench"
    rows = synth_attribution_rows(n_rows, seed=seed, service=service)
    n_train = int(len(rows) * (1.0 - holdout))
    train, held = rows[:n_train], rows[n_train:]
    stripped = [{k: v for k, v in r.items()
                 if k not in ("analytic_flops", "analytic_bytes")}
                for r in train]
    m_v6 = CostModel(min_rows=32, registry=MetricsRegistry())
    m_v6.fit(train)
    m_v5 = CostModel(min_rows=32, registry=MetricsRegistry())
    m_v5.fit(stripped)
    v6_abs, v5_abs = [], []
    for r in held:
        actual = r["execute_ms"]
        for model, acc in ((m_v6, v6_abs), (m_v5, v5_abs)):
            pred = model.predict_batch_ms(
                service, r["batch"], route=r["route"],
                entity_bytes=r["entity_bytes"],
                queue_depth=r["queue_depth"], count=False)
            if pred is not None:
                acc.append(abs(pred - actual))
    v6_mae = sum(v6_abs) / len(v6_abs) if v6_abs else float("nan")
    v5_mae = sum(v5_abs) / len(v5_abs) if v5_abs else float("nan")

    return {
        "seed": seed,
        "platform_spec": {
            "platform": peak_spec("cpu").platform,
            "peak_flops": peak_spec("cpu").peak_flops,
            "hbm_bytes_per_s": peak_spec("cpu").hbm_bytes_per_s,
        },
        "rooflines": rooflines,
        "matmul_compute_bound": bool(
            rooflines.get("attr_matmul_256", {}).get("bound")
            == "compute"),
        "add_memory_bound": bool(
            rooflines.get("attr_add_wide", {}).get("bound")
            == "memory"),
        "utilization_max": max(
            [u for r in rooflines.values()
             for u in (r["utilization_compute"],
                       r["utilization_memory"])], default=0.0),
        "goodput_ratio": ratio_trace[-1] if ratio_trace else None,
        "goodput_ratio_trace": ratio_trace,
        "goodput_waste_seconds": waste,
        "goodput_waste_itemized": bool(
            sum(1 for v in waste.values() if v > 0) >= 4),
        "v6_mae_ms": v6_mae,
        "v5_mae_ms": v5_mae,
        "v6_no_worse": bool(v6_mae <= v5_mae * 1.001),
    }


# --------------------------------------------------- whole-pipeline fusion
def _fusion_pipelines(n_rows: int, width: int, seed: int = 7,
                      device=None):
    """The two benchmark pipelines of the whole-pipeline fusion scenario
    (the reference's): a featurize→infer→postproc chain shaped like the
    image-featurizer serving path (dense feature matrix through a model
    head), and a text featurize→encoder chain whose tokenizer is
    genuinely host-bound (string ops split the fused span). The udfs
    take host arrays (eager) or device tensors (fused) alike."""
    import numpy as np
    import torch

    from ..core import DataFrame, PipelineModel
    from ..device import resolve_device
    from ..featurize import CleanMissingData, VectorAssembler
    from ..stages import SelectColumns, UDFTransformer

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def on(x):
        return torch.as_tensor(x, device=dev)

    def weights(*shape):
        return on((rng.normal(size=shape) * 0.05).astype(np.float32))

    # -- featurizer pipeline: clean → assemble → model head → postproc
    feat_df = DataFrame({
        "img": rng.normal(size=(n_rows, width)).astype(np.float32),
        "aux": np.where(rng.random(n_rows) < 0.25, np.nan,
                        rng.normal(size=n_rows)).astype(np.float32),
    })
    w1 = weights(width + 1, 128)
    w2 = weights(128, 10)
    clean = CleanMissingData(inputCols=["aux"], cleaningMode="Mean",
                             device=str(dev)).fit(feat_df)
    feat_pm = PipelineModel([
        clean,
        VectorAssembler(inputCols=["img", "aux"], outputCol="features",
                        handleInvalid="keep", device=str(dev)),
        UDFTransformer(inputCol="features", outputCol="logits",
                       jitSafe=True,
                       udf=lambda f: torch.tanh(on(f) @ w1) @ w2),
        UDFTransformer(inputCol="logits", outputCol="pred", jitSafe=True,
                       udf=lambda z: torch.argmax(on(z), dim=-1)
                       .to(torch.float32)),
        SelectColumns(cols=["pred"]),
    ])

    # -- text pipeline: host tokenizer → embed+encode (BERT-shaped) → pool
    seq, vocab, dim = 16, 512, 64
    texts = np.empty(n_rows, object)
    texts[:] = [" ".join(rng.choice(["the", "cat", "sat", "on", "mat",
                                     "dog", "ran", "fast", "tpu", "jit"],
                                    size=8)) for _ in range(n_rows)]
    text_df = DataFrame({"text": texts})

    def tokenize(col):
        # genuinely host-bound: python string hashing per token
        ids = np.zeros((len(col), seq), np.int32)
        for i, s in enumerate(col):
            for j, tok in enumerate(str(s).split()[:seq]):
                ids[i, j] = (hash(tok) & 0x7FFFFFFF) % vocab
        return ids

    emb = weights(vocab, dim)
    wq = weights(dim, dim)
    wo = weights(dim, 8)

    def encode(ids):
        x = emb[on(ids).long()]                     # [n, seq, dim]
        a = torch.einsum("nsd,de,nte->nst", x, wq, x)
        a = a / float(np.sqrt(np.float32(dim)))
        x = x + torch.einsum("nst,ntd->nsd", a, x)
        return torch.tanh(x.mean(dim=1) @ wo)        # [n, 8]

    text_pm = PipelineModel([
        UDFTransformer(inputCol="text", outputCol="ids", udf=tokenize),
        UDFTransformer(inputCol="ids", outputCol="enc", jitSafe=True,
                       udf=encode),
        UDFTransformer(inputCol="enc", outputCol="score", jitSafe=True,
                       udf=lambda e: on(e).sum(dim=-1)),
        SelectColumns(cols=["score"]),
    ])
    return (feat_pm, feat_df, "pred"), (text_pm, text_df, "score")


def _bench_pipeline(pm, df, out_col: str, reps: int, device=None) -> dict:
    """Median end-to-end seconds of eager per-stage vs compiled execution
    (both end with the outputs on the host), the fused path's dispatch
    count, and equivalence of the outputs."""
    import numpy as np

    cp = pm.compile(df, device=device)
    eager_out = pm.transform(df)
    fused_out = cp.transform(df)        # warmup = the one "compile"
    diff = float(np.max(np.abs(
        np.asarray(eager_out[out_col], np.float32)
        - np.asarray(fused_out[out_col], np.float32)))) \
        if len(df) else 0.0

    def _median(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(df)
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    eager_s = _median(pm.transform)
    fused_s = _median(cp.transform)
    return {
        "eager_ms": eager_s * 1e3,
        "fused_ms": fused_s * 1e3,
        "speedup": eager_s / max(fused_s, 1e-9),
        "segments": cp.compiled_segments,
        "eager_stages_in_plan": cp.eager_stages,
        # device round trips for the traced portion + host stages that
        # still run between segments — the per-request dispatch count
        "dispatches": cp.compiled_segments + cp.eager_stages,
        "max_abs_diff": diff,
        "equivalent": bool(diff <= 1e-5),
        "plan": cp.describe(),
    }


def pipeline_fusion_scenario(*, n_rows: int = 64, width: int = 64,
                             reps: int = 30, device=None) -> dict:
    """Fused vs per-stage pipeline execution: the featurizer pipeline
    must fuse into ≤ 2 dispatches per request and agree within 1e-5. The
    reference's ≥ 3x speed-up is its TPU acceptance figure: reported
    here (``featurizer_speedup_ge_3x``), held by nothing."""
    feat, text = _fusion_pipelines(n_rows, width, device=device)
    feat_r = _bench_pipeline(*feat, reps=reps, device=device)
    text_r = _bench_pipeline(*text, reps=reps, device=device)
    return {
        "featurizer": feat_r,
        "text": text_r,
        "featurizer_fused_le_2_dispatches": bool(
            feat_r["dispatches"] <= 2),
        "featurizer_speedup_ge_3x": bool(feat_r["speedup"] >= 3.0),
        "all_equivalent": bool(feat_r["equivalent"]
                               and text_r["equivalent"]),
    }


# --------------------------------------------------------------------- AOT
def _aot_bench_spec(n_rows: int, width: int, seed: int = 9, device=None):
    """A deterministic, fully param-fingerprintable pipeline (no callable
    params — those are AOT-ineligible by design) shaped like the
    featurizer serving path: clean → one-hot → assemble. The fit runs on
    ``device`` (CUDA unless "cpu")."""
    import numpy as np

    from ..core import DataFrame
    from ..device import resolve_device
    from ..featurize import CleanMissingData, VectorAssembler
    from ..featurize.vector import OneHotEncoderModel

    rng = np.random.default_rng(seed)
    aux = rng.normal(size=n_rows).astype(np.float32)
    aux[::5] = np.nan
    df = DataFrame({
        "img": rng.normal(size=(n_rows, width)).astype(np.float32),
        "aux": aux,
        "cat": rng.integers(0, 8, size=n_rows).astype(np.int32),
    })
    clean = CleanMissingData(inputCols=["aux"], cleaningMode="Median",
                             device=str(resolve_device(device))).fit(df)
    stages = [
        clean,
        OneHotEncoderModel(inputCol="cat", outputCol="onehot",
                           categorySize=8, handleInvalid="keep"),
        VectorAssembler(inputCols=["img", "aux", "onehot"],
                        outputCol="features", handleInvalid="keep"),
    ]
    return stages, df


# ------------------------------------------------ serving-plane scenarios
def _device(device):
    """``device`` resolved at call time (CUDA unless "cpu")."""
    from ..device import resolve_device
    return resolve_device(device)


def _tiny_causal_lm(vocab: int):
    """The LLM scenarios' causal LM (width 32, depth 1, heads 2, mlp 64,
    f32, dense causal attention), its weights drawn from a seeded
    ``torch.Generator``: the same architecture as the JAX package's, not
    the same bits."""
    import torch

    from ..dl import MaskedLMModel, TextEncoder
    from ..dl.text_encoder import make_attention_fn

    gen = torch.Generator().manual_seed(0)
    enc = TextEncoder(vocab=vocab, width=32, depth=1, heads=2, mlp_dim=64,
                      dtype=torch.float32,
                      attention_fn=make_attention_fn("dense", causal=True),
                      generator=gen)
    return MaskedLMModel(enc, generator=gen)


def tracing_overhead_scenario(*, service: str = "tracing-bench",
                              n_requests: int = 200,
                              item_service_s: float = 0.005,
                              max_batch: int = 8,
                              reps: int = 3,
                              registry=None) -> dict:
    """Profiler-overhead guard : the same synthetic
    serving pipeline (RequestScheduler + deterministic executor — no
    HTTP socket, so loopback jitter cannot masquerade as tracing cost)
    measured with the full tracing+profiler stack OFF vs ON, asserting
    the instrumented p99 stays within 5%% of bare.

    ON means everything a traced serving request pays: a request span
    per item, the scheduler's ``sched.queue`` child span, a retroactive
    execute span, a cost-model feature-log record, a ``StepProfiler``
    step around each executor batch, and a flight-recorder
    ``note_request`` per reply. The modes run INTERLEAVED (off, on,
    off, on, ...) and each mode keeps its best-of-``reps`` p99 — the
    same min-of-runs discipline bench.py's loaded rows use: the
    per-rep minimum is the deterministic floor (service time + any
    instrumentation cost), so host contention and sleep jitter — which
    hit both modes but not symmetrically within one rep — cannot
    manufacture or mask overhead. Returns both p99s, ``overhead_pct``,
    and ``within_bound`` (the 5%% contract — asserted by the test AND
    banked in the bench JSON).
    """
    from ..obs.export import flight_recorder
    from ..obs.profile import StepProfiler, feature_log
    from ..obs.metrics import registry as _default
    from ..obs.tracing import tracer
    from ..sched import RequestScheduler

    reg = registry if registry is not None else _default
    profiler = StepProfiler(service=service, registry=reg)
    flight_recorder.install()

    def one_run(traced: bool) -> float:
        sched = RequestScheduler(f"{service}-{'on' if traced else 'off'}",
                                 registry=reg)
        done: list[_SynthRequest] = []
        stop = threading.Event()

        def executor():
            while not stop.is_set() or sched.qsize():
                batch = sched.next_batch(max_batch=max_batch,
                                         max_wait=0.05)
                if not batch:
                    continue
                if traced:
                    with profiler.step("tracing-bench.batch") as h:
                        time.sleep(item_service_s * len(batch))
                        h.done(None)
                else:
                    time.sleep(item_service_s * len(batch))
                for item in batch:
                    span = getattr(item, "span", None)
                    if span is not None:
                        tracer.emit_span(
                            "serving.execute", parent=span,
                            seconds=item_service_s * len(batch),
                            service=service, rows=len(batch))
                        feature_log.record(
                            service=service, route="/",
                            batch=len(batch),
                            queue_ms=(getattr(item, "queue_wait", 0.0)
                                      or 0.0) * 1e3,
                            execute_ms=item_service_s * len(batch)
                            * 1e3, trace_id=span.trace_id)
                    item.reply(200)
                    if span is not None:
                        span.set_attr("status", 200)
                        tracer.end_span(span)
                        flight_recorder.note_request(
                            span.trace_id,
                            time.monotonic() - item.submitted,
                            status=200)
                    done.append(item)

        worker = threading.Thread(target=executor, daemon=True)
        worker.start()
        # pace BELOW saturation: the executor's cost is linear in batch
        # size here, so an overloaded run would measure queue growth —
        # the one thing that is NOT tracing overhead — in both modes
        interval = item_service_s * 1.5
        for _ in range(n_requests):
            req = _SynthRequest()
            if traced:
                req.span = tracer.start_span(
                    "serving.request", parent=None, current=False,
                    service=service, route="/")
            try:
                sched.submit(req)
            except Exception:
                req.reply(503)
            time.sleep(interval)
        stop.set()
        sched.wake()
        worker.join(timeout=20)
        lat = sorted((r.done_at - r.submitted) for r in done
                     if r.done_at is not None and r.status == 200)
        if not lat:
            return float("nan")
        return lat[max(_ceil(0.99 * len(lat)) - 1, 0)]

    offs, ons = [], []
    for _ in range(reps):
        offs.append(one_run(False))
        ons.append(one_run(True))
    p99_off, p99_on = min(offs), min(ons)
    overhead_pct = (p99_on - p99_off) / p99_off * 100.0
    return {
        "n_requests": n_requests,
        "item_service_s": item_service_s,
        "reps": reps,
        "p99_off_s": p99_off,
        "p99_on_s": p99_on,
        "overhead_pct": overhead_pct,
        "bound_pct": 5.0,
        "within_bound": overhead_pct <= 5.0,
        "feature_records": len(feature_log),
    }


def recorder_overhead_scenario(*, service: str = "recorder-bench",
                               n_requests: int = 600,
                               item_service_s: float = 0.002,
                               max_batch: int = 8,
                               reps: int = 3,
                               record_interval_s: float = 1.0,
                               registry_gauges: int = 120,
                               registry=None) -> dict:
    """History-plane overhead guard: the same synthetic
    serving pipeline as :func:`tracing_overhead_scenario` (scheduler +
    deterministic executor, no HTTP socket) measured with the
    time-series :class:`~mmlspark_torch.obs.timeseries.Recorder` thread
    OFF vs ON at its production cadence (1 s), over a registry
    pre-seeded with ``registry_gauges`` extra gauge series so the
    snapshot walks a production-scale sample surface.

    The 1%% verdict is NOT read off the end-to-end p99 delta — a 1%%
    effect (~30 us here) sits below the host's run-to-run p99 drift,
    so an e2e diff would be a coin flip (the tracing guard's 5%% bound
    is already at that noise floor). Instead the bound is decomposed
    into two precisely measurable parts, and the e2e OFF/ON p99s ride
    along as reported context only:

    * ``overhead_pct`` — the recorder's amortized per-request share of
      p99: median synchronous tick cost (timed directly, us
      precision) x ``interarrival / record_interval_s``, over the
      pipeline's best-of-``reps`` bare p99.
    * ``affected_fraction`` — the collision geometry: a tick delays at
      most ~2 in-flight requests, so
      ``2 * interarrival / record_interval_s`` of requests can feel a
      tick at all. Kept below the 1%% tail cut, a colliding tick
      cannot reach the p99 statistic — the p99 request is a
      non-collided one paying only the amortized share."""
    from ..obs.metrics import MetricsRegistry
    from ..obs.timeseries import Recorder, TimeSeriesStore
    from ..sched import RequestScheduler

    reg = registry if registry is not None else MetricsRegistry()
    pad = reg.gauge("profile_bench_pad",
                    "synthetic sample surface for the overhead guard")
    for i in range(max(int(registry_gauges), 0)):
        pad.set(float(i), idx=str(i))

    def one_run(recording: bool) -> float:
        sched = RequestScheduler(
            f"{service}-{'on' if recording else 'off'}", registry=reg)
        rec = None
        if recording:
            rec = Recorder(TimeSeriesStore(reg), reg)
            rec.start(record_interval_s)
        done: list[_SynthRequest] = []
        stop = threading.Event()

        def executor():
            while not stop.is_set() or sched.qsize():
                batch = sched.next_batch(max_batch=max_batch,
                                         max_wait=0.05)
                if not batch:
                    continue
                time.sleep(item_service_s * len(batch))
                for item in batch:
                    item.reply(200)
                    done.append(item)

        worker = threading.Thread(target=executor, daemon=True)
        worker.start()
        interval = item_service_s * 1.5
        try:
            for _ in range(n_requests):
                req = _SynthRequest()
                try:
                    sched.submit(req)
                except Exception:
                    req.reply(503)
                time.sleep(interval)
            stop.set()
            sched.wake()
            worker.join(timeout=20)
        finally:
            if rec is not None:
                rec.stop()
        lat = sorted((r.done_at - r.submitted) for r in done
                     if r.done_at is not None and r.status == 200)
        if not lat:
            return float("nan")
        return lat[max(_ceil(0.99 * len(lat)) - 1, 0)]

    offs, ons = [], []
    for _ in range(reps):
        offs.append(one_run(False))
        ons.append(one_run(True))
    p99_off, p99_on = min(offs), min(ons)

    costs = []
    probe = Recorder(TimeSeriesStore(reg), reg)
    for _ in range(50):
        t0 = time.perf_counter()
        probe.tick()
        costs.append(time.perf_counter() - t0)
    costs.sort()
    tick_cost_s = costs[len(costs) // 2]

    interarrival = item_service_s * 1.5
    amortized_s = tick_cost_s * interarrival / record_interval_s
    overhead_pct = amortized_s / p99_off * 100.0
    affected_fraction = 2.0 * interarrival / record_interval_s
    return {
        "n_requests": n_requests,
        "item_service_s": item_service_s,
        "reps": reps,
        "record_interval_s": record_interval_s,
        "registry_gauges": registry_gauges,
        "p99_off_s": p99_off,
        "p99_on_s": p99_on,
        "tick_cost_s": tick_cost_s,
        "amortized_per_request_s": amortized_s,
        "affected_fraction": affected_fraction,
        "overhead_pct": overhead_pct,
        "bound_pct": 1.0,
        "within_bound": (overhead_pct <= 1.0
                         and affected_fraction <= 0.01),
    }


def regression_chaos_scenario(*, service: str = "regression-bench",
                              seed: int = 23, chaos: bool = True,
                              warmup: int = 8, inject_after: int = 12,
                              max_ticks: int = 40,
                              base_step_s: float = 0.010,
                              slow_factor: float = 6.0,
                              sustain_ticks: int = 3) -> dict:
    """Live perf-regression acceptance: a seeded synthetic
    training loop exports ``profile_mfu`` each tick; the recorder
    samples it into a private store and the CUSUM sentinel watches.
    With ``chaos=True`` a ``worker.slow`` fault (the resilience
    plane's persistent-degradation path, ``factor=slow_factor``) arms
    after ``inject_after`` ticks — MFU steps down by that factor and
    the sentinel must flip ``obs_regression_active{series=
    profile_mfu}`` within 20 recorder ticks of the step, after which
    ``FleetHealth`` (sentinel attached) reads DEGRADED. With
    ``chaos=False`` the identical replay must alarm exactly never —
    the detector is a pure fold over the value sequence, so the
    healthy trajectory is bit-identical run to run."""
    from ..obs.fleet import FleetAggregator, FleetHealth
    from ..obs.metrics import MetricsRegistry
    from ..obs.regression import RegressionSentinel, SeriesWatch, _pull_mfu
    from ..obs.timeseries import Recorder, TimeSeriesStore
    from ..resilience import FaultRule, faults

    reg = MetricsRegistry()
    store = TimeSeriesStore(reg)
    recorder = Recorder(store, reg)
    sent = RegressionSentinel(store, reg, watches=[
        SeriesWatch("profile_mfu", _pull_mfu, direction="lower_bad",
                    warmup=warmup)], sustain_ticks=sustain_ticks)
    health = FleetHealth(FleetAggregator(reg), registry=reg,
                         service=service, store=store)
    health.attach_sentinel(sent)
    g_mfu = reg.gauge("profile_mfu", "model FLOP utilization, by stage")
    from ..obs.attribution import peak_spec
    peak_flops = peak_spec("cpu").peak_flops   # the 1 Tflop/s cpu row
    flops_per_step = base_step_s * peak_flops * 0.42   # healthy MFU 0.42

    rules = []
    if chaos:
        rules = [FaultRule(point="worker.slow", kind="slow",
                           match="trainer", times=1, after=inject_after,
                           factor=slow_factor)]
    step_at = None
    alarm_tick = None
    degraded_tick = None
    events = 0
    mfu_trace: list = []
    with faults(seed, rules):
        from ..resilience.faults import injector
        for t in range(max_ticks):
            injector.apply("worker.slow", "trainer")
            slow = injector.degradation("trainer")
            if slow > 1.0 and step_at is None:
                step_at = t
            step_s = base_step_s * slow
            mfu = flops_per_step / (peak_flops * step_s)
            mfu_trace.append(round(mfu, 4))
            g_mfu.set(mfu, stage="train")
            recorder.tick()
            active = sent.tick()
            verdict = health.tick()
            if active and alarm_tick is None:
                alarm_tick = t
            if verdict == "degraded" and degraded_tick is None:
                degraded_tick = t
            if alarm_tick is not None and degraded_tick is not None \
                    and t >= alarm_tick + sustain_ticks:
                break
        snap = reg.snapshot()
        events = int(sum(v for k, v in snap.items()
                         if k.startswith("obs_regression_events_total")))
    return {
        "chaos": chaos,
        "seed": seed,
        "mfu_healthy": mfu_trace[0] if mfu_trace else None,
        "mfu_degraded": mfu_trace[-1] if mfu_trace else None,
        "step_at_tick": step_at,
        "alarm_tick": alarm_tick,
        "ticks_to_alarm": (alarm_tick - step_at
                           if alarm_tick is not None and step_at is not None
                           else None),
        "degraded_tick": degraded_tick,
        "events": events,
        "verdict_end": health.verdict(),
        "mfu_trace": mfu_trace,
    }


def llm_serving_scenario(*, service: str = "llm-bench", slots: int = 2,
                         block_len: int = 4, spec_k: int = 0,
                         n_prompts: int = 4, prompt_len: int = 12,
                         max_new_tokens: int = 6, vocab: int = 64,
                         seed: int = 17, registry=None,
                         device=None) -> dict:
    """Generation benchmark for the LLM serving engine: warm a tiny causal LM's prefill+decode programs (weights from a
    seeded ``torch.Generator``, on ``device``: CUDA unless "cpu"), serve
    a repeated-prefix workload through
    :class:`~mmlspark_torch.serving.llm.LLMEngine`, and read the
    ``gen_*``/``kv_*`` series back from the obs registry.

    Three rounds over the SAME ``n_prompts`` prompts (shared
    ``block_len``-aligned prefix, distinct tails). Rounds 1-2 submit
    one sequence at a time and drain — TTFT is pure prefill, no
    slot-queue wait folded in: round 1 prefills cold, round 2 must hit
    the refcounted prefix cache, and the quantile split by the
    ``reuse`` label separates ``ttft_cold_p50_ms`` from
    ``ttft_warm_p50_ms`` (the measured TTFT improvement the paged
    cache exists to buy — a full-prompt hit prefills a 1-token
    suffix). TTFT quantiles are read BEFORE round 3 — the batched
    throughput round (all prompts at once, continuous batching), whose
    queue waits would otherwise pollute the warm column — which is
    what ``tokens_per_s`` measures. The whole serving run executes
    inside CompileTracker steady state, so a single runtime compile on
    a warmed worker fails the scenario rather than hiding in the
    latency columns.

    Returns tokens/sec, TTFT percentiles (registry
    ``gen_ttft_seconds`` quantiles split by the ``reuse`` label),
    prefix hit rate, spec-acceptance ratio (``spec_k > 0``), AOT
    fingerprint count, and the per-sequence outputs — callers bank the
    numbers and tests assert on either surface.
    """
    import numpy as np

    from ..obs.metrics import registry as _default
    from ..obs.profile import compile_tracker
    from ..serving.llm import LLMEngine, _bucket_window

    reg = registry if registry is not None else _default
    module = _tiny_causal_lm(vocab)
    rng = np.random.default_rng(seed)
    # shared prefix covering whole blocks (reuse is whole-chunk only),
    # distinct per-prompt tails
    shared = rng.integers(2, vocab, size=prompt_len - block_len)
    prompts = [list(map(int, np.concatenate(
        [shared, rng.integers(2, vocab, size=block_len)])))
        for _ in range(n_prompts)]

    engine = LLMEngine(
        module, draft_module=module if spec_k else None,
        slots=slots, block_len=block_len,
        max_seq_len=prompt_len + max_new_tokens + block_len,
        spec_k=spec_k, service=service, registry=reg,
        device=_device(device))
    windows = sorted({_bucket_window(len(p)) for p in prompts}
                     | {_bucket_window(block_len)} | {1})
    fps = engine.warm(prefill_windows=tuple(windows), mark_steady=True)
    try:
        outputs = {}
        # rounds 1-2: one sequence in flight at a time, so the TTFT
        # histogram holds pure submit→prefill→first-token latencies
        for rnd, reuse in ((0, "cold"), (1, "warm")):
            for i, p in enumerate(prompts):
                engine.submit(f"r{rnd}-s{i}", p, max_new_tokens)
                outputs.update(engine.run_until_drained())
        h = reg.metrics("gen_ttft_seconds")[0]
        ttft_ms = {
            "ttft_cold_p50_ms": h.quantile(0.5, service=service,
                                           reuse="cold") * 1e3,
            "ttft_warm_p50_ms": h.quantile(0.5, service=service,
                                           reuse="warm") * 1e3,
            "ttft_p99_ms": max(h.quantile(0.99, service=service,
                                          reuse=r) for r in
                               ("cold", "warm")) * 1e3,
        }
        # round 3: everything at once — continuous batching throughput
        t0 = time.monotonic()
        for i, p in enumerate(prompts):
            engine.submit(f"rt-s{i}", p, max_new_tokens)
        batch_out = engine.run_until_drained()
        wall_s = time.monotonic() - t0
        outputs.update(batch_out)
        compile_tracker.assert_steady_state()
        steady_ok = True
    finally:
        compile_tracker.unmark_steady()

    kv = engine.kv.stats()
    snap = reg.snapshot()

    def _sum(prefix: str) -> float:
        return sum(v for k, v in snap.items()
                   if k.startswith(prefix)
                   and f'service="{service}"' in k)

    hits = _sum("kv_prefix_hits_total")
    misses = _sum("kv_prefix_misses_total")
    # throughput counts round 3's committed tokens (decode commits plus
    # the prefill-produced first token per sequence) over round 3 wall
    batch_tokens = sum(len(v) for v in batch_out.values()) \
        - sum(len(p) for p in prompts)
    gen_tokens = int(_sum("gen_tokens_total")) \
        + len(outputs)   # + the prefill-produced first tokens
    return {
        "sequences": len(outputs),
        "gen_tokens": gen_tokens,
        "wall_s": wall_s,
        "tokens_per_s": batch_tokens / max(wall_s, 1e-9),
        **ttft_ms,
        "prefix_hits": int(hits),
        "prefix_misses": int(misses),
        "prefix_hit_rate": hits / max(hits + misses, 1),
        "tokens_reused": int(_sum("kv_prefix_tokens_reused_total")),
        "spec_accept_ratio": _sum("gen_spec_accept_ratio")
        if spec_k else None,
        "decode_steps": int(_sum("gen_decode_steps_total")),
        "kv_blocks": kv["blocks"],
        "kv_cached": kv["cached"],
        "aot_fingerprints": len(fps),
        "steady_state_ok": steady_ok,
        "outputs": {k: [int(t) for t in v] for k, v in outputs.items()},
    }


def llm_decode_scenario(*, service: str = "llm-decode-bench",
                        context_tokens: int = 4096,
                        block_len: int = 128,
                        max_new_tokens: int = 32, slots: int = 1,
                        vocab: int = 64, seed: int = 23,
                        registry=None, device=None) -> dict:
    """Long-context decode-throughput bench:
    steady-state tokens/sec of the decode executor at ``context_tokens``
    of resident KV — the regime the paged-attention kernel exists for,
    where the old path re-gathered the whole dense cache every step.

    One sequence fills ``context_tokens - max_new_tokens`` prompt
    tokens, then the timed window covers ONLY the drained decode steps
    (the first engine boundary — prefill + first decode step — runs
    before the clock starts, so prefill cost never pollutes the decode
    number). Runs inside CompileTracker steady state: a runtime compile
    mid-decode fails the scenario. The path's identity rides along in
    the numbers — ``dense_gather_bytes`` is exactly 0 on the paged
    path and the old path's per-step re-gather total behind
    ``MMLSPARK_TPU_PAGED_ATTN=0`` — so the side-by-side bank
    (``bench_llm_decode``) can prove which kernel produced which
    column. The engine runs on ``device`` (CUDA unless "cpu")."""
    import numpy as np

    from ..dl.paged_kv import paged_attention_enabled
    from ..obs.metrics import registry as _default
    from ..obs.profile import compile_tracker
    from ..serving.llm import LLMEngine, _bucket_window

    reg = registry if registry is not None else _default
    module = _tiny_causal_lm(vocab)
    rng = np.random.default_rng(seed)
    prompt_len = int(context_tokens) - int(max_new_tokens)
    prompt = [int(t) for t in rng.integers(2, vocab, size=prompt_len)]

    engine = LLMEngine(module, slots=slots,
                       block_len=block_len, max_seq_len=context_tokens,
                       service=service, registry=reg,
                       device=_device(device))
    windows = sorted({_bucket_window(prompt_len), 1})
    fps = engine.warm(prefill_windows=tuple(windows), mark_steady=True)
    try:
        engine.submit("ctx0", prompt, max_new_tokens)
        engine.step()            # admit + prefill + first decode step
        snap0 = reg.snapshot()

        def _sum(snapshot, prefix):
            return sum(v for k, v in snapshot.items()
                       if k.startswith(prefix)
                       and f'service="{service}"' in k)

        tok0 = _sum(snap0, "gen_tokens_total")
        t0 = time.monotonic()
        outputs = engine.run_until_drained()
        decode_wall_s = time.monotonic() - t0
        compile_tracker.assert_steady_state()
        steady_ok = True
    finally:
        compile_tracker.unmark_steady()

    snap = reg.snapshot()
    decode_tokens = _sum(snap, "gen_tokens_total") - tok0
    gather_bytes = _sum(snap, "kv_dense_gather_bytes_total")
    attn_decode_s = sum(
        v for k, v in snap.items()
        if k.startswith("gen_decode_attn_seconds_sum")
        and f'service="{service}"' in k and 'phase="decode"' in k)
    steps = _sum(snap, "gen_decode_steps_total")
    return {
        "context_tokens": int(context_tokens),
        "context_blocks": -(-int(context_tokens) // int(block_len)),
        "paged_attention": bool(paged_attention_enabled()),
        "decode_tokens": int(decode_tokens),
        "decode_wall_s": decode_wall_s,
        "tokens_per_s": decode_tokens / max(decode_wall_s, 1e-9),
        "dense_gather_bytes": int(gather_bytes),
        "attn_ms_per_step": (attn_decode_s / max(steps, 1)) * 1e3,
        "decode_steps": int(steps),
        "aot_fingerprints": len(fps),
        "steady_state_ok": steady_ok,
        "outputs": {k: [int(t) for t in v] for k, v in outputs.items()},
    }


def _later(name: str, item: str, what: str):
    def scenario(*args, **kwargs):
        raise NotImplementedError(
            f"{name} needs {what}: ROADMAP.md §1 item {item}")
    scenario.__name__ = scenario.__qualname__ = name
    scenario.__doc__ = (f"Not ported yet: {what} come with ROADMAP.md "
                        f"§1 item {item}.")
    return scenario


autoscale_lead_scenario = _later("autoscale_lead_scenario", "9d-2",
                                 "the autoscaler")
mixed_tenant_scenario = _later("mixed_tenant_scenario", "9d-2",
                               "the autoscaler and the serving mesh")
aot_scale_up_scenario = _later("aot_scale_up_scenario", "9d-2",
                               "the autoscaler and the worker pool")
chaos_scenario = _later("chaos_scenario", "9d-2",
                        "the serving mesh")
fleet_chaos_scenario = _later("fleet_chaos_scenario", "9d-2",
                              "the serving mesh and the autoscaler")
rollout_scenario = _later("rollout_scenario", "9d-2", "the deploy plane")
