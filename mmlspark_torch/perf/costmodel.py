"""Learned service-cost model trained on the obs FeatureLog (the port's
own copy of the JAX package's ``perf/costmodel.py``: the same features,
schema window, gate, env switches and save format, so a model file saved
by either package loads in the other).

``obs/profile.FeatureLog`` appends one training row per served request
or executed batch (route, batch, padding bucket, entity bytes, queue
depth, execute ms). This module is its learned consumer — a
per-(service, route) ridge regression over those rows, per "A Learned
Performance Model for TPUs" (arXiv:2008.01040), scoped to what a
pure-stdlib/numpy control plane can train online:

- **features**: padding bucket (the padded shape the executor actually
  runs), raw batch size, entity kilobytes, queue depth — with per-key
  training means filling features the caller cannot know at estimate
  time (admission prices a request before its batch forms);
- **target**: ``execute_ms`` — the batch transform wall time the
  scheduler's close decision and admission's Little's-law shed both
  price, by default through a per-bucket EWMA;
- **online refresh**: :meth:`CostModel.maybe_refresh` refits from the
  live FeatureLog every ``refresh_every`` new rows — serving traffic
  trains the model that prices serving traffic;
- **loud fallback gate**: a cold model (too few rows for the service)
  or one whose recent absolute error exceeds ``error_gate`` × the
  recent actual magnitude answers ``None`` — the consumer falls back
  to the EWMA it always had, and the refusal is counted
  (``sched_costmodel_fallback_total{reason=cold|error}``) and logged
  on every gate flip, never silent;
- **persistence**: :meth:`save`/:meth:`load_file` round-trip the
  fitted parameters as JSON under :func:`perf_root`, so a rebooted
  server prices with last boot's model until fresh traffic retrains it.

Rows are schema-checked: anything whose ``schema_version`` is not in
``ACCEPTED_SCHEMA_VERSIONS`` is SKIPPED loudly (counted + warned),
never misparsed — old logs degrade to the EWMA, not to garbage
predictions.

Import is stdlib + numpy + obs/sched only — no torch, no device.
Prediction takes a lock; it runs on scheduler and handler threads.
"""

from __future__ import annotations

import json
import logging
import math
import os
import tempfile
import threading

import numpy as np

from ..obs import registry as _default_registry
from ..obs.profile import FEATURE_SCHEMA_VERSION, feature_log as _feature_log
from ..sched.policy import bucket_of

_LOG = logging.getLogger("mmlspark_torch.perf")

__all__ = ["CostModel", "shared_cost_model", "enabled", "perf_root",
           "model_path", "bucket_build_priority"]

#: default on-disk root for learned-performance artifacts (cost-model
#: params). Under the process's temporary directory (``TMPDIR``), per
#: user: a shared path would let any local user plant parameters another
#: user's server boot would trust. The directory name is the reference's.
DEFAULT_PERF_ROOT = os.path.join(
    tempfile.gettempdir(),
    "mmlspark_tpu_perf-" + str(getattr(os, "getuid", lambda: "u")()))

#: the model's feature vector (after the intercept); per-key training
#: means fill features the caller cannot supply at estimate time. The
#: last three are generation-only (v4/v5 rows from the LLM serving
#: engine) — absent on every other row, where they train as 0 and the
#: fitted weights price exactly the decode-vs-prefill split (and, via
#: ``context_blocks``, decode cost by resident context — the chain
#: length the paged-attention kernel streams per step) for services
#: that record them.
FEATURES = ("bucket", "batch", "entity_kb", "queue_depth",
            "decode_steps", "prefill_tokens", "context_blocks",
            "analytic_tflops", "analytic_gb")

#: Row schemas this model can consume. v3 (the fleet PR) added only the
#: ``process`` rank stamp, v4 only the OPTIONAL generation fields
#: (``decode_steps``/``prefill_tokens`` default to 0 when absent), v5
#: only the OPTIONAL ``context_blocks`` (same default), and v6 only the
#: OPTIONAL analytic-cost pair (``analytic_flops``/``analytic_bytes``
#: from obs.attribution, same default) — no existing feature column
#: changed meaning — so v2–v5 logs remain fully usable; anything else
#: is skipped loudly in :meth:`fit`.
ACCEPTED_SCHEMA_VERSIONS = frozenset({FEATURE_SCHEMA_VERSION, 5, 4, 3,
                                      2})

MODEL_VERSION = 1


def perf_root() -> str:
    """The configured artifact root: ``MMLSPARK_TPU_PERF_STORE`` (the
    reference's name, so one setting serves both packages) or the
    per-user default."""
    return os.environ.get("MMLSPARK_TPU_PERF_STORE") or DEFAULT_PERF_ROOT


def model_path() -> str:
    return os.path.join(perf_root(), "costmodel.json")


def enabled() -> bool:
    """Process-wide kill switch: ``MMLSPARK_TPU_COSTMODEL=0`` keeps
    every scheduler on the pure-EWMA path."""
    return os.environ.get("MMLSPARK_TPU_COSTMODEL", "1") != "0"


def _row_features(row: dict) -> list[float] | None:
    """FeatureLog row → [1, bucket, batch, entity_kb, queue_depth,
    decode_steps, prefill_tokens, context_blocks, analytic_tflops,
    analytic_gb], or None when the row cannot price a batch (no batch /
    no target). The generation fields are v4+/v5-only and the analytic
    pair v6-only — all OPTIONAL: absent (older rows, services without
    them) they train as 0, so old logs keep fitting unchanged. The
    analytic pair is rescaled to Tflops/GB so its weights live in the
    same numeric range as the other columns (raw flops counts would
    dominate the ridge penalty)."""
    try:
        batch = float(row.get("batch") or 0)
        if batch <= 0:
            return None
        bucket = float(row.get("bucket") or bucket_of(int(batch)))
        ekb = float(row.get("entity_bytes") or 0.0) / 1024.0
        depth = float(row.get("queue_depth") or 0.0)
        decode_steps = float(row.get("decode_steps") or 0.0)
        prefill_tokens = float(row.get("prefill_tokens") or 0.0)
        context_blocks = float(row.get("context_blocks") or 0.0)
        analytic_tflops = float(row.get("analytic_flops") or 0.0) / 1e12
        analytic_gb = float(row.get("analytic_bytes") or 0.0) / 1e9
        return [1.0, bucket, batch, ekb, depth, decode_steps,
                prefill_tokens, context_blocks, analytic_tflops,
                analytic_gb]
    except (TypeError, ValueError):
        return None


class CostModel:
    """Per-(service, route) ridge regression predicting ``execute_ms``.

    Keys are ``(service, route)`` plus a ``(service, "")`` aggregate
    trained on every row of the service — batch-level pricing (the
    scheduler's close decision) uses the aggregate; per-route pricing
    falls back to it when the route is unseen.
    """

    def __init__(self, min_rows: int = 64, ridge: float = 1e-3,
                 error_gate: float = 0.5, error_alpha: float = 0.2,
                 refresh_every: int = 64, registry=None):
        reg = registry if registry is not None else _default_registry
        self.min_rows = int(min_rows)
        self.ridge = float(ridge)
        self.error_gate = float(error_gate)
        self.error_alpha = float(error_alpha)
        self.refresh_every = int(refresh_every)
        self._lock = threading.Lock()
        # (service, route) -> {"theta": ndarray, "mean": ndarray,
        #                      "n": int, "train_mae_ms": float}
        self._models: dict[tuple[str, str], dict] = {}
        self._err: dict[str, float] = {}    # EWMA |pred - actual| ms
        self._act: dict[str, float] = {}    # EWMA actual ms
        self._gated: dict[str, bool] = {}   # last gate state (flip log)
        self._last_fit_total = -1           # feature_log.total_recorded
        self._c_fallback = reg.counter(
            "sched_costmodel_fallback_total",
            "cost-model refusals answered by the EWMA instead, by "
            "service/reason (cold | error)")
        self._c_skipped = reg.counter(
            "sched_costmodel_skipped_rows_total",
            "FeatureLog rows the trainer skipped, by reason "
            "(schema | bad)")
        # the history plane's Recorder ticks every sched_-prefixed
        # sample into the time-series store, so this error gauge (and
        # the scheduler's sched_costmodel_error_ms histogram, which the
        # regression sentinel's cost-model watch CUSUMs) gets a
        # queryable drift trajectory for free — /debug/timeline shows
        # the scheduler being priced progressively wrong
        self._g_mae = reg.gauge(
            "sched_costmodel_mae_ms",
            "EWMA absolute prediction error ms, by service")
        self._g_rows = reg.gauge(
            "sched_costmodel_train_rows",
            "rows behind the fitted model, by service")

    # -- training ----------------------------------------------------------
    def fit(self, rows: list[dict]) -> int:
        """Fit from FeatureLog-shaped rows. Returns the rows used.
        Rows with a missing/mismatched ``schema_version`` are skipped
        LOUDLY (counted ``reason="schema"``, warned once per fit) —
        old logs fall back to the EWMA, they are never misparsed."""
        by_key: dict[tuple[str, str], list[tuple[list, float]]] = {}
        skipped_schema = skipped_bad = 0
        for row in rows:
            if row.get("schema_version") not in ACCEPTED_SCHEMA_VERSIONS:
                skipped_schema += 1
                continue
            try:
                y = float(row.get("execute_ms"))
            except (TypeError, ValueError):
                skipped_bad += 1
                continue
            x = _row_features(row)
            if x is None or not math.isfinite(y) or y < 0:
                skipped_bad += 1
                continue
            svc = str(row.get("service") or "")
            route = str(row.get("route") or "")
            by_key.setdefault((svc, ""), []).append((x, y))
            if route:
                by_key.setdefault((svc, route), []).append((x, y))
        if skipped_schema:
            self._c_skipped.inc(skipped_schema, reason="schema")
            _LOG.warning(
                "cost model skipped %d FeatureLog rows with schema_version"
                " not in %s (old log format — retrain from fresh traffic)",
                skipped_schema, sorted(ACCEPTED_SCHEMA_VERSIONS))
        if skipped_bad:
            self._c_skipped.inc(skipped_bad, reason="bad")
        used = 0
        fitted: dict[tuple[str, str], dict] = {}
        for key, pairs in by_key.items():
            # per-key floor: a route with 3 rows must not pretend to a
            # model; the service aggregate covers it meanwhile
            floor = self.min_rows if key[1] == "" else \
                max(self.min_rows // 2, 8)
            if len(pairs) < floor:
                continue
            X = np.asarray([p[0] for p in pairs], np.float64)
            y = np.asarray([p[1] for p in pairs], np.float64)
            d = X.shape[1]
            try:
                theta = np.linalg.solve(
                    X.T @ X + self.ridge * np.eye(d), X.T @ y)
            except np.linalg.LinAlgError:
                continue
            pred = X @ theta
            fitted[key] = {
                "theta": theta,
                "mean": X.mean(axis=0),
                "n": len(pairs),
                "train_mae_ms": float(np.mean(np.abs(pred - y))),
            }
            if key[1] == "":
                used += len(pairs)
                self._g_rows.set(len(pairs), service=key[0])
        with self._lock:
            self._models.update(fitted)
            # a refit resets the gate's error evidence for the services
            # it re-learned: while gated the model never predicts, so
            # the error EWMA that tripped the gate cannot update — if
            # actuals DROPPED (e.g. a warm path made batches faster)
            # the frozen error would hold the gate shut forever even
            # though every refit is accurate. Fresh fit → fresh trial;
            # a still-bad model rebuilds its error and re-trips (each
            # flip is logged).
            for svc in {k[0] for k in fitted}:
                self._err.pop(svc, None)
        return used

    def maybe_refresh(self, log=None, min_new: int | None = None) -> int:
        """Refit from the live FeatureLog when at least ``min_new``
        rows landed since the last fit (the online-refresh loop —
        ``ServiceTimeEstimator.observe`` calls this periodically).
        Returns rows used (0 = no refit)."""
        log = log if log is not None else _feature_log
        min_new = self.refresh_every if min_new is None else min_new
        total = getattr(log, "total_recorded", None)
        if total is None:
            total = len(log)
        if self._last_fit_total >= 0 and \
                total - self._last_fit_total < min_new:
            return 0
        rows = log.snapshot()
        if not rows:
            return 0
        self._last_fit_total = total
        return self.fit(rows)

    # -- prediction --------------------------------------------------------
    def _usable_model(self, svc: str, route: str,
                      count: bool) -> dict | None:
        """Route-then-aggregate model lookup + the gate check, with the
        loud fallback counting (``cold`` / ``error``) in ONE place —
        batch and per-item pricing must never diverge on gating."""
        with self._lock:
            m = self._models.get((svc, route)) if route else None
            if m is None:
                m = self._models.get((svc, ""))
            if m is None:
                if count:
                    self._c_fallback.inc(1, service=svc, reason="cold")
                return None
            gated = self._gate_locked(svc)
        if gated:
            if count:
                self._c_fallback.inc(1, service=svc, reason="error")
            return None
        return m

    def predict_batch_ms(self, service: str, batch: int,
                         route: str = "", entity_bytes: float | None = None,
                         queue_depth: float | None = None,
                         decode_steps: float | None = None,
                         prefill_tokens: float | None = None,
                         context_blocks: float | None = None,
                         count: bool = True) -> float | None:
        """Predicted ``execute_ms`` for a batch, or ``None`` when the
        model is cold for this service or its recent error exceeds the
        gate — the caller MUST fall back to its EWMA then. ``count=False``
        suppresses the fallback counters (error bookkeeping reads).
        ``decode_steps``/``prefill_tokens`` price a generation request's
        two phases separately and ``context_blocks`` its resident
        KV-chain length (services whose rows record them); omitted, the
        service's training mean fills in."""
        batch = int(batch)
        if batch <= 0:
            return None
        m = self._usable_model(str(service), route, count)
        if m is None:
            return None
        mean = m["mean"]
        feats = [
            1.0,
            float(bucket_of(batch)),
            float(batch),
            mean[3] if entity_bytes is None else
            float(entity_bytes) / 1024.0,
            mean[4] if queue_depth is None else float(queue_depth),
        ]
        # a model persisted before the v4 generation features has a
        # 5-dim theta (pre-v5: 7-dim, pre-v6: 8-dim); only append what
        # it was trained with
        if len(m["theta"]) > 5:
            feats.append(mean[5] if decode_steps is None
                         else float(decode_steps))
            feats.append(mean[6] if prefill_tokens is None
                         else float(prefill_tokens))
        if len(m["theta"]) > 7:
            feats.append(mean[7] if context_blocks is None
                         else float(context_blocks))
        if len(m["theta"]) > 8:
            # the v6 analytic pair has no request-time override — the
            # service's training mean (its compiled programs' cost)
            # always fills in
            feats.append(mean[8])
            feats.append(mean[9])
        x = np.asarray(feats, np.float64)
        ms = float(x @ m["theta"])
        # a linear extrapolation can dip negative off the training
        # range; a non-positive service time is never a usable price
        return max(ms, 1e-3)

    def predict_item_ms(self, service: str, route: str = "",
                        count: bool = False) -> float | None:
        """Average per-item cost at the service's observed operating
        point: the predicted batch cost AT the training-mean batch,
        divided by that batch — the same semantic as the EWMA's
        per-item series (seconds / batch_size averaged over observed
        batches). Deliberately NOT the cost of a batch of one: its
        intercept (fixed dispatch cost the real batches amortize) would
        inflate Little's-law drain estimates by the batching factor and
        shed healthy traffic."""
        m = self._usable_model(str(service), route, count)
        if m is None:
            return None
        ms = float(np.asarray(m["mean"], np.float64) @ m["theta"])
        mean_batch = max(float(m["mean"][2]), 1.0)
        return max(ms, 1e-3) / mean_batch

    def ready(self, service: str, route: str = "") -> bool:
        return self.predict_batch_ms(service, 1, route=route,
                                     count=False) is not None

    # -- the error gate ----------------------------------------------------
    def observe(self, service: str, predicted_ms: float | None,
                actual_ms: float) -> None:
        """Fold one (prediction, observation) pair into the gate's
        error EWMA (``predicted_ms=None`` still trains the actual-
        magnitude EWMA, so recovery is possible while gated)."""
        svc = str(service)
        a = self.error_alpha
        with self._lock:
            cur_a = self._act.get(svc)
            self._act[svc] = actual_ms if cur_a is None else \
                a * actual_ms + (1 - a) * cur_a
            if predicted_ms is not None:
                err = abs(float(predicted_ms) - float(actual_ms))
                cur_e = self._err.get(svc)
                self._err[svc] = err if cur_e is None else \
                    a * err + (1 - a) * cur_e
            mae = self._err.get(svc)
            gated = self._gate_locked(svc)
            flipped = gated != self._gated.get(svc, False)
            self._gated[svc] = gated
        if mae is not None:
            self._g_mae.set(mae, service=svc)
        if flipped:
            # LOUD on every flip: an operator must see the scheduler
            # change pricing brains, in the log and in the counter above
            if gated:
                _LOG.warning(
                    "cost model GATED for service %r (EWMA error %.3f ms"
                    " > %.0f%% of recent actual) — scheduler falls back "
                    "to the per-bucket EWMA until the error recovers",
                    svc, mae or 0.0, self.error_gate * 100)
            else:
                _LOG.warning("cost model UNGATED for service %r — "
                             "predictions price admission again", svc)

    def _gate_locked(self, svc: str) -> bool:
        err, act = self._err.get(svc), self._act.get(svc)
        if err is None or act is None:
            return False  # no evidence against the model yet
        return err > self.error_gate * max(act, 1e-6)

    def mae_ms(self, service: str) -> float | None:
        with self._lock:
            return self._err.get(str(service))

    # -- persistence -------------------------------------------------------
    def save(self, path: str | None = None) -> str:
        """Write the fitted parameters as JSON (atomic tmp+replace)."""
        path = path or model_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            models = [{
                "service": k[0], "route": k[1],
                "theta": [float(v) for v in m["theta"]],
                "mean": [float(v) for v in m["mean"]],
                "n": int(m["n"]),
                "train_mae_ms": float(m["train_mae_ms"]),
            } for k, m in sorted(self._models.items())]
        payload = {"version": MODEL_VERSION,
                   "schema_version": FEATURE_SCHEMA_VERSION,
                   "features": list(FEATURES), "models": models}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def load_file(self, path: str | None = None) -> int:
        """Load previously fitted parameters. A version or feature-
        schema mismatch raises — a persisted model from an older row
        schema must not price traffic silently."""
        path = path or model_path()
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        if payload.get("version") != MODEL_VERSION or \
                payload.get("schema_version") not in \
                ACCEPTED_SCHEMA_VERSIONS:
            raise ValueError(
                f"cost-model file {path!r} has version="
                f"{payload.get('version')} schema_version="
                f"{payload.get('schema_version')}; this build expects "
                f"({MODEL_VERSION}, {sorted(ACCEPTED_SCHEMA_VERSIONS)})"
                " — rebuild it from fresh FeatureLog traffic")
        loaded = {}
        for m in payload.get("models", ()):
            loaded[(str(m["service"]), str(m["route"]))] = {
                "theta": np.asarray(m["theta"], np.float64),
                "mean": np.asarray(m["mean"], np.float64),
                "n": int(m["n"]),
                "train_mae_ms": float(m["train_mae_ms"]),
            }
        with self._lock:
            self._models.update(loaded)
        return len(loaded)


# ------------------------------------------------- process-wide instance
_shared: CostModel | None = None
_shared_lock = threading.Lock()


def shared_cost_model() -> CostModel:
    """THE process-wide cost model (``RequestScheduler`` attaches it to
    its estimator). First call warm-boots from :func:`model_path` when
    a persisted model exists — a rebooted server prices with last
    boot's parameters until live traffic retrains them."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = CostModel()
            path = model_path()
            if os.path.exists(path):
                try:
                    n = _shared.load_file(path)
                    _LOG.info("cost model warm-booted %d fitted keys "
                              "from %s", n, path)
                except Exception:
                    _LOG.warning("persisted cost model at %s unusable — "
                                 "starting cold", path, exc_info=True)
        return _shared


# ------------------------------------------- AOT build-planner priority
def bucket_build_priority(service: str, buckets, log=None,
                          model: CostModel | None = None) -> list[int]:
    """Order padding buckets by predicted traffic value — observed
    request share × predicted execute cost — most valuable first, so an
    interrupted or time-boxed AOT build covers the hot path before the
    long tail (``core.aot._bucket_build_order`` consults this for
    ``core.aot.build_registered``, as in the JAX package).

    Returns ``[]`` when the FeatureLog holds no rows for the service —
    the caller keeps its deterministic ascending order then."""
    log = log if log is not None else _feature_log
    counts: dict[int, int] = {}
    for row in log.snapshot():
        if str(row.get("service") or "") != service:
            continue
        try:
            b = int(row.get("bucket") or
                    bucket_of(int(row.get("batch") or 0)))
        except (TypeError, ValueError):
            continue
        if b > 0:
            counts[b] = counts.get(b, 0) + 1
    if not counts:
        return []
    total = float(sum(counts.values()))
    model = model or shared_cost_model()

    def value(b: int) -> float:
        share = counts.get(b, 0) / total
        # predicted cost weights the share; a cold model degrades to
        # the padded size itself (bigger buckets cost more to compile
        # AND to serve — still a sane proxy)
        ms = model.predict_batch_ms(service, b, count=False)
        return share * (ms if ms is not None else float(b))

    return sorted({int(b) for b in buckets}, key=lambda b: (-value(b), b))
