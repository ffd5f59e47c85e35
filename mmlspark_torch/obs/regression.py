"""Perf-regression sentinel: the history plane grown teeth.

The port's own copy of the JAX package's ``obs/regression.py`` (stdlib only;
no JAX import), with the same names, series and wire forms.

Two halves, one contract — "slower than it was" is detected, not
discovered in a postmortem:

- **Offline trajectory gate** (``python -m mmlspark_torch.obs.regression
  compare OLD.json NEW.json`` / ``... gate [FILES...]``): diffs two
  banked bench JSONs metric by metric, with the good/bad direction
  inferred from the metric name (images_per_sec up is good; _ms up is
  bad) and a noise-aware tolerance — MAD over the full banked
  ``BENCH_r0*`` trajectory when it is deep enough, a relative floor
  when it is not, plus an absolute floor for sub-millisecond latency
  jitter. Exit status is the verdict, so CI wires it straight in as
  the RegressionGate job.
- **Live CUSUM sentinel** (:class:`RegressionSentinel`): watches the
  time-series store (``obs.timeseries``) for step changes in
  ``profile_mfu``, the windowed serving p99, and the cost model's
  prediction error. CUSUM accumulates standardized drift beyond a
  slack ``k`` and alarms at threshold ``h`` — a pure function of the
  value sequence, so a same-seed healthy replay alarms exactly never.
  Alarms export ``obs_regression_active{series}`` /
  ``obs_regression_events_total``, fire one ``obs.regression`` span
  per rising edge, and — sustained — turn ``GET /healthz`` DEGRADED
  via :meth:`~mmlspark_torch.obs.fleet.FleetHealth.attach_sentinel`
  (never critical: a slow fleet must not be drained).

Import is stdlib-only; the module attaches the process-wide sentinel
to ``fleet_health`` on import so serving processes get the live watch
for free.
"""

from __future__ import annotations

import glob as _glob
import json
import re
import sys
import threading

from .fleet import fleet_health
from .metrics import registry as _registry
from .timeseries import TimeSeriesStore, timeseries_store
from .tracing import tracer as _tracer

__all__ = [
    "CusumDetector",
    "RegressionSentinel",
    "SeriesWatch",
    "compare_benches",
    "format_table",
    "load_bench",
    "sentinel",
]


# ---------------------------------------------------------------------------
# offline: bench trajectory loader


#: bench-wrapper / bookkeeping keys that are not metrics
_NON_METRIC_KEYS = frozenset({
    "n", "rc", "value", "vs_baseline", "stale", "timeout",
})

_NUM_RE = re.compile(r'"([A-Za-z_][A-Za-z0-9_]*)":\s*(-?\d[\d.eE+-]*)')


def _harvest(obj, out: dict) -> None:
    """Pull numeric leaves out of a (possibly nested) parsed dict."""
    if not isinstance(obj, dict):
        return
    metric = obj.get("metric")
    for k, v in obj.items():
        if isinstance(v, dict):
            _harvest(v, out)
        elif isinstance(v, bool):
            continue
        elif isinstance(v, (int, float)):
            if k == "value" and isinstance(metric, str) and metric:
                out[metric] = float(v)
            elif k not in _NON_METRIC_KEYS:
                out[_norm(k)] = float(v)


def _norm(key: str) -> str:
    """One metric, one name across runs: the stale-reuse banker
    prefixes carried-over metrics with ``last_measured_``."""
    return key[14:] if key.startswith("last_measured_") else key


def _harvest_text(text: str, out: dict) -> None:
    """Recover metrics from a bench run's captured tail: try each line
    as a JSON object first (the bench emits one metrics line), then
    fall back to a regex sweep — the tail is the LAST 2000 chars of
    output, so the metrics line is routinely beheaded mid-JSON and
    only the pair-by-pair sweep still reads it."""
    for line in text.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            _harvest(json.loads(line), out)
            return
        except ValueError:
            pass
    for key, num in _NUM_RE.findall(text):
        if key in _NON_METRIC_KEYS:
            continue
        try:
            out.setdefault(_norm(key), float(num))
        except ValueError:
            continue


def load_bench(path: str) -> dict:
    """One banked bench JSON → flat ``{metric: value}``.

    Accepts the banker's wrapper (``{"n","cmd","rc","tail","parsed"}``
    — ``parsed`` may be null with the real metrics line truncated in
    the tail) or a plain flat dict of numbers (synthetic fixtures)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    out: dict = {}
    if isinstance(doc, dict) and "tail" in doc:
        _harvest_text(str(doc.get("tail") or ""), out)
        if isinstance(doc.get("parsed"), dict):
            _harvest(doc["parsed"], out)
    elif isinstance(doc, dict):
        _harvest(doc, out)
    return out


# ---------------------------------------------------------------------------
# offline: direction + tolerance + compare


#: name tokens whose metric is good-when-HIGHER
_HIGHER_TOKENS = ("per_sec", "_rps", "throughput", "mfu", "qps",
                  "hit_rate", "speedup", "concurrency", "samples_sec",
                  "rows_per")
#: name tokens whose metric is good-when-LOWER
_LOWER_TOKENS = ("_ms", "_seconds", "latency", "_rtt", "overhead",
                 "error", "stall", "_bytes", "evicted", "failures")


def direction(metric: str) -> str | None:
    """'higher' / 'lower' = which way is GOOD; None = unknowable from
    the name (reported as info, never gated)."""
    m = metric.lower()
    hi = any(t in m for t in _HIGHER_TOKENS)
    lo = any(t in m for t in _LOWER_TOKENS)
    if hi == lo:
        return None
    return "higher" if hi else "lower"


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


def _mad(vals):
    med = _median(vals)
    return _median([abs(v - med) for v in vals])


def compare_benches(old: dict, new: dict, history=None, *,
                    rel_floor: float = 0.10, mad_k: float = 3.0,
                    abs_floor_ms: float = 0.25) -> list:
    """Diff two flat bench dicts into verdict rows.

    Tolerance per metric = ``max(rel_floor, mad_k·MAD/|median|)`` over
    that metric's banked ``history`` values when ≥3 exist (the
    trajectory prices its own noise), else the bare ``rel_floor`` — a
    2-sample history proves nothing about variance. ``_ms`` metrics
    additionally get ``abs_floor_ms``: sub-quarter-millisecond swings
    on a loopback serving bench are host jitter, not regressions.
    Zero/negative values mark a FAILED measurement on that side and
    the metric is skipped, never gated."""
    history = history or {}
    rows = []
    for metric in sorted(set(old) & set(new)):
        a, b = float(old[metric]), float(new[metric])
        row = {"metric": metric, "old": a, "new": b,
               "direction": direction(metric)}
        if a <= 0 or b <= 0:
            row.update(delta_pct=0.0, tol_pct=0.0, verdict="skipped")
            rows.append(row)
            continue
        delta = (b - a) / a
        tol = rel_floor
        hist = [v for v in history.get(metric, []) if v > 0]
        if len(hist) >= 3:
            med = _median(hist)
            if med > 0:
                tol = max(rel_floor, mad_k * _mad(hist) / med)
        row.update(delta_pct=delta * 100.0, tol_pct=tol * 100.0)
        d = row["direction"]
        if d is None:
            row["verdict"] = "info"
        elif metric.endswith("_ms") and abs(b - a) <= abs_floor_ms:
            row["verdict"] = "ok"
        elif (d == "higher" and delta < -tol) or \
                (d == "lower" and delta > tol):
            row["verdict"] = "regression"
        elif (d == "higher" and delta > tol) or \
                (d == "lower" and delta < -tol):
            row["verdict"] = "improved"
        else:
            row["verdict"] = "ok"
        rows.append(row)
    return rows


def history_from_files(paths) -> dict:
    """``{metric: [value, ...]}`` across a trajectory of bench files
    (file order = time order; failed measurements dropped)."""
    hist: dict = {}
    for p in paths:
        for metric, v in load_bench(p).items():
            hist.setdefault(metric, []).append(v)
    return hist


def format_table(rows) -> str:
    """The human diff table ``compare`` prints and ``bench.py
    --compare`` appends a verdict from."""
    if not rows:
        return "(no common metrics)"
    head = f"{'metric':<34} {'old':>12} {'new':>12} " \
           f"{'delta':>8} {'tol':>6}  verdict"
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['metric']:<34} {r['old']:>12.4g} {r['new']:>12.4g} "
            f"{r['delta_pct']:>+7.1f}% {r['tol_pct']:>5.1f}%  "
            f"{r['verdict']}")
    return "\n".join(lines)


def gate_verdict(rows) -> str:
    bad = [r["metric"] for r in rows if r["verdict"] == "regression"]
    if bad:
        return "REGRESSION: " + ", ".join(bad)
    n_ok = sum(r["verdict"] in ("ok", "improved") for r in rows)
    return f"PASS ({n_ok} metrics within tolerance)"


# ---------------------------------------------------------------------------
# live: CUSUM step-change detection


class CusumDetector:
    """One-sided CUSUM over a standardized series.

    The first ``warmup`` values establish the reference (median) and
    scale (1.4826·MAD, floored at 5% of |median| so a perfectly steady
    warmup cannot make the detector infinitely touchy). Each later
    value contributes its standardized drift in the BAD direction
    beyond the slack ``k``; the accumulated statistic alarms at ``h``.
    Everything is a pure fold over the value sequence — replaying the
    same values gives bit-identical alarm history."""

    def __init__(self, *, warmup: int = 8, k: float = 0.5,
                 h: float = 5.0, direction: str = "lower_bad"):
        if direction not in ("lower_bad", "higher_bad"):
            raise ValueError(f"bad direction: {direction!r}")
        self.warmup = max(int(warmup), 2)
        self.k = float(k)
        self.h = float(h)
        self.direction = direction
        self._warmup_vals: list = []
        self.ref: float | None = None
        self.scale: float | None = None
        self.stat = 0.0
        self.alarm = False

    def update(self, x: float) -> bool:
        """Fold one value; returns the current alarm state."""
        x = float(x)
        if self.ref is None:
            self._warmup_vals.append(x)
            if len(self._warmup_vals) >= self.warmup:
                self.ref = _median(self._warmup_vals)
                self.scale = max(1.4826 * _mad(self._warmup_vals),
                                 0.05 * abs(self.ref), 1e-9)
                self._warmup_vals = []
            return False
        z = (x - self.ref) / self.scale
        drift = -z if self.direction == "lower_bad" else z
        self.stat = max(0.0, self.stat + drift - self.k)
        self.alarm = self.stat >= self.h
        return self.alarm


class SeriesWatch:
    """One sentinel watch: a name, a store → value pull (None = no
    signal this tick, the detector is not fed), and the bad
    direction."""

    def __init__(self, name: str, pull, *, direction: str = "lower_bad",
                 warmup: int = 8, k: float = 0.5, h: float = 5.0):
        self.name = name
        self.pull = pull
        self.detector = CusumDetector(warmup=warmup, k=k, h=h,
                                      direction=direction)


def _pull_mfu(store: TimeSeriesStore):
    vals = [p[1] for name in store.series_names("profile_mfu")
            if (name == "profile_mfu" or name.startswith("profile_mfu{"))
            for p in [store.latest(name)] if p is not None]
    return sum(vals) / len(vals) if vals else None


def _pull_serving_p99(window: float):
    def pull(store: TimeSeriesStore):
        v = store.quantile_over_time("serving_request_seconds", 0.99,
                                     window)
        return v if v > 0 else None
    return pull


def _pull_costmodel_error(window: float):
    def pull(store: TimeSeriesStore):
        num = sum(store.increase(n, window) for n in
                  store.series_names("sched_costmodel_error_ms_sum"))
        den = sum(store.increase(n, window) for n in
                  store.series_names("sched_costmodel_error_ms_count"))
        return num / den if den > 0 else None
    return pull


def default_watches(window: float = 120.0) -> list:
    """The stock watch set: training MFU (lower = bad), the WINDOWED
    serving p99 rebuilt from recorded bucket deltas (higher = bad),
    and the cost model's mean absolute error (higher = bad — the
    scheduler is being priced wrong)."""
    return [
        SeriesWatch("profile_mfu", _pull_mfu, direction="lower_bad"),
        SeriesWatch("serving_p99_seconds", _pull_serving_p99(window),
                    direction="higher_bad"),
        SeriesWatch("sched_costmodel_error_ms",
                    _pull_costmodel_error(window),
                    direction="higher_bad"),
    ]


class RegressionSentinel:
    """Ticks the watch set against the store and exports the alarms.

    Per watch: ``obs_regression_active{series}`` (0/1 gauge), one
    ``obs_regression_events_total{series}`` count plus one
    ``obs.regression`` span per RISING edge, and — once an alarm has
    held for ``sustain_ticks`` consecutive ticks — membership in
    :meth:`sustained`, which is what FleetHealth folds into the
    degraded verdict (one noisy tick must not flip healthz)."""

    def __init__(self, store: TimeSeriesStore | None = None,
                 registry=None, *, watches=None, sustain_ticks: int = 3,
                 window: float = 120.0):
        self._reg = registry if registry is not None else _registry
        self.store = store if store is not None else timeseries_store
        self.watches = (list(watches) if watches is not None
                        else default_watches(window))
        self.sustain_ticks = max(int(sustain_ticks), 1)
        self._lock = threading.Lock()
        self._streak: dict = {}
        self._active: set = set()
        self._g_active = self._reg.gauge(
            "obs_regression_active",
            "live CUSUM regression alarm, by series (0/1)")
        self._c_events = self._reg.counter(
            "obs_regression_events_total",
            "regression alarm rising edges, by series")

    def tick(self) -> frozenset:
        """Evaluate every watch once; returns the active alarm set."""
        edges = []
        readings = [(w, w.pull(self.store)) for w in self.watches]
        with self._lock:
            for w, value in readings:
                if value is None:
                    continue
                alarm = w.detector.update(value)
                was = w.name in self._active
                if alarm:
                    self._active.add(w.name)
                    self._streak[w.name] = self._streak.get(w.name, 0) + 1
                    if not was:
                        edges.append((w.name, value, w.detector))
                else:
                    self._active.discard(w.name)
                    self._streak[w.name] = 0
            active = frozenset(self._active)
        for w, value in readings:
            if value is not None:
                self._g_active.set(1.0 if w.name in active else 0.0,
                                   series=w.name)
        for name, value, det in edges:
            self._c_events.inc(series=name)
            _tracer.emit_span(
                "obs.regression", parent=None, seconds=0.0, series=name,
                value=value, reference=det.ref, cusum=round(det.stat, 3))
        return active

    def active(self) -> frozenset:
        with self._lock:
            return frozenset(self._active)

    def sustained(self) -> frozenset:
        """Watches alarmed for ≥ ``sustain_ticks`` consecutive ticks —
        the healthz-degrading subset."""
        with self._lock:
            return frozenset(
                name for name in self._active
                if self._streak.get(name, 0) >= self.sustain_ticks)


#: THE process-wide sentinel over the shared store, attached to the
#: shared health view at import: any process that imports obs gets the
#: live watch wired into /healthz for free.
sentinel = RegressionSentinel(timeseries_store)
fleet_health.attach_sentinel(sentinel)


# ---------------------------------------------------------------------------
# CLI


def _default_trajectory() -> list:
    return sorted(_glob.glob("BENCH_r0*.json") or
                  _glob.glob("BENCH_r*.json"))


def main(argv=None) -> int:
    """``compare OLD NEW [--history F...]`` diffs two runs; ``gate
    [FILES...]`` diffs the newest banked run against its predecessor
    with the whole trajectory pricing the noise. Exit 0 = pass, 1 =
    regression, 2 = not enough data."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("compare", "gate"):
        print("usage: python -m mmlspark_torch.obs.regression "
              "compare OLD.json NEW.json [--history FILE...]\n"
              "       python -m mmlspark_torch.obs.regression "
              "gate [FILES...]", file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "compare":
        hist_files: list = []
        if "--history" in rest:
            i = rest.index("--history")
            hist_files = rest[i + 1:]
            rest = rest[:i]
        if len(rest) != 2:
            print("compare needs exactly OLD.json NEW.json",
                  file=sys.stderr)
            return 2
        old_p, new_p = rest
        files = hist_files
    else:
        files = rest or _default_trajectory()
        if len(files) < 2:
            print(f"gate: need >= 2 trajectory files, got {len(files)}",
                  file=sys.stderr)
            return 2
        old_p, new_p = files[-2], files[-1]
    rows = compare_benches(load_bench(old_p), load_bench(new_p),
                           history_from_files(files))
    print(f"{old_p} -> {new_p}")
    print(format_table(rows))
    verdict = gate_verdict(rows)
    print(verdict)
    return 1 if verdict.startswith("REGRESSION") else 0


if __name__ == "__main__":
    sys.exit(main())
