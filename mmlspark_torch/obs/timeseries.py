"""Embedded time-series store: ONE bounded history substrate (the port's
own copy of the JAX package's ``obs/timeseries.py``; the HTTP route waits
for the serving server).

Until this module, every consumer of "how has this series moved" kept
a private history: BurnRateMonitor held a tick list, the Autoscaler a
depth deque, the StragglerDetector only its last flag set, and the
cost model an EWMA nobody could query. Each invented its own
retention, none was visible over HTTP, and the perf-regression
sentinel (``obs.regression``) would have needed a fourth copy. This
module is the shared substrate instead:

- :class:`TimeSeriesStore` — per-series ring buffers keyed by the
  REGISTRY SAMPLE NAME (``name{label="v"}``), timestamps derived from
  ``time.monotonic``.
  Bounded three ways, each with a loud eviction counter
  (``obs_timeseries_evicted_total{reason}``): per-series point cap
  (``ring``), per-series retention horizon (``retention``), and a
  global point bound across all series (``global``).
- :class:`Recorder` — a tick that snapshots the metrics registry,
  filters to the federated prefixes (``profile_``, ``sched_``,
  ``serving_``, ``mem_``, ``fleet_``, ``aot_``, ``slo_``), and appends
  every matching sample. Run it manually (tests, health ticks) or as a
  background thread (:meth:`Recorder.start`).
- a PromQL-shaped query API: :meth:`~TimeSeriesStore.range`,
  :meth:`~TimeSeriesStore.rate` / :meth:`~TimeSeriesStore.increase`
  (counters), ``avg/min/max_over_time``, ``mad_over_time`` (the robust
  dispersion the straggler flap suppression uses), and
  :meth:`~TimeSeriesStore.quantile_over_time` which rebuilds
  quantiles from Histogram ``_bucket{le=...}`` deltas over the window
  via the same :func:`~mmlspark_torch.obs.metrics.bucket_quantile`
  estimator ``Histogram.quantile`` uses.
- :func:`timeline_payload` — the JSON body both serving fronts expose
  at ``GET /debug/timeline?series=<patterns>&window=<seconds>``.

Import is stdlib-only and side-effect-free. All shared state mutates under
the store's lock; registry handles do their own locking.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque

from .metrics import bucket_quantile, registry as _registry

__all__ = [
    "DEFAULT_RECORD_PREFIXES",
    "Recorder",
    "TimeSeriesStore",
    "recorder",
    "timeline_payload",
    "timeseries_store",
]

#: registry prefixes the Recorder samples by default — the same
#: families the fleet plane federates, plus the SLO burn series.
DEFAULT_RECORD_PREFIXES = (
    "profile_", "sched_", "serving_", "mem_", "fleet_", "aot_", "slo_",
    "kv_", "gen_", "deploy_", "goodput_",
)

#: /debug/timeline response bounds: series per response, points per
#: series — a scrape surface must not become an OOM surface.
_TIMELINE_MAX_SERIES = 64
_TIMELINE_MAX_POINTS = 512


class _Ring:
    """One series' bounded history: (t, value) points plus its limits."""

    __slots__ = ("pts", "maxlen", "retention_s")

    def __init__(self, maxlen: int, retention_s: float):
        self.pts: deque = deque()
        self.maxlen = int(maxlen)
        self.retention_s = float(retention_s)


class TimeSeriesStore:
    """Bounded in-process TSDB over registry sample names.

    ``clock`` must be monotonic-derived (default ``time.monotonic``) —
    timestamps are spans since an arbitrary origin, never wall time, so
    a suspended host or an NTP step cannot tear a window. Tests inject
    a hand-cranked clock for frozen-time assertions.
    """

    def __init__(self, registry=None, *, clock=time.monotonic,
                 default_maxlen: int = 512,
                 default_retention_s: float = 900.0,
                 max_total_points: int = 200_000):
        self._reg = registry if registry is not None else _registry
        self._clock = clock
        self.default_maxlen = int(default_maxlen)
        self.default_retention_s = float(default_retention_s)
        self.max_total_points = int(max_total_points)
        self._lock = threading.Lock()
        self._rings: dict[str, _Ring] = {}
        self._total = 0
        self._c_evicted = self._reg.counter(
            "obs_timeseries_evicted_total",
            "history points dropped, by reason "
            "(ring | retention | global)")
        self._g_series = self._reg.gauge(
            "obs_timeseries_series", "live series in the history store")
        self._g_points = self._reg.gauge(
            "obs_timeseries_points", "total points across all series")

    # -- write path --------------------------------------------------------

    def ensure(self, series: str, *, maxlen: int | None = None,
               retention_s: float | None = None) -> None:
        """Create (or re-limit) one series' ring. Consumers with a
        known horizon (burn windows, depth trends) size their rings
        here instead of inheriting the defaults."""
        with self._lock:
            self._ensure_locked(series, maxlen, retention_s)

    def _ensure_locked(self, series: str, maxlen, retention_s) -> _Ring:
        ring = self._rings.get(series)
        if ring is None:
            ring = self._rings[series] = _Ring(
                maxlen if maxlen is not None else self.default_maxlen,
                retention_s if retention_s is not None
                else self.default_retention_s)
        else:
            if maxlen is not None:
                ring.maxlen = int(maxlen)
            if retention_s is not None:
                ring.retention_s = float(retention_s)
        return ring

    def append(self, series: str, value: float, *, t: float | None = None,
               maxlen: int | None = None,
               retention_s: float | None = None) -> None:
        """Append one point (timestamp = store clock unless given)."""
        self.append_many({series: value}, t=t, maxlen=maxlen,
                         retention_s=retention_s)

    def append_many(self, samples: dict, *, t: float | None = None,
                    maxlen: int | None = None,
                    retention_s: float | None = None) -> int:
        """Append a batch under one lock hold (the Recorder hot path).
        Non-numeric values are skipped. Returns points appended."""
        now = self._clock() if t is None else float(t)
        evicted = {"ring": 0, "retention": 0, "global": 0}
        n = 0
        with self._lock:
            for series, value in samples.items():
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                ring = self._ensure_locked(series, maxlen, retention_s)
                ring.pts.append((now, v))
                self._total += 1
                n += 1
                while len(ring.pts) > ring.maxlen:
                    ring.pts.popleft()
                    self._total -= 1
                    evicted["ring"] += 1
                horizon = now - ring.retention_s
                while ring.pts and ring.pts[0][0] < horizon:
                    ring.pts.popleft()
                    self._total -= 1
                    evicted["retention"] += 1
            evicted["global"] += self._enforce_global_locked()
            n_series, n_points = len(self._rings), self._total
        for reason, count in evicted.items():
            if count:
                self._c_evicted.inc(count, reason=reason)
        self._g_series.set(n_series)
        self._g_points.set(n_points)
        return n

    def _enforce_global_locked(self) -> int:
        """Oldest-first global eviction: while over the total bound,
        drop the oldest point in the store (whichever series holds it).
        Loud by design — a tripped global bound means some producer's
        cardinality needs a look, not silent data loss."""
        dropped = 0
        while self._total > self.max_total_points:
            oldest_key = None
            oldest_t = math.inf
            for key, ring in self._rings.items():
                if ring.pts and ring.pts[0][0] < oldest_t:
                    oldest_t = ring.pts[0][0]
                    oldest_key = key
            if oldest_key is None:
                break
            ring = self._rings[oldest_key]
            ring.pts.popleft()
            self._total -= 1
            dropped += 1
            if not ring.pts:
                del self._rings[oldest_key]
        return dropped

    def clear(self) -> None:
        """Drop every series (test isolation)."""
        with self._lock:
            self._rings.clear()
            self._total = 0
        self._g_series.set(0)
        self._g_points.set(0)

    # -- read path ---------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def size(self) -> tuple[int, int]:
        """(series, total points)."""
        with self._lock:
            return len(self._rings), self._total

    def series_names(self, pattern: str = "") -> list[str]:
        """Sorted series names; ``pattern`` is a prefix filter."""
        with self._lock:
            names = list(self._rings)
        return sorted(n for n in names if n.startswith(pattern))

    def points(self, series: str, window: float | None = None,
               now: float | None = None) -> list:
        """One series' ``[(t, value), ...]`` oldest-first, optionally
        clipped to the trailing ``window`` seconds."""
        with self._lock:
            ring = self._rings.get(series)
            pts = list(ring.pts) if ring is not None else []
        if window is None:
            return pts
        t0 = (self._clock() if now is None else now) - float(window)
        return [p for p in pts if p[0] >= t0]

    def last_n(self, series: str, n: int) -> list:
        """The newest ``n`` points, oldest-first."""
        with self._lock:
            ring = self._rings.get(series)
            if ring is None:
                return []
            pts = list(ring.pts)
        return pts[-int(n):] if n > 0 else []

    def latest(self, series: str):
        """Newest ``(t, value)`` or None."""
        pts = self.last_n(series, 1)
        return pts[0] if pts else None

    def range(self, patterns, window: float | None = None) -> dict:
        """``{series: [(t, value), ...]}`` for every series matching
        any pattern (exact name or name prefix — a bare family name
        matches all its label combinations)."""
        if isinstance(patterns, str):
            patterns = [patterns]
        pats = [p for p in patterns if p]
        with self._lock:
            names = list(self._rings)
        out = {}
        now = self._clock()
        for name in sorted(names):
            if any(name == p or name.startswith(p) for p in pats):
                out[name] = self.points(name, window, now=now)
        return out

    # -- window functions --------------------------------------------------

    def increase(self, series: str, window: float) -> float:
        """Counter increase over the window: the sum of positive
        deltas, so a counter reset (process restart mid-window) loses
        the pre-reset increase instead of fabricating a negative one."""
        pts = self.points(series, window)
        inc = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b > a:
                inc += b - a
        return inc

    def rate(self, series: str, window: float) -> float:
        """Per-second counter rate over the window (0.0 under 2 points
        or zero elapsed)."""
        pts = self.points(series, window)
        if len(pts) < 2:
            return 0.0
        elapsed = pts[-1][0] - pts[0][0]
        if elapsed <= 0:
            return 0.0
        return self.increase(series, window) / elapsed

    def _values(self, series: str, window: float) -> list:
        return [v for _, v in self.points(series, window)]

    def avg_over_time(self, series: str, window: float) -> float:
        vals = self._values(series, window)
        return sum(vals) / len(vals) if vals else 0.0

    def min_over_time(self, series: str, window: float) -> float:
        vals = self._values(series, window)
        return min(vals) if vals else 0.0

    def max_over_time(self, series: str, window: float) -> float:
        vals = self._values(series, window)
        return max(vals) if vals else 0.0

    @staticmethod
    def _median(vals: list) -> float:
        vals = sorted(vals)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0

    def mad_over_time(self, series: str, window: float) -> float:
        """Median absolute deviation of the window's values — the
        robust dispersion behind straggler flap suppression and the
        offline gate's noise tolerance. 0.0 under 2 points."""
        vals = self._values(series, window)
        if len(vals) < 2:
            return 0.0
        med = self._median(vals)
        return self._median([abs(v - med) for v in vals])

    def quantile_over_time(self, family: str, q: float, window: float,
                           **labels) -> float:
        """Reconstruct the ``q``-quantile of a HISTOGRAM family's
        observations made during the window, from the recorded
        cumulative ``<family>_bucket{le=...}`` series (label filter =
        subset match). Bucket increases over the window un-cumulate
        into per-bucket counts; :func:`bucket_quantile` interpolates —
        so the serving p99 the sentinel watches is a WINDOWED p99, not
        the all-time one the raw registry snapshot gives. 0.0 when no
        observation landed in the window."""
        prefix = f"{family}_bucket{{"
        want = [f'{k}="{v}"' for k, v in labels.items()]
        per_le: dict[float, float] = {}
        for name in self.series_names(prefix):
            if any(w not in name for w in want):
                continue
            le = _parse_le(name)
            if le is None:
                continue
            per_le[le] = per_le.get(le, 0.0) + self.increase(name, window)
        if not per_le:
            return 0.0
        bounds = sorted(b for b in per_le if not math.isinf(b))
        if not bounds:
            return 0.0
        counts, prev = [], 0.0
        for b in bounds:
            counts.append(max(0.0, per_le[b] - prev))
            prev = per_le[b]
        inf_cum = per_le.get(math.inf, prev)
        counts.append(max(0.0, inf_cum - prev))
        return bucket_quantile(tuple(bounds), counts, q)

    # -- HTTP export -------------------------------------------------------

    def timeline_payload(self, query: str = "") -> tuple[int, bytes]:
        """The ``GET /debug/timeline?series=&window=`` body (both
        serving fronts route here). ``series`` is a comma-separated
        pattern list (exact sample name or prefix); without it the
        response is an index of series names + sizes, so an operator
        can discover what to ask for. ``window`` defaults to 300 s."""
        params = _parse_qs(query)
        window = 300.0
        try:
            if params.get("window"):
                window = float(params["window"])
        except ValueError:
            return 400, b'{"error": "window must be a number"}'
        pats = [p for p in params.get("series", "").split(",") if p]
        n_series, n_points = self.size()
        body = {
            "window_s": window,
            "now": self.now(),
            "series_total": n_series,
            "points_total": n_points,
        }
        if not pats:
            body["series"] = {
                name: len(self.points(name))
                for name in self.series_names()[:_TIMELINE_MAX_SERIES]}
        else:
            matched = self.range(pats, window)
            truncated = len(matched) > _TIMELINE_MAX_SERIES
            body["truncated"] = truncated
            body["series"] = {
                name: [[round(t, 4), v] for t, v in
                       pts[-_TIMELINE_MAX_POINTS:]]
                for name, pts in
                list(matched.items())[:_TIMELINE_MAX_SERIES]}
        return 200, json.dumps(body).encode()


def _parse_le(sample: str) -> float | None:
    """Extract the ``le`` bound from a rendered bucket sample name."""
    i = sample.find('le="')
    if i < 0:
        return None
    j = sample.find('"', i + 4)
    if j < 0:
        return None
    raw = sample[i + 4:j]
    if raw == "+Inf":
        return math.inf
    try:
        return float(raw)
    except ValueError:
        return None


def _parse_qs(query: str) -> dict:
    """Tiny query-string parser (last value wins; %xx unescaping via
    stdlib). Kept local so the native front's poller thread never
    imports urllib lazily under load."""
    from urllib.parse import unquote_plus
    out: dict[str, str] = {}
    for part in (query or "").split("&"):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[unquote_plus(k)] = unquote_plus(v)
    return out


class Recorder:
    """Samples registry prefixes into the store, one tick at a time.

    ``tick()`` is the unit of work: snapshot the registry, keep samples
    matching the configured prefixes, append them all at one timestamp.
    Drive it from a health loop for lockstep tests, or
    :meth:`start` the background thread (idempotent) for production.
    Its own cost is exported (``obs_recorder_tick_seconds``) so the
    ≤1% serving-p99 overhead contract is itself a watchable series.
    """

    def __init__(self, store: TimeSeriesStore | None = None,
                 registry=None, *,
                 prefixes=DEFAULT_RECORD_PREFIXES,
                 interval_s: float = 1.0):
        self._reg = registry if registry is not None else _registry
        self.store = store if store is not None else timeseries_store
        self.prefixes = tuple(prefixes)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._c_ticks = self._reg.counter(
            "obs_recorder_ticks_total", "history recorder ticks")
        self._c_points = self._reg.counter(
            "obs_recorder_points_total", "samples recorded into history")
        self._g_cost = self._reg.gauge(
            "obs_recorder_tick_seconds", "wall cost of the last tick")

    def tick(self) -> int:
        """One sampling pass. Returns points appended."""
        t0 = time.perf_counter()
        snap = self._reg.snapshot()
        picked = {k: v for k, v in snap.items()
                  if k.startswith(self.prefixes)}
        n = self.store.append_many(picked)
        self._c_ticks.inc()
        if n:
            self._c_points.inc(n)
        self._g_cost.set(time.perf_counter() - t0)
        return n

    # -- background loop ---------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, interval_s: float | None = None) -> "Recorder":
        """Start the background sampling thread (idempotent)."""
        with self._lock:
            if interval_s is not None:
                self.interval_s = float(interval_s)
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, name="obs-recorder", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            thread = self._thread
            self._thread = None
            self._stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def _loop(self) -> None:
        stop = self._stop
        while not stop.is_set():
            try:
                self.tick()
            except Exception:
                # a bad sample must not kill the history plane
                pass
            stop.wait(self.interval_s)


#: THE process-wide history substrate — burn windows, depth trends,
#: straggler score histories, and the regression sentinel all read it.
timeseries_store = TimeSeriesStore()

#: THE process-wide recorder over it (started by ``serving_query``;
#: tests tick it by hand).
recorder = Recorder(timeseries_store)


def timeline_payload(query: str = "",
                     store: TimeSeriesStore | None = None
                     ) -> tuple[int, bytes]:
    """Route-shaped helper: the serving fronts call this with the raw
    query string of ``GET /debug/timeline``."""
    return (store if store is not None
            else timeseries_store).timeline_payload(query)
