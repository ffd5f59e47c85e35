"""Process-wide metrics: Counter / Gauge / Histogram behind one registry.

The port's own copy of ``mmlspark_tpu/obs/metrics.py`` (stdlib only): the
serving engine's ``gen_*``/``kv_*``/``sched_continuous_*`` series keep their
names and labels, snapshot-able as a dict (:meth:`MetricsRegistry.snapshot`)
and renderable as Prometheus text (:meth:`MetricsRegistry.exposition`).
Thread-safe: one registry lock per update keeps counts exact. Labels ride as
kwargs on the observation call (``c.inc(1, route="/")``); each distinct
label combination is an independent series.
"""

from __future__ import annotations

import threading
import time

# Fixed log-scale latency buckets (seconds): 100 µs → ~105 s, factor 2.
# One fixed geometric ladder for every latency histogram keeps series
# comparable across components (serving request, boosting round, bench
# phase) and bounds the exposition size; counts above the top land in
# +Inf like any Prometheus histogram.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = tuple(
    1e-4 * 2 ** k for k in range(21))


def _label_key(labels: dict) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n") \
                .replace('"', '\\"')


def _render(name: str, key: tuple[tuple[str, str], ...],
            extra: tuple[tuple[str, str], ...] = ()) -> str:
    """Prometheus sample name: ``name{a="b",...}`` (bare name when no
    labels). ``extra`` appends synthetic labels (histogram ``le``)."""
    pairs = key + extra
    if not pairs:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return f"{name}{{{inner}}}"


def _num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return f"{v:.10g}"


def bucket_quantile(bounds: tuple, counts, q: float) -> float:
    """Estimate the ``q``-quantile of a bucketed distribution.

    ``bounds`` are the finite upper bucket bounds (sorted ascending);
    ``counts`` are PER-BUCKET (non-cumulative) observation counts, one
    per bound plus a final +Inf bucket. The estimate interpolates
    linearly inside the target bucket — exact at bucket edges, off by
    at most half a bucket width inside one, which on the factor-2
    latency ladder bounds relative error at ~50% of the true value.

    Documented bias at the top: mass in the +Inf bucket has no upper
    edge to interpolate toward, so any quantile landing there is
    CLAMPED to the highest finite bound. A p99 that truly lives above
    the ladder reads as ``bounds[-1]`` — an underestimate, never a
    fabricated larger number. Widen the ladder if the tail matters.
    """
    total = float(sum(counts))
    if total <= 0:
        return 0.0
    q = min(max(float(q), 0.0), 1.0)
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            if i >= len(bounds):        # +Inf bucket: clamp (see above)
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return float(bounds[-1])


class _Metric:
    """Base: one named metric holding per-label-combination series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: dict = {}

    def _copy_series(self) -> dict:
        """Cheap value copy of the series (called under the registry
        lock) — rendering then happens OUTSIDE the lock, so a scrape
        formatting thousands of sample lines never stalls the handler
        threads' ``inc``/``observe`` calls."""
        return dict(self._series)

    def remove_matching(self, **labels) -> None:
        """Drop every series whose label set CONTAINS the given pairs
        (e.g. ``remove_matching(endpoint=wid)`` clears all from/to
        transition combos for one endpoint). For metrics labeled by
        unbounded identities — per-worker breaker endpoints in a mesh
        with churn — the exposition would otherwise grow forever."""
        want = set(_label_key(labels))
        with self._lock:
            for key in [k for k in self._series if want <= set(k)]:
                del self._series[key]

    def _samples(self, series: dict) -> dict[str, float]:
        """Flat ``{sample_name: value}`` from a ``_copy_series`` copy."""
        return {_render(self.name, k): v for k, v in series.items()}


class Counter(_Metric):
    """Monotonically increasing count (requests served, bytes moved)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    """A value that goes both ways (queue depth, in-flight requests)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class _Timer:
    """``with hist.time(**labels) as t: ...`` → observes elapsed wall
    seconds into the histogram at exit and exposes them as ``t.seconds``
    — the ONE stopwatch shape callers use instead of paired
    ``perf_counter`` reads, so every timed region is registry-visible."""

    __slots__ = ("_hist", "_labels", "_t0", "seconds")

    def __init__(self, hist: "Histogram", labels: dict):
        self._hist = hist
        self._labels = labels
        self.seconds = 0.0

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        self._hist.observe(self.seconds, **self._labels)


class Histogram(_Metric):
    """Distribution over fixed buckets (log-scale latency ladder by
    default). Exposes cumulative ``_bucket{le=...}`` / ``_sum`` /
    ``_count`` samples exactly like a Prometheus histogram."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs  # upper bounds, +Inf implicit

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        value = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets) + 1)
            i = 0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    break
            else:
                i = len(self.buckets)  # +Inf bucket
            s.counts[i] += 1
            s.sum += value
            s.count += 1

    def time(self, **labels) -> _Timer:
        return _Timer(self, labels)

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return 0 if s is None else s.count

    def quantile(self, q: float, **labels) -> float:
        """Estimated ``q``-quantile of one label combination's series
        (:func:`bucket_quantile`: linear interpolation inside the
        log-ladder bucket, clamped at the +Inf bucket). 0.0 when the
        series has no observations."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            counts = None if s is None else tuple(s.counts)
        if counts is None:
            return 0.0
        return bucket_quantile(self.buckets, counts, q)

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return 0.0 if s is None else s.sum

    def _copy_series(self) -> dict:
        return {k: (tuple(s.counts), s.sum, s.count)
                for k, s in self._series.items()}

    def _samples(self, series: dict) -> dict[str, float]:
        out: dict[str, float] = {}
        for key, (counts, total, n) in series.items():
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out[_render(f"{self.name}_bucket", key,
                            (("le", _num(b)),))] = cum
            out[_render(f"{self.name}_bucket", key,
                        (("le", "+Inf"),))] = n
            out[_render(f"{self.name}_sum", key)] = total
            out[_render(f"{self.name}_count", key)] = n
        return out


class MetricsRegistry:
    """Thread-safe get-or-create registry of named metrics.

    ``counter``/``gauge``/``histogram`` are idempotent: asking for an
    existing name returns the existing instance (so a re-constructed
    engine keeps accumulating into the same series), and asking
    for it as a different type raises — silent shadowing would split
    series invisibly.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}, requested {cls.kind}")
                want = kw.get("buckets")
                if want is not None and \
                        tuple(sorted(float(b) for b in want)) != m.buckets:
                    # same rationale as the kind check: creation order
                    # silently deciding which bucket ladder wins would
                    # make the losing caller's series meaningless
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}, requested {want}")
                return m
            m = cls(name, help, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def metrics(self, prefix: str = "") -> list["_Metric"]:
        """Registered metric objects whose name starts with ``prefix``
        — the eviction surface: callers bounding label cardinality
        (idle-tenant sweeps, mesh churn) iterate these and
        :meth:`_Metric.remove_matching` the departing identity's
        series without having to hold references to every metric."""
        with self._lock:
            return [m for name, m in self._metrics.items()
                    if name.startswith(prefix)]

    def _collect(self) -> list[tuple["_Metric", dict]]:
        """Value-copy every metric's series under the lock; callers
        render outside it (a scrape must not stall ``inc``/``observe``
        in the request hot path while it string-formats samples)."""
        with self._lock:
            return [(self._metrics[name], self._metrics[name]._copy_series())
                    for name in sorted(self._metrics)]

    def snapshot(self) -> dict[str, float]:
        """Every sample as a flat ``{sample_name: value}`` dict — the
        same names (and numbers) the text exposition renders, so tests
        and benches can assert on either surface interchangeably."""
        out: dict[str, float] = {}
        for m, series in self._collect():
            out.update(m._samples(series))
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for m, series in self._collect():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample, value in m._samples(series).items():
                lines.append(f"{sample} {_num(float(value))}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every metric (test isolation only — production callers
        hold metric references that would silently detach)."""
        with self._lock:
            self._metrics.clear()


# THE process-wide registry. Component code imports this instance
# (``from mmlspark_torch.obs import registry``); a private registry is
# only for tests that need isolation.
registry = MetricsRegistry()
