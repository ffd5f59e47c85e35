"""Fleet telemetry plane: metric federation, stragglers, SLO health (the
port's own copy of the JAX package's ``obs/fleet.py``).

Without it every observability surface is strictly per-process —
on a pod each rank owns a private ``MetricsRegistry`` and there is no
single place to see the fleet. This module is that place:

- :class:`FleetAggregator` merges remote registry snapshots into one
  exposition. Sources push over the channels the mesh already has:
  pod ranks embed ``local_fleet_snapshot()`` in their
  ``MULTIHOST_RESULT`` payloads (``ingest_pod_results``), mesh workers
  ride the ``__fleet__`` heartbeat next to ``__lease__``/``__reply__``
  (``serving/distributed.py``), and ingest peers can be pulled via
  their ``/metrics`` text (:func:`parse_exposition`). Merged samples
  carry ``process``/``worker`` identity labels so two ranks' series
  never collide; per-source staleness is a gauge and dead ranks are
  evicted boundedly (reusing ``Gauge.remove_matching``).
- :class:`StragglerDetector` watches the per-rank
  ``profile_step_seconds{process=...}`` (or per-worker ``worker=...``)
  family and flags ranks sitting > k·MAD above the fleet median:
  ``fleet_straggler{...}`` gauge, a ``fleet.straggler`` span on the
  flip, and a replace signal the autoscaler consumes.
- :class:`BurnRateMonitor` turns the ``sched_tenant_*`` counters into
  multi-window error-budget burn rates (``slo_burn_rate{tenant,
  window}``), and :class:`FleetHealth` folds burn + stragglers into
  the single ``GET /healthz`` verdict (ok/degraded/critical) that the
  autoscaler and ``pick_least_loaded`` consult.

History: the ad-hoc private histories this module used to
keep — the burn monitor's tick list, the detector's last-flag-only
memory — are re-based on the shared
:class:`~mmlspark_torch.obs.timeseries.TimeSeriesStore`: burn windows
are store-window deltas over ``slo_tenant_*`` series, and straggler
flap suppression debounces re-flags against ``mad_over_time`` of the
rank's recorded score trajectory. Components built against the
process-wide registry share the process-wide store (one queryable
substrate); a private registry (test isolation) gets a private store.

Clock discipline: everything here uses ``time.monotonic``; burn-rate windows are monotonic
spans, never wall timestamps. All shared state (source tables, flagged
sets, burn histories) mutates under a lock; registry handles do their
own locking.
"""

from __future__ import annotations

import json
import threading
import time

from .metrics import _escape, registry as _registry
from .timeseries import TimeSeriesStore, timeseries_store as _shared_store
from .tracing import tracer as _tracer

__all__ = [
    "BurnRateMonitor",
    "FleetAggregator",
    "FleetHealth",
    "StragglerDetector",
    "fleet_aggregator",
    "fleet_health",
    "ingest_pod_results",
    "local_fleet_snapshot",
    "own_worker_samples",
    "parse_exposition",
    "parse_sample",
    "render_sample",
    "straggler_workers",
]

#: registry families worth federating — bounds what a worker heartbeat
#: or a pod result ships (nobody needs a remote rank's http histograms
#: twice; the ingest already observed the request side).
FEDERATED_PREFIXES = (
    "profile_", "collective_", "mem_", "sched_", "serving_", "aot_",
    "kv_", "gen_", "deploy_", "goodput_",
)


def _store_for(store, registry, clock=time.monotonic):
    """The history substrate a component should use: an explicit one
    wins; the process-wide registry pairs with the process-wide store
    (ONE queryable history plane); a private registry or custom clock
    (test isolation) gets a private store on the same clock."""
    if store is not None:
        return store
    if registry is None and clock is time.monotonic:
        return _shared_store
    return TimeSeriesStore(
        registry if registry is not None else _registry, clock=clock)

# ---------------------------------------------------------------------------
# sample-name parsing — the inverse of metrics._render, so snapshots and
# expositions can be relabelled and re-merged without guessing.


def parse_sample(sample: str) -> tuple[str, dict]:
    """Split a rendered sample name into ``(family, labels)``.

    Understands exactly what ``metrics._render`` emits (sorted
    ``k="v"`` pairs, ``_escape``'d values). Anything that does not
    parse comes back opaque — ``(sample, {})`` — so foreign text can
    still be merged verbatim."""
    if "{" not in sample:
        return sample, {}
    name, _, rest = sample.partition("{")
    if not rest.endswith("}"):
        return sample, {}
    body = rest[:-1]
    labels: dict = {}
    i, n = 0, len(body)
    while i < n:
        j = body.find("=", i)
        if j < 0 or j + 1 >= n or body[j + 1] != '"':
            return sample, {}
        key = body[i:j]
        i = j + 2
        out: list = []
        closed = False
        while i < n:
            c = body[i]
            if c == "\\" and i + 1 < n:
                nxt = body[i + 1]
                out.append("\n" if nxt == "n" else nxt)
                i += 2
                continue
            if c == '"':
                closed = True
                break
            out.append(c)
            i += 1
        if not closed:
            return sample, {}
        labels[key] = "".join(out)
        i += 1
        if i < n:
            if body[i] != ",":
                return sample, {}
            i += 1
    return name, labels


def render_sample(name: str, labels: dict) -> str:
    """Re-render a parsed sample the way ``metrics._render`` would."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def parse_exposition(text: str) -> dict:
    """Prometheus text → ``{sample_name: float}`` (HELP/TYPE dropped).
    This is the pull half of federation: point it at a peer ingest's
    ``/metrics`` body and hand the result to ``ingest_snapshot``."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(None, 1)
        if len(parts) != 2:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return out


def local_fleet_snapshot(registry=None, prefixes=FEDERATED_PREFIXES) -> dict:
    """This process's registry samples worth federating, by prefix.
    Pod ranks embed this in their MULTIHOST_RESULT payload; standalone
    workers push it over the ``__fleet__`` heartbeat."""
    reg = registry if registry is not None else _registry
    return {k: v for k, v in reg.snapshot().items() if k.startswith(prefixes)}


def own_worker_samples(worker_id: str, registry=None) -> dict:
    """The series a mesh worker THREAD owns: samples already labelled
    ``worker="<id>"``. Thread workers share the ingest's registry, so
    pushing a full snapshot would re-merge the ingest's own series back
    at itself with a bogus worker label — this filter keeps the
    heartbeat honest (process workers push the full snapshot instead,
    see ``distributed._worker_fleet_payload``)."""
    reg = registry if registry is not None else _registry
    tag = f'worker="{_escape(str(worker_id))}"'
    return {k: v for k, v in reg.snapshot().items() if tag in k}


# ---------------------------------------------------------------------------
# federation


class FleetAggregator:
    """Merges remote registry snapshots into one fleet exposition.

    Each source (a pod rank, a mesh worker, a peer ingest) is keyed by
    identity; its latest snapshot replaces the previous one wholesale
    (registries are cumulative, so last-write-wins is exact). Identity
    labels are stamped into every sample that does not already carry
    them, which is what makes the merged exposition collision-free.

    Staleness is CONSUMED here too, not just
    exported: each source's push cadence is learned as an EWMA of its
    inter-arrival gaps, and :meth:`check_staleness` flags sources whose
    age exceeds ``STALE_FACTOR`` × that cadence —
    ``fleet_sources_stale_total`` counts the flips and
    :class:`FleetHealth` folds the flags into a DEGRADED (never
    critical) verdict: a quiet rank is a telemetry gap, not proof the
    service is failing its SLO.
    """

    #: a source older than this multiple of its learned cadence is stale
    STALE_FACTOR = 3.0
    #: absolute grace floor: sub-second cadences (in-thread mesh
    #: heartbeats) would otherwise flag on routine GIL/scheduler jitter
    MIN_STALE_S = 1.0

    def __init__(self, registry=None, *, max_sources: int = 64,
                 clock=time.monotonic):
        self._reg = registry if registry is not None else _registry
        self._clock = clock
        self._max_sources = max_sources
        self._lock = threading.Lock()
        # source -> {"samples": dict, "at": t, "process": str|None,
        #            "worker": str|None, "channel": str}
        self._sources: dict = {}
        self._channels: set = set()
        self._g_sources = self._reg.gauge(
            "fleet_sources",
            "remote telemetry sources currently merged, by channel")
        self._g_staleness = self._reg.gauge(
            "fleet_source_staleness_seconds",
            "seconds since each fleet source's last snapshot")
        self._c_merges = self._reg.counter(
            "fleet_merges_total", "snapshot ingests, by channel")
        self._c_evicted = self._reg.counter(
            "fleet_sources_evicted_total",
            "fleet sources dropped, by reason (death|bound)")
        self._stale: set = set()   # sources currently flagged stale
        self._c_stale = self._reg.counter(
            "fleet_sources_stale_total",
            "fleet sources that went stale (age > 3x learned cadence), "
            "by source")

    # -- ingest -----------------------------------------------------------

    def ingest_snapshot(self, samples: dict, *, process=None, worker=None,
                        channel: str = "push") -> str:
        """Merge one source's snapshot. ``process``/``worker`` become
        the source identity AND get stamped into any sample missing
        them. Returns the source key."""
        proc = None if process is None else str(process)
        wid = None if worker is None else str(worker)
        source = (f"worker:{wid}" if wid is not None
                  else f"proc:{proc}" if proc is not None else "anon")
        relabelled: dict = {}
        for sample, value in samples.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            name, labels = parse_sample(sample)
            if name == sample and "{" in sample:
                # opaque foreign line — keep verbatim, collision risk
                # is the pusher's problem
                relabelled[sample] = value
                continue
            if proc is not None:
                labels.setdefault("process", proc)
            if wid is not None:
                labels.setdefault("worker", wid)
            relabelled[render_sample(name, labels)] = value
        now = self._clock()
        evicted = []
        with self._lock:
            prev = self._sources.get(source)
            cadence = None if prev is None else prev.get("cadence")
            if prev is not None:
                gap = max(0.0, now - prev["at"])
                # EWMA of inter-arrival gaps: adapts to a source that
                # legitimately slows its push rate without a restart
                cadence = gap if cadence is None \
                    else 0.5 * cadence + 0.5 * gap
            self._sources[source] = {
                "samples": relabelled, "at": now, "process": proc,
                "worker": wid, "channel": channel, "cadence": cadence,
            }
            self._stale.discard(source)   # fresh push clears the flag
            self._channels.add(channel)
            while len(self._sources) > self._max_sources:
                oldest = min(self._sources, key=lambda s:
                             self._sources[s]["at"])
                evicted.append((oldest, self._sources.pop(oldest)))
        self._c_merges.inc(channel=channel)
        for key, info in evicted:
            self._scrub(key, info)
            self._c_evicted.inc(reason="bound")
        return source

    def ingest_exposition(self, text: str, **kw) -> str:
        return self.ingest_snapshot(parse_exposition(text), **kw)

    # -- eviction ---------------------------------------------------------

    def evict(self, source: str, reason: str = "death") -> bool:
        """Drop a dead source and its registry residue. The mesh calls
        this from the same paths that detect worker death (registry
        eviction, lease monitor) so a dead rank's staleness gauge and
        straggler flag do not linger forever."""
        with self._lock:
            info = self._sources.pop(source, None)
            self._stale.discard(source)
        if info is None:
            return False
        self._scrub(source, info)
        self._c_evicted.inc(reason=reason)
        return True

    def evict_worker(self, worker_id) -> bool:
        return self.evict(f"worker:{worker_id}")

    def _scrub(self, source: str, info: dict) -> None:
        """remove_matching sweep for one departed source: its staleness
        series, any fleet_* series keyed by its identity, and — for
        thread-mode workers that record straight into the shared local
        registry — the federated families carrying its label, so a dead
        worker's step histogram stops feeding the straggler median."""
        self._g_staleness.remove_matching(source=source)
        ident = {}
        if info.get("worker") is not None:
            ident = {"worker": info["worker"]}
        elif info.get("process") is not None:
            ident = {"process": info["process"]}
        if ident:
            for prefix in ("fleet_",) + FEDERATED_PREFIXES:
                for m in self._reg.metrics(prefix):
                    m.remove_matching(**ident)

    # -- merge / exposition ----------------------------------------------

    def sources(self) -> dict:
        """Per-source summary (age, identity, size) for /debug/fleet."""
        now = self._clock()
        with self._lock:
            return {
                key: {
                    "age_s": round(now - info["at"], 3),
                    "process": info["process"],
                    "worker": info["worker"],
                    "channel": info["channel"],
                    "samples": len(info["samples"]),
                    "cadence_s": (None if info.get("cadence") is None
                                  else round(info["cadence"], 3)),
                    "stale": key in self._stale,
                }
                for key, info in self._sources.items()
            }

    def check_staleness(self, factor: float | None = None) -> dict:
        """Flag sources whose age exceeds ``factor`` × learned cadence
        (default :data:`STALE_FACTOR`), with :data:`MIN_STALE_S` as an
        absolute grace floor. A source with no learned cadence yet
        (single push) is never stale — one push proves nothing about
        its rhythm. Rising edges count into
        ``fleet_sources_stale_total``; a fresh push clears the flag.
        Returns ``{source: {"age_s", "cadence_s"}}`` of current
        flags."""
        factor = self.STALE_FACTOR if factor is None else float(factor)
        now = self._clock()
        stale: dict = {}
        newly: list = []
        with self._lock:
            for key, info in self._sources.items():
                cadence = info.get("cadence")
                if not cadence or cadence <= 0:
                    continue
                age = now - info["at"]
                if age > max(factor * cadence, self.MIN_STALE_S):
                    stale[key] = {"age_s": round(age, 3),
                                  "cadence_s": round(cadence, 3)}
                    if key not in self._stale:
                        self._stale.add(key)
                        newly.append(key)
                else:
                    self._stale.discard(key)
        for key in newly:
            self._c_stale.inc(source=key)
        return stale

    def merged_samples(self, *, include_local: bool = False,
                       update_gauges: bool = True) -> dict:
        """One flat ``{sample: value}`` across every live source (local
        registry last when ``include_local`` — its values win ties,
        which only arise when a process pushes to itself)."""
        now = self._clock()
        with self._lock:
            snap = [(k, dict(v, samples=v["samples"]))
                    for k, v in self._sources.items()]
            channels = set(self._channels)
        if update_gauges:
            counts = {c: 0 for c in channels}
            for key, info in snap:
                self._g_staleness.set(
                    max(0.0, now - info["at"]), source=key)
                counts[info["channel"]] = counts.get(info["channel"], 0) + 1
            for channel, n in counts.items():
                self._g_sources.set(n, channel=channel)
        merged: dict = {}
        for _, info in snap:
            merged.update(info["samples"])
        if include_local:
            merged.update(self._reg.snapshot())
        return merged

    def exposition(self) -> str:
        """The fleet-scoped scrape body: the local registry's full
        exposition (HELP/TYPE intact) followed by every remote sample
        the local registry does not already carry, as bare lines."""
        merged = self.merged_samples()
        head = self._reg.exposition()
        local = set(self._reg.snapshot())
        remote = {k: v for k, v in merged.items() if k not in local}
        if not remote:
            return head
        lines = [f"# fleet: {len(remote)} remote samples from "
                 f"{len(self.sources())} sources"]
        for name in sorted(remote):
            v = remote[name]
            rendered = "+Inf" if v == float("inf") else f"{v:.10g}"
            lines.append(f"{name} {rendered}")
        return head + "\n".join(lines) + "\n"


def ingest_pod_results(results, aggregator=None, *,
                       channel: str = "pod") -> int:
    """Merge ``launch_pod`` result dicts (built by
    ``parallel.multihost.fleet_result``) into the aggregator. Returns
    how many ranks carried a snapshot."""
    agg = aggregator if aggregator is not None else fleet_aggregator
    n = 0
    for r in results or []:
        if not isinstance(r, dict) or "snapshot" not in r:
            continue
        agg.ingest_snapshot(
            r["snapshot"], process=r.get("process"), channel=channel)
        n += 1
    return n


# ---------------------------------------------------------------------------
# straggler / skew detection


class StragglerDetector:
    """Flags ranks whose mean step time sits > k·MAD above the fleet
    median of ``profile_step_seconds``.

    Identity comes from the ``worker`` label when present (in-process
    mesh workers) else ``process`` (pod ranks); the two populations are
    detected independently so a slow pod rank is never compared against
    a serving thread. With exactly two members MAD is degenerate, so a
    ratio test applies (slower/faster > ``ratio_floor``). The MAD is
    floored at ``mad_floor_frac``·median so a perfectly uniform fleet
    with microscopic jitter does not page.

    Flap suppression: each rank's score (mean / fleet
    median) is recorded into the history store every tick. A rank that
    RE-flags within ``flap_window_s`` of its last unflag is debounced:
    the re-flag only lands immediately when its excess over the group
    threshold clears ``flap_k`` × ``mad_over_time`` of its own recorded
    score trajectory — i.e. the breach is large against the rank's own
    recent noise. A threshold-straddling jitterer is held back (counted
    in ``fleet_straggler_flaps_suppressed_total``) until it breaches on
    two CONSECUTIVE ticks, so a genuine relapse is delayed by at most
    one tick while alert flapping stops. First-ever flags are never
    delayed (no unflag history — nothing to debounce against)."""

    #: sample families whose per-rank sums/counts define "step time"
    FAMILIES = ("profile_step_seconds",)

    def __init__(self, aggregator=None, registry=None, *, k: float = 3.0,
                 ratio_floor: float = 2.0, mad_floor_frac: float = 0.05,
                 min_count: float = 1.0, store=None,
                 flap_window_s: float = 120.0, flap_k: float = 3.0):
        self._agg = aggregator if aggregator is not None else fleet_aggregator
        self._reg = registry if registry is not None else _registry
        self._store = _store_for(store, registry)
        self.k = float(k)
        self.ratio_floor = float(ratio_floor)
        self.mad_floor_frac = float(mad_floor_frac)
        self.min_count = float(min_count)
        self.flap_window_s = float(flap_window_s)
        self.flap_k = float(flap_k)
        self._lock = threading.Lock()
        self._flagged: set = set()   # {(label, value)}
        self._known: set = set()
        self._unflag_at: dict = {}   # {(label, value): t of last unflag}
        self._pending: dict = {}     # {(label, value): raw-flag streak}
        self._g = self._reg.gauge(
            "fleet_straggler",
            "1 while a rank's mean step time exceeds median + k*MAD "
            "(or the 2-rank ratio floor), by process/worker")
        self._g_score = self._reg.gauge(
            "fleet_straggler_score",
            "mean step seconds over fleet median, by process/worker")
        self._c_flaps = self._reg.counter(
            "fleet_straggler_flaps_suppressed_total",
            "re-flags debounced by the score-history noise gate")

    def rank_means(self, samples: dict) -> dict:
        """``{(label, value): mean_step_seconds}`` from the merged
        ``profile_step_seconds_sum/_count`` series."""
        sums: dict = {}
        counts: dict = {}
        for sample, v in samples.items():
            name, labels = parse_sample(sample)
            fam = kind = None
            for f in self.FAMILIES:
                if name == f + "_sum":
                    fam, kind = f, "sum"
                elif name == f + "_count":
                    fam, kind = f, "count"
            if fam is None:
                continue
            if "worker" in labels:
                ident = ("worker", labels["worker"])
            elif "process" in labels:
                ident = ("process", labels["process"])
            else:
                continue
            bucket = sums if kind == "sum" else counts
            bucket[ident] = bucket.get(ident, 0.0) + float(v)
        return {
            ident: sums[ident] / counts[ident]
            for ident in sums
            if counts.get(ident, 0.0) >= self.min_count
        }

    @staticmethod
    def _median(vals) -> float:
        vals = sorted(vals)
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0

    def _detect_group(self, means: dict) -> tuple:
        """(flagged idents, flag threshold in raw mean-seconds). The
        threshold is what flap suppression measures excess against;
        None when the group is too small to judge."""
        if len(means) < 2:
            return set(), None
        vals = [v for v in means.values()]
        med = self._median(vals)
        if len(means) == 2:
            (i1, v1), (i2, v2) = sorted(means.items(), key=lambda kv: kv[1])
            thr = v1 * self.ratio_floor if v1 > 0 else None
            if v1 > 0 and v2 / v1 > self.ratio_floor:
                return {i2}, thr
            return set(), thr
        mad = self._median([abs(v - med) for v in vals])
        thr = med + self.k * max(mad, self.mad_floor_frac * med, 1e-9)
        return {ident for ident, v in means.items() if v > thr}, thr

    def tick(self, samples=None) -> set:
        """Recompute flags from the merged fleet view. Returns the
        flagged identity set ``{(label, value), ...}``."""
        if samples is None:
            samples = self._agg.merged_samples(include_local=True)
        means = self.rank_means(samples)
        groups: dict = {}
        for ident, mean in means.items():
            groups.setdefault(ident[0], {})[ident] = mean
        raw: set = set()
        medians: dict = {}
        thresholds: dict = {}
        for label, group in groups.items():
            got, thr = self._detect_group(group)
            raw |= got
            medians[label] = self._median(list(group.values()))
            thresholds[label] = thr
        scores = {
            (label, value): (mean / medians[label]
                             if medians.get(label, 0.0) > 0 else 1.0)
            for (label, value), mean in means.items()}
        now = self._store.now()
        # record every rank's score trajectory — the flap-suppression
        # history AND an operator-queryable /debug/timeline series
        self._store.append_many(
            {render_sample("fleet_straggler_score", {lab: val}): s
             for (lab, val), s in scores.items()}, t=now)
        suppressed: list = []
        with self._lock:
            prev = set(self._flagged)
            flagged = set(raw)
            for ident in sorted(raw - prev):
                label, value = ident
                streak = self._pending.get(ident, 0) + 1
                self._pending[ident] = streak
                thr, med = thresholds.get(label), medians.get(label, 0.0)
                last_unflag = self._unflag_at.get(ident)
                if (last_unflag is None
                        or now - last_unflag > self.flap_window_s
                        or streak >= 2 or thr is None or med <= 0):
                    continue   # not a flap (or sustained): flag lands
                vol = self._store.mad_over_time(
                    render_sample("fleet_straggler_score",
                                  {label: value}),
                    self.flap_window_s)
                excess = (means[ident] - thr) / med
                if excess <= self.flap_k * vol:
                    flagged.discard(ident)
                    suppressed.append(ident)
            for ident in [i for i in self._pending if i not in raw]:
                self._pending.pop(ident)
            for ident in prev - flagged:
                self._unflag_at[ident] = now
            for ident in [i for i in self._unflag_at
                          if i not in means]:
                self._unflag_at.pop(ident)
            newly = flagged - prev
            gone = self._known - set(means)
            self._flagged = flagged
            self._known = set(means)
        for label, value in sorted(suppressed):
            self._c_flaps.inc(**{label: value})
        for (label, value), score in scores.items():
            self._g_score.set(score, **{label: value})
            self._g.set(1.0 if (label, value) in flagged else 0.0,
                        **{label: value})
        for label, value in gone:
            self._g.remove_matching(**{label: value})
            self._g_score.remove_matching(**{label: value})
        for label, value in newly:
            med = medians.get(label) or 0.0
            _tracer.emit_span(
                "fleet.straggler", parent=None,
                seconds=means[(label, value)],
                **{label: value, "fleet_median_s": med,
                   "mean_step_s": means[(label, value)]})
        return flagged

    def flagged(self) -> frozenset:
        """Current ``{(label, value)}`` flags (no recompute)."""
        with self._lock:
            return frozenset(self._flagged)

    def flagged_workers(self) -> frozenset:
        """Just the worker ids — what ``pick_least_loaded`` avoids."""
        with self._lock:
            return frozenset(v for (lab, v) in self._flagged
                             if lab == "worker")


# ---------------------------------------------------------------------------
# SLO burn-rate health

#: error-budget fraction (allowed shed/fail ratio) per SLO tier — gold
#: pages at a thousandth, best-effort tolerates an order of magnitude
#: more. sched.tenancy maps tenants onto these through error_budget_for.
TIER_ERROR_BUDGETS = {"gold": 0.001, "silver": 0.01, "best_effort": 0.1}

#: fallback budget for tenants nobody registered a tier for
DEFAULT_ERROR_BUDGET = 0.05

#: burn-rate windows in seconds; fast catches an active incident,
#: slow keeps a brief blip from paging
DEFAULT_WINDOWS = {"fast": 30.0, "slow": 180.0}


class BurnRateMonitor:
    """Multi-window error-budget burn over the ``sched_tenant_*``
    counters.

    Each ``tick`` appends per-tenant (admitted, shed) totals as
    ``slo_tenant_admitted`` / ``slo_tenant_shed`` series in the history
    store (the store IS the history — no private tick list),
    plus a ``slo_burn_ticks`` marker series recording when the monitor
    looked; the burn for a window is ``(shed / total) / budget`` over
    that window's store delta — burn 1.0 means the tenant is consuming
    budget exactly as fast as the SLO allows, ``page_burn`` (default
    10×) means an incident."""

    def __init__(self, registry=None, *, windows=None, budget_for=None,
                 service: str = "", clock=time.monotonic, store=None):
        self._reg = registry if registry is not None else _registry
        self._clock = clock
        self._store = _store_for(store, registry, clock)
        self.windows = dict(windows) if windows else dict(DEFAULT_WINDOWS)
        self._budget_for = budget_for
        self._service = service
        self._lock = threading.Lock()
        self._latest: dict = {}    # {tenant: {window: burn}}
        self._g_burn = self._reg.gauge(
            "slo_burn_rate",
            "error-budget burn multiple, by tenant and window "
            "(1.0 = burning exactly at the SLO rate)")

    def _series(self, family: str, tenant: str | None = None) -> str:
        labels = {"service": self._service} if self._service else {}
        if tenant is not None:
            labels["tenant"] = tenant
        return render_sample(family, labels)

    def set_budget_for(self, fn) -> None:
        self._budget_for = fn

    def budget(self, tenant: str) -> float:
        if self._budget_for is not None:
            try:
                b = float(self._budget_for(tenant))
                if b > 0:
                    return b
            except Exception:
                pass
        return DEFAULT_ERROR_BUDGET

    def _totals(self, samples: dict) -> dict:
        """{tenant: (admitted, bad)} from the tenant counters,
        optionally filtered to one service. The bad side folds sheds
        (``sched_tenant_shed_total``) together with server-side 5xx
        (``serving_tenant_requests_total{code=5xx}``) — a canary build
        answering 500s burns its error budget exactly like one being
        shed, which is what lets the rollout controller (deploy plane)
        act on burn alone. Admissions stay the denominator: every
        answered request was admitted, so the two families never
        double-count the good side."""
        out: dict = {}
        for sample, v in samples.items():
            name, labels = parse_sample(sample)
            if name not in ("sched_tenant_admitted_total",
                            "sched_tenant_shed_total",
                            "serving_tenant_requests_total"):
                continue
            if self._service and labels.get("service") != self._service:
                continue
            tenant = labels.get("tenant")
            if tenant is None:
                continue
            if name == "serving_tenant_requests_total":
                try:
                    if int(labels.get("code", "0")) < 500:
                        continue
                except ValueError:
                    continue
            adm, bad = out.get(tenant, (0.0, 0.0))
            if name == "sched_tenant_admitted_total":
                adm += float(v)
            else:
                bad += float(v)
            out[tenant] = (adm, bad)
        return out

    def tick(self, samples=None) -> dict:
        """Sample the counters and recompute ``slo_burn_rate`` for
        every tenant × window. Returns ``{tenant: {window: burn}}``."""
        if samples is None:
            samples = self._reg.snapshot()
        totals = self._totals(samples)
        now = self._clock()
        horizon = max(self.windows.values()) * 1.5 + 1.0
        # one batch append at one timestamp: the tick marker plus every
        # tenant's cumulative totals. Retention = the burn horizon, so
        # the store prunes exactly what the old private list did.
        batch = {self._series("slo_burn_ticks"): now}
        for tenant, (adm, shed) in totals.items():
            batch[self._series("slo_tenant_admitted", tenant)] = adm
            batch[self._series("slo_tenant_shed", tenant)] = shed
        self._store.append_many(batch, t=now, retention_s=horizon)
        burns: dict = {}
        for tenant, (adm_now, shed_now) in totals.items():
            budget = self.budget(tenant)
            adm_series = self._series("slo_tenant_admitted", tenant)
            shed_series = self._series("slo_tenant_shed", tenant)
            per_window: dict = {}
            for wname, wsec in self.windows.items():
                # base = the tenant's totals at the oldest tick inside
                # the window; a tenant that first appeared later than
                # that tick has no point there — its whole total is
                # in-window (base 0), same as the old history list
                ticks = self._store.points(self._series("slo_burn_ticks"),
                                           wsec, now=now)
                t0 = ticks[0][0] if ticks else now
                base_adm = base_shed = 0.0
                adm_pts = self._store.points(adm_series, wsec, now=now)
                if adm_pts and adm_pts[0][0] <= t0 + 1e-9:
                    base_adm = adm_pts[0][1]
                shed_pts = self._store.points(shed_series, wsec, now=now)
                if shed_pts and shed_pts[0][0] <= t0 + 1e-9:
                    base_shed = shed_pts[0][1]
                d_adm = max(0.0, adm_now - base_adm)
                d_shed = max(0.0, shed_now - base_shed)
                total = d_adm + d_shed
                rate = (d_shed / total) if total > 0 else 0.0
                burn = rate / budget
                per_window[wname] = burn
                self._g_burn.set(burn, tenant=tenant, window=wname)
            burns[tenant] = per_window
        with self._lock:
            self._latest = burns
        return burns

    def latest(self) -> dict:
        with self._lock:
            return {t: dict(w) for t, w in self._latest.items()}


class FleetHealth:
    """Folds burn rates + stragglers + source staleness into the one
    verdict ``GET /healthz`` serves: ``ok`` / ``degraded`` /
    ``critical``. Degraded still answers 200 (load balancers must not
    drain a merely-slow fleet); only critical returns 503."""

    #: verdict → (gauge value, http status)
    VERDICTS = {"ok": (0, 200), "degraded": (1, 200), "critical": (2, 503)}

    def __init__(self, aggregator=None, registry=None, *,
                 page_burn: float = 10.0, degraded_burn: float = 1.0,
                 windows=None, service: str = "", store=None):
        self._reg = registry if registry is not None else _registry
        self._store = _store_for(store, registry)
        self.aggregator = (aggregator if aggregator is not None
                           else fleet_aggregator)
        self.stragglers = StragglerDetector(self.aggregator,
                                            registry=self._reg,
                                            store=self._store)
        self.burn = BurnRateMonitor(registry=self._reg, windows=windows,
                                    service=service, store=self._store)
        self.page_burn = float(page_burn)
        self.degraded_burn = float(degraded_burn)
        self._lock = threading.Lock()
        self._verdict = "ok"
        self._reasons: list = []
        self._sentinel = None
        self._deploy_reasons = None
        self._g_health = self._reg.gauge(
            "fleet_health",
            "healthz verdict: 0 ok, 1 degraded, 2 critical")

    def attach_tenancy(self, tenancy) -> None:
        """Point burn budgets at a TenancyPolicy's tier table (its
        ``error_budget_for``); absent tiers keep the default budget."""
        fn = getattr(tenancy, "error_budget_for", None)
        if callable(fn):
            self.burn.set_budget_for(fn)

    def attach_sentinel(self, sentinel) -> None:
        """Point the verdict at a perf-regression sentinel
        (``obs.regression.RegressionSentinel``): series with a
        SUSTAINED live regression mark the fleet degraded — slower than
        it was is sick, but never load-balancer-drain critical. The
        sentinel module attaches the process-wide pair on import."""
        self._sentinel = sentinel

    def attach_deploy(self, reasons_fn) -> None:
        """Point the verdict at the deploy plane
        (``serving.deploy.RolloutController.deploy_reasons``): while a
        rollback flap is in progress the fleet reads degraded — traffic
        is snapping back to the prior version, so "slow but serving",
        never load-balancer-drain critical."""
        self._deploy_reasons = reasons_fn

    def tick(self) -> str:
        """One health evaluation: refresh memory gauges, detect
        stragglers over the merged fleet view, recompute burn rates,
        and derive the verdict."""
        from .memory import memory_profiler
        memory_profiler.update()
        merged = self.aggregator.merged_samples(include_local=True)
        flagged = self.stragglers.tick(merged)
        burns = self.burn.tick(merged)
        verdict = "ok"
        reasons = []
        if flagged:
            verdict = "degraded"
            reasons.append("stragglers=%d" % len(flagged))
        for tenant, per_window in burns.items():
            fast = per_window.get("fast", 0.0)
            slow = per_window.get("slow", 0.0)
            if fast >= self.page_burn and slow >= self.page_burn / 2.0:
                verdict = "critical"
                reasons.append(f"{tenant} paging (fast burn {fast:.1f})")
            elif fast >= self.degraded_burn and verdict != "critical":
                verdict = "degraded"
                reasons.append(f"{tenant} burning (fast burn {fast:.1f})")
        stale = self.aggregator.check_staleness()
        if stale:
            # a source that stopped reporting is a blind spot, not an
            # outage: never escalate past degraded on staleness alone
            if verdict == "ok":
                verdict = "degraded"
            reasons.append("stale_sources=%d" % len(stale))
        sentinel = self._sentinel
        if sentinel is not None:
            sustained = sentinel.sustained()
            if sustained:
                if verdict == "ok":
                    verdict = "degraded"
                reasons.append(
                    "regression=" + ",".join(sorted(sustained)))
        deploy_fn = self._deploy_reasons
        if deploy_fn is not None:
            try:
                flapping = list(deploy_fn())
            except Exception:
                flapping = []
            if flapping:
                if verdict == "ok":
                    verdict = "degraded"
                reasons.extend(flapping)
        with self._lock:
            self._verdict = verdict
            self._reasons = reasons
        self._g_health.set(self.VERDICTS[verdict][0])
        return verdict

    def verdict(self) -> str:
        with self._lock:
            return self._verdict

    def healthz_payload(self) -> tuple:
        """(http_status, json_bytes) for the /healthz route — runs a
        fresh tick so the verdict is never staler than the request."""
        verdict = self.tick()
        body = {
            "status": verdict,
            "reasons": list(getattr(self, "_reasons", [])),
            "stragglers": sorted(
                f"{lab}:{val}" for lab, val in self.stragglers.flagged()),
            "burn": self.burn.latest(),
            "sources": len(self.aggregator.sources()),
            "stale_sources": sorted(
                k for k, v in self.aggregator.sources().items()
                if v.get("stale")),
        }
        return self.VERDICTS[verdict][1], json.dumps(body, indent=1).encode()

    def debug_payload(self) -> bytes:
        """The /debug/fleet body: verdict + per-source detail."""
        self.tick()
        body = {
            "status": self.verdict(),
            "sources": self.aggregator.sources(),
            "stragglers": sorted(
                f"{lab}:{val}" for lab, val in self.stragglers.flagged()),
            "burn": self.burn.latest(),
        }
        return json.dumps(body, indent=1).encode()


#: THE process-wide federation point — the serving fronts, the mesh
#: heartbeat ingest, and the pod launcher all merge into this one.
fleet_aggregator = FleetAggregator()

#: THE process-wide health view over it.
fleet_health = FleetHealth(fleet_aggregator)


def straggler_workers() -> frozenset:
    """Worker ids currently flagged as stragglers — consumed by
    ``serving.distributed.pick_least_loaded`` (cheap: no recompute)."""
    return fleet_health.stragglers.flagged_workers()
