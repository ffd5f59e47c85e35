"""Fleet goodput ledger: useful chip-seconds vs itemized waste.

The port's own copy of the JAX package's ``obs/goodput.py`` (stdlib only;
no JAX import), with the same names, series and wire forms.

Serving efficiency on chips is goodput — useful work per chip-second
— and the registry already counts every waste source this ledger
folds; nothing here instruments the hot path. Each :meth:`tick` reads
one registry snapshot, takes deltas against the previous tick, prices
each waste source in estimated chip-seconds, and exports:

- ``goodput_waste_seconds_total{cause}`` — estimated wasted seconds by
  cause (monotone, federated fleet-wide like every ``goodput_``
  series),
- ``goodput_ratio`` — useful / (useful + waste) since the ledger's
  baseline tick,
- ``goodput_useful_seconds_total`` — the denominator's useful half.

Waste-cause taxonomy (what is read, and how it is priced):

===============  ====================================================
cause            source counters -> chip-second pricing
===============  ====================================================
spec_reject      ``gen_spec_rejected_total`` draft tokens the verifier
                 threw away x the measured seconds-per-committed-token
                 (``gen_decode_attn_seconds_sum`` / ``gen_tokens_total``)
eager_fallback   ``pipeline_fused_fallback_total`` calls that ran
                 eager x the measured mean profiled step
                 (``profile_step_seconds``), i.e. the fused run the
                 call was supposed to be
shed             ``sched_shed_total`` + ``sched_tenant_shed_total``
                 (reasons other than ``expired``) x a fixed admission
                 unit cost — work turned away at the door
expired          the ``expired`` reasons of the shed families plus
                 ``sched_continuous_expired_total`` x the same unit —
                 work queued, aged out, and thrown away
runtime_compile  ``profile_runtime_compiles_total`` x the measured
                 mean compile (``profile_compile_seconds``)
straggler        the stretch the slowest rank imposes on the whole
                 step: ``(1 - 1/score_max)`` of the tick's step
                 seconds when any ``fleet_straggler_score`` > 1
===============  ====================================================

Useful seconds are the profiled device families the executors already
record: ``profile_step_seconds_sum`` + ``gen_decode_attn_seconds_sum``.
Everything is an attribution model, not a measurement — the pricing
constants are explicit (:data:`DEFAULT_UNIT_COSTS`) and the payload
reports which were measured vs defaulted.

Import is stdlib-only; a process with no device can construct and tick
a ledger.
"""

from __future__ import annotations

import json
import threading
import time

from .fleet import parse_sample
from .metrics import registry as _registry

#: the waste-cause label values, in taxonomy order
WASTE_CAUSES = ("spec_reject", "eager_fallback", "shed", "expired",
                "runtime_compile", "straggler")

#: fallback chip-second prices used when no measured mean exists yet
#: (fresh process, cause never measured). Deliberately conservative.
DEFAULT_UNIT_COSTS = {
    "spec_reject": 1e-3,       # one committed-token's decode time
    "eager_fallback": 5e-3,    # one fused-segment execution
    "shed": 1e-3,              # admission + queue bookkeeping
    "expired": 1e-3,
    "runtime_compile": 5e-2,   # one trace+compile
}

#: never attribute more than this share of a tick's step seconds to a
#: straggler — MAD scores are unbounded and a single wild rank must
#: not zero the whole fleet's goodput
_STRAGGLER_CAP = 0.5


class GoodputLedger:
    """Delta-based goodput accounting over a metrics registry."""

    def __init__(self, registry=None, clock=time.monotonic,
                 unit_costs: dict | None = None):
        reg = registry if registry is not None else _registry
        self._reg = reg
        self._clock = clock
        self._unit_defaults = dict(DEFAULT_UNIT_COSTS)
        if unit_costs:
            self._unit_defaults.update(unit_costs)
        self._lock = threading.Lock()
        self._prev: dict | None = None
        self._waste = dict.fromkeys(WASTE_CAUSES, 0.0)
        self._useful = 0.0
        self._ticks = 0
        self._last_units: dict[str, float] = {}
        self._c_waste = reg.counter(
            "goodput_waste_seconds_total",
            "estimated chip-seconds wasted, by cause (see the ledger's "
            "taxonomy: spec_reject | eager_fallback | shed | expired | "
            "runtime_compile | straggler)")
        self._c_useful = reg.counter(
            "goodput_useful_seconds_total",
            "profiled useful device seconds the waste is measured "
            "against")
        self._g_ratio = reg.gauge(
            "goodput_ratio",
            "useful / (useful + estimated waste) chip-seconds since "
            "the ledger baseline (1.0 until anything is measured)")
        self._c_ticks = reg.counter(
            "goodput_ticks_total", "ledger delta evaluations")

    # -- snapshot folding --------------------------------------------------
    def _totals(self) -> dict[str, float]:
        """Fold one registry snapshot into the scalar totals the delta
        pass prices. Sums over label sets so pod-rank / per-service
        splits all count."""
        t = {
            "spec_rejected": 0.0, "fallbacks": 0.0, "shed": 0.0,
            "expired": 0.0, "runtime_compiles": 0.0,
            "compile_sum": 0.0, "compile_count": 0.0,
            "step_sum": 0.0, "decode_sum": 0.0,
            "tokens": 0.0, "straggler_max": 0.0,
        }
        for sample, value in self._reg.snapshot().items():
            name, labels = parse_sample(sample)
            if name == "gen_spec_rejected_total":
                t["spec_rejected"] += value
            elif name == "pipeline_fused_fallback_total":
                t["fallbacks"] += value
            elif name in ("sched_shed_total", "sched_tenant_shed_total"):
                key = "expired" \
                    if labels.get("reason") == "expired" else "shed"
                t[key] += value
            elif name == "sched_continuous_expired_total":
                t["expired"] += value
            elif name == "profile_runtime_compiles_total":
                t["runtime_compiles"] += value
            elif name == "profile_compile_seconds_sum":
                t["compile_sum"] += value
            elif name == "profile_compile_seconds_count":
                t["compile_count"] += value
            elif name == "profile_step_seconds_sum":
                t["step_sum"] += value
            elif name == "gen_decode_attn_seconds_sum":
                t["decode_sum"] += value
            elif name == "gen_tokens_total":
                t["tokens"] += value
            elif name == "fleet_straggler_score":
                t["straggler_max"] = max(t["straggler_max"], value)
        return t

    def _unit(self, cause: str, measured_sum: float,
              measured_count: float) -> float:
        """Measured mean when the denominator exists, else the default
        price; remembered per tick for the debug payload."""
        if measured_count > 0 and measured_sum > 0:
            unit = measured_sum / measured_count
        else:
            unit = self._unit_defaults[cause]
        self._last_units[cause] = unit
        return unit

    # -- the ledger --------------------------------------------------------
    def tick(self) -> dict:
        """Price the waste accrued since the previous tick and update
        the exported series. The first tick only establishes the
        baseline (ratio 1.0). Returns the debug payload."""
        with self._lock:
            totals = self._totals()
            prev, self._prev = self._prev, totals
            self._ticks += 1
            self._c_ticks.inc(1)
            if prev is None:
                return self._payload_locked()
            d = {k: max(totals[k] - prev.get(k, 0.0), 0.0)
                 for k in totals}
            waste = {
                "spec_reject": d["spec_rejected"] * self._unit(
                    "spec_reject", d["decode_sum"], d["tokens"]),
                "eager_fallback": d["fallbacks"] * self._unit(
                    "eager_fallback", 0.0, 0.0),
                "shed": d["shed"] * self._unit("shed", 0.0, 0.0),
                "expired": d["expired"] * self._unit(
                    "expired", 0.0, 0.0),
                "runtime_compile": d["runtime_compiles"] * self._unit(
                    "runtime_compile", d["compile_sum"],
                    d["compile_count"]),
            }
            useful = d["step_sum"] + d["decode_sum"]
            s = totals["straggler_max"]
            stretch = min(max(1.0 - 1.0 / s, 0.0), _STRAGGLER_CAP) \
                if s > 1.0 else 0.0
            waste["straggler"] = stretch * useful
            self._last_units["straggler"] = stretch
            for cause, sec in waste.items():
                if sec > 0:
                    self._c_waste.inc(sec, cause=cause)
                self._waste[cause] += sec
            if useful > 0:
                self._c_useful.inc(useful)
            self._useful += useful
            self._g_ratio.set(self._ratio_locked())
            return self._payload_locked()

    def _ratio_locked(self) -> float:
        total = self._useful + sum(self._waste.values())
        return self._useful / total if total > 0 else 1.0

    def _payload_locked(self) -> dict:
        return {
            "goodput_ratio": self._ratio_locked(),
            "useful_seconds": self._useful,
            "waste_seconds": dict(self._waste),
            "waste_total_seconds": sum(self._waste.values()),
            "ticks": self._ticks,
            "unit_costs": dict(self._last_units),
        }

    def payload(self) -> dict:
        """Tick, then report — the ``/debug/goodput`` surface is never
        staler than its own request."""
        return self.tick()

    def reset(self) -> None:
        """Drop the baseline and accumulated totals (the exported
        counters stay monotone; only the ratio restarts)."""
        with self._lock:
            self._prev = None
            self._waste = dict.fromkeys(WASTE_CAUSES, 0.0)
            self._useful = 0.0
            self._ticks = 0
            self._last_units.clear()


#: THE process-wide ledger (both serving fronts' /debug/goodput route
#: and the bench harness tick this one).
goodput_ledger = GoodputLedger()


def goodput_payload() -> bytes:
    """JSON body for ``GET /debug/goodput`` (ticks the singleton)."""
    return json.dumps(goodput_ledger.payload(), indent=1,
                      sort_keys=True).encode()
