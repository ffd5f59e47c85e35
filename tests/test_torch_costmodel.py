"""The port's learned cost model (``mmlspark_torch/perf/costmodel.py``) and
its scenario harness against the JAX package's.

Every scenario of ``test_perf.py`` that needs no autoscaler, and reads no
TPU kernel's own tiles, runs against the port on the same inputs and with
the same assertions (``torch_obs_port``): the autotuner's search, registry
and CLI, and the serving front's feature rows, among them; the excluded ones are
named below by ROADMAP item or by their port versions. Then both packages
fit the same ``synth_feature_rows`` (the rows themselves must be equal)
and must agree: every prediction within a relative 1e-9 (numpy's solve
on the same float64 inputs; the test reports when they come out
bit-equal), the same
rows used and skipped, the same estimator answers through
``ServiceTimeEstimator``, the same gate flips and build order. A model
file saved by the JAX package loads in the port and predicts the same,
and the other way round. The harness's cost-model and attribution
scenarios bank the same numbers in both packages where they run the same
code (the attribution scenario's roofline part counts with
``count_cost`` in the port and XLA's ``cost_analysis`` in the JAX
package: each is held to its placement, not to the other's counts).
"""

import json

import numpy as np
import pytest

import mmlspark_torch.perf as tperf
import mmlspark_torch.perf.costmodel as tcm
import mmlspark_torch.sched.policy as tpolicy
import mmlspark_torch.testing.benchmarks as tbench
import mmlspark_tpu.perf.autotune as jautotune
import mmlspark_tpu.perf.costmodel as jcm
import mmlspark_tpu.sched.policy as jpolicy
import mmlspark_tpu.testing.benchmarks as jbench
from mmlspark_torch.obs.metrics import MetricsRegistry as TRegistry
from mmlspark_torch.obs.profile import FeatureLog as TFeatureLog
from mmlspark_tpu.obs.metrics import MetricsRegistry as JRegistry
from mmlspark_tpu.obs.profile import FeatureLog as JFeatureLog
from torch_obs_port import port_reference_tests

globals().update(port_reference_tests("test_perf.py", (
    # the autoscaler (ROADMAP item 9d-2)
    "TestPredictiveAutoscale",
    # the autotuner's scenarios that read the TPU kernels' own tiles (VMEM
    # budget, block_kv x slots_tile, the Pallas kernels consulting the
    # registry): their port versions, on the CUDA kernels' limits and
    # tiles, are in test_torch_autotune.py
    "TestAutotune.test_attention_candidates_respect_vmem_budget",
    "TestPagedAutotune",
    "TestKernelsConsultRegistry",
    # the mixed-tenant autoscaling acceptance (item 9d-2)
    "TestPredictiveMixedTenant"), rewrites=(
    # the serving front's feature rows: the port's threaded front
    ("mmlspark_tpu.serving", "mmlspark_torch.serving"),
    ("mmlspark_tpu.io.http", "mmlspark_torch.io.http"),
    # the AOT store's build order runs against the port's store
    ("mmlspark_tpu.core.aot", "mmlspark_torch.core.aot"),
    # the autotuner (its CLI too) and the no-JAX import run on the port's
    ("mmlspark_tpu.perf", "mmlspark_torch.perf"))))

SVC = "costmodel-bench"
REL = 1e-9
PKGS = ((jcm, jpolicy, JRegistry, JFeatureLog),
        (tcm, tpolicy, TRegistry, TFeatureLog))
QUERIES = [dict(batch=b, route=r, entity_bytes=e, queue_depth=d,
                context_blocks=c)
           for b in (1, 3, 8, 17, 64) for r in ("", "/feat", "/gen", "/x")
           for e, d, c in ((None, None, None), (64 * 1024, 4.0, 7.0))]


def close(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def predictions(m, service=SVC):
    out = [m.predict_batch_ms(service, count=False, **q) for q in QUERIES]
    out.append(m.predict_item_ms(service))
    out.append(m.predict_item_ms(service, route="/gen"))
    return out


def assert_close(j, t):
    assert len(j) == len(t)
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(j, t))
           if not close(a, b)]
    assert not bad, bad[:5]


def test_public_names_equal_reference():
    assert tcm.__all__ == jcm.__all__
    assert tperf.__all__ == ["CostModel", "bucket_build_priority",
                             "enabled", "model_path", "perf_root",
                             "shared_cost_model", "autotune"]
    assert tcm.FEATURES == jcm.FEATURES
    assert tcm.ACCEPTED_SCHEMA_VERSIONS == jcm.ACCEPTED_SCHEMA_VERSIONS
    assert tcm.MODEL_VERSION == jcm.MODEL_VERSION
    assert tperf.autotune.__all__ == jautotune.__all__
    assert tperf.autotune.REGISTRY_VERSION == jautotune.REGISTRY_VERSION
    assert tperf.autotune.kernel_winner("hist", "x", "cpu") is None


def test_harness_rows_equal():
    for fn, kw in ((jbench.synth_feature_rows, {}),
                   (jbench.synth_attribution_rows, {})):
        j = fn(300, seed=4, **kw)
        t = getattr(tbench, fn.__name__)(300, seed=4, **kw)
        assert j == t


class TestFitParity:
    @pytest.mark.parametrize("seed", [5, 11])
    def test_predictions_within_1e9(self, seed):
        rows = tbench.synth_feature_rows(900, seed=seed)
        ms = []
        for cm, _, Registry, _ in PKGS:
            reg = Registry()
            m = cm.CostModel(min_rows=32, registry=reg)
            used = m.fit(rows)
            ms.append((m, used, reg.snapshot()))
        (jm, jused, jsnap), (tm, tused, tsnap) = ms
        assert jused == tused == 900
        assert jsnap == tsnap
        jp, tp = predictions(jm), predictions(tm)
        assert_close(jp, tp)
        exact = sum(a == b for a, b in zip(jp, tp))
        print(f"{exact} of {len(jp)} predictions bit-equal")
        for key in jm._models:
            np.testing.assert_allclose(tm._models[key]["theta"],
                                       jm._models[key]["theta"],
                                       rtol=REL, atol=0)

    def test_v6_and_mixed_schema_rows(self):
        rows = (tbench.synth_attribution_rows(400, seed=2)
                + [dict(r, schema_version=v) for v, r in zip(
                   (1, 2, 3, 4, 5, 7) * 40,
                   tbench.synth_feature_rows(240, seed=8))]
                + [{"schema_version": 6, "batch": 0, "execute_ms": 1.0},
                   {"schema_version": 6, "batch": 4, "execute_ms": "x"}])
        out = []
        for cm, _, Registry, _ in PKGS:
            reg = Registry()
            m = cm.CostModel(min_rows=16, registry=reg)
            out.append((m.fit(rows), reg.snapshot(),
                        predictions(m, "attr-bench"),
                        predictions(m, SVC)))
        (ju, js, jp, jq), (tu, ts, tp, tq) = out
        assert (ju, js) == (tu, ts)
        assert_close(jp + jq, tp + tq)

    def test_estimator_and_gate_parity(self):
        rows = tbench.synth_feature_rows(600, seed=5)
        observed = [(b, 0.001 * (1 + b) * f) for b, f in zip(
            (1, 4, 8, 16, 3, 32, 8, 8, 2, 64) * 6,
            (1.0, 1.2, 0.8, 30.0, 1.1, 0.9, 25.0, 1.0, 1.0, 1.3) * 6)]
        out = []
        for cm, policy, Registry, _ in PKGS:
            reg = Registry()
            m = cm.CostModel(min_rows=32, error_gate=0.5, error_alpha=0.5,
                             registry=reg)
            m.fit(rows)
            est = policy.ServiceTimeEstimator(SVC, registry=reg,
                                              cost_model=m)
            trace = []
            for b, s in observed:
                est.observe(b, s)
                trace.append((est.estimate(b), est.estimate(2 * b + 1),
                              est.item_seconds(), m.mae_ms(SVC)))
            out.append((trace, reg.snapshot()))
        (jt, js), (tt, ts) = out
        assert_close([x for step in jt for x in step],
                     [x for step in tt for x in step])
        assert js.keys() == ts.keys()
        assert_close([js[k] for k in sorted(js)], [ts[k] for k in sorted(ts)])
        gated = js.get('sched_costmodel_fallback_total'
                       f'{{reason="error",service="{SVC}"}}', 0)
        assert gated > 0, "the observations must trip the error gate"

    def test_refresh_and_build_priority(self):
        out = []
        for cm, _, Registry, FeatureLog in PKGS:
            reg = Registry()
            log = FeatureLog(maxlen=256, registry=reg)
            m = cm.CostModel(min_rows=32, refresh_every=64, registry=reg)
            used = []
            for i, r in enumerate(tbench.synth_feature_rows(400, seed=9)):
                log.record(**r)
                if i % 50 == 49:
                    used.append(m.maybe_refresh(log))
            order = cm.bucket_build_priority(SVC, (1, 2, 4, 8, 16, 32, 64),
                                             log=log, model=m)
            out.append((used, order, predictions(m)))
        (ju, jo, jp), (tu, to, tp) = out
        assert (ju, jo) == (tu, to)
        assert_close(jp, tp)


class TestModelFilesCross:
    @pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
    def test_saved_file_loads_and_predicts_same(self, tmp_path, direction):
        src, dst = (PKGS if direction == "jax_to_torch" else PKGS[::-1])
        rows = (tbench.synth_feature_rows(500, seed=3)
                + tbench.synth_attribution_rows(300, seed=3))
        a = src[0].CostModel(min_rows=32, registry=src[2]())
        a.fit(rows)
        path = a.save(str(tmp_path / "costmodel.json"))
        payload = json.loads(open(path).read())
        assert payload["features"] == list(jcm.FEATURES)
        b = dst[0].CostModel(registry=dst[2]())
        assert b.load_file(path) == len(a._models)
        for service in (SVC, "attr-bench"):
            assert predictions(a, service) == predictions(b, service)
        # the file is byte-for-byte what the other package writes
        again = b.save(str(tmp_path / "again.json"))
        assert open(again).read() == open(path).read()

    def test_stale_file_refused_by_both(self, tmp_path):
        path = tmp_path / "old.json"
        path.write_text(json.dumps({"version": 1, "schema_version": 1,
                                    "models": []}))
        for cm, _, Registry, _ in PKGS:
            with pytest.raises(ValueError, match="schema_version"):
                cm.CostModel(registry=Registry()).load_file(str(path))


def test_env_switches_keep_reference_names(monkeypatch, tmp_path):
    monkeypatch.setenv("MMLSPARK_TPU_PERF_STORE", str(tmp_path))
    assert tcm.perf_root() == jcm.perf_root() == str(tmp_path)
    assert tcm.model_path() == jcm.model_path()
    monkeypatch.setenv("MMLSPARK_TPU_COSTMODEL", "0")
    assert tcm.enabled() is jcm.enabled() is False
    monkeypatch.delenv("MMLSPARK_TPU_COSTMODEL")
    assert tcm.enabled() is jcm.enabled() is True


class TestScenarioParity:
    def test_costmodel_scenario_equal(self):
        j = jbench.costmodel_scenario(n_rows=800, seed=6,
                                      registry=JRegistry())
        t = tbench.costmodel_scenario(n_rows=800, seed=6,
                                      registry=TRegistry())
        assert j.keys() == t.keys()
        for k in j:
            assert close(j[k], t[k]) if isinstance(j[k], float) \
                else j[k] == t[k], k
        assert t["model_beats_ewma"]

    def test_attribution_scenario_goodput_and_v6_equal(self):
        j = jbench.attribution_scenario(seed=29, n_rows=600, ticks=8)
        t = tbench.attribution_scenario(seed=29, n_rows=600, ticks=8)
        assert j.keys() == t.keys()
        for k in ("goodput_ratio", "goodput_ratio_trace",
                  "goodput_waste_seconds", "goodput_waste_itemized",
                  "v6_no_worse", "matmul_compute_bound",
                  "add_memory_bound"):
            assert j[k] == t[k], k
        assert close(j["v6_mae_ms"], t["v6_mae_ms"])
        assert close(j["v5_mae_ms"], t["v5_mae_ms"])


@pytest.mark.parametrize("name", ["autoscale_lead_scenario",
                                  "mixed_tenant_scenario", "chaos_scenario"])
def test_later_scenarios_name_their_item(name):
    with pytest.raises(NotImplementedError, match="9d-2"):
        getattr(tbench, name)()
