"""The port's serving fronts against the JAX package's, across packages.

- The same requests go to a JAX front serving a JAX ``LightGBMRegressor``
  and to the port's fronts (threaded and epoll) serving that booster,
  carried across with ``lightgbm/convert.py``: the port's replies are its
  direct transform's bit for bit, and the JAX front's within
  ``GBDT_ATOL`` (``test_torch_lightgbm.py``'s ``RAW_ATOL``: the trees are
  walked exactly, their f32 leaf values summed in XLA's order there).
- A 2-layer, width-64 text encoder (``test_torch_text_encoder.py``'s
  ``ARCH``) behind ``TokenIdEncoder`` is served by both packages, the JAX
  featurizer in Pallas interpret mode and the port's on ``flash_torch``:
  the pooled replies agree within that file's ``F32_ATOL`` (1e-4).
- ``bucket_pad``, ``loadgen.summarize`` and ``trace_id_of`` are exactly
  equal on the same arrays.
- The host build: ``httpfront.cpp`` and ``loadgen.cpp`` build with g++
  and export their C interfaces; a front that cannot be built raises with
  the compiler's output under ``backend="native"`` and is replaced by the
  Python front under ``backend="auto"``.
- The serving mesh's, the autoscaler's and the deploy plane's entry points
  raise ``NotImplementedError`` naming ROADMAP.md §1 item 9d-2.

Every test that starts a server or a thread stops it in ``finally`` and
runs under its own time limit (``THREAD_LIMIT_S``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.serving.loadgen as jloadgen
import mmlspark_torch.serving.loadgen as tloadgen
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import \
    TextEncoderFeaturizer as JTextEncoderFeaturizer
from mmlspark_tpu.featurize import TokenIdEncoder as JTokenIdEncoder
from mmlspark_tpu.io.http import string_to_response as jstring_to_response
from mmlspark_tpu.lightgbm import LightGBMRegressor as JLightGBMRegressor
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_tpu.serving import bucket_pad as jbucket_pad
from mmlspark_tpu.serving import serving_query as jserving_query
from mmlspark_torch import serving as tserving
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import TextEncoderFeaturizer
from mmlspark_torch.featurize import TokenIdEncoder
from mmlspark_torch.io.http import (AsyncClient, HTTPRequestData,
                                    string_to_response)
from mmlspark_torch.lightgbm import LightGBMRegressionModel
from mmlspark_torch.lightgbm.convert import booster_from_arrays
from mmlspark_torch.models import LoadedModel, get_model, \
    text_encoder_from_flax
from mmlspark_torch.native import loader as tloader
from mmlspark_torch.serving import bucket_pad, serving_query
from mmlspark_torch.serving.native_front import NativeServingServer
from mmlspark_torch.serving.server import ServingServer
from mmlspark_torch.testing import benchmarks as tbench
from test_torch_stages import THREAD_LIMIT_S, _within

# test_torch_lightgbm.py's RAW_ATOL: a booster carried across scores the
# same rows within it (the f32 sums over the trees run in another order)
GBDT_ATOL = 1e-5
TEXT_ARCH = dict(vocab=1000, width=64, depth=2, heads=4, mlp_dim=128)
# test_torch_text_encoder.py's tolerance for the f32 featurizer
F32_ATOL = 1e-4
WORDS = ("long context models embed entire documents in one pass while "
         "short notes take a single chunk of the sequence budget").split()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _send(address, bodies, path="/", concurrency=8):
    """POST each body to ``address`` with the port's ``AsyncClient``; the
    replies' (status, entity) in order."""
    url = f"http://{address[0]}:{address[1]}{path}"
    reqs = [HTTPRequestData(url=url, method="POST",
                            headers={"Content-Type": "application/json"},
                            entity=b) for b in bodies]
    out = AsyncClient(concurrency=concurrency, timeout=30.0).send(reqs)
    return [(r.status_code, r.entity) for r in out]


# ----------------------------------------------------------------- GBDT
@pytest.fixture(scope="module")
def regressors():
    """A JAX ``LightGBMRegressor`` fit and the port's model of its booster
    (``booster_from_arrays``)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 4)).astype(np.float32)
    y = x @ np.asarray([1, 2, -1, 0.5], np.float32)
    jmodel = JLightGBMRegressor(numIterations=12, numShards=1).fit(
        JDataFrame({"features": x, "label": y}))
    jb = jmodel.booster
    tb = booster_from_arrays(
        jb.arrays, num_class=jb.num_class, objective=jb.objective,
        sigmoid=jb.sigmoid, init_score=jb.init_score,
        feature_names=jb.feature_names, max_depth_bound=jb.max_depth_bound,
        tree_weights=jb.tree_weights)
    tmodel = LightGBMRegressionModel(booster=tb, device="cpu")
    return jmodel, tmodel, rng.normal(size=(48, 4)).astype(np.float32)


def _gbdt_pipeline(frame, model, respond):
    def score(df):
        feats = np.stack([np.asarray(json.loads(r.entity)["features"],
                                     np.float32) for r in df["request"]])
        pred = np.asarray(model.transform(
            frame({"features": feats}))["prediction"])   # one host copy
        replies = np.empty(len(df), object)
        replies[:] = [respond(json.dumps({"prediction": float(p)}))
                      for p in pred]
        return df.with_column("reply", replies)
    return score


@pytest.mark.parametrize("backend", ["python", "native"])
def test_gbdt_replies_match_across_packages(regressors, backend):
    jmodel, tmodel, rows = regressors
    bodies = [json.dumps({"features": r.tolist()}).encode() for r in rows]

    def run():
        jq = jserving_query(f"xpkg-gbdt-jax-{backend}",
                            _gbdt_pipeline(JDataFrame, jmodel,
                                           jstring_to_response),
                            backend="python")
        try:
            tq = serving_query(f"xpkg-gbdt-torch-{backend}",
                               _gbdt_pipeline(DataFrame, tmodel,
                                              string_to_response),
                               backend=backend)
            try:
                cls = NativeServingServer if backend == "native" \
                    else ServingServer
                assert type(tq.server) is cls
                return (_send(jq.server.address, bodies),
                        _send(tq.server.address, bodies))
            finally:
                tq.stop()
        finally:
            jq.stop()

    jout, tout = _within(THREAD_LIMIT_S, run)
    assert all(s == 200 for s, _ in jout + tout)
    # the port's replies are its direct transform's, bit for bit, however
    # the front batched them
    direct = np.asarray(tmodel.transform(
        DataFrame({"features": rows}))["prediction"])
    got = np.asarray([json.loads(e)["prediction"] for _, e in tout])
    np.testing.assert_array_equal(got, direct.astype(np.float64))
    # against the JAX front: the tree walk is exact, the f32 sum over the
    # trees is XLA's order there (test_torch_lightgbm.py's RAW_ATOL)
    want = np.asarray([json.loads(e)["prediction"] for _, e in jout])
    np.testing.assert_allclose(got, want, rtol=0, atol=GBDT_ATOL)


# --------------------------------------------------------- text encoder
def _docs(n, seed=0, max_words=120):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(1, max_words)))
            for _ in range(n)]


def _text_pipeline(frame, stages, respond):
    def embed(df):
        text = np.empty(len(df), object)
        text[:] = [json.loads(r.entity)["text"] for r in df["request"]]
        out = frame({"text": text})
        for s in stages:
            out = s.transform(out)
        pooled = np.asarray(out["features"])     # one host copy a batch
        replies = np.empty(len(df), object)
        replies[:] = [respond(json.dumps(v.tolist())) for v in pooled]
        return df.with_column("reply", replies)
    return embed


def test_text_encoder_replies_within_tolerance():
    jmodule = JTextEncoder(**TEXT_ARCH, dtype=jnp.float32)
    variables = jax.jit(jmodule.init)(jax.random.PRNGKey(0),
                                      np.ones((1, 128), np.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = text_encoder_from_flax(params, heads=TEXT_ARCH["heads"],
                                  dtype=torch.float32)
    jstages = [JTokenIdEncoder(maxLength=128, vocabSize=TEXT_ARCH["vocab"]),
               JTextEncoderFeaturizer(
                   attentionImpl="pallas", seqChunk=64,
                   model=JLoadedModel(JModelSchema(name="shared",
                                                   model_type="text"),
                                      jmodule, variables))]
    tstages = [TokenIdEncoder(maxLength=128, vocabSize=TEXT_ARCH["vocab"]),
               TextEncoderFeaturizer(
                   attentionImpl="pallas", seqChunk=64, device="cpu",
                   model=LoadedModel(get_model("TextEncoderBase"), port))]
    docs = _docs(6, seed=4)
    bodies = [json.dumps({"text": d}).encode() for d in docs]

    def run():
        jq = jserving_query("xpkg-text-jax",
                            _text_pipeline(JDataFrame, jstages,
                                           jstring_to_response),
                            backend="python")
        try:
            tq = serving_query("xpkg-text-torch",
                               _text_pipeline(DataFrame, tstages,
                                              string_to_response),
                               backend="python")
            try:
                # one request at a time: the JAX interpret-mode kernel
                # then traces one batch shape
                return (_send(jq.server.address, bodies, concurrency=1),
                        _send(tq.server.address, bodies, concurrency=1))
            finally:
                tq.stop()
        finally:
            jq.stop()

    jout, tout = _within(THREAD_LIMIT_S, run)
    assert all(s == 200 for s, _ in jout + tout)
    want = np.asarray([json.loads(e) for _, e in jout], np.float32)
    got = np.asarray([json.loads(e) for _, e in tout], np.float32)
    assert got.shape == (len(docs), TEXT_ARCH["width"])
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


# --------------------------------------------------- exact host helpers
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64, 100])
def test_bucket_pad_equal(n):
    xs = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    (jp, jn), (tp, tn) = jbucket_pad(xs), bucket_pad(xs)
    assert jn == tn == n
    assert jp.dtype == tp.dtype and jp.shape == tp.shape
    np.testing.assert_array_equal(jp, tp)


def _loadgen_arrays(seed, nconn=4, nreq=40):
    rng = np.random.default_rng(seed)
    lat = rng.gamma(2.0, 2.0, size=(nconn, nreq))
    status = rng.choice([200, 200, 200, 200, 429, 503, 1200, 1429, -1],
                        size=(nconn, nreq)).astype(np.int32)
    lat[status < 0] = -1.0
    ttft = np.where(status < 0, -1.0, lat * 0.3)
    versions = rng.choice(["", "v1", "v2"], size=(nconn, nreq))
    return lat, status, ttft, versions


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loadgen_summarize_equal(seed):
    lat, status, ttft, versions = _loadgen_arrays(seed)
    for kw in (dict(), dict(warmup=5, trace_prefix="ab" * 10),
               dict(warmup=0, tenants=["gold", "be", "gold", "be"],
                    ttft=ttft),
               dict(warmup=3, versions=versions.tolist())):
        j = jloadgen.summarize(lat, status, 1.5, **kw)
        t = tloadgen.summarize(lat, status, 1.5, **kw)
        assert json.dumps(j, sort_keys=True) == \
            json.dumps(t, sort_keys=True), kw


def test_trace_id_of_equal():
    for prefix, conn, req in (("", 0, 0), ("f" * 20, 15, 255),
                              ("0123456789abcdef0123", 3, 1 << 30)):
        assert tloadgen.trace_id_of(prefix, conn, req) == \
            jloadgen.trace_id_of(prefix, conn, req)


# ------------------------------------------------------------ host build
@pytest.mark.parametrize("name,symbols", [
    ("httpfront", ("hf_start", "hf_poll", "hf_req_info", "hf_req_body",
                   "hf_req_headers", "hf_reply", "hf_stop")),
    ("loadgen", ("lg_run6",))])
def test_host_libraries_build_with_gxx(name, symbols):
    """Built with g++ into the build directory at first use (the other
    serving tests of the process may have built it already), keyed by
    the sources' hash, the flags and the host CPU."""
    ld = tloader.NativeLoader(name, [f"{name}.cpp"])
    assert "-march=native" in ld.flags and "-std=c++17" in ld.flags
    lib = ld.load()
    assert os.path.exists(ld.so_path())
    assert os.path.dirname(ld.so_path()) == tloader.build_dir()
    for sym in symbols:
        assert getattr(lib, sym) is not None


@pytest.fixture
def broken_front(tmp_path, monkeypatch):
    """The epoll front's loader pointed at a source g++ refuses."""
    src = tmp_path / "httpfront_broken.cpp"
    src.write_text("extern \"C\" int hf_start(const char* h) {\n"
                   "  return undeclared_name;\n}\n")
    monkeypatch.setenv("MMLSPARK_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tloader, "HTTPFRONT",
                        tloader.NativeLoader("httpfront", [str(src)]))
    tloader.reset_httpfront()
    yield
    monkeypatch.undo()
    tloader.reset_httpfront()


def test_native_backend_raises_with_compiler_output(broken_front):
    def echo(df):
        replies = np.empty(len(df), object)
        replies[:] = [string_to_response("ok") for _ in range(len(df))]
        return df.with_column("reply", replies)

    assert tloader.get_httpfront() is None
    with pytest.raises(tloader.NativeBuildError,
                       match="undeclared_name") as err:
        serving_query("broken-native", echo, backend="native")
    assert "g++ failed building httpfront" in str(err.value)
    with pytest.raises(tloader.NativeBuildError):
        NativeServingServer("broken-native-direct")

    def run():
        q = serving_query("broken-auto", echo, backend="auto")
        try:
            assert type(q.server) is ServingServer
            return _send(q.server.address, [b"{}"] * 3)
        finally:
            q.stop()

    assert _within(THREAD_LIMIT_S, run) == [(200, b"ok")] * 3


# --------------------------------------------------------------- 9d-2
@pytest.mark.parametrize("name", [
    "Autoscaler", "AutoscaleConfig", "AutoscaleSignals",
    "ComputeWorkerPool", "ModelRegistry", "ModelVersion", "RolloutConfig",
    "RolloutController", "VersionRouter", "DistributedServingServer",
    "NativeDistributedServingServer", "DriverRegistry", "RegistryClient",
    "ServiceInfo", "pick_least_loaded", "remote_worker_loop"])
def test_mesh_entry_points_name_their_item(name):
    with pytest.raises(NotImplementedError, match="item 9d-2"):
        getattr(tserving, name)()


def test_dsl_and_scenarios_name_their_item():
    from mmlspark_torch.serving import dsl
    with pytest.raises(NotImplementedError, match="item 9d-2"):
        tserving.read_stream().distributedServer()
    with pytest.raises(NotImplementedError, match="item 9d-2"):
        dsl._default_registry()
    for name in ("chaos_scenario", "mixed_tenant_scenario",
                 "autoscale_lead_scenario", "aot_scale_up_scenario",
                 "fleet_chaos_scenario", "rollout_scenario"):
        with pytest.raises(NotImplementedError, match="item 9d-2"):
            getattr(tbench, name)()
