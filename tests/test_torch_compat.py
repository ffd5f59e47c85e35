"""The port and the JAX package speak one stage format and one Param
surface.

- Every ported stage has the reference class's Param names and defaults
  (the ranker and its model included); the port's extra ``device`` (on
  the stages that run on a device) is the only difference.
- The GBDT estimator takes the reference's inert Params
  (``verbosity=-1``, ``numThreads``, ``timeout``, ...) and fits as with
  none; a value that selects an unported configuration raises.
- A multiclass, a DART, an rf and a regression model saved by either
  package (as a stage and as a LightGBM text model) load in the other
  with the same raw scores within 1e-5.
- ``TokenIdEncoder``, ``ComputeModelStatistics``,
  ``LightGBMClassificationModel`` and ``TextEncoderFeaturizer`` (without
  ``model``) saved by either package load in the other and give the same
  outputs (GBDT probabilities within 1e-6: the text model's leaf values
  round-trip through decimal text). The port's side runs in a subprocess
  that asserts no JAX module was imported.
- A JAX-saved ``TextEncoderFeaturizer`` whose ``model`` is a real JAX
  ``LoadedModel`` (a seeded ``TextEncoder``, f32 and the default bf16)
  loads in the port through ``core.foreign_pickle`` in that subprocess,
  with no ``jax``, ``flax`` or ``mmlspark_tpu`` module imported, and its
  features equal the JAX featurizer's within 1e-4 in f32 and 1e-2 in bf16
  (the text encoder tests' tolerances); a
  ``model`` payload of anything else raises ``NotImplementedError`` naming
  what it holds.
- The featurize slice: every class of ``featurize`` and ``stages`` has the
  reference's Param surface (plus ``device`` where it computes on one); a
  ``FeaturizeModel``, ``CleanMissingDataModel``, ``ValueIndexerModel``,
  ``TextFeaturizerModel`` and ``Word2VecModel`` fitted and saved by the
  JAX package load in the port (in the subprocess that asserts no JAX
  import) with no ``device``, so on CUDA by default, and on the CPU give
  its outputs exactly (Word2Vec's within 1e-6); a port-fitted
  ``FeaturizeModel`` loads in the JAX package and gives the same features.
- A pickle naming any global outside the codec's list (``os.system``, a
  module never imported) raises ``UnpicklingError`` without importing or
  calling it; so does a real JAX ``LoadedModel`` of a zoo model the port
  does not read (a seeded ``BertEncoder``), naming its first foreign
  class.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import mmlspark_tpu.dl.text_encoder as jte
import mmlspark_tpu.featurize as jfeat
import mmlspark_tpu.featurize.text as jtext
import mmlspark_tpu.stages as jstages
import mmlspark_tpu.lightgbm as jlgbm
import mmlspark_tpu.train.statistics as jstats
import jax
import jax.numpy as jnp
from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.core import load_stage as jload_stage
# Importing dl.bert at module level registers BertEncoder's partition
# rules as a side effect. tests/test_partition.py::TestModelRuleSets::
# test_registry_covers_the_zoo asserts that registration but never imports
# dl.bert itself, and the JAX package's tests may not change; every xdist
# worker collects this module before it runs tests, so that test passes in
# whichever worker it lands. Keep this import at module level.
from mmlspark_tpu.dl.bert import BertEncoder as JBertEncoder
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import register_bert_encoder as jregister_bert
from mmlspark_tpu.models.zoo import register_text_encoder as jregister
from mmlspark_torch.core import DataFrame, foreign_pickle, load_stage
from mmlspark_torch.core import serialize
from mmlspark_torch.core.serialize import resolve_stage_class
import mmlspark_torch.featurize as tfeat
import mmlspark_torch.stages as tstages
from mmlspark_torch.dl import TextEncoderFeaturizer
from mmlspark_torch.featurize import TokenIdEncoder
from mmlspark_torch.lightgbm import (Booster, LightGBMClassificationModel,
                                     LightGBMClassifier, LightGBMRanker,
                                     LightGBMRankerModel,
                                     LightGBMRegressionModel,
                                     LightGBMRegressor)
from mmlspark_torch.train import ComputeModelStatistics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROB_ATOL = 1e-6
FEAT_ATOL = 1e-4
# bf16 pooled features: test_torch_text_encoder.py's BF16_POOLED_ATOL (both
# packages round to bf16, at places that differ by XLA's fusion)
BF16_POOLED_ATOL = 1e-2
DOCS = ["long context models embed entire documents in one pass",
        "short note", "", "the same words again and again"]

PAIRS = {
    "TokenIdEncoder": (TokenIdEncoder, jtext.TokenIdEncoder),
    "TextEncoderFeaturizer": (TextEncoderFeaturizer,
                              jte.TextEncoderFeaturizer),
    "ComputeModelStatistics": (ComputeModelStatistics,
                               jstats.ComputeModelStatistics),
    "LightGBMClassifier": (LightGBMClassifier, jlgbm.LightGBMClassifier),
    "LightGBMClassificationModel": (LightGBMClassificationModel,
                                    jlgbm.LightGBMClassificationModel),
    "LightGBMRegressor": (LightGBMRegressor, jlgbm.LightGBMRegressor),
    "LightGBMRegressionModel": (LightGBMRegressionModel,
                                jlgbm.LightGBMRegressionModel),
    "LightGBMRanker": (LightGBMRanker, jlgbm.LightGBMRanker),
    "LightGBMRankerModel": (LightGBMRankerModel, jlgbm.LightGBMRankerModel),
}
# the featurize slice: every class of featurize/ and stages/
PAIRS.update({name: (getattr(tfeat, name), getattr(jfeat, name))
              for name in jfeat.__all__ if name != "TokenIdEncoder"})
PAIRS.update({name: (getattr(tstages, name), getattr(jstages, name))
              for name in jstages.__all__
              if name != "DynamicBufferedBatcher"})   # not a stage


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _surface(cls) -> dict:
    return {p.name: (p.default if p.has_default else None)
            for p in cls.params()}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_param_names_and_defaults_match_the_reference(name):
    port, ref = PAIRS[name]
    mine, theirs = _surface(port), _surface(ref)
    assert set(mine) - set(theirs) <= {"device"}, name
    assert set(theirs) - set(mine) == set(), name
    assert {k: (mine[k], theirs[k]) for k in theirs
            if mine[k] != theirs[k]} == {}, name


def _gbdt_frame(n=300, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.normal(size=n) > 0
         ).astype(np.float32)
    return x, y


def test_inert_reference_params_fit_as_without_them():
    x, y = _gbdt_frame()
    df = DataFrame({"features": x, "label": y})
    base = dict(device="cpu", numIterations=3, numLeaves=7)
    plain = LightGBMClassifier(**base).fit(df)
    inert = LightGBMClassifier(
        **base, verbosity=-1, numThreads=4, timeout=1200.0,
        useBarrierExecutionMode=True, defaultListenPort=12500,
        parallelism="voting_parallel", topK=5, shardAxisName="rows",
        scanChunk=1, evalFreq=2, metric="auc", baggingSeed=9,
        topRate=0.3, dropRate=0.2, catSmooth=5.0, maxBinSparse=8).fit(df)
    assert inert.booster.save_native() == plain.booster.save_native()
    assert inert.getVerbosity() == -1 and inert.getNumThreads() == 4


@pytest.mark.parametrize("kwargs, exc", [
    (dict(xgboostDartMode=True, boostingType="dart"), NotImplementedError),
    (dict(parallelism="feature_parallel"), ValueError),
])
def test_unported_reference_configurations_raise(kwargs, exc):
    x, y = _gbdt_frame(60)
    df = DataFrame({"features": x, "label": y})
    with pytest.raises(exc):
        LightGBMClassifier(device="cpu", numIterations=1, **kwargs).fit(df)


def test_shard_params_without_a_process_group_fit_one_shard():
    """numShards above the world size clamps to it (the JAX package's
    clamp to its devices): with no process group the world is one rank,
    so the shard settings fit what one shard fits."""
    x, y = _gbdt_frame()
    df = DataFrame({"features": x, "label": y})
    base = dict(device="cpu", numIterations=3, numLeaves=7)
    plain = LightGBMClassifier(**base).fit(df)
    est = LightGBMClassifier(**base, numShards=4,
                             parallelism="voting_parallel", topK=2,
                             shardAxisName="slice,dp")
    assert est._training_group(len(y)) is None
    assert est.fit(df).booster.save_native() == plain.booster.save_native()


def test_reference_names_resolve_without_importing_jax_modules():
    assert resolve_stage_class(
        "mmlspark_tpu.featurize.text.TokenIdEncoder") is TokenIdEncoder
    assert resolve_stage_class(
        "mmlspark_torch.featurize.text.TokenIdEncoder") is TokenIdEncoder
    with pytest.raises(KeyError):
        resolve_stage_class("mmlspark_tpu.featurize.text.NoSuchStage")
    with pytest.raises(KeyError):
        resolve_stage_class("mmlspark_tpu.no_such_module.Stage")


def test_broken_mirror_module_raises_its_own_error(monkeypatch):
    """A port module that exists but fails on one of its own imports shows
    that error, not 'unknown stage class'."""
    def broken(name):
        raise ModuleNotFoundError("No module named 'absent_dependency'",
                                  name="absent_dependency")

    monkeypatch.setattr(serialize.importlib, "import_module", broken)
    with pytest.raises(ModuleNotFoundError, match="absent_dependency"):
        resolve_stage_class("mmlspark_tpu.featurize.text.NotYetLoaded")


# The port's side: load what the JAX package saved, save the port's own
# stages, and prove that no JAX module came in on the way.
PORT_SIDE = r"""
import json, sys
import numpy as np
from mmlspark_torch.core import DataFrame, load_stage
from mmlspark_torch.dl import TextEncoderFeaturizer
from mmlspark_torch.featurize import TokenIdEncoder
from mmlspark_torch.lightgbm import LightGBMClassifier
from mmlspark_torch.train import ComputeModelStatistics

root = sys.argv[1]
data = np.load(root + "/data.npz")
docs = DataFrame({"text": np.asarray(json.load(open(root + "/docs.json")),
                                     object)})
out = {}

enc = load_stage(root + "/jax/tok")
assert type(enc) is TokenIdEncoder, type(enc)
out["tok_from_jax"] = enc.transform(docs)["tokens"]
model = load_stage(root + "/jax/gbdt")
model.setDevice("cpu")
scored = model.transform(DataFrame({"features": data["x"],
                                    "label": data["y"]}))
out["prob_from_jax"] = scored["probability"]
stats = load_stage(root + "/jax/stats")
assert type(stats) is ComputeModelStatistics, type(stats)
out["auc_from_jax"] = np.asarray(stats.transform(scored)["AUC"], float)
feat = load_stage(root + "/jax/feat")
assert type(feat) is TextEncoderFeaturizer, type(feat)
out["feat_params"] = np.asarray([feat.getWidth(), feat.getHeads(),
                                 feat.getDepth(), feat.getVocabSize(),
                                 feat.getSeqChunk()])
for dtype in ("float32", "bfloat16"):
    feat_model = load_stage(root + "/jax/feat_model_" + dtype)
    assert type(feat_model) is TextEncoderFeaturizer, type(feat_model)
    feat_model.setDevice("cpu")
    enc = feat_model.get("model").module
    assert str(enc.dtype) == "torch." + dtype, enc.dtype
    out["model_arch_" + dtype] = np.asarray(
        [enc.vocab, enc.width, enc.depth, enc.heads, enc.mlp_dim])
    out["feat_from_jax_model_" + dtype] = feat_model.transform(
        DataFrame({"tokens": data["tokens"]}))["features"]
try:
    load_stage(root + "/jax/feat_other")
    raise AssertionError("a pickled dict loaded as a model")
except NotImplementedError as e:
    assert "builtins.dict" in str(e), e

df = DataFrame({"features": data["x"], "label": data["y"]})
port_model = LightGBMClassifier(device="cpu", numIterations=4, numLeaves=7,
                                verbosity=-1).fit(df)
port_model.save(root + "/torch/gbdt")
out["prob_port"] = port_model.transform(df)["probability"]
TokenIdEncoder(maxLength=16, vocabSize=300).save(root + "/torch/tok")
ComputeModelStatistics(labelCol="label",
                       evaluationMetric="classification").save(
    root + "/torch/stats")
TextEncoderFeaturizer(width=48, heads=3, depth=1, vocabSize=300,
                      seqChunk=16, attentionImpl="pallas").save(
    root + "/torch/feat")
np.savez(root + "/port_out.npz", **out)

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "mmlspark_tpu"))
assert not bad, bad
print("PORT_SIDE_OK")
"""


def test_stages_load_across_packages_both_ways(tmp_path):
    root = str(tmp_path)
    x, y = _gbdt_frame()
    with open(os.path.join(root, "docs.json"), "w") as f:
        json.dump(DOCS, f)
    jdf = JDataFrame({"features": x, "label": y})
    jdocs = JDataFrame({"text": np.asarray(DOCS, object)})

    jtok = jtext.TokenIdEncoder(maxLength=24, vocabSize=500)
    jtok.save(os.path.join(root, "jax", "tok"))
    jmodel = jlgbm.LightGBMClassifier(numIterations=4, numLeaves=7).fit(jdf)
    jmodel.save(os.path.join(root, "jax", "gbdt"))
    jscored = jmodel.transform(jdf)
    jstats.ComputeModelStatistics(labelCol="label").save(
        os.path.join(root, "jax", "stats"))
    jte.TextEncoderFeaturizer(width=32, heads=2, depth=2, vocabSize=400,
                              seqChunk=32).save(
        os.path.join(root, "jax", "feat"))
    # real JAX LoadedModels: a seeded TextEncoder and its variables, in
    # f32 and in the default bf16 (what a user saves without a dtype)
    tokens = np.random.default_rng(4).integers(1, 400, size=(3, 16))
    tokens = tokens.astype(np.int32)
    tokens[1, 9:] = 0
    np.savez(os.path.join(root, "data.npz"), x=x, y=y, tokens=tokens)
    schema = jregister("CompatTextEncoder", vocab=400, width=32, depth=1,
                       heads=2, mlp_dim=64)
    jfeatures = {}
    for dtype, kw in (("float32", {"dtype": jnp.float32}), ("bfloat16", {})):
        module = jte.TextEncoder(vocab=400, width=32, depth=1, heads=2,
                                 mlp_dim=64, **kw)
        assert module.dtype == getattr(jnp, dtype)
        variables = module.init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 8), jnp.int32), False)
        feat_model = jte.TextEncoderFeaturizer(
            width=32, heads=2, depth=1, vocabSize=400, seqChunk=16,
            model=JLoadedModel(schema, module, variables))
        feat_model.save(os.path.join(root, "jax", "feat_model_" + dtype))
        jfeatures[dtype] = np.asarray(feat_model.transform(
            JDataFrame({"tokens": tokens}))["features"], np.float32)
    # a model payload of anything else
    other = jte.TextEncoderFeaturizer(width=32, heads=2, depth=1,
                                      vocabSize=400)
    other.set("model", {"weights": np.zeros(3, np.float32)})
    other.save(os.path.join(root, "jax", "feat_other"))

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", PORT_SIDE, root], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and "PORT_SIDE_OK" in run.stdout, \
        run.stdout + run.stderr
    got = np.load(os.path.join(root, "port_out.npz"))

    # JAX-saved, port-loaded
    np.testing.assert_array_equal(
        got["tok_from_jax"], np.asarray(jtok.transform(jdocs)["tokens"]))
    np.testing.assert_allclose(got["prob_from_jax"],
                               np.asarray(jscored["probability"]),
                               atol=PROB_ATOL, rtol=0)
    jauc = jstats.ComputeModelStatistics(labelCol="label").transform(
        jscored)["AUC"]
    np.testing.assert_allclose(got["auc_from_jax"], np.asarray(jauc, float),
                               atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got["feat_params"], [32, 2, 2, 400, 32])
    for dtype, atol in (("float32", FEAT_ATOL),
                        ("bfloat16", BF16_POOLED_ATOL)):
        np.testing.assert_array_equal(got["model_arch_" + dtype],
                                      [400, 32, 1, 2, 64])
        feats = got["feat_from_jax_model_" + dtype]
        assert feats.shape == (3, 32) and np.isfinite(feats).all()
        np.testing.assert_allclose(feats, jfeatures[dtype], atol=atol,
                                   rtol=0)

    # port-saved, JAX-loaded
    with open(os.path.join(root, "torch", "gbdt", "metadata.json")) as f:
        meta = json.load(f)
    assert meta["class"] == \
        "mmlspark_tpu.lightgbm.estimators.LightGBMClassificationModel"
    assert meta["library"] == "mmlspark_torch"
    jm = jload_stage(os.path.join(root, "torch", "gbdt"))
    assert type(jm) is jlgbm.LightGBMClassificationModel
    np.testing.assert_allclose(np.asarray(jm.transform(jdf)["probability"]),
                               got["prob_port"], atol=PROB_ATOL, rtol=0)
    assert jm.getVerbosity() == -1
    jt = jload_stage(os.path.join(root, "torch", "tok"))
    assert type(jt) is jtext.TokenIdEncoder
    assert (jt.getMaxLength(), jt.getVocabSize()) == (16, 300)
    js = jload_stage(os.path.join(root, "torch", "stats"))
    assert type(js) is jstats.ComputeModelStatistics
    assert js.getEvaluationMetric() == "classification"
    jf = jload_stage(os.path.join(root, "torch", "feat"))
    assert type(jf) is jte.TextEncoderFeaturizer
    assert (jf.getWidth(), jf.getHeads(), jf.getDepth(),
            jf.getAttentionImpl()) == (48, 3, 1, "pallas")


# the GBDT breadth slice's model kinds: (estimator name, Params, labels)
BREADTH_MODELS = {
    "multiclass": ("LightGBMClassifier", dict(objective="multiclass"),
                   "classes"),
    "dart": ("LightGBMClassifier", dict(boostingType="dart", skipDrop=0.0),
             "binary"),
    "rf": ("LightGBMClassifier", dict(boostingType="rf", baggingFraction=0.8,
                                      baggingFreq=1), "binary"),
    "regression": ("LightGBMRegressor", dict(objective="huber"), "real"),
}


@pytest.mark.parametrize("kind", sorted(BREADTH_MODELS))
def test_breadth_models_cross_packages_both_ways(kind, tmp_path):
    """Stages saved by either package load in the other; their text models
    give the same raw scores within 1e-5 both ways."""
    est, kw, labels = BREADTH_MODELS[kind]
    x, y = _gbdt_frame()
    if labels == "classes":
        y = (np.digitize(x[:, 0] + x[:, 1], [-0.8, 0.0, 0.8])
             ).astype(np.float32)
    elif labels == "real":
        y = (x[:, 0] - 0.5 * x[:, 1]).astype(np.float32)
    kw = dict(kw, numIterations=5, numLeaves=7)
    jm = getattr(jlgbm, est)(numShards=1, **kw).fit(
        JDataFrame({"features": x, "label": y}))
    tm = globals()[est](device="cpu", **kw).fit(
        DataFrame({"features": x, "label": y}))
    jraw, traw = jm.booster.raw_scores(x), tm.booster.raw_scores(
        x, device="cpu")
    assert traw.shape == jraw.shape
    if kind == "multiclass":
        assert traw.shape == (len(y), 4)
    # text models, both ways
    np.testing.assert_allclose(
        Booster.load_native(jm.booster.save_native()).raw_scores(
            x, device="cpu"), jraw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        jlgbm.Booster.load_native(tm.booster.save_native()).raw_scores(x),
        traw, rtol=0, atol=1e-5)
    # stages, both ways
    jm.save(str(tmp_path / "jax"))
    tm.save(str(tmp_path / "torch"))
    from_jax = load_stage(str(tmp_path / "jax"))
    assert type(from_jax).__name__ == type(jm).__name__
    assert type(from_jax).__module__.startswith("mmlspark_torch")
    np.testing.assert_allclose(from_jax.booster.raw_scores(x, device="cpu"),
                               jraw, rtol=0, atol=1e-5)
    from_port = jload_stage(str(tmp_path / "torch"))
    assert type(from_port) is type(jm)
    np.testing.assert_allclose(from_port.booster.raw_scores(x), traw,
                               rtol=0, atol=1e-5)
    assert from_port.booster.average_output == (kind == "rf")


@pytest.mark.parametrize("module, name", [
    ("os", "system"), ("mmlspark_compat_never_imported", "run")])
def test_foreign_pickle_refuses_other_globals(tmp_path, module, name):
    """A payload naming a global outside the codec's list raises
    UnpicklingError, naming it, before anything is imported or called:
    directly and as a JAX-saved ``TextEncoderFeaturizer.model``."""
    payload = f"c{module}\n{name}\n(S'echo hi'\ntR.".encode()
    before = set(sys.modules)
    with pytest.raises(pickle.UnpicklingError, match=f"{module}.{name}"):
        foreign_pickle.loads(payload)
    stage = jte.TextEncoderFeaturizer(width=32, heads=2, depth=1,
                                      vocabSize=400)
    stage.save(str(tmp_path))
    with open(tmp_path / "metadata.json") as f:
        meta = json.load(f)
    meta["complexParams"] = ["model"]
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump(meta, f)
    os.makedirs(tmp_path / "params" / "model")
    (tmp_path / "params" / "model" / "value.pkl").write_bytes(payload)
    with pytest.raises(pickle.UnpicklingError, match=f"{module}.{name}"):
        load_stage(str(tmp_path))
    assert set(sys.modules) - before <= {"mmlspark_torch.core.foreign_pickle"}
    assert module == "os" or module not in sys.modules


def test_foreign_pickle_refuses_a_zoo_model_it_does_not_read(tmp_path):
    """A JAX ``LoadedModel`` of a seeded ``BertEncoder``, pickled alone and
    as a saved ``TextEncoderFeaturizer.model``, raises UnpicklingError
    naming its first foreign class; nothing of the JAX package is
    imported on the port's side."""
    arch = dict(vocab=64, width=16, depth=1, heads=2, mlp_dim=32,
                max_len=16)
    module = JBertEncoder(**arch, dtype=jnp.float32)
    variables = module.init(jax.random.PRNGKey(5),
                            jnp.zeros((1, 8), jnp.int32), False)
    schema = jregister_bert("CompatBertEncoder", **arch, seq_len=8)
    model = JLoadedModel(schema, module, variables)
    foreign = (r"mmlspark_tpu\.(dl\.bert\.BertEncoder"
               r"|models\.zoo\._BertEncoderBuilder)")
    with pytest.raises(pickle.UnpicklingError, match=foreign):
        foreign_pickle.loads(pickle.dumps(model))
    jte.TextEncoderFeaturizer(width=16, heads=2, depth=1, vocabSize=64,
                              seqChunk=8, model=model).save(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", REFUSE_SIDE, str(tmp_path),
                          foreign], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0 and "REFUSED" in run.stdout, \
        run.stdout + run.stderr


# The port's side of the refusal: load the saved stage, expect the error,
# and prove that no JAX module came in on the way.
REFUSE_SIDE = r"""
import pickle, re, sys
from mmlspark_torch.core import load_stage

try:
    load_stage(sys.argv[1])
    raise AssertionError("a BertEncoder model loaded in the port")
except pickle.UnpicklingError as e:
    assert re.search(sys.argv[2], str(e)), e
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "mmlspark_tpu"))
assert not bad, bad
print("REFUSED")
"""


# The featurize slice across packages: stages the JAX package fitted and
# saved, loaded and run by the port with no JAX module imported; and a
# port-fitted FeaturizeModel loaded by the JAX package.
FEATURIZE_SIDE = r"""
import pickle, sys
import numpy as np
from mmlspark_torch.core import DataFrame, load_stage

root = sys.argv[1]
with open(root + "/frames.pkl", "rb") as f:
    frames = pickle.load(f)
out = {}
for name in ("featurize", "clean", "indexer", "text", "w2v"):
    stage = load_stage(root + "/jax/" + name)
    assert type(stage).__module__.startswith("mmlspark_torch."), type(stage)
    inner = stage.getStages() if stage.has_param("stages") else [stage]
    for s in inner:
        if s.has_param("device"):
            assert s.getDevice() == "cuda"      # saved without a device
            s.setDevice("cpu")
    out[name] = stage.transform(DataFrame(frames[name]))
    if name == "w2v":
        out["w2v_syn"] = stage.findSynonyms("g1w1", 3)
from mmlspark_torch.core import ColumnMetadata
out["slot_names"] = ColumnMetadata.get(out["featurize"], "features")
from mmlspark_torch.featurize import Featurize
model = Featurize(inputCols=list(frames["featurize"]), numFeatures=40,
                  device="cpu").fit(DataFrame(frames["featurize"]))
model.save(root + "/torch/featurize")
out["port_features"] = model.transform(
    DataFrame(frames["featurize"]))["features"]
result = {k: ({c: v[c] for c in v.columns} if hasattr(v, "columns") else v)
          for k, v in out.items()}
with open(root + "/port_out.pkl", "wb") as f:
    pickle.dump(result, f)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "mmlspark_tpu"))
assert not bad, bad
print("FEATURIZE_SIDE_OK")
"""


def _compat_frames():
    rng = np.random.default_rng(21)
    n = 64
    num = rng.normal(1.0, 2.0, n).astype(np.float32)
    num[rng.random(n) < 0.2] = np.nan
    wide = rng.normal(size=n)
    wide[:3] = np.nan
    cat = np.asarray([f"c{v}" for v in rng.integers(0, 5, n)], object)
    high = np.asarray([f"h{v}" for v in rng.integers(0, 90, n)], object)
    featurize = {"num": num, "wide": wide, "cat": cat, "high": high,
                 "flag": rng.random(n) > 0.3,
                 "vec": rng.normal(size=(n, 2)).astype(np.float32),
                 "when": np.datetime64("2020-02-02")
                 + rng.integers(0, 10 ** 6, n).astype("timedelta64[s]")}
    text = np.asarray(["the cat sat on the mat", "dogs and cats",
                       "a mat for a cat", "", None, "THE END"], object)
    tokens = np.empty(40, object)
    tokens[:] = [[f"g{g}w{w}" for w in rng.integers(0, 4, 8)]
                 for g in rng.integers(0, 3, 40)]
    return {"featurize": featurize, "clean": {"num": num, "wide": wide},
            "indexer": {"cat": cat}, "text": {"text": text},
            "w2v": {"tokens": tokens}}


def test_featurize_stages_load_across_packages(tmp_path):
    root = str(tmp_path)
    frames = _compat_frames()
    with open(os.path.join(root, "frames.pkl"), "wb") as f:
        pickle.dump(frames, f)
    fr = {k: JDataFrame(v) for k, v in frames.items()}
    cols = list(frames["featurize"])
    fitted = {
        "featurize": jfeat.Featurize(inputCols=cols, numFeatures=40)
        .fit(fr["featurize"]),
        "clean": jfeat.CleanMissingData(inputCols=["num", "wide"],
                                        cleaningMode="Median")
        .fit(fr["clean"]),
        "indexer": jfeat.ValueIndexer(inputCol="cat", outputCol="idx")
        .fit(fr["indexer"]),
        "text": jfeat.TextFeaturizer(inputCol="text", outputCol="vec",
                                     numFeatures=32, useNGram=True)
        .fit(fr["text"]),
        "w2v": jfeat.Word2Vec(vectorSize=8, minCount=1, maxIter=1,
                              batchSize=64).fit(fr["w2v"]),
    }
    want = {}
    for name, model in fitted.items():
        model.save(os.path.join(root, "jax", name))
        want[name] = model.transform(fr[name])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", FEATURIZE_SIDE, root],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0 and "FEATURIZE_SIDE_OK" in run.stdout, \
        run.stdout + run.stderr
    with open(os.path.join(root, "port_out.pkl"), "rb") as f:
        got = pickle.load(f)

    # JAX-saved, port-loaded: the same outputs
    exact = {"featurize": ["features"], "clean": ["num", "wide"],
             "indexer": ["idx"], "text": ["vec"]}
    for name, out_cols in exact.items():
        for c in out_cols:
            w = np.asarray(want[name][c])
            assert got[name][c].dtype == w.dtype, (name, c)
            np.testing.assert_array_equal(got[name][c], w)
    np.testing.assert_allclose(got["w2v"]["features"],
                               np.asarray(want["w2v"]["features"]),
                               rtol=0, atol=1e-6)
    jsyn = fitted["w2v"].findSynonyms("g1w1", 3)
    assert [w for w, _ in got["w2v_syn"]] == [w for w, _ in jsyn]
    np.testing.assert_allclose([s for _, s in got["w2v_syn"]],
                               [s for _, s in jsyn], rtol=0, atol=1e-6)
    assert got["slot_names"] == {"slot_names":
                                 fitted["featurize"].slot_names()}

    # port-saved, JAX-loaded
    with open(os.path.join(root, "torch", "featurize",
                           "metadata.json")) as f:
        meta = json.load(f)
    assert meta["class"] == \
        "mmlspark_tpu.featurize.featurize.FeaturizeModel"
    jm = jload_stage(os.path.join(root, "torch", "featurize"))
    assert type(jm) is jfeat.FeaturizeModel
    np.testing.assert_array_equal(
        np.asarray(jm.transform(fr["featurize"])["features"]),
        got["port_features"])
