"""The port stands alone: it imports nothing of JAX or of the JAX package,
and it never moves to the CPU unless asked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mmlspark_torch.core import DataFrame
from mmlspark_torch.device import resolve_device
from mmlspark_torch.lightgbm import (Booster, LightGBMClassifier,
                                     LightGBMRegressor)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")

SLICE_SCRIPT = r"""
import sys
import numpy as np
from mmlspark_torch import DataFrame
from mmlspark_torch.lightgbm import LightGBMClassifier
from mmlspark_torch.train import ComputeModelStatistics

rng = np.random.default_rng(7)
x = rng.normal(size=(600, 6)).astype(np.float32)
y = (x[:, 0] + x[:, 1] * x[:, 2] + rng.normal(size=600) > 0).astype(
    np.float32)
df = DataFrame({"features": x, "label": y})
model = LightGBMClassifier(device="cpu", numIterations=3,
                           numLeaves=7).fit(df)
auc = float(ComputeModelStatistics(labelCol="label")
            .transform(model.transform(df))["AUC"][0])
assert auc > 0.8, auc

from mmlspark_torch.dl import TextEncoderFeaturizer
from mmlspark_torch.featurize import TokenIdEncoder

docs = DataFrame({"text": np.asarray(
    ["long context models embed entire documents in one pass",
     "short note", ""], object)})
ids = TokenIdEncoder(maxLength=32, vocabSize=512).transform(docs)
emb = TextEncoderFeaturizer(attentionImpl="pallas", device="cpu",
                            vocabSize=512, width=32, depth=1, heads=2,
                            seqChunk=32).transform(ids)["features"]
assert emb.shape == (3, 32) and np.isfinite(emb).all(), emb

from mmlspark_torch.dl import (TextEncoder, encoder_variables,
                               make_attention_fn, pretrain_masked_lm)

enc = TextEncoder(vocab=513, width=32, depth=1, heads=2, mlp_dim=64,
                  attention_fn=make_attention_fn("pallas"))
state, losses = pretrain_masked_lm(enc, ids["tokens"], steps=2,
                                   batch_size=2, device="cpu")
assert len(losses) == 2 and np.isfinite(losses).all(), losses
assert encoder_variables(state) is enc

from mmlspark_torch.dl import MaskedLMModel, generate
from mmlspark_torch.obs import MetricsRegistry
from mmlspark_torch.serving import LLMEngine

lm = MaskedLMModel(TextEncoder(vocab=64, width=32, depth=1, heads=2,
                               mlp_dim=64, attention_fn=make_attention_fn(
                                   "pallas", causal=True)))
prompts = np.array([[5, 6, 7, 8], [9, 10, 11, 0]], np.int32)
out = generate(lm, prompts, max_new_tokens=3, device="cpu")
assert out.shape == (2, 7) and (out[0, 4:] != 0).all(), out
engine = LLMEngine(lm, slots=2, block_len=4, max_seq_len=16,
                   registry=MetricsRegistry(), device="cpu")
engine.submit("a", prompts[0], 3)
served = engine.run_until_drained()
assert served["a"].shape == (7,), served

from mmlspark_torch.dl import pretrain_causal_lm

rows = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 0, 0]], np.int32)
state, losses = pretrain_causal_lm(lm, rows, steps=1, batch_size=2,
                                   device="cpu")
assert len(losses) == 1 and np.isfinite(losses).all(), losses
assert state.model is lm

from mmlspark_torch.core import Pipeline
from mmlspark_torch.featurize import (CleanMissingData, Featurize,
                                      TextFeaturizer, Word2Vec)
from mmlspark_torch.stages import StratifiedRepartition, Timer

rng = np.random.default_rng(3)
raw = {f"c{i}": x[:, i].astype(np.float64) for i in range(6)}
raw["c0"][rng.random(600) < 0.05] = np.nan
raw["kind"] = np.asarray([f"k{v}" for v in (x[:, 0] > 0) * 1 +
                          (x[:, 1] > 0) * 2], object)
raw["label"] = y
chain = Pipeline(stages=[
    CleanMissingData(inputCols=["c0"], cleaningMode="Median", device="cpu"),
    Featurize(inputCols=[c for c in raw if c != "label"], device="cpu"),
    LightGBMClassifier(device="cpu", numIterations=3, numLeaves=7)])
frame = StratifiedRepartition(labelCol="label", device="cpu").transform(
    DataFrame(raw, num_partitions=2))
timer = Timer(stage=chain)
scored = timer.transform(frame)
chain_auc = float(ComputeModelStatistics(labelCol="label")
                  .transform(scored)["AUC"][0])
assert chain_auc > 0.8 and timer.lastDuration > 0, chain_auc
vec = TextFeaturizer(inputCol="text", outputCol="v", numFeatures=16,
                     device="cpu").fit(docs).transform(docs)["v"]
assert vec.shape == (3, 16), vec.shape
sentences = np.empty(20, object)
sentences[:] = [["a", "b", "c", "d"]] * 20
w2v = Word2Vec(vectorSize=4, minCount=1, device="cpu").fit(
    DataFrame({"tokens": sentences}))
assert np.isfinite(w2v.epoch_losses).all(), w2v.epoch_losses
from mmlspark_torch.lightgbm import LightGBMRegressor

classes = (np.digitize(x[:, 0] + x[:, 1], [-0.7, 0.7])).astype(np.float32)
mc = LightGBMClassifier(device="cpu", objective="multiclass",
                        numIterations=3, numLeaves=7).fit(
    DataFrame({"features": x, "label": classes}))
prob = mc.transform(DataFrame({"features": x}))["probability"]
assert prob.shape == (600, 3) and np.allclose(prob.sum(1), 1.0), prob.shape
assert mc.booster.num_trees == 9
target = (x[:, 0] - x[:, 1]).astype(np.float32)
target[np.arange(600) %% 5 == 0] = rng.permutation(
    target[np.arange(600) %% 5 == 0])
reg = LightGBMRegressor(device="cpu", numIterations=40, numLeaves=7,
                        learningRate=0.3, earlyStoppingRound=2,
                        validationIndicatorCol="val").fit(
    DataFrame({"features": x, "label": target,
               "val": np.arange(600) %% 5 == 0}))
best = reg.booster.best_iteration
assert 0 <= best and reg.booster.num_iterations == best + 3, best
pred = reg.transform(DataFrame({"features": x}))["prediction"]
assert pred.shape == (600,) and np.isfinite(pred).all()
from mmlspark_torch.lightgbm import LightGBMRanker

cats = np.floor(np.abs(x[:, 3]) * 4).astype(np.float32)
xc = np.concatenate([x, cats[:, None]], 1)
yc = ((cats %% 3 == 1) ^ (x[:, 0] > 0.5)).astype(np.float32)
cat = LightGBMClassifier(device="cpu", numIterations=3, numLeaves=7,
                         categoricalSlotIndexes=[6]).fit(
    DataFrame({"features": xc, "label": yc}))
assert cat.booster.arrays["cat_flag"].any()
cat.setFeaturesShapCol("shap")
shap = cat.transform(DataFrame({"features": xc[:20]}))["shap"]
raw = cat.booster.raw_scores(xc[:20], device="cpu")
assert np.allclose(shap.sum(1), raw, atol=1e-5), (shap.sum(1), raw)
idx = np.argsort(-np.abs(x), 1)[:, :3].astype(np.int32)
val = np.take_along_axis(x, idx, 1)
coo = DataFrame({"features_indices": idx, "features_values": val,
                 "label": y})
sp = LightGBMClassifier(device="cpu", numIterations=3, numLeaves=7).fit(coo)
assert np.isfinite(sp.transform(coo)["probability"]).all()
qid = np.repeat(np.arange(60), 10)
rank = LightGBMRanker(device="cpu", groupCol="query", numIterations=3,
                      numLeaves=7).fit(
    DataFrame({"features": x, "label": np.digitize(x[:, 0], [0.0, 1.0]),
               "query": qid}))
ndcg = rank.evaluate_ndcg(DataFrame({"features": x, "label": np.digitize(
    x[:, 0], [0.0, 1.0]), "query": qid}), k=5)
assert 0.5 < ndcg <= 1.0, ndcg
import os
import shutil
import tempfile

import torch

from mmlspark_torch.dl import (ContinuousGenerator, TextGenerator,
                               generate_speculative)
from mmlspark_torch.dl.checkpoint import CheckpointManager
from mmlspark_torch.featurize import BpeTokenizer
from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                   get_model)

g = torch.Generator().manual_seed(0)


def t(*shape):
    return torch.randn(*shape, generator=g) * 0.05


sd = {"bert.embeddings.word_embeddings.weight": t(64, 32),
      "bert.embeddings.position_embeddings.weight": t(32, 32),
      "bert.embeddings.token_type_embeddings.weight": t(2, 32)}
for name, (o, i) in {"attention.self.query": (32, 32),
                     "attention.self.key": (32, 32),
                     "attention.self.value": (32, 32),
                     "attention.output.dense": (32, 32),
                     "intermediate.dense": (64, 32),
                     "output.dense": (32, 64)}.items():
    sd[f"bert.encoder.layer.0.{name}.weight"] = t(o, i)
    sd[f"bert.encoder.layer.0.{name}.bias"] = t(o)
for name in ("embeddings.LayerNorm", "encoder.layer.0.attention.output."
             "LayerNorm", "encoder.layer.0.output.LayerNorm"):
    sd[f"bert.{name}.weight"] = 1 + t(32)
    sd[f"bert.{name}.bias"] = t(32)
bert = bert_encoder_from_torch(sd, heads=2)
bert_emb = TextEncoderFeaturizer(
    model=LoadedModel(get_model("TextEncoderBase"), bert),
    attentionImpl="pallas", device="cpu", seqChunk=32).transform(
    DataFrame({"tokens": np.asarray(ids["tokens"]) %% 64}))["features"]
assert bert_emb.shape == (3, 32) and np.isfinite(bert_emb).all()
ckdir = tempfile.mkdtemp()
try:
    mgr = CheckpointManager(ckdir)
    mgr.save(state)
    assert mgr.restore(target=state).step == state.step == 1
finally:
    shutil.rmtree(ckdir)
ref = generate(lm, prompts, max_new_tokens=3, device="cpu")  # trained lm
cgen = ContinuousGenerator(lm, slots=1, max_len=8, device="cpu",
                           registry=MetricsRegistry())
cgen.submit("a", prompts[0], 3)
cgen.submit("b", prompts[1, :3], 3)
rows = cgen.run_until_drained()
np.testing.assert_array_equal(rows["a"][:7], ref[0])
spec, rate = generate_speculative(lm, lm, prompts[:1], max_new_tokens=3,
                                  k=2, device="cpu")
np.testing.assert_array_equal(spec[0], ref[0])
bpe = BpeTokenizer(vocabSize=64, maxLength=8, inputCol="text",
                   outputCol="tokens").fit(docs)
texts = TextGenerator(tokenizer=bpe, lm=lm, maxNewTokens=2, draftLm=lm,
                      device="cpu").transform(docs)["generated"]
assert len(texts) == 3 and all(texts), texts
os.environ["MMLSPARK_TPU_PAGED_ATTN"] = "0"
dense = LLMEngine(lm, slots=2, block_len=4, max_seq_len=16,
                  registry=MetricsRegistry(), device="cpu")
del os.environ["MMLSPARK_TPU_PAGED_ATTN"]
dense.submit("a", prompts[0], 3)
np.testing.assert_array_equal(dense.run_until_drained()["a"], ref[0])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
print("ISOLATED", auc)
""" % (FORBIDDEN,)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this module: tier-1 runs in several
    worker processes at once, and torch's intra-op threads in each of
    them oversubscribe the cores (small ops then wait on spinning
    threads, ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slice_runs_without_importing_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # see one_torch_thread
    proc = subprocess.run([sys.executable, "-c", SLICE_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED" in proc.stdout


# modules the GBDT breadth slice added; the scan below must reach each
GBDT_BREADTH = ["lightgbm/sparse.py", "lightgbm/ranker_objective.py",
                "lightgbm/shap.py", "parallel/collectives.py",
                "parallel/sharding.py"]
# modules the text-generation slice added or finished; the scan below must
# reach each
TEXTGEN_SLICE = ["dl/bert.py", "dl/checkpoint.py", "dl/speculative.py",
                 "dl/generate.py", "models/convert.py", "models/zoo.py",
                 "serving/llm.py"]
# modules the featurize slice added; the scan below must reach each
FEATURIZE_SLICE = [
    "core/arrow.py", "core/bindings.py", "core/dataframe.py",
    "core/utils.py", "featurize/_hostenc.py", "featurize/featurize.py",
    "featurize/clean_missing_data.py", "featurize/value_indexer.py",
    "featurize/data_conversion.py", "featurize/count_selector.py",
    "featurize/vector.py", "featurize/text.py", "featurize/embedding.py",
    "sched/policy.py", "stages/__init__.py", "stages/basic.py",
    "stages/batching.py", "stages/misc.py"]


def _port_sources():
    root = os.path.join(REPO, "mmlspark_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "profile_torch_gbdt.py")
    yield os.path.join(REPO, "tools", "profile_torch_text.py")
    yield os.path.join(REPO, "tools", "profile_torch_train.py")
    yield os.path.join(REPO, "tools", "profile_torch_llm.py")
    yield os.path.join(REPO, "tools", "shard_gbdt.py")


def _imported_modules(path):
    """Every module named by an import statement, importlib.import_module
    or __import__ call with a literal name."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_static_scan_finds_no_jax_import():
    sources = list(_port_sources())
    assert any(p.endswith("chip_smoke.py") for p in sources)
    scanned = {os.path.relpath(p, os.path.join(REPO, "mmlspark_torch"))
               for p in sources}
    assert set(FEATURIZE_SLICE) <= scanned, set(FEATURIZE_SLICE) - scanned
    assert set(GBDT_BREADTH) <= scanned, set(GBDT_BREADTH) - scanned
    assert set(TEXTGEN_SLICE) <= scanned, set(TEXTGEN_SLICE) - scanned
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda:0")
    rng = np.random.default_rng(0)
    df = DataFrame({"features": rng.normal(size=(50, 3)).astype(np.float32),
                    "label": (rng.random(50) > 0.5).astype(np.float32)})
    clf = LightGBMClassifier(numIterations=2)
    assert clf.getDevice() == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        clf.fit(df)
    model = LightGBMClassifier(device="cpu", numIterations=2,
                               minDataInLeaf=5).fit(df)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.booster.raw_scores(df["features"])
    model.setDevice("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.transform(df)
    assert isinstance(model.booster, Booster)
    assert resolve_device("cpu") == torch.device("cpu")


def test_generation_entry_points_raise_without_cuda(monkeypatch):
    """The text-generation slice's entry points run on CUDA unless asked:
    without a GPU their defaults raise."""
    from mmlspark_torch.dl import (ContinuousGenerator, MaskedLMModel,
                                   TextEncoder, TextGenerator,
                                   generate_speculative, make_attention_fn)
    from mmlspark_torch.obs import MetricsRegistry
    lm = MaskedLMModel(TextEncoder(vocab=64, width=32, depth=1, heads=2,
                                   mlp_dim=64, attention_fn=make_attention_fn(
                                       "dense", causal=True)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ContinuousGenerator(lm, registry=MetricsRegistry())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        generate_speculative(lm, lm, np.array([[3, 4]]), max_new_tokens=2)
    stage = TextGenerator(lm=lm)
    assert stage.get("device") == "cuda"


def _device_stages():
    """Every stage with a ``device`` Param, at its default, and a frame it
    would compute on."""
    from mmlspark_torch import featurize as f, stages as s
    x = np.asarray([1.0, np.nan, 3.0])
    toks = np.empty(2, object)
    toks[:] = [["a", "b"], ["b", "a"]]
    num = DataFrame({"x": x, "i": np.asarray([0, 2, 1]),
                     "v": np.ones((3, 2), np.float32)})
    return {
        "Featurize": (f.Featurize(inputCols=["x"]).fit, num),
        "FeaturizeModel": (f.FeaturizeModel(encodingPlan=[
            {"col": "x", "kind": "numeric", "width": 1, "fill": 0.0}],
            inputCols=["x"]).transform, num),
        "CleanMissingData": (f.CleanMissingData(inputCols=["x"]).fit, num),
        "CleanMissingDataModel": (f.CleanMissingDataModel(
            inputCols=["x"], fillValues={"x": 0.0}).transform, num),
        "CountSelector": (f.CountSelector(inputCol="v").fit, num),
        "VectorAssembler": (f.VectorAssembler(inputCols=["v"]).transform,
                            num),
        "OneHotEncoder": (f.OneHotEncoder(inputCol="i").fit, num),
        "OneHotEncoderModel": (f.OneHotEncoderModel(
            inputCol="i", outputCol="oh", categorySize=3).transform, num),
        "IDFModel": (f.IDFModel(inputCol="v", outputCol="w",
                                idf=[1.0, 2.0]).transform, num),
        "Word2Vec": (f.Word2Vec(minCount=1).fit, DataFrame({"tokens": toks})),
        "Word2VecModel": (f.Word2VecModel(
            inputCol="tokens", outputCol="e", vocabulary=["a"],
            wordVectors=[[1.0]])
            .transform, DataFrame({"tokens": toks})),
        "EnsembleByKey": (s.EnsembleByKey(keys=["i"], cols=["x"]).transform,
                          num),
        "StratifiedRepartition": (s.StratifiedRepartition(
            labelCol="i").transform, num),
        "LightGBMRegressor": (LightGBMRegressor(
            numIterations=1, minDataInLeaf=1).fit, DataFrame(
            {"features": np.ones((3, 1), np.float32),
             "label": np.asarray([0.0, 1.0, 2.0], np.float32)})),
    }


@pytest.mark.parametrize("name", sorted(_device_stages()))
def test_default_device_stages_raise_without_cuda(monkeypatch, name):
    """A stage with a ``device`` Param runs on CUDA unless asked: without a
    GPU its default raises, never moving to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run, frame = _device_stages()[name]
    assert run.__self__.getDevice() == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run(frame)
    run.__self__.setDevice("cpu")
    run(frame)
