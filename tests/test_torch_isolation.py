"""The port stands alone: it imports nothing of JAX or of the JAX package,
and it never moves to the CPU unless asked."""

import ast
import json
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
import torch

# torch seeds its default generator from the OS at start-up: the modules
# built below without a generator would draw new weights in every run
torch.manual_seed(0)
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
# the continuous batcher's contract: generate(use_cache=False)'s tokens
nocache = generate(lm, prompts, max_new_tokens=3, device="cpu",
                   use_cache=False)
np.testing.assert_array_equal(rows["a"][:7], nocache[0])
np.testing.assert_array_equal(rows["b"][:6], nocache[1, :6])
# generate's cached bf16 path rounds apart from the re-encoding one and
# parts from it at near-ties: every token it chose, re-scored with the
# re-encoding forward on its own output, lies within 0.05 of the best
# logit (0 where the paths agree; at a parting, the top-2 margin). Over 60
# seeded weight sets the two paths' logits differed by at most 0.025 at a
# position, so a parting's margin stays under twice that.
with torch.inference_mode():
    lg = lm(torch.from_numpy(ref).long())["logits"].float()
    lg[..., 0] = -float("inf")                # generation never emits pad
gaps = [float(lg[b, j - 1].max() - lg[b, j - 1, ref[b, j]])
        for b, start in enumerate((4, 3)) for j in range(start, start + 3)]
print("cached generate re-scored: largest gap", max(gaps))
assert max(gaps) <= 0.05, gaps
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
import json
from mmlspark_torch import obs

with obs.SpanCollector() as col:
    LightGBMClassifier(device="cpu", numIterations=2, numLeaves=7).fit(df)
names = [sp["name"] for sp in col.spans()]
assert names == ["boosting_round"] * 2 + ["lightgbm.fit"], names
assert json.loads(json.dumps(obs.chrome_trace(col.spans())))
info = obs.cost_attribution.record_call("iso_mm", lambda a: a @ a,
                                        torch.ones(8, 8))
assert info["flops"] == 2 * 8 ** 3, info
warm = LLMEngine(lm, slots=2, block_len=4, max_seq_len=16,
                 registry=MetricsRegistry(), device="cpu", service="iso")
fps = warm.warm()
assert sorted(fps) == ["llm_decode_paged_iso_S2_k0",
                       "llm_prefill_iso_w1_b" + str(warm.prefiller.batch)], fps
assert obs.compile_tracker.steady
assert obs.cost_attribution.service_cost("iso")[0] > 0
obs.compile_tracker.unmark_steady()
assert obs.device_memory_stats() == [] and not torch.cuda.is_initialized()
with obs.XprofCaptures(root=tempfile.mkdtemp()).region("iso") as cap:
    obs.step_profiler.record_mfu("iso", 1e6, 1e-3)
assert cap["device"] is False and os.path.exists(cap["trace"]), cap
assert "lightgbm_boosting_round_seconds" in obs.registry.exposition()
from mmlspark_torch import perf, resilience, sched
from mmlspark_torch.dl import TrainState
from mmlspark_torch.dl.checkpoint import CheckpointManager
from mmlspark_torch.testing.benchmarks import synth_feature_rows

ten = sched.Tenancy("iso", quotas={
    "g": sched.TenantQuota(tier=sched.GOLD),
    "b": sched.TenantQuota(tier=sched.BEST_EFFORT, rate=1.0, burst=1.0)},
    tier_deadlines={sched.GOLD: 5.0}, registry=MetricsRegistry())
rs = sched.RequestScheduler("iso", max_queue=8, tenancy=ten,
                            registry=MetricsRegistry())
for tenant in ("b", "g"):
    rs.submit(type("I", (), {})(), tenant=tenant)
try:
    rs.submit(type("I", (), {})(), tenant="b")
    raise AssertionError("the rate quota did not shed")
except sched.Shed as e:
    assert (e.reason, e.status) == ("tenant_rate", 429), e.reason
assert sorted(i.tenant for i in rs.next_batch(max_batch=4,
                                               max_wait=0)) == ["b", "g"]
cm = perf.CostModel(min_rows=16, registry=MetricsRegistry())
assert cm.fit(synth_feature_rows(128)) == 128
assert cm.predict_batch_ms("costmodel-bench", 8) is not None
ck = CheckpointManager(tempfile.mkdtemp())
net = torch.nn.Linear(2, 2)
st = TrainState(net, torch.optim.SGD(net.parameters(), lr=0.1), 1)
ck.save(st)
with resilience.faults(0, [resilience.FaultRule(
        point="checkpoint.write", kind="drop")]):
    try:
        ck.save(st, step=2)
        raise AssertionError("the armed checkpoint.write did not fire")
    except resilience.InjectedDrop:
        pass
assert ck.all_steps() == [1]
from mmlspark_torch.core import aot, compile_pipeline
from mmlspark_torch.featurize import CleanMissingData, Featurize
from mmlspark_torch.stages import DropColumns

rng = np.random.default_rng(4)
xs = rng.normal(size=(32, 3)).astype(np.float32)
xs[::5, 1] = np.nan
frame = DataFrame({"x0": xs[:, 0], "x1": xs[:, 1], "x2": xs[:, 2],
                   "k": np.arange(32)})
names = ["x0", "x1", "x2"]
cmd = CleanMissingData(inputCols=names, device="cpu").fit(frame)
fzm = Featurize(inputCols=names, device="cpu").fit(cmd.transform(frame))
chain = [cmd, fzm, DropColumns(cols=["k"])]
cp = compile_pipeline(chain, frame, device="cpu", service="iso")
assert [p["kind"] for p in cp.describe()] == ["fused"], cp.describe()
eager = DropColumns(cols=["k"]).transform(fzm.transform(cmd.transform(frame)))
fused = cp.transform(frame)
for c in eager.columns:
    assert np.array_equal(eager[c], fused[c], equal_nan=True), c
store = aot.AotStore(tempfile.mkdtemp())
assert aot.build_pipeline(cp, frame, store)[0]["built"]
aot.install(store)
cp2 = compile_pipeline(chain, frame, device="cpu", service="iso")
assert cp2.warm_aot() == 1
obs.compile_tracker.mark_steady()
again = cp2.transform(frame)
assert obs.compile_tracker.runtime_compiles() == 0
obs.compile_tracker.unmark_steady()
aot.uninstall()
for c in eager.columns:
    assert np.array_equal(again[c], fused[c], equal_nan=True), c
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


VISION_SCRIPT = r"""
import os
import sys
import tempfile

import numpy as np
import torch

from mmlspark_torch import DataFrame
from mmlspark_torch.image import (ImageFeaturizer, ImageSetAugmenter,
                                  ImageTransformer, ResizeImageTransformer,
                                  UnrollImage)
from mmlspark_torch.io import BinaryFileReader, FileStreamSource
from mmlspark_torch.models import (LoadedModel, ModelDownloader, ModelSchema,
                                   ResNet, ViT, quantize_resnet,
                                   save_converted)
from mmlspark_torch.models.resnet import BottleneckBlock

torch.manual_seed(0)
g = torch.Generator().manual_seed(1)
imgs = np.random.default_rng(2).integers(0, 256, (5, 40, 36, 3)).astype(
    np.uint8)
df = DataFrame({"image": imgs})
layers = ("stage1", "stage2", "pooled", "logits")
net = ResNet((1, 1), BottleneckBlock, num_classes=4, width=8,
             dtype=torch.bfloat16, generator=g)
for m in net.modules():
    if hasattr(m, "scale"):
        m.scale.data.uniform_(0.5, 1.5, generator=g)
loaded = LoadedModel(ModelSchema(name="tiny", input_size=32,
                                 layer_names=layers), net)
for cut in range(4):
    f = ImageFeaturizer(model=loaded, cutOutputLayers=cut, miniBatchSize=2,
                        device="cpu").transform(df)["features"]
    assert f.shape[0] == 5 and np.isfinite(f).all(), (cut, f.shape)
q = ImageFeaturizer(model=loaded, quantize=True, miniBatchSize=2,
                    device="cpu").transform(df)["features"]
assert q.shape == (5, 64) and np.isfinite(q).all()
vit = ViT(patch=4, width=32, depth=1, heads=4, mlp_dim=64, num_classes=3,
          image_size=16, generator=g)
v = ImageFeaturizer(model=LoadedModel(ModelSchema(
    name="v", input_size=16, layer_names=("block1", "pooled", "logits")),
    vit), device="cpu").transform(df)["features"]
assert v.shape == (5, 32) and np.isfinite(v).all()
chain = ImageTransformer(inputCol="image", outputCol="t", device="cpu") \
    .resize(16, 16).colorFormat("bgr2rgb").flip(1).blur(3, 3) \
    .gaussianKernel(3, 0.0).threshold(100.0, 255.0)
out = chain.transform(df)
out = ResizeImageTransformer(inputCol="t", outputCol="t", height=8,
                             width=8, device="cpu").transform(out)
out = UnrollImage(inputCol="t", device="cpu").transform(out)
assert out["unrolled"].shape == (5, 8 * 8 * 3)
assert ImageSetAugmenter(device="cpu").transform(df).num_rows == 10
root = tempfile.mkdtemp()
save_converted(net, "ResNet50", root)
open(os.path.join(root, "blob.bin"), "wb").write(b"123")
assert BinaryFileReader(inspect_zip=False).read(root).num_rows == 3
assert FileStreamSource(root, glob="*.bin").next_batch().num_rows == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("ISOLATED vision")
""" % (FORBIDDEN,)


def test_vision_slice_runs_without_importing_jax():
    """ImageFeaturizer (ResNet at every cut, the int8 path, ViT), the image
    stages, the model store and the readers in a process with no JAX."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # see one_torch_thread
    proc = subprocess.run([sys.executable, "-c", VISION_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED vision" in proc.stdout


# modules the DL inference slice added; the scan below must reach each
VISION_SLICE = ["models/resnet.py", "models/vit.py", "models/quantize.py",
                "models/convert.py", "models/zoo.py", "dl/model.py",
                "image/__init__.py", "image/ops.py", "image/transforms.py",
                "image/stages.py", "image/featurizer.py", "io/__init__.py",
                "io/binary.py", "io/image_source.py",
                "core/foreign_pickle.py"]
# modules the GBDT breadth slice added; the scan below must reach each
GBDT_BREADTH = ["lightgbm/sparse.py", "lightgbm/ranker_objective.py",
                "lightgbm/shap.py", "parallel/collectives.py",
                "parallel/sharding.py"]
# modules the control-plane slice added; the scan below must reach each
COMPILE_SLICE = ["core/compile.py", "core/aot.py", "core/pipeline.py",
                 "native/loader.py", "serving/llm.py",
                 "testing/benchmarks.py"]
CONTROL_SLICE = ["resilience/__init__.py", "resilience/faults.py",
                 "resilience/retry.py", "resilience/breaker.py",
                 "sched/policy.py", "sched/scheduler.py",
                 "sched/tenancy.py", "perf/__init__.py",
                 "perf/costmodel.py", "testing/__init__.py",
                 "testing/benchmarks.py"]
# modules the tile-search slice added or finished; the scan below must
# reach each
AUTOTUNE_SLICE = ["perf/__init__.py", "perf/autotune.py",
                  "lightgbm/hist.py", "dl/flash_attention.py",
                  "dl/paged_attention.py"]
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


# modules the serving-fronts slice added; the scan below must reach each
SERVING_SLICE = ["serving/__init__.py", "serving/server.py",
                 "serving/native_front.py", "serving/dsl.py",
                 "serving/udfs.py", "serving/loadgen.py",
                 "io/http/__init__.py", "io/http/schema.py",
                 "io/http/shared.py", "io/http/clients.py",
                 "io/http/transformer.py", "io/http/port_forwarding.py",
                 "native/__init__.py", "native/loader.py",
                 "testing/benchmarks.py"]


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
    yield os.path.join(REPO, "tools", "vision_bf16_agreement.py")
    yield os.path.join(REPO, "tools", "control_bf16_agreement.py")
    yield os.path.join(REPO, "tools", "time_fused_segment.py")
    yield os.path.join(REPO, "tools", "profile_torch_serving.py")


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


SERVING_SCRIPT = r"""
import json
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from mmlspark_torch.core import DataFrame
from mmlspark_torch.io.http import (AsyncClient, HTTPRequestData,
                                    string_to_response)
from mmlspark_torch.lightgbm import LightGBMRegressor
from mmlspark_torch.serving import read_stream, serving_query
from mmlspark_torch.serving.loadgen import run_load
from mmlspark_torch.serving.native_front import NativeServingServer

rng = np.random.default_rng(0)
x = rng.normal(size=(300, 4)).astype(np.float32)
model = LightGBMRegressor(numIterations=5, device="cpu").fit(
    DataFrame({"features": x, "label": x @ np.ones(4, np.float32)}))
want = np.asarray(model.transform(DataFrame({"features": x[:8]}))[
    "prediction"])


def score(df):
    feats = np.stack([np.asarray(json.loads(r.entity), np.float32)
                      for r in df["request"]])
    pred = np.asarray(model.transform(DataFrame({"features": feats}))[
        "prediction"])
    replies = np.empty(len(df), object)
    replies[:] = [string_to_response(json.dumps(float(p))) for p in pred]
    return df.with_column("reply", replies)


for backend in ("python", "native"):
    q = serving_query("iso-" + backend, score, backend=backend)
    try:
        assert (type(q.server) is NativeServingServer) == \
            (backend == "native")
        host, port = q.server.address
        out = AsyncClient(concurrency=4).send([HTTPRequestData(
            url=f"http://{host}:{port}/", method="POST",
            entity=json.dumps(r.tolist()).encode()) for r in x[:8]])
        got = [json.loads(r.entity) for r in out]
        np.testing.assert_array_equal(got, want.astype(np.float64))
        r = run_load(host, port, json.dumps(x[0].tolist()).encode(),
                     nconn=2, nreq=10, warmup=2)
        assert r["errors"] == 0, r
    finally:
        q.stop()
q = (read_stream().server().address("127.0.0.1", 0, "iso").load()
     .transform(lambda df: df.with_column("value", np.asarray(
         [len(r.entity or b"") for r in df["request"]])))
     .with_reply(lambda v: {"n": int(v)}).start())
try:
    host, port = q.server.address
    out = AsyncClient().send([HTTPRequestData(
        url=f"http://{host}:{port}/iso", method="POST", entity=b"abc")])
    assert json.loads(out[0].entity) == {"n": 3}
finally:
    q.stop()
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("ISOLATED serving")
""" % (FORBIDDEN,)


def test_serving_fronts_run_without_importing_jax():
    """A fitted GBDT served through both fronts (its replies equal its
    direct transform), the load generator and the DSL, in a process with
    no JAX and nothing of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"          # see one_torch_thread
    proc = subprocess.run([sys.executable, "-c", SERVING_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED serving" in proc.stdout


AUTOTUNE_SCRIPT = r"""
import sys

from mmlspark_torch.perf import autotune

# the registry the environment names was loaded at import
w = autotune.kernel_winner("hist", "n4096-F16-B32", "cuda")
assert w == {"feat_block": 8, "block_rows": 64, "ms": 1.0}, w
assert autotune.kernel_winner("hist", "n4096-F16-B32", "cpu") is None
assert autotune.load(autotune.registry_path()) == 1
assert autotune.lookup_stats()["hits"] == {"hist": 1}
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("ISOLATED autotune")
""" % (FORBIDDEN + ("torch",),)


def test_autotune_imports_no_jax_and_no_torch(tmp_path):
    """Importing the tuner, its boot-time load of the registry
    ``MMLSPARK_TPU_TUNE_STORE`` names, ``kernel_winner`` and ``load`` pull
    in no JAX, nothing of the JAX package and no torch."""
    path = tmp_path / "autotune.json"
    path.write_text(json.dumps({"version": 1, "winners": {
        "hist|n4096-F16-B32|cuda": {"feat_block": 8, "block_rows": 64,
                                    "ms": 1.0}}}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["MMLSPARK_TPU_TUNE_STORE"] = str(path)
    proc = subprocess.run([sys.executable, "-c", AUTOTUNE_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED autotune" in proc.stdout


def test_static_scan_finds_no_jax_import():
    sources = list(_port_sources())
    assert any(p.endswith("chip_smoke.py") for p in sources)
    scanned = {os.path.relpath(p, os.path.join(REPO, "mmlspark_torch"))
               for p in sources}
    assert set(FEATURIZE_SLICE) <= scanned, set(FEATURIZE_SLICE) - scanned
    assert set(GBDT_BREADTH) <= scanned, set(GBDT_BREADTH) - scanned
    assert set(TEXTGEN_SLICE) <= scanned, set(TEXTGEN_SLICE) - scanned
    assert set(VISION_SLICE) <= scanned, set(VISION_SLICE) - scanned
    assert set(CONTROL_SLICE) <= scanned, set(CONTROL_SLICE) - scanned
    assert set(COMPILE_SLICE) <= scanned, set(COMPILE_SLICE) - scanned
    assert set(AUTOTUNE_SLICE) <= scanned, set(AUTOTUNE_SLICE) - scanned
    assert set(SERVING_SLICE) <= scanned, set(SERVING_SLICE) - scanned
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
    from mmlspark_torch import image as im
    from mmlspark_torch.dl import TPUModel
    from mmlspark_torch.models import LoadedModel, ModelSchema, ResNet
    from mmlspark_torch.models.resnet import BasicBlock
    net = ResNet((1,), BasicBlock, num_classes=2, width=4)
    tiny = LoadedModel(ModelSchema(name="tiny", input_size=8, layer_names=(
        "stage1", "pooled", "logits")), net)
    pics = DataFrame({"image": np.zeros((2, 6, 6, 3), np.uint8)})
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
        "ImageFeaturizer": (im.ImageFeaturizer(model=tiny).transform,
                            pics),
        "ImageTransformer": (im.ImageTransformer().flip(1).transform, pics),
        "ResizeImageTransformer": (im.ResizeImageTransformer(
            height=4, width=4).transform, pics),
        "UnrollImage": (im.UnrollImage().transform, pics),
        "ImageSetAugmenter": (im.ImageSetAugmenter().transform, pics),
        "TPUModel": (TPUModel(model=net, inputCol="image").transform, pics),
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
