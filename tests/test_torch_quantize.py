"""The port's int8 path against the JAX package's ``models/quantize.py``.

Held, on the small ResNets of ``test_torch_vision_models.py`` (every
parameter and statistic non-zero) and a seeded two-block ``TextEncoder``:
- ``_quant_w`` and ``_quant_dense_w`` bit-equal to JAX's on the same
  weights (int8 values and f32 scales); the BatchNorm fold within one f32
  ulp (XLA's CPU ``sqrt`` is not always correctly rounded; torch's is);
- ``int8_matmul`` exact where f32 is not (sums past 2^24), with the
  padding ``torch._int_mm`` needs;
- the quantized ResNet forward within 1e-4 (of the largest value) of JAX's
  ``q_forward``, cosine > 0.99 against the f32 model (the JAX package's own
  bound, ``tests/test_quantize.py``), and a row's features bit-equal with
  and without an outlier neighbour;
- ``quantize_text_encoder`` within 1e-4 of JAX's, plain and causal; a
  non-dense attention raises;
- both featurizers' ``quantize`` Param against the JAX featurizers, and
  their refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.text_encoder import \
    TextEncoderFeaturizer as JTextEncoderFeaturizer
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.image import ImageFeaturizer as JImageFeaturizer
from mmlspark_tpu.models import quantize as jq
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import TextEncoderFeaturizer, make_attention_fn
from mmlspark_torch.image import ImageFeaturizer
from mmlspark_torch.models import (LoadedModel, ModelSchema,
                                   quantization_fidelity, quantize_resnet,
                                   quantize_text_encoder, resnet_from_flax,
                                   text_encoder_from_flax, vit_from_flax)
from mmlspark_torch.models import quantize as pq
import test_torch_vision_models as vm

RTOL = 1e-4
TEXT = dict(vocab=100, width=32, depth=2, heads=4, mlp_dim=64)
LAYERS = ("stage1", "stage2", "stage3", "stage4", "pooled", "logits")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quant_w_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    for shape in [(7, 7, 3, 8), (3, 3, 64, 16), (1, 1, 32, 24)]:
        w = rng.normal(size=shape).astype(np.float32)
        w[..., 0] = 0.0                         # an all-zero channel
        jw, js = jq._quant_w(jnp.asarray(w))
        pw, ps = pq._quant_w(torch.from_numpy(w))
        assert pw.dtype == torch.int8 and pw.is_contiguous()
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    w = rng.normal(size=(48, 40)).astype(np.float32)
    jw, js = jq._quant_dense_w(jnp.asarray(w))
    pw, ps = pq._quant_dense_w(torch.from_numpy(w))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # half-way values round to even, as jnp.round does
    half = np.asarray([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    np.testing.assert_array_equal(
        pq._quant_dense_w(torch.from_numpy(half.T))[0].numpy().ravel(),
        np.asarray(jq._quant_dense_w(jnp.asarray(half.T))[0]).ravel())


@pytest.mark.parametrize("block", sorted(vm.BLOCKS))
def test_fold_within_an_ulp_of_jax(block):
    _, v = vm.jax_resnet(block)
    port = resnet_from_flax(v, dtype=torch.float32)
    p, s = v["params"], v["batch_stats"]
    jw, jb = jq._fold(p["conv_init"], p["bn_init"], s["bn_init"])
    pw, pb = pq._fold(port.conv_init, port.bn_init)
    eps = np.finfo(np.float32).eps
    for got, want in ((pw, jw), (pb, jb)):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= eps * np.abs(want))


def test_int8_matmul_exact_past_f32():
    """3x3x512 taps of 127·127 sum to 7.4e7 > 2^24: f32 would round."""
    K = 3 * 3 * 512 + 3                        # not a multiple of 8
    a = torch.full((5, K), 127, dtype=torch.int8)   # fewer than 17 rows
    b = torch.full((K, 9), -127, dtype=torch.int8)  # N not a multiple of 8
    a[:, 1] = 1
    got = pq.int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (5, 9)
    want = a.long() @ b.long()
    assert torch.equal(got.long(), want)
    assert (a.float() @ b.float()).long().ne(want).any()


@pytest.mark.parametrize("block", sorted(vm.BLOCKS))
def test_q_forward_against_jax(block):
    m, v = vm.jax_resnet(block)
    jf, jp = jq.quantize_resnet(m, v)
    x = vm.images(3, 32, seed=8)
    want = np.asarray(jax.jit(jf)(jp, jnp.asarray(x)))
    port = resnet_from_flax(v, dtype=torch.float32)
    qf, qp = quantize_resnet(port)
    got = qf(qp, torch.from_numpy(x)).numpy()
    vm.assert_close(got, want, RTOL, "pooled")
    cos = quantization_fidelity(port, qf, qp, torch.from_numpy(x))
    assert cos > 0.99, cos


def test_rows_independent_of_minibatch_neighbours():
    _, v = vm.jax_resnet("basic")
    qf, qp = quantize_resnet(resnet_from_flax(v, dtype=torch.float32))
    rng = np.random.default_rng(7)
    row = torch.from_numpy(rng.uniform(0, 255, (1, 32, 32, 3))
                           .astype(np.float32))
    outlier = 100.0 * torch.from_numpy(rng.normal(size=(1, 32, 32, 3))
                                       .astype(np.float32))
    alone = qf(qp, row)
    batched = qf(qp, torch.cat([row, outlier]))
    assert torch.equal(alone[0], batched[0])
    w = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    wq, sw = pq._quant_dense_w(w)
    x = torch.from_numpy(rng.normal(size=(1, 3, 6)).astype(np.float32))
    b = torch.zeros(5)
    assert torch.equal(pq._qdense(x, wq, sw, b)[0],
                       pq._qdense(torch.cat([x, 50 * x]), wq, sw, b)[0])
    with pytest.raises(ValueError, match="batched"):
        pq._qdense(x[0, 0], wq, sw, b)


def _text_variables(seed=1):
    m = JTextEncoder(**TEXT, dtype=jnp.float32)
    ids = np.zeros((1, 16), np.int32)
    v = jax.jit(m.init, static_argnums=2)(jax.random.PRNGKey(seed), ids,
                                          False)
    return vm.nonzero(v, seed)


def _ids(seed=3):
    ids = np.random.default_rng(seed).integers(1, TEXT["vocab"], (3, 16))
    ids[1, 10:] = 0
    ids[2, :] = 0                                  # an empty row
    return ids.astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_quantize_text_encoder_against_jax(causal):
    v = _text_variables()
    jm = JTextEncoder(**TEXT, dtype=jnp.float32,
                      attention_fn=jmake_attention("dense", causal=causal))
    jf, jp = jq.quantize_text_encoder(jm, v)
    ids = _ids()
    want = np.asarray(jax.jit(jf)(jp, jnp.asarray(ids)))
    port = text_encoder_from_flax(
        v, heads=TEXT["heads"], dtype=torch.float32,
        attention_fn=make_attention_fn("dense", causal=causal))
    qf, qp = quantize_text_encoder(port)
    got = qf(qp, torch.from_numpy(ids).long()).numpy()
    vm.assert_close(got, want, RTOL, "pooled")
    for impl in ("pallas", "blockwise"):
        with pytest.raises(ValueError, match="dense attention only"):
            quantize_text_encoder(port.with_attention(make_attention_fn(impl)))


def test_text_featurizer_quantize_param_against_jax():
    v = _text_variables(seed=4)
    jmodule = JTextEncoder(**TEXT, dtype=jnp.float32)
    jloaded = JLoadedModel(JModelSchema(name="tiny", model_type="text"),
                           jmodule, v)
    ids = _ids(seed=5)
    want = JTextEncoderFeaturizer(model=jloaded, quantize=True,
                                  seqChunk=16).transform(
        JDataFrame({"tokens": ids}))["features"]
    port = text_encoder_from_flax(v, heads=TEXT["heads"],
                                  dtype=torch.float32)
    loaded = LoadedModel(ModelSchema(name="tiny", model_type="text"), port)
    stage = TextEncoderFeaturizer(model=loaded, quantize=True, seqChunk=16,
                                  device="cpu")
    got = stage.transform(DataFrame({"tokens": ids}))["features"]
    vm.assert_close(got, np.asarray(want), RTOL, "features")
    plain = TextEncoderFeaturizer(model=loaded, seqChunk=16, device="cpu") \
        .transform(DataFrame({"tokens": ids}))["features"]
    assert not np.array_equal(plain, got)
    with pytest.raises(ValueError, match="dense attention only"):
        TextEncoderFeaturizer(model=loaded, quantize=True, device="cpu",
                              attentionImpl="pallas").transform(
            DataFrame({"tokens": ids}))


def test_image_featurizer_quantize_param_against_jax():
    m, v = vm.jax_resnet("bottleneck")
    jschema = JModelSchema(name="tiny", input_size=32, layer_names=LAYERS)
    imgs = np.random.default_rng(9).integers(
        0, 256, (5, 40, 36, 3)).astype(np.uint8)
    kw = dict(quantize=True, miniBatchSize=2, inputCol="image")
    want = JImageFeaturizer(model=JLoadedModel(jschema, m, v), **kw) \
        .transform(JDataFrame({"image": imgs}))["features"]
    schema = ModelSchema(name="tiny", input_size=32, layer_names=LAYERS)
    port = resnet_from_flax(v, dtype=torch.float32)
    stage = ImageFeaturizer(model=LoadedModel(schema, port), device="cpu",
                            **kw)
    got = stage.transform(DataFrame({"image": imgs}))["features"]
    vm.assert_close(got, np.asarray(want), RTOL, "features")
    assert set(stage.last_transform_stats) == {
        "prep_ms", "dispatch_ms", "drain_ms", "total_ms"}
    with pytest.raises(ValueError, match="pooled endpoint only"):
        ImageFeaturizer(model=LoadedModel(schema, port), device="cpu",
                        cutOutputLayers=2, **kw).transform(
            DataFrame({"image": imgs}))
    vit = vit_from_flax(vm.jax_vit()[1], heads=vm.VIT["heads"])
    with pytest.raises(ValueError, match="ResNet zoo models only"):
        ImageFeaturizer(model=LoadedModel(ModelSchema(
            name="v", input_size=16, layer_names=("block1", "block2",
                                                  "pooled", "logits")),
            vit), device="cpu", **kw).transform(DataFrame({"image": imgs}))
