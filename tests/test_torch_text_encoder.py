"""The text slice against the JAX package: raw strings → ``TokenIdEncoder``
→ ``TextEncoderFeaturizer`` → pooled embeddings.

Held, on the same seeded inputs and the same weights (carried across by
``text_encoder_from_flax``):
- token ids exactly (murmur hash mode and vocab-file mode);
- ``TextEncoder`` (depth 2, width 64, heads 4, mlp 128, vocab 1000, T=128,
  padded rows) in f32: pooled and tokens at atol 1e-4, for the dense,
  pallas and blockwise attention;
- the same encoder in bf16 at the tolerances stated at ``BF16_*``;
- the featurizer end to end for ``dense``, ``pallas`` (on the CPU the
  port's ``pallas`` runs ``flash_torch``; the JAX one its interpret mode)
  and ``blockwise``, f32 at atol 1e-4.
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
from mmlspark_tpu.featurize import TokenIdEncoder as JTokenIdEncoder
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_tpu.vw.murmur import murmur3_32 as jmurmur
from mmlspark_torch.core import DataFrame, Pipeline, load_stage
from mmlspark_torch.dl import (TextEncoder, TextEncoderFeaturizer,
                               make_attention_fn)
from mmlspark_torch.featurize import TokenIdEncoder
from mmlspark_torch.models import (LoadedModel, get_model,
                                   register_text_encoder,
                                   text_encoder_from_flax)
from mmlspark_torch.vw import murmur3_32

ARCH = dict(vocab=1000, width=64, depth=2, heads=4, mlp_dim=128)
F32_ATOL = 1e-4
# bf16: both packages round every Dense output, the GELU and the attention
# output to bf16, but XLA fuses elementwise chains and rounds once where
# PyTorch rounds after each op; the final-LN tokens (|x| up to ~4, where a
# bf16 ulp is 2^-6) then differ by a few ulps, and the pooled means over
# >= 50 tokens average most of that away.
BF16_TOKENS_ATOL = 0.0625
BF16_POOLED_ATOL = 1e-2
IMPLS = ("dense", "pallas", "blockwise")

WORDS = ("long context models embed entire documents in one pass while "
         "short notes take a single chunk of the sequence budget").split()


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


def make_docs(n=4, seed=0, max_words=150):
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(WORDS, size=rng.integers(1, max_words)))
            for _ in range(n)]
    docs[0] = docs[0].upper() + ", with Punctuation; and MIXED case!"
    docs.append("")                                   # no tokens at all
    return np.asarray(docs, object)


def padded_ids(seed=1, n=3, T=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, ARCH["vocab"], size=(n, T)).astype(np.int32)
    ids[0, 50:] = 0
    ids[2, 100:] = 0
    return ids


def shared(dtype: str):
    """A JAX TextEncoder's variables and the port's copy of them."""
    jmodule = JTextEncoder(**ARCH, dtype=getattr(jnp, dtype))
    variables = jmodule.init(jax.random.PRNGKey(0),
                             jnp.asarray(padded_ids()))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    port = text_encoder_from_flax(params, heads=ARCH["heads"],
                                  dtype=getattr(torch, dtype))
    return jmodule, variables, params, port


@pytest.fixture(scope="module")
def f32_weights():
    return shared("float32")


@pytest.fixture(scope="module")
def bf16_weights():
    return shared("bfloat16")


def encode_both(jmodule, variables, port, impl):
    ids = padded_ids()
    jm = jmodule.clone(attention_fn=jmake_attention(impl, block_size=64))
    want = jm.apply(variables, jnp.asarray(ids))
    pm = port.with_attention(make_attention_fn(impl, block_size=64))
    with torch.inference_mode():
        got = pm(torch.from_numpy(ids))
    assert got["pooled"].dtype == got["tokens"].dtype == torch.float32
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


class TestTokenIds:
    def test_murmur_matches(self):
        for s in ["", "a", "ab", "abc", "abcd", "token", "ünïcödé", "x" * 37]:
            b = s.encode("utf-8")
            for seed in (0, 7, 2 ** 31 + 5):
                assert murmur3_32(b, seed) == jmurmur(b, seed)

    def test_hash_ids_equal_exactly(self):
        docs = make_docs()
        kw = dict(maxLength=96, vocabSize=1000)
        want = JTokenIdEncoder(**kw).transform(
            JDataFrame({"text": docs}))["tokens"]
        got = TokenIdEncoder(**kw).transform(DataFrame({"text": docs}))
        np.testing.assert_array_equal(got["tokens"], np.asarray(want))
        assert got["tokens"].dtype == np.int32
        assert (got["tokens"][-1] == 0).all()          # the empty document

    def test_vocab_file_ids_equal_exactly(self, tmp_path):
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(WORDS[:10]) + "\n")
        docs = make_docs(seed=2)
        kw = dict(maxLength=64, vocabSize=50, vocabFile=str(path))
        want = JTokenIdEncoder(**kw).transform(
            JDataFrame({"text": docs}))["tokens"]
        got = TokenIdEncoder(**kw).transform(DataFrame({"text": docs}))
        np.testing.assert_array_equal(got["tokens"], np.asarray(want))
        assert (got["tokens"] == 1).any()              # out-of-vocabulary
        with pytest.raises(ValueError, match="raise vocabSize"):
            TokenIdEncoder(vocabSize=5, vocabFile=str(path)).transform(
                DataFrame({"text": docs}))


class TestTextEncoder:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_f32_matches_jax_on_shared_weights(self, f32_weights, impl):
        jmodule, variables, _, port = f32_weights
        got, want = encode_both(jmodule, variables, port, impl)
        for key in ("tokens", "pooled"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=F32_ATOL)

    def test_bf16_matches_jax_on_shared_weights(self, bf16_weights):
        jmodule, variables, _, port = bf16_weights
        got, want = encode_both(jmodule, variables, port, "dense")
        np.testing.assert_allclose(got["tokens"], want["tokens"], rtol=0,
                                   atol=BF16_TOKENS_ATOL)
        np.testing.assert_allclose(got["pooled"], want["pooled"], rtol=0,
                                   atol=BF16_POOLED_ATOL)

    def test_weights_carry_across_exactly(self, bf16_weights):
        _, _, params, port = bf16_weights
        assert port.dtype == torch.bfloat16
        sd = port.state_dict()
        assert (port.vocab, port.width, port.depth, port.mlp_dim) == (
            ARCH["vocab"], ARCH["width"], ARCH["depth"], ARCH["mlp_dim"])
        np.testing.assert_array_equal(sd["embed.weight"],
                                      params["embed"]["embedding"])
        blk = params["block1"]
        np.testing.assert_array_equal(sd["block1.qkv.weight"],
                                      blk["qkv"]["kernel"].T)
        np.testing.assert_array_equal(sd["block1.mlp_2.bias"],
                                      blk["mlp_2"]["bias"])
        np.testing.assert_array_equal(sd["block1.ln_2.weight"],
                                      blk["ln_2"]["scale"])
        np.testing.assert_array_equal(sd["ln.bias"], params["ln"]["bias"])
        assert all(v.dtype == torch.float32 for v in sd.values())

    def test_random_init_follows_flax_distributions(self):
        W = 256
        m = TextEncoder(vocab=4096, width=W, depth=1, heads=4, mlp_dim=512,
                        generator=torch.Generator().manual_seed(3))
        emb = m.embed.weight.detach()
        assert abs(float(emb.std()) / W ** -0.5 - 1) < 0.02
        qkv = m.block0.qkv.weight.detach()            # fan_in = W
        assert abs(float(qkv.std()) / W ** -0.5 - 1) < 0.03
        bound = 2 * W ** -0.5 / 0.87962566103423978
        assert float(qkv.abs().max()) <= bound
        assert float(m.block0.mlp_2.weight.detach().std()) < float(
            qkv.std())
        assert not m.block0.qkv.bias.any()
        assert (m.ln.weight == 1).all() and not m.ln.bias.any()
        again = TextEncoder(vocab=4096, width=W, depth=1, heads=4,
                            mlp_dim=512,
                            generator=torch.Generator().manual_seed(3))
        assert torch.equal(again.block0.qkv.weight, qkv)

    def test_padding_does_not_change_a_rows_embedding(self):
        g = torch.Generator().manual_seed(0)
        m = TextEncoder(**ARCH, dtype=torch.float32, generator=g)
        ids = torch.from_numpy(padded_ids())
        longer = torch.cat([ids, torch.zeros(3, 64, dtype=ids.dtype)], 1)
        with torch.inference_mode():
            torch.testing.assert_close(m(ids)["pooled"], m(longer)["pooled"],
                                       rtol=0, atol=1e-5)


def jax_featurizer_output(docs, jmodule, variables, impl):
    loaded = JLoadedModel(JModelSchema(name="shared", model_type="text"),
                          jmodule, variables)
    stages = [JTokenIdEncoder(maxLength=128, vocabSize=ARCH["vocab"]),
              JTextEncoderFeaturizer(attentionImpl=impl, model=loaded,
                                     seqChunk=64)]
    df = JDataFrame({"text": docs})
    for s in stages:
        df = s.transform(df)
    return np.asarray(df["features"])


class TestFeaturizer:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_end_to_end_matches_jax(self, f32_weights, impl):
        jmodule, variables, _, port = f32_weights
        docs = make_docs(n=3, seed=4, max_words=120)
        want = jax_featurizer_output(docs, jmodule, variables, impl)
        pipe = Pipeline(stages=[
            TokenIdEncoder(maxLength=128, vocabSize=ARCH["vocab"]),
            TextEncoderFeaturizer(attentionImpl=impl, seqChunk=64,
                                  device="cpu",
                                  model=LoadedModel(get_model(
                                      "TextEncoderBase"), port))])
        got = pipe.fit(DataFrame({"text": docs})).transform(
            DataFrame({"text": docs}))["features"]
        assert got.shape == (len(docs), ARCH["width"])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)

    def test_random_init_round_trips_save_load(self, tmp_path):
        df = DataFrame({"tokens": padded_ids(seed=5)})
        stage = TextEncoderFeaturizer(vocabSize=1000, width=32, depth=1,
                                      heads=2, seed=11, seqChunk=64,
                                      device="cpu", attentionImpl="pallas")
        out = stage.transform(df)["features"]
        assert out.shape == (3, 32) and np.isfinite(out).all()
        stage.save(str(tmp_path / "stage"))
        loaded = load_stage(str(tmp_path / "stage"))
        assert isinstance(loaded, TextEncoderFeaturizer)
        assert loaded.getSeed() == 11 and loaded.getDevice() == "cpu"
        np.testing.assert_array_equal(loaded.transform(df)["features"], out)
        other = TextEncoderFeaturizer(vocabSize=1000, width=32, depth=1,
                                      heads=2, seed=12, seqChunk=64,
                                      device="cpu")
        assert not np.allclose(other.transform(df)["features"], out)

    def test_loaded_model_round_trips_save_load(self, tmp_path):
        schema = register_text_encoder("TinyTextEncoder", **ARCH)
        module = schema.builder(generator=torch.Generator().manual_seed(1))
        assert isinstance(module, TextEncoder) and module.depth == 2
        stage = TextEncoderFeaturizer(
            model=LoadedModel(schema, module),
            device="cpu", seqChunk=64, attentionImpl="blockwise")
        df = DataFrame({"tokens": padded_ids(seed=6)})
        out = stage.transform(df)["features"]
        stage.save(str(tmp_path / "stage"))
        np.testing.assert_array_equal(
            load_stage(str(tmp_path / "stage")).transform(df)["features"],
            out)

    def test_raises(self, monkeypatch):
        df = DataFrame({"tokens": padded_ids(seed=7)})
        small = dict(vocabSize=1000, width=32, depth=1, heads=2,
                     device="cpu")
        # a zoo name without its checkpoint refuses random weights
        monkeypatch.delenv("MMLSPARK_TPU_MODEL_DIR", raising=False)
        with pytest.raises(FileNotFoundError, match="allow_random_init"):
            TextEncoderFeaturizer(modelName="TextEncoderBase",
                                  **small).transform(df)
        with pytest.raises(ValueError, match="dense attention only"):
            TextEncoderFeaturizer(quantize=True, attentionImpl="pallas",
                                  **small).transform(df)
        with pytest.raises(NotImplementedError, match="item 10"):
            TextEncoderFeaturizer(mesh=object(), **small)
        for impl in ("ring", "ring_flash", "ulysses", "ulysses_flash"):
            with pytest.raises(NotImplementedError, match="item 10"):
                TextEncoderFeaturizer(attentionImpl=impl,
                                      **small).transform(df)
        with pytest.raises(ValueError, match="unknown attention"):
            make_attention_fn("sparse")
        with pytest.raises(ValueError, match="multiple of 2"):
            TextEncoderFeaturizer(vocabSize=1000, width=30, heads=4,
                                  device="cpu").transform(df)
        with pytest.raises(TypeError, match="not a text encoder"):
            TextEncoderFeaturizer(
                model=LoadedModel(get_model("TextEncoderBase"),
                                  torch.nn.Linear(2, 2)),
                device="cpu").transform(df)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        stage = TextEncoderFeaturizer(vocabSize=1000, width=32, depth=1,
                                      heads=2)
        assert stage.getDevice() == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            stage.transform(df)
