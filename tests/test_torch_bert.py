"""The port's BERT ingestion against the JAX package: ``BertEncoder``,
``bert_encoder_from_torch``/``bert_encoder_from_flax``, the zoo entry and the
featurizer over an ingested checkpoint.

Held, on the seeded BERT-mini of ``tests/test_bert_convert.py`` (HF layout,
vocab 99, width 32, depth 2, heads 2, mlp 64, max_len 64, f32):
- the converter's parameters bit-equal to ``torch_bert_to_flax``'s (the
  ``bert.`` prefix, ``gamma``/``beta`` names, ``cls.*`` dropped, the
  ``position_ids`` buffer ignored; a leftover key raises; no head count
  warns and assumes ``width // 64``);
- ``tokens``, ``pooled``, ``cls`` and ``cls_pooled`` within 1e-4 of the JAX
  module's, dense and pallas (JAX in interpret mode, the port's plain
  K2a), and a module built from the JAX params likewise;
- ``max_len`` overflow raises; ``remat=True`` computes the same outputs and
  gradients;
- ``TextEncoderFeaturizer`` over a ``LoadedModel`` within 1e-4 of the JAX
  featurizer, and the JAX package's ingestion chain end to end (WordPiece →
  featurizer → the torch oracle's mean pool), without ``save_converted``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.dl.bert import BertEncoder as JBertEncoder
from mmlspark_tpu.dl.text_encoder import \
    TextEncoderFeaturizer as JTextEncoderFeaturizer
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_tpu.models.convert import (bert_encoder_from_torch as
                                         jbert_from_torch)
from mmlspark_tpu.models.convert import torch_bert_to_flax
from mmlspark_tpu.models.zoo import LoadedModel as JLoadedModel
from mmlspark_tpu.models.zoo import ModelSchema as JModelSchema
from mmlspark_torch.core import DataFrame
from mmlspark_torch.dl import (BertEncoder, TextEncoderFeaturizer,
                               make_attention_fn)
from mmlspark_torch.featurize import WordPieceTokenizerModel
from mmlspark_torch.models import (LoadedModel, bert_encoder_from_flax,
                                   bert_encoder_from_torch, get_model,
                                   register_bert_encoder)
from test_bert_convert import (DEPTH, HEADS, MAXLEN, MLP, VOCAB, VOCAB_TXT,
                               WIDTH, make_bert_state_dict,
                               torch_bert_forward)

ATOL = 1e-4
IMPLS = ("dense", "pallas")


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


def padded_ids(T=32, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, size=(3, T)).astype(np.int32)
    ids[:, 0] = 2                                  # [CLS]
    ids[1, 20:] = 0
    ids[2, 9:] = 0
    return ids


@pytest.fixture(scope="module")
def ingested():
    sd = make_bert_state_dict(seed=0, prefix="bert.", lm_head=True)
    jmodule, variables = jbert_from_torch(sd, heads=HEADS)
    return sd, jmodule, variables, bert_encoder_from_torch(sd, heads=HEADS)


def flax_to_port_names(params):
    """The JAX params as a flat dict under the port's parameter names."""
    out = {}
    for top, sub in params.items():
        name = {"type": "typ", "pooler": "pooler_dense"}.get(top, top)
        if top.startswith("block"):
            for mod, leaves in sub.items():
                for leaf, a in leaves.items():
                    out[f"{name}.{mod}.{leaf}"] = a
        else:
            for leaf, a in sub.items():
                out[f"{name}.{leaf}"] = a
    port = {}
    for key, a in out.items():
        a = np.asarray(a)
        mod, leaf = key.rsplit(".", 1)
        if leaf == "kernel":
            port[f"{mod}.weight"] = a.T
        elif leaf in ("scale", "embedding"):
            port[f"{mod}.weight"] = a
        else:
            port[key] = a
    return port


class TestConvert:
    def test_params_bit_equal_to_torch_bert_to_flax(self, ingested):
        sd, _, variables, port = ingested
        want = flax_to_port_names(variables["params"])
        got = {k: v.numpy() for k, v in port.state_dict().items()}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (port.vocab, port.width, port.depth, port.heads,
                port.mlp_dim, port.max_len, port.type_vocab,
                port.pooler) == (VOCAB, WIDTH, DEPTH, HEADS, MLP, MAXLEN, 2,
                                 True)

    def test_older_names_buffer_and_leftovers(self):
        sd = make_bert_state_dict(seed=2, pooler=False)
        old = {}
        for k, v in sd.items():
            if "LayerNorm" in k:
                k = k.replace(".weight", ".gamma").replace(".bias", ".beta")
            old[k] = v
        old["embeddings.position_ids"] = torch.arange(MAXLEN)[None]
        jvars, arch = torch_bert_to_flax(old, heads=HEADS)
        port = bert_encoder_from_torch(old, config={"num_attention_heads":
                                                    HEADS})
        assert not port.pooler and arch["pooler"] is False
        want = flax_to_port_names(jvars["params"])
        for k, v in port.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        bad = dict(sd, **{"encoder.layer.0.extra.weight": torch.zeros(2)})
        for convert in (torch_bert_to_flax, bert_encoder_from_torch):
            with pytest.raises(ValueError, match="unconverted"):
                convert(bad, heads=HEADS)
        with pytest.raises(ValueError, match="not a BERT"):
            bert_encoder_from_torch({
                k: v for k, v in sd.items() if "encoder.layer" not in k},
                heads=HEADS)
        with pytest.warns(UserWarning, match="head count not provided"):
            guessed = bert_encoder_from_torch(sd)
        assert guessed.heads == max(WIDTH // 64, 1)

    def test_from_flax_equals_from_torch(self, ingested):
        _, _, variables, port = ingested
        params = jax.tree.map(np.asarray, variables)
        again = bert_encoder_from_flax(params, heads=HEADS)
        for (k, a), (k2, b) in zip(port.state_dict().items(),
                                   again.state_dict().items()):
            assert k == k2 and torch.equal(a, b)


class TestEncoder:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_outputs_match_jax(self, ingested, impl):
        _, jmodule, variables, port = ingested
        ids = padded_ids()
        jm = jmodule.clone(attention_fn=jmake_attention(impl, block_size=16))
        want = jm.apply(variables, jnp.asarray(ids))
        pm = port.with_attention(make_attention_fn(impl))
        with torch.inference_mode():
            got = pm(torch.from_numpy(ids))
        assert sorted(got) == sorted(want) == ["cls", "cls_pooled",
                                               "pooled", "tokens"]
        for key in want:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=0,
                                       atol=ATOL, err_msg=key)
        assert got["pooled"].dtype == torch.float32

    def test_overflow_raises_and_remat(self, ingested):
        _, _, _, port = ingested
        with pytest.raises(ValueError, match="position table"):
            port(torch.ones(1, MAXLEN + 1, dtype=torch.int32))
        ids = torch.from_numpy(padded_ids())
        remat = port.with_attention(make_attention_fn("pallas"))
        remat.remat = True
        plain = port.with_attention(make_attention_fn("pallas"))
        grads = []
        for m in (plain, remat):
            out = m(ids, train=True)
            (out["pooled"].square().sum() + out["cls_pooled"].sum()).backward()
            grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        for n in grads[0]:
            torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0,
                                       atol=1e-6, msg=n)

    def test_fresh_module_and_zoo_entry(self):
        schema = register_bert_encoder("BertMiniPort", vocab=VOCAB,
                                       width=WIDTH, depth=DEPTH, heads=HEADS,
                                       mlp_dim=MLP, max_len=MAXLEN,
                                       seq_len=128)
        assert get_model("BertMiniPort") is schema
        assert schema.input_size == MAXLEN          # clamped to max_len
        assert schema.layer_names[-3:] == ("tokens", "pooled", "cls")
        m = schema.builder(generator=torch.Generator().manual_seed(0))
        assert isinstance(m, BertEncoder) and m.max_len == MAXLEN
        out = m(torch.from_numpy(padded_ids()))
        assert out["tokens"].shape == (3, 32, WIDTH)
        assert torch.isfinite(out["cls_pooled"]).all()


class TestFeaturizer:
    @pytest.mark.parametrize("impl", IMPLS)
    def test_loaded_model_matches_jax_featurizer(self, ingested, impl):
        _, jmodule, variables, port = ingested
        ids = padded_ids()
        schema = JModelSchema(name="bert-mini", model_type="text")
        want = JTextEncoderFeaturizer(
            attentionImpl=impl, seqChunk=16, inputCol="tokens",
            model=JLoadedModel(schema, jmodule, variables)).transform(
            JDataFrame({"tokens": ids}))["features"]
        stage = TextEncoderFeaturizer(
            attentionImpl=impl, seqChunk=16, inputCol="tokens",
            device="cpu", model=LoadedModel(
                get_model("TextEncoderBase"), port))
        got = stage.transform(DataFrame({"tokens": ids}))["features"]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)

    def test_ingested_end_to_end(self):
        """The mirror of ``TestIngestedEndToEnd`` without
        ``save_converted``: foreign state dict + vocabulary → converted
        module + WordPiece → the featurizer serving the foreign weights,
        against the torch oracle's mean pool."""
        sd = make_bert_state_dict()
        schema = register_bert_encoder("BertMiniTestPort", vocab=VOCAB,
                                       width=WIDTH, depth=DEPTH, heads=HEADS,
                                       mlp_dim=MLP, max_len=MAXLEN)
        loaded = LoadedModel(schema, bert_encoder_from_torch(sd,
                                                             heads=HEADS))
        tok = WordPieceTokenizerModel.from_vocab(
            VOCAB_TXT[:VOCAB] + [f"tok{i}" for i in
                                 range(VOCAB - len(VOCAB_TXT))],
            maxLength=16)
        feat = TextEncoderFeaturizer(model=loaded, inputCol="tokens",
                                     outputCol="features", seqChunk=16,
                                     attentionImpl="pallas", device="cpu")
        df = DataFrame({"text": np.array(
            ["the cat sat", "unable , the mat ."], object)})
        emb = np.asarray(feat.transform(tok.transform(df))["features"])
        assert emb.shape == (2, WIDTH) and np.isfinite(emb).all()
        ids = np.asarray(tok.transform(df)["tokens"], np.int32)
        want_tok = torch_bert_forward(sd, ids)["tokens"].numpy()
        mask = (ids != 0)[..., None]
        want = (want_tok * mask).sum(1) / mask.sum(1)
        np.testing.assert_allclose(emb, want, atol=1e-4, rtol=1e-3)
        with pytest.raises(TypeError, match="not a text encoder"):
            TextEncoderFeaturizer(model=LoadedModel(schema, torch.nn.Linear(
                2, 2)), device="cpu").transform(
                DataFrame({"tokens": ids}))
