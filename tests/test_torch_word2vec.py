"""The port's Word2Vec against the JAX package's, on the CPU.

The fits draw their shuffles and negatives from different generators
(``torch.Generator`` against ``jax.random``), so they cannot agree bit for
bit. Held instead:

- one skip-gram negative-sampling step (``sgns_step``: closed-form
  gradients, per-row-mean ``index_add_`` updates) equals the JAX package's
  step (``value_and_grad`` of its loss and its ``scatter_row_mean``) on the
  same tables, batch and negatives, within 1e-6;
- the (center, context) pairs are the JAX package's pairs, as a multiset;
- both fits start from the same table (``maxIter=0``), and a port fit is
  reproducible from its seed;
- on a planted-group corpus both packages' fits put the nearest neighbour
  of at least 90 % of the words in the word's own group, and the port's
  epoch losses are finite and fall;
- ``Word2VecModel.transform`` and ``findSynonyms`` on the same vectors match
  the JAX package's within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mmlspark_tpu.featurize as jf
from mmlspark_tpu.core import DataFrame as JDataFrame
import mmlspark_torch.featurize as tf
from mmlspark_torch.core import DataFrame
from mmlspark_torch.featurize.embedding import sgns_step, skipgram_pairs

ATOL = 1e-6
QUALITY_MIN = 0.9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_step(e_in, e_out, centers, contexts, negs, lr):
    """The body of the JAX package's epoch scan
    (``mmlspark_tpu/featurize/embedding.py:50-85``) for one batch."""
    def scatter_row_mean(table, idx, grads):
        cnt = jnp.zeros((table.shape[0], 1), table.dtype).at[idx].add(1.0)
        acc = jnp.zeros_like(table).at[idx].add(grads)
        return table - lr * acc / jnp.maximum(cnt, 1.0)

    def loss_fn(vi, uo, un):
        pos = jnp.sum(vi * uo, axis=-1)
        neg = jnp.einsum("bd,bkd->bk", vi, un,
                         preferred_element_type=jnp.float32)
        return -(jnp.sum(jax.nn.log_sigmoid(pos))
                 + jnp.sum(jax.nn.log_sigmoid(-neg)))

    vi, uo, un = e_in[centers], e_out[contexts], e_out[negs]
    loss, (gvi, guo, gun) = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2))(vi, uo, un)
    e_in = scatter_row_mean(e_in, centers, gvi)
    out_idx = jnp.concatenate([contexts, negs.reshape(-1)])
    out_g = jnp.concatenate([guo, gun.reshape(-1, gun.shape[-1])])
    return scatter_row_mean(e_out, out_idx, out_g), e_in, loss


def test_sgns_step_matches_jax():
    rng = np.random.default_rng(1)
    V, D, B, K = 30, 16, 64, 5
    e_in = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    e_out = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    centers = rng.integers(0, V, B)             # duplicates on purpose
    contexts = rng.integers(0, V, B)
    negs = rng.integers(0, V, (B, K))
    want_out, want_in, want_loss = _jax_step(
        jnp.asarray(e_in), jnp.asarray(e_out), jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(negs), 0.05)
    t_in, t_out = torch.tensor(e_in), torch.tensor(e_out)
    loss = sgns_step(t_in, t_out, torch.tensor(centers),
                     torch.tensor(contexts), torch.tensor(negs), 0.05)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    np.testing.assert_allclose(t_in.numpy(), np.asarray(want_in), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(want_out), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("window", [1, 2, 5])
def test_skipgram_pairs_are_the_jax_pairs(window):
    rng = np.random.default_rng(window)
    docs = [rng.integers(0, 9, n) for n in (0, 1, 2, 7, 12, 3)]
    want = []                 # the JAX package's loop (embedding.py:134-140)
    for ids in docs:
        ids = list(ids)
        for i, c in enumerate(ids):
            for j in range(max(0, i - window),
                           min(len(ids), i + window + 1)):
                if j != i:
                    want.append((c, ids[j]))
    got = skipgram_pairs(docs, window)
    assert got.shape == (len(want), 2)
    assert sorted(map(tuple, got.tolist())) == sorted(want)


def _planted(groups=20, size=8, sentences=600, length=12, seed=0):
    """Sentences of ``length`` words, each drawn from one group's words."""
    rng = np.random.default_rng(seed)
    docs = np.empty(sentences, object)
    docs[:] = [[f"g{g}w{w}" for w in rng.integers(0, size, length)]
               for g in rng.integers(0, groups, sentences)]
    return docs


def _in_group_share(model) -> float:
    vocab = model.get("vocabulary")
    return np.mean([model.findSynonyms(w, 1)[0][0].split("w")[0]
                    == w.split("w")[0] for w in vocab])


W2V = dict(vectorSize=32, windowSize=5, numNegatives=5, maxIter=5,
           minCount=1, batchSize=256, seed=3)


def test_both_fits_find_the_planted_groups():
    docs = _planted()
    jmodel = jf.Word2Vec(**W2V).fit(JDataFrame({"tokens": docs}))
    tmodel = tf.Word2Vec(**W2V, device="cpu").fit(DataFrame({"tokens": docs}))
    assert tmodel.get("vocabulary") == jmodel.get("vocabulary")
    assert _in_group_share(jmodel) >= QUALITY_MIN
    assert _in_group_share(tmodel) >= QUALITY_MIN
    losses = tmodel.epoch_losses
    assert len(losses) == W2V["maxIter"] and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    again = tf.Word2Vec(**W2V, device="cpu").fit(DataFrame({"tokens": docs}))
    np.testing.assert_array_equal(np.asarray(again.get("wordVectors")),
                                  np.asarray(tmodel.get("wordVectors")))


def test_fits_start_from_the_same_table():
    docs = _planted(sentences=50)
    kw = dict(W2V, maxIter=0)
    jmodel = jf.Word2Vec(**kw).fit(JDataFrame({"tokens": docs}))
    tmodel = tf.Word2Vec(**kw, device="cpu").fit(DataFrame({"tokens": docs}))
    np.testing.assert_array_equal(np.asarray(tmodel.get("wordVectors")),
                                  np.asarray(jmodel.get("wordVectors")))


def test_transform_and_synonyms_match_jax_on_the_same_vectors():
    docs = _planted(sentences=80, seed=5)
    tmodel = tf.Word2Vec(**dict(W2V, maxIter=2), device="cpu").fit(
        DataFrame({"tokens": docs}))
    jmodel = jf.Word2VecModel(inputCol="tokens", outputCol="features") \
        .set("vocabulary", tmodel.get("vocabulary")) \
        .set("wordVectors", tmodel.get("wordVectors"))
    probe = np.empty(5, object)
    probe[:] = [list(docs[0]), ["unknown", "g1w1", "g1w1"], [], None,
                ["nothing", "known"]]
    got = tmodel.transform(DataFrame({"tokens": probe}))["features"]
    want = jmodel.transform(JDataFrame({"tokens": probe}))["features"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not got[2:].any()
    for word in tmodel.get("vocabulary")[:20]:
        t_syn, j_syn = tmodel.findSynonyms(word, 5), \
            jmodel.findSynonyms(word, 5)
        assert [w for w, _ in t_syn] == [w for w, _ in j_syn]
        np.testing.assert_allclose([s for _, s in t_syn],
                                   [s for _, s in j_syn], rtol=0, atol=ATOL)
    vecs = tmodel.getVectors()
    assert set(vecs) == set(jmodel.getVectors())
    np.testing.assert_array_equal(vecs["g1w1"], jmodel.getVectors()["g1w1"])


def test_both_reject_plain_strings_and_empty_vocabularies():
    text = np.asarray(["a plain string", "another"], object)
    rare = np.empty(2, object)
    rare[:] = [["a"], ["b"]]
    for est, frame in ((jf.Word2Vec(), JDataFrame),
                       (tf.Word2Vec(device="cpu"), DataFrame)):
        with pytest.raises(TypeError, match="plain strings"):
            est.fit(frame({"tokens": text}))
        with pytest.raises(ValueError, match="empty vocabulary"):
            est.fit(frame({"tokens": rare}))
