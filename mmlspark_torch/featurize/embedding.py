"""Word2Vec — skip-gram with negative sampling on the device.

Reference surface: SparkML ``Word2Vec`` (tested at
``core/ml/Word2VecSpec.scala`` — fit on token-list rows, ``transform``
averages word vectors per document, ``findSynonyms`` returns cosine
neighbors). The port of ``mmlspark_tpu/featurize/embedding.py``, whose
training is one jitted ``lax.scan`` per epoch. Here an epoch is a loop of
fixed-shape steps in torch on the stage's ``device`` with nothing read back
inside it:

- the (center, context) pairs are built on the host once (vectorized over
  window offsets) and live on the device;
- each epoch shuffles them with ``torch.randperm`` and draws every step's
  negatives from the unigram^0.75 distribution at once, both from one
  ``torch.Generator`` seeded from ``seed`` (so a fit is reproducible on one
  device, but not equal to the JAX package's ``jax.random`` draws);
- each step computes the loss's gradients in closed form and applies the
  per-row MEAN of the batch gradient with ``index_add_`` of the gradients
  and of the counts (the JAX package's ``scatter_row_mean``);
- the per-step losses stay on the device; an epoch's mean is read once,
  at the epoch's end, into ``Word2VecModel.epoch_losses``.

The initial input vectors come from the same numpy generator as the JAX
package's, so both fits start from the same table.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ..core import Estimator, Model, Param, TypeConverters as TC
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..core.dataframe import to_host


def skipgram_pairs(docs_ids: list[np.ndarray], window: int) -> np.ndarray:
    """Every (center, context) pair with ``0 < |i - j| <= window`` inside
    one document, as an [m, 2] int64 array."""
    if not docs_ids:
        return np.zeros((0, 2), np.int64)
    ids = np.concatenate(docs_ids).astype(np.int64)
    doc = np.repeat(np.arange(len(docs_ids)),
                    [len(d) for d in docs_ids])
    parts = []
    for off in range(-window, window + 1):
        if off == 0 or abs(off) >= len(ids):
            continue
        c = np.arange(max(0, -off), len(ids) - max(0, off))
        same = doc[c] == doc[c + off]
        parts.append(np.stack([ids[c[same]], ids[c[same] + off]], 1))
    return np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)


def _row_mean_step(table, idx, grads, lr):
    """Apply the PER-ROW MEAN of the batch gradient in place. A plain
    scatter-add sums every duplicate contribution into one step — with a
    small vocabulary (hundreds of duplicates per batch) that multiplies the
    effective rate by the duplicate count and diverges; the mean keeps each
    row's step at ``lr`` however often the batch touched it."""
    cnt = torch.zeros(table.shape[0], device=table.device,
                      dtype=table.dtype).index_add_(
        0, idx, torch.ones_like(idx, dtype=table.dtype))
    acc = torch.zeros_like(table).index_add_(0, idx, grads)
    table.sub_(lr * acc / cnt.clamp(min=1.0)[:, None])


def sgns_step(emb_in, emb_out, centers, contexts, negs, lr):
    """One skip-gram negative-sampling step on [B] centers, [B] contexts
    and [B, K] negatives: the loss (summed over the batch, a 0-d tensor)
    and the in-place per-row-mean updates of both tables, both from the
    tables as they were before the step."""
    vi, uo, un = emb_in[centers], emb_out[contexts], emb_out[negs]
    pos = (vi * uo).sum(-1)
    neg = torch.einsum("bd,bkd->bk", vi, un)
    loss = -(F.logsigmoid(pos).sum() + F.logsigmoid(-neg).sum())
    g_pos = -torch.sigmoid(-pos)                  # d loss / d pos
    g_neg = torch.sigmoid(neg)                    # d loss / d neg
    g_vi = g_pos[:, None] * uo + torch.einsum("bk,bkd->bd", g_neg, un)
    g_uo = g_pos[:, None] * vi
    g_un = g_neg[:, :, None] * vi[:, None, :]
    _row_mean_step(emb_in, centers, g_vi, lr)
    _row_mean_step(emb_out, torch.cat([contexts, negs.reshape(-1)]),
                   torch.cat([g_uo, g_un.reshape(-1, g_un.shape[-1])]), lr)
    return loss


class Word2Vec(Estimator, HasInputCol, HasOutputCol, HasDevice):
    """Fit skip-gram embeddings on a token-list column."""

    vectorSize = Param("vectorSize", "embedding width", TC.toInt,
                       default=100, has_default=True)
    windowSize = Param("windowSize", "context window radius", TC.toInt,
                       default=5, has_default=True)
    minCount = Param("minCount", "drop words rarer than this", TC.toInt,
                     default=5, has_default=True)
    maxIter = Param("maxIter", "training epochs", TC.toInt, default=1,
                    has_default=True)
    stepSize = Param("stepSize", "SGD learning rate", TC.toFloat,
                     default=0.025, has_default=True)
    numNegatives = Param("numNegatives", "negative samples per pair",
                         TC.toInt, default=5, has_default=True)
    batchSize = Param("batchSize", "pairs per scan step", TC.toInt,
                      default=1024, has_default=True)
    seed = Param("seed", "init/shuffle seed", TC.toInt, default=0,
                 has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="tokens", outputCol="features")

    def _fit(self, df):
        dev = self._device()
        raw_docs = df[self.getInputCol()]
        if any(isinstance(d, str) for d in raw_docs):
            # a str is an iterable of CHARACTERS — training on it would
            # silently fit character embeddings (SparkML's Word2Vec rejects
            # non-Array[String] columns at the schema level)
            raise TypeError(
                f"inputCol {self.getInputCol()!r} holds plain strings; "
                "Word2Vec expects token lists — split first (e.g. "
                "TextFeaturizer / s.split())")
        docs = [list(map(str, d)) if d is not None else []
                for d in raw_docs]
        counts = Counter(w for d in docs for w in d)
        vocab = sorted(w for w, c in counts.items()
                       if c >= self.get("minCount"))
        if not vocab:
            raise ValueError(
                "empty vocabulary: every token fell under "
                f"minCount={self.get('minCount')}")
        index = {w: i for i, w in enumerate(vocab)}
        pairs = skipgram_pairs(
            [np.asarray([index[w] for w in d if w in index], np.int64)
             for d in docs], self.get("windowSize"))
        if not len(pairs):
            raise ValueError("no (center, context) pairs: documents too "
                             "short for the window")

        V, D = len(vocab), self.get("vectorSize")
        rng = np.random.default_rng(self.get("seed"))
        emb_in = torch.as_tensor(
            rng.uniform(-0.5 / D, 0.5 / D, size=(V, D)),
            dtype=torch.float32).to(dev)
        emb_out = torch.zeros((V, D), dtype=torch.float32, device=dev)
        freq = np.asarray([counts[w] for w in vocab], np.float64) ** 0.75
        cdf = torch.as_tensor(np.cumsum(freq) / freq.sum(),
                              dtype=torch.float32, device=dev)

        pairs_dev = torch.as_tensor(pairs, device=dev)
        batch = min(self.get("batchSize"), len(pairs))
        steps = max(1, len(pairs) // batch)
        k_neg = self.get("numNegatives")
        lr = self.get("stepSize")
        gen = torch.Generator(device=dev).manual_seed(self.get("seed"))
        epoch_losses, epoch_seconds = [], []
        for _ in range(self.get("maxIter")):
            t0 = time.perf_counter()
            perm = torch.randperm(len(pairs), generator=gen, device=dev)
            sh = pairs_dev[perm[:steps * batch]].view(steps, batch, 2)
            u = torch.rand((steps, batch, k_neg), generator=gen, device=dev)
            negs = torch.searchsorted(cdf, u).clamp_(max=V - 1)
            losses = torch.empty(steps, dtype=torch.float32, device=dev)
            for s in range(steps):
                losses[s] = sgns_step(emb_in, emb_out, sh[s, :, 0],
                                      sh[s, :, 1], negs[s], lr)
            epoch_losses.append(float(losses.mean()))  # the epoch's one sync
            epoch_seconds.append(time.perf_counter() - t0)

        model = Word2VecModel() \
            .set("vocabulary", vocab) \
            .set("wordVectors", to_host(emb_in).tolist())
        self._copy_params_to(model)
        model.epoch_losses = epoch_losses
        model.epoch_seconds = epoch_seconds
        model.pairs_per_epoch = steps * batch
        return model


class Word2VecModel(Model, HasInputCol, HasOutputCol, HasDevice):
    vocabulary = Param("vocabulary", "fitted vocabulary (sorted)")
    wordVectors = Param("wordVectors", "[V, D] embedding rows")

    # set by Word2Vec.fit (not saved): each epoch's mean step loss and
    # wall seconds (to the end of its device work), and the pairs one
    # epoch trains on
    epoch_losses: list[float] | None = None
    epoch_seconds: list[float] | None = None
    pairs_per_epoch: int | None = None

    def _vectors(self) -> tuple[dict[str, int], torch.Tensor]:
        # wordVectors persists as a nested list (JSON-serializable); the
        # O(V·D) list → tensor parse is cached by identity and device, so
        # repeated transform/findSynonyms calls pay it once
        vocab = self.get("vocabulary")
        raw = self.get("wordVectors")
        dev = self._device()
        cached = getattr(self, "_vec_cache", None)
        if cached is not None and cached[0] is raw and cached[1] is vocab \
                and cached[2] == dev:
            return cached[3], cached[4]
        mat = torch.as_tensor(np.asarray(raw, np.float32)).to(dev)
        index = {w: i for i, w in enumerate(vocab)}
        self._vec_cache = (raw, vocab, dev, index, mat)
        return index, mat

    def getVectors(self) -> dict[str, np.ndarray]:
        index, mat = self._vectors()
        host = to_host(mat)
        return {w: host[i] for w, i in index.items()}

    def findSynonyms(self, word: str, num: int) -> list[tuple[str, float]]:
        """Cosine-nearest vocabulary words (the word itself excluded)."""
        index, mat = self._vectors()
        if word not in index:
            raise KeyError(f"{word!r} not in the fitted vocabulary")
        q = mat[index[word]]
        norms = torch.linalg.vector_norm(mat, dim=1) \
            * torch.linalg.vector_norm(q)
        sims = mat @ q / norms.clamp(min=1e-12)
        sims[index[word]] = -torch.inf
        top = torch.topk(sims, min(num, len(index))).indices
        vocab = self.get("vocabulary")
        sims_host, top_host = to_host(sims), to_host(top)
        return [(vocab[i], float(sims_host[i])) for i in top_host]

    def _transform(self, df):
        index, mat = self._vectors()
        rows, ids = [], []
        for r, doc in enumerate(df[self.getInputCol()]):
            for w in (doc or []):
                i = index.get(str(w))
                if i is not None:
                    rows.append(r)
                    ids.append(i)
        dev = mat.device
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        n, D = df.num_rows, mat.shape[1]
        sums = torch.zeros((n, D), dtype=torch.float32, device=dev) \
            .index_add_(0, rows_t, mat[ids_t])
        cnt = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
            0, rows_t, torch.ones_like(rows_t, dtype=torch.float32))
        return df.with_column(self.getOutputCol(),
                              sums / cnt.clamp(min=1.0)[:, None])
