"""Text featurization.

Reference ``featurize/text/TextFeaturizer.scala`` (tokenize → n-gram →
hashingTF → IDF pipeline builder), ``MultiNGram.scala`` (concatenated n-gram
ranges), ``PageSplitter.scala`` (split long documents into bounded-length
pages). The port of ``mmlspark_tpu/featurize/text.py``: tokenizers, n-grams,
stop words, hashing TF (a stable crc32, so featurization is reproducible
across processes and equal to the JAX package's), the IDF fit, BPE and
WordPiece run on the host, as there; ``IDFModel``'s tf·idf product runs in
torch on its ``device``. ``TokenIdEncoder`` gives the text encoder its ids.
"""

from __future__ import annotations

import os
import re
import zlib

import numpy as np
import torch

from ..core import (Estimator, Model, Param, StageListParam, Transformer,
                    TypeConverters as TC)
from ..core.compile import device_constant, run_traced
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..core.dataframe import readable_dtype
from ..vw.murmur import murmur3_32


def _tokenize(text: str, lower: bool, pattern: str, *,
              gaps: bool = True, min_len: int = 1) -> list[str]:
    """THE tokenization path: None-safe, optional lowercase, gaps-split or
    token-find regex, minimum token length."""
    if text is None:
        return []
    if lower:
        text = text.lower()
    parts = re.split(pattern, text) if gaps else re.findall(pattern, text)
    return [t for t in parts if len(t) >= max(min_len, 1)]


def _ngrams(tokens: list[str], n: int) -> list[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


def _hash_tf(grams: list[str], width: int, binary: bool) -> np.ndarray:
    vec = np.zeros(width, dtype=np.float32)
    for g in grams:
        vec[zlib.crc32(g.encode("utf-8")) % width] += 1.0
    if binary:
        vec = (vec > 0).astype(np.float32)
    return vec


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    toLowercase = Param("toLowercase", "lowercase before splitting",
                        TC.toBoolean, default=True)
    pattern = Param("pattern", "regex split pattern", TC.toString,
                    default=r"\W+")
    gaps = Param("gaps", "pattern matches gaps between tokens (True, "
                 "Spark RegexTokenizer default) or the tokens "
                 "themselves (False)", TC.toBoolean, default=True)
    minTokenLength = Param("minTokenLength",
                           "drop tokens shorter than this", TC.toInt,
                           default=1)

    def _transform(self, df):
        lower, pat = self.getToLowercase(), self.getPattern()
        gaps, min_len = self.get("gaps"), self.get("minTokenLength")
        col = df[self.getInputCol()]
        out = np.empty(len(col), dtype=object)
        out[:] = [_tokenize(v, lower, pat, gaps=gaps, min_len=min_len)
                  for v in col.tolist()]
        return df.with_column(self.getOutputCol(), out)


class NGram(Transformer, HasInputCol, HasOutputCol):
    n = Param("n", "n-gram length", TC.toInt, default=2)

    def _transform(self, df):
        n = self.getN()
        col = df[self.getInputCol()]
        out = np.empty(len(col), dtype=object)
        out[:] = [_ngrams(list(v), n) for v in col.tolist()]
        return df.with_column(self.getOutputCol(), out)


# a compact English stop list (Spark's StopWordsRemover ships a longer
# one; this covers the high-frequency core the reference relies on)
_ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are as at be because
been before being below between both but by could did do does doing down
during each few for from further had has have having he her here hers
herself him himself his how i if in into is it its itself just me more
most my myself no nor not now of off on once only or other our ours
ourselves out over own same she should so some such than that the their
theirs them themselves then there these they this those through to too
under until up very was we were what when where which while who whom why
will with you your yours yourself yourselves
""".split())


class StopWordsRemover(Transformer, HasInputCol, HasOutputCol):
    """Drop stop words from a token-list column (the Spark
    ``StopWordsRemover`` the reference's TextFeaturizer composes)."""

    stopWords = Param("stopWords", "custom stop word list (empty = the "
                      "language default)", TC.toListString, default=[])
    caseSensitive = Param("caseSensitive", "match case-sensitively",
                          TC.toBoolean, default=False)
    language = Param("language", "built-in stop list to use",
                     TC.toString, default="english")

    def _stop_set(self):
        words = self.get("stopWords")
        if not words:
            lang = self.get("language")
            if lang != "english":
                raise ValueError(
                    f"no built-in stop list for {lang!r}; pass stopWords")
            words = _ENGLISH_STOP_WORDS
        if self.get("caseSensitive"):
            return frozenset(words)
        return frozenset(w.lower() for w in words)

    def _transform(self, df):
        stop = self._stop_set()
        cs = self.get("caseSensitive")
        col = df[self.getInputCol()]
        out = np.empty(len(col), dtype=object)
        out[:] = [[t for t in toks
                   if (t if cs else t.lower()) not in stop]
                  for toks in col.tolist()]
        return df.with_column(self.getOutputCol(), out)


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams for each length in ``lengths`` (reference
    ``featurize/text/MultiNGram.scala``)."""

    lengths = Param("lengths", "n-gram lengths to include", TC.toListInt,
                    default=[1, 2, 3])

    def _transform(self, df):
        lengths = self.getLengths()
        col = df[self.getInputCol()]
        out = np.empty(len(col), dtype=object)
        out[:] = [[g for n in lengths for g in _ngrams(list(v), n)]
                  for v in col.tolist()]
        return df.with_column(self.getOutputCol(), out)


class HashingTF(Transformer, HasInputCol, HasOutputCol):
    numFeatures = Param("numFeatures", "hash space width", TC.toInt,
                        default=1 << 18)
    binary = Param("binary", "binary term presence instead of counts",
                   TC.toBoolean, default=False)

    def _transform(self, df):
        width, binary = self.getNumFeatures(), self.getBinary()
        col = df[self.getInputCol()]
        mat = np.stack([_hash_tf(list(v), width, binary)
                        for v in col.tolist()])
        return df.with_column(self.getOutputCol(), mat)


class IDF(Estimator, HasInputCol, HasOutputCol, HasDevice):
    minDocFreq = Param("minDocFreq", "min docs a term must appear in",
                       TC.toInt, default=0)

    def _fit(self, df):
        tf = np.asarray(df[self.getInputCol()], dtype=np.float32)
        n_docs = tf.shape[0]
        doc_freq = (tf > 0).sum(axis=0)
        idf = np.log((n_docs + 1.0) / (doc_freq + 1.0)).astype(np.float32)
        idf[doc_freq < self.getMinDocFreq()] = 0.0
        model = IDFModel().set("idf", idf.tolist())
        self._copy_params_to(model)
        return model


class IDFModel(Model, HasInputCol, HasOutputCol, HasDevice):
    """Fitted IDF reweighting: the tf·idf product runs in torch on the
    stage's ``device`` (the fitted frequencies live in the ``idf``
    param), and as a traced form inside a fused segment."""

    idf = Param("idf", "inverse document frequencies")

    def _transform(self, df):
        ic, oc = self.getInputCol(), self.getOutputCol()
        tf = df[ic]
        if tf.dtype == object:
            tf = np.stack([np.asarray(v) for v in tf])
        host = run_traced(self, {ic: np.asarray(tf, np.float32)},
                          self._device())
        return df.with_column(oc, host[oc])

    def _trace_ok(self, schema, n_rows):
        ic = self.getInputCol()
        if ic not in schema or not readable_dtype(schema[ic][0]):
            return False
        trailing = schema[ic][1]
        # elementwise against a [width] vector: the column's last axis
        # must match the fitted width (broadcast would silently produce
        # garbage on a mismatched matrix)
        idf = self.get("idf")
        width = int(np.size(idf)) if idf is not None else 0
        return len(trailing) == 1 and width > 0 \
            and trailing[0] == width

    def _trace(self, cols):
        out = dict(cols)
        tf = cols[self.getInputCol()].to(torch.float32)
        idf = device_constant(self.get("idf"), np.float32, tf.device)
        out[self.getOutputCol()] = tf * idf
        return out


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol, HasDevice):
    """One-stop text → feature-vector pipeline builder.

    Reference ``featurize/text/TextFeaturizer.scala:1-586``: composes
    tokenizer, optional n-grams, hashingTF, optional IDF into a PipelineModel.
    ``device`` is the fitted ``IDFModel``'s.
    """

    useTokenizer = Param("useTokenizer", "tokenize input strings",
                         TC.toBoolean, default=True)
    toLowercase = Param("toLowercase", "lowercase text", TC.toBoolean,
                        default=True)
    useNGram = Param("useNGram", "add n-grams", TC.toBoolean, default=False)
    nGramLength = Param("nGramLength", "n-gram length", TC.toInt, default=2)
    numFeatures = Param("numFeatures", "hash space width", TC.toInt,
                        default=1 << 18)
    binary = Param("binary", "binary term counts", TC.toBoolean,
                   default=False)
    useIDF = Param("useIDF", "apply IDF weighting", TC.toBoolean,
                   default=True)
    minDocFreq = Param("minDocFreq", "IDF min doc frequency", TC.toInt,
                       default=0)
    minTokenLength = Param("minTokenLength",
                           "drop tokens shorter than this", TC.toInt,
                           default=1)
    tokenizerPattern = Param("tokenizerPattern", "tokenizer regex",
                             TC.toString, default=r"\W+")
    tokenizerGaps = Param("tokenizerGaps", "pattern matches gaps (True) "
                          "or tokens (False)", TC.toBoolean, default=True)
    useStopWordsRemover = Param("useStopWordsRemover",
                                "drop stop words after tokenizing",
                                TC.toBoolean, default=False)
    stopWords = Param("stopWords", "custom stop word list",
                      TC.toListString, default=[])
    caseSensitiveStopWords = Param("caseSensitiveStopWords",
                                   "stop-word matching is case-sensitive",
                                   TC.toBoolean, default=False)
    defaultStopWordLanguage = Param("defaultStopWordLanguage",
                                    "built-in stop list", TC.toString,
                                    default="english")

    def _fit(self, df):
        from ..core import PipelineModel
        in_col, out_col = self.getInputCol(), self.getOutputCol()
        stages = []
        cur_col = in_col
        cur = df
        if self.getUseTokenizer():
            tok = Tokenizer(inputCol=cur_col, outputCol=f"{out_col}_tokens",
                            toLowercase=self.getToLowercase(),
                            pattern=self.get("tokenizerPattern"),
                            gaps=self.get("tokenizerGaps"),
                            minTokenLength=self.get("minTokenLength"))
            stages.append(tok)
            cur = tok.transform(cur)
            cur_col = f"{out_col}_tokens"
        if self.get("useStopWordsRemover"):
            if not self.getUseTokenizer():
                raise ValueError(
                    "useStopWordsRemover needs useTokenizer=True "
                    "(stop words apply to token lists)")
            sw = StopWordsRemover(
                inputCol=cur_col, outputCol=f"{out_col}_nostop",
                stopWords=self.get("stopWords"),
                caseSensitive=self.get("caseSensitiveStopWords"),
                language=self.get("defaultStopWordLanguage"))
            stages.append(sw)
            cur = sw.transform(cur)
            cur_col = f"{out_col}_nostop"
        if self.getUseNGram():
            ng = NGram(inputCol=cur_col, outputCol=f"{out_col}_ngrams",
                       n=self.getNGramLength())
            stages.append(ng)
            cur = ng.transform(cur)
            cur_col = f"{out_col}_ngrams"
        tf_col = f"{out_col}_tf" if self.getUseIDF() else out_col
        htf = HashingTF(inputCol=cur_col, outputCol=tf_col,
                        numFeatures=self.getNumFeatures(),
                        binary=self.getBinary())
        stages.append(htf)
        cur = htf.transform(cur)
        if self.getUseIDF():
            idf_model = IDF(inputCol=tf_col, outputCol=out_col,
                            minDocFreq=self.getMinDocFreq(),
                            device=self.get("device")).fit(cur)
            stages.append(idf_model)
        helper_cols = [c for c in
                       (f"{out_col}_tokens", f"{out_col}_nostop",
                        f"{out_col}_ngrams", f"{out_col}_tf")
                       if c != out_col]
        from ..stages.basic import DropColumns
        stages.append(DropColumns(cols=helper_cols))
        return TextFeaturizerModel().setStages(stages)


class TextFeaturizerModel(Model):
    stages = StageListParam("stages", "fitted text pipeline stages",
                            default=[], has_default=True)

    def _transform(self, df):
        cur = df
        for s in self.getStages():
            cur = s.transform(cur)
        return cur


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split documents into pages of bounded character length.

    Reference ``featurize/text/PageSplitter.scala``: bounded pages with
    min/max length, preferring whitespace/word boundaries.
    """

    maximumPageLength = Param("maximumPageLength", "max chars per page",
                              TC.toInt, default=5000)
    minimumPageLength = Param("minimumPageLength",
                              "min chars before a boundary split is allowed",
                              TC.toInt, default=4500)
    boundaryRegex = Param("boundaryRegex", "preferred split boundary",
                          TC.toString, default=r"\s")

    def _transform(self, df):
        maxlen = self.getMaximumPageLength()
        minlen = self.getMinimumPageLength()
        pat = re.compile(self.getBoundaryRegex())
        col = df[self.getInputCol()]
        out = np.empty(len(col), dtype=object)
        for i, text in enumerate(col.tolist()):
            pages = []
            if text:
                start = 0
                while start < len(text):
                    end = min(start + maxlen, len(text))
                    if end < len(text):
                        window = text[start + minlen:end]
                        candidates = [m.start() for m in pat.finditer(window)]
                        if candidates:
                            end = start + minlen + candidates[-1] + 1
                    pages.append(text[start:end])
                    start = end
            out[i] = pages
        return df.with_column(self.getOutputCol(), out)


class TokenIdEncoder(Transformer, HasInputCol, HasOutputCol):
    """Raw strings → fixed-shape int32 token-id matrix [n, maxLength], the
    input ``TextEncoderFeaturizer`` consumes.

    Two vocabulary modes:
    - hashing (default): id = 2 + murmur3_32(token) % (vocabSize - 2), the
      VW-compatible stable hash — deterministic across processes and equal
      to the JAX package's ids;
    - ``vocabFile``: one token per line, ids assigned in file order from
      2; out-of-vocabulary tokens map to the UNK id 1.

    Id 0 is PAD (masked out of attention and pooling downstream); id 1 is
    reserved for UNK. Sequences truncate at ``maxLength`` and pad with 0.
    """

    maxLength = Param("maxLength", "token-id row width (truncate/pad)",
                      TC.toInt, default=128)
    vocabSize = Param("vocabSize", "hash-id space (must match the "
                      "encoder's vocabSize)", TC.toInt, default=32768)
    toLowercase = Param("toLowercase", "lowercase before splitting",
                        TC.toBoolean, default=True)
    pattern = Param("pattern", "regex split pattern", TC.toString,
                    default=r"\W+")
    vocabFile = Param("vocabFile", "optional vocabulary file "
                      "(one token per line; OOV -> unk id 1)",
                      TC.toString, default="")

    # class-level default: load_stage rebuilds stages without __init__
    _vocab_cache: tuple[tuple[str, int], dict] | None = None

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="text", outputCol="tokens")

    def _vocab(self) -> dict | None:
        path = self.get("vocabFile")
        if not path:
            return None
        # keyed by vocabSize too, so changing it re-runs the size check
        key = (path, self.get("vocabSize"))
        if self._vocab_cache is None or self._vocab_cache[0] != key:
            with open(path) as f:
                tokens = [ln.rstrip("\n") for ln in f if ln.strip()]
            if len(tokens) + 2 > self.get("vocabSize"):
                raise ValueError(
                    f"vocab file holds {len(tokens)} tokens but "
                    f"vocabSize={self.get('vocabSize')} (ids 0/1 are "
                    "reserved); raise vocabSize")
            self._vocab_cache = (key,
                                 {t: i + 2 for i, t in enumerate(tokens)})
        return self._vocab_cache[1]

    def _transform(self, df):
        lower = self.get("toLowercase")
        pat = self.get("pattern")
        L = self.get("maxLength")
        space = self.get("vocabSize") - 2
        if space < 1:
            raise ValueError("vocabSize must be > 2")
        vocab = self._vocab()
        col = df[self.getInputCol()]
        out = np.zeros((len(col), L), np.int32)
        for i, text in enumerate(col.tolist()):
            toks = _tokenize(text, lower, pat)[:L]
            if vocab is None:
                ids = [2 + murmur3_32(t.encode("utf-8")) % space
                       for t in toks]
            else:
                ids = [vocab.get(t, 1) for t in toks]
            out[i, :len(ids)] = ids
        return df.with_column(self.getOutputCol(), out)


class BpeTokenizer(Estimator, HasInputCol, HasOutputCol):
    """Learn byte-pair-encoding merges from a corpus and emit the same
    fixed-shape int32 token-id matrix ``TokenIdEncoder`` produces — the
    corpus-fitted alternative to its hashing/vocab-file modes, closing
    the raw-text → subword-ids → ``TextEncoderFeaturizer`` chain without
    an external vocabulary.

    Classic whitespace-pretokenized BPE (Sennrich et al.): words split
    to characters plus an end-of-word marker, and the most frequent
    adjacent symbol pair merges repeatedly until the id budget
    (``vocabSize`` minus PAD/UNK/base characters) is spent or no pair
    repeats. No reference counterpart (``TextFeaturizer.scala`` stops at
    word-level tokens); this serves the framework's long-context
    extension.
    """

    vocabSize = Param("vocabSize", "total id budget incl. PAD=0/UNK=1 "
                      "(must match the encoder's vocabSize)",
                      TC.toInt, default=8192)
    maxLength = Param("maxLength", "token-id row width (truncate/pad)",
                      TC.toInt, default=128)
    toLowercase = Param("toLowercase", "lowercase before splitting",
                        TC.toBoolean, default=True)
    pattern = Param("pattern", "regex pre-tokenizer split pattern",
                    TC.toString, default=r"\W+")
    minPairCount = Param("minPairCount", "stop merging below this pair "
                         "frequency", TC.toInt, default=2)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="text", outputCol="tokens")

    def _fit(self, df):
        import heapq
        from collections import Counter, defaultdict

        lower = self.get("toLowercase")
        pat = self.get("pattern")
        words = Counter()
        for text in df[self.getInputCol()].tolist():
            words.update(_tokenize(text, lower, pat))

        # word id → (symbol tuple, count); incremental pair bookkeeping
        # (the standard BPE fit): each merge touches only the words that
        # contain its pair, not the whole corpus
        syms: list[list[str]] = []
        counts: list[int] = []
        for w, c in words.items():
            syms.append(list(w) + ["</w>"])
            counts.append(c)
        base = sorted({ch for s in syms for ch in s})
        budget = self.get("vocabSize") - 2 - len(base)
        if budget < 0:
            raise ValueError(
                f"vocabSize={self.get('vocabSize')} cannot hold the "
                f"{len(base)} base symbols (+PAD/UNK); raise it")
        min_count = int(self.get("minPairCount"))
        if min_count < 1:
            raise ValueError(
                f"minPairCount={min_count} must be >= 1")

        pairs: Counter = Counter()
        where: defaultdict = defaultdict(set)   # pair → word ids
        for wid, s in enumerate(syms):
            for p in zip(s, s[1:]):
                pairs[p] += counts[wid]
                where[p].add(wid)

        # merge selection via a lazily-invalidated max-heap:
        # a full max() scan per merge is O(distinct pairs) and dominates
        # large-vocab fits. Stale entries (count changed since push) are
        # discarded at pop time by comparing against the live count.
        # Ties break toward the lexicographically smallest pair — a
        # deterministic, corpus-order-independent rule.
        heap = [(-c, p) for p, c in pairs.items()]
        heapq.heapify(heap)

        merges: list[list[str]] = []
        for _ in range(budget):
            top = None
            while heap:
                negc, p = heap[0]
                if pairs.get(p, 0) == -negc:
                    top = -negc
                    break
                heapq.heappop(heap)              # stale entry
            if top is None or top < min_count:
                break
            a, b = p
            merged = a + b
            touched: set = set()
            for wid in list(where[(a, b)]):
                s, c = syms[wid], counts[wid]
                for pr in zip(s, s[1:]):         # retract old pairs
                    pairs[pr] -= c
                    if pairs[pr] <= 0:
                        del pairs[pr]
                    where[pr].discard(wid)
                    touched.add(pr)
                out, i = [], 0
                while i < len(s):
                    if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(s[i])
                        i += 1
                syms[wid] = out
                for pr in zip(out, out[1:]):     # add new pairs
                    pairs[pr] += c
                    where[pr].add(wid)
                    touched.add(pr)
            for pr in touched:
                if pairs.get(pr, 0) > 0:
                    heapq.heappush(heap, (-pairs[pr], pr))
            merges.append([a, b])

        # two merge paths can concatenate to the same string — dedupe so
        # no id slot is allocated to a token that can never be emitted
        vocab = list(dict.fromkeys(base + [a + b for a, b in merges]))
        model = BpeTokenizerModel() \
            .set("merges", merges) \
            .set("vocabulary", vocab)
        self._copy_params_to(model)
        return model


class BpeTokenizerModel(Model, HasInputCol, HasOutputCol):
    """Fitted BPE: greedy lowest-rank merging per word, then ids in
    ``vocabulary`` order from 2 (0=PAD, 1=UNK for unseen characters)."""

    merges = Param("merges", "ordered [a, b] merge rules")
    vocabulary = Param("vocabulary", "id-ordered token strings")
    # estimator params carried onto the model by _copy_params_to
    vocabSize = BpeTokenizer.vocabSize
    maxLength = BpeTokenizer.maxLength
    toLowercase = BpeTokenizer.toLowercase
    pattern = BpeTokenizer.pattern
    minPairCount = BpeTokenizer.minPairCount

    def _tables(self):
        merges = self.get("merges")
        vocab = self.get("vocabulary")
        cached = getattr(self, "_bpe_cache", None)
        if cached is not None and cached[0] is merges \
                and cached[1] is vocab:
            return cached[2], cached[3]
        ranks = {(a, b): r for r, (a, b) in enumerate(merges)}
        ids = {t: i + 2 for i, t in enumerate(vocab)}
        self._bpe_cache = (merges, vocab, ranks, ids,
                           {i: t for t, i in ids.items()})
        return ranks, ids

    def _id_to_tok(self) -> dict:
        self._tables()
        return self._bpe_cache[4]

    def encode_word(self, word: str) -> list[str]:
        ranks, _ = self._tables()
        sym = list(word) + ["</w>"]
        while len(sym) > 1:
            best, best_rank = None, None
            for i, (a, b) in enumerate(zip(sym, sym[1:])):
                r = ranks.get((a, b))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            sym[best:best + 2] = [sym[best] + sym[best + 1]]
        return sym

    def _transform(self, df):
        _, ids = self._tables()
        lower = self.get("toLowercase")
        pat = self.get("pattern")
        L = self.get("maxLength")
        col = df[self.getInputCol()]
        out = np.zeros((len(col), L), np.int32)
        word_cache: dict[str, list[int]] = {}
        for i, text in enumerate(col.tolist()):
            row: list[int] = []
            for w in _tokenize(text, lower, pat):
                got = word_cache.get(w)
                if got is None:
                    got = [ids.get(t, 1) for t in self.encode_word(w)]
                    word_cache[w] = got
                row.extend(got)
                if len(row) >= L:
                    break
            out[i, :min(len(row), L)] = row[:L]
        return df.with_column(self.getOutputCol(), out)

    def decode(self, ids_row) -> str:
        """Token ids → text: the inverse the generation path needs
        (``dl.generate`` emits id rows). Subword pieces concatenate;
        the ``</w>`` end-of-word marker becomes a space; PAD (0) stops
        the row and UNK (1) renders as ``�`` (the original
        characters are unrecoverable — BPE ids are the whole
        vocabulary)."""
        id_to_tok = self._id_to_tok()  # cached with the other tables
        pieces: list[str] = []
        for tid in np.asarray(ids_row).tolist():
            if tid == 0:
                break
            # UNK (1) is never a vocabulary key → the fallback renders it
            pieces.append(id_to_tok.get(int(tid), "�"))
        return "".join(pieces).replace("</w>", " ").strip()


class WordPieceTokenizerModel(Model, HasInputCol, HasOutputCol):
    """IMPORTED-vocabulary subword tokenizer (BERT's WordPiece): ids
    come from a foreign ``vocab.txt`` (one token per line, line number
    = id) rather than a corpus fit — the tokenizer half of external
    text-checkpoint ingestion (a converted checkpoint's weights being
    the other half; reference counterpart
    ``downloader/ModelDownloader.scala:37-60``, whose models ship with
    their own vocabularies).

    Encoding is the published WordPiece scheme: whitespace split,
    punctuation isolated, then greedy LONGEST-match against the
    vocabulary with ``##``-prefixed continuation pieces; unmatched
    words become ``[UNK]``. Rows render as ``[CLS] … [SEP]`` (when
    ``addSpecialTokens``) padded with ``[PAD]`` to ``maxLength``.
    ``[PAD]`` must sit at id 0 — the framework-wide pad-masking
    convention, which standard BERT vocabularies already satisfy.
    """

    vocabulary = Param("vocabulary", "id-ordered token strings "
                       "(vocab.txt order)")
    maxLength = Param("maxLength", "token-id row width (truncate/pad)",
                      TC.toInt, default=128, has_default=True)
    toLowercase = Param("toLowercase", "lowercase before matching "
                        "(uncased vocabularies)", TC.toBoolean,
                        default=True, has_default=True)
    addSpecialTokens = Param("addSpecialTokens", "wrap rows in "
                             "[CLS]/[SEP]", TC.toBoolean, default=True,
                             has_default=True)
    maxCharsPerWord = Param("maxCharsPerWord", "words longer than this "
                            "become [UNK]", TC.toInt, default=100,
                            has_default=True)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="text", outputCol="tokens")

    @classmethod
    def from_vocab(cls, source, **kwargs) -> "WordPieceTokenizerModel":
        """Build from a ``vocab.txt`` path or an id-ordered token list."""
        if isinstance(source, (str, os.PathLike)):
            with open(source, encoding="utf-8") as f:
                tokens = [ln.rstrip("\r\n") for ln in f]
            while tokens and not tokens[-1]:
                tokens.pop()
        else:
            tokens = list(source)
        model = cls(**kwargs).set("vocabulary", tokens)
        model._lookup()                  # validate [PAD]/[UNK] up front
        return model

    def _lookup(self) -> dict:
        vocab = self.get("vocabulary")
        cached = getattr(self, "_wp_cache", None)
        if cached is not None and cached[0] is vocab:
            return cached[1]
        ids = {t: i for i, t in enumerate(vocab)}
        if ids.get("[PAD]") != 0:
            raise ValueError(
                "[PAD] must be id 0 (the framework-wide pad-masking "
                "convention); this vocabulary puts it at "
                f"{ids.get('[PAD]', 'absent')}")
        if "[UNK]" not in ids:
            raise ValueError("vocabulary has no [UNK] token")
        self._wp_cache = (vocab, ids)
        return ids

    def encode_word(self, word: str) -> list[str]:
        """Greedy longest-match WordPiece split of one word."""
        ids = self._lookup()
        if len(word) > self.get("maxCharsPerWord"):
            return ["[UNK]"]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in ids:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    @staticmethod
    def _is_split_char(ch: str) -> bool:
        """BERT basic-tokenizer split set: Unicode punctuation, ASCII
        non-alphanumeric symbols ($ + = < > ^ ` | ~ …), and CJK
        ideographs (each becomes its own word)."""
        import unicodedata
        cp = ord(ch)
        if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 \
                or 123 <= cp <= 126:
            return True
        if unicodedata.category(ch).startswith("P"):
            return True
        # CJK Unified Ideographs blocks (the BERT CJK ranges)
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _words(self, text: str) -> list[str]:
        """Basic tokenization (the BERT basic tokenizer): lowercase +
        accent-strip for uncased vocabularies, whitespace split, with
        punctuation/symbols/CJK isolated as single-char words."""
        import unicodedata
        if self.get("toLowercase"):
            # NFD + drop combining marks: "café" → "cafe", matching how
            # uncased vocabularies were built
            text = "".join(
                ch for ch in unicodedata.normalize("NFD", text.lower())
                if unicodedata.category(ch) != "Mn")
        words: list[str] = []
        buf: list[str] = []
        for ch in text:
            if ch.isspace():
                if buf:
                    words.append("".join(buf))
                    buf = []
            elif self._is_split_char(ch):
                if buf:
                    words.append("".join(buf))
                    buf = []
                words.append(ch)
            else:
                buf.append(ch)
        if buf:
            words.append("".join(buf))
        return words

    def _transform(self, df):
        ids = self._lookup()
        L = self.get("maxLength")
        special = self.get("addSpecialTokens")
        cls_id, sep_id = ids.get("[CLS]"), ids.get("[SEP]")
        if special and (cls_id is None or sep_id is None):
            raise ValueError("addSpecialTokens needs [CLS] and [SEP] "
                             "in the vocabulary")
        unk = ids["[UNK]"]
        col = df[self.getInputCol()]
        out = np.zeros((len(col), L), np.int32)
        word_cache: dict[str, list[int]] = {}
        body = L - 2 if special else L
        for i, text in enumerate(col.tolist()):
            row: list[int] = []
            for w in self._words(text):
                got = word_cache.get(w)
                if got is None:
                    got = [ids.get(p, unk) for p in self.encode_word(w)]
                    word_cache[w] = got
                row.extend(got)
                if len(row) >= body:
                    break
            row = row[:body]
            if special:
                row = [cls_id] + row + [sep_id]
            out[i, :len(row)] = row
        return df.with_column(self.getOutputCol(), out)

    def decode(self, ids_row) -> str:
        """Token ids → text: ``##`` continuations concatenate onto the
        previous piece; specials ([CLS]/[SEP]/[PAD]) drop."""
        vocab = self.get("vocabulary")
        self._lookup()
        words: list[str] = []
        for tid in np.asarray(ids_row).tolist():
            tid = int(tid)
            if tid == 0:
                break
            tok = vocab[tid] if 0 <= tid < len(vocab) else "[UNK]"
            if tok in ("[CLS]", "[SEP]", "[MASK]"):
                continue
            if tok.startswith("##") and words:
                words[-1] += tok[2:]
            else:
                words.append(tok)
        return " ".join(words)
