"""The port's text stages against the JAX package's, on the CPU.

Tokenizer, n-grams, stop words, hashing TF (crc32), the IDF fit, BPE,
WordPiece and the page splitter are host work in both packages and must
match exactly: tokens, ids, merges, vocabularies and decoded text.
``IDFModel``'s tf·idf product runs in torch on the stage's device; one
float32 multiply per cell, so it matches exactly too, as does a fitted
``TextFeaturizer`` end to end.
"""

import numpy as np
import pytest
import torch

import mmlspark_tpu.featurize.text as jt
from mmlspark_tpu.core import DataFrame as JDataFrame
import mmlspark_torch.featurize.text as tt
from mmlspark_torch.core import DataFrame

DOCS = np.asarray([
    "The quick brown fox jumps over the lazy dog; the dog sleeps.",
    "A café in Zürich serves über-strong coffee, isn't it?",
    "", None,
    "Numbers 123 and 4567 mix with words_and_underscores here",
    "the the the THE The repeated repeated words words",
    "Long-context models embed entire documents in one pass.",
    "中文字符 mixed with English and punctuation!!!",
], object)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(col="text", values=DOCS):
    return JDataFrame({col: values}), DataFrame({col: values})


def _same_cells(got, want):
    assert got.dtype == np.asarray(want).dtype
    if got.dtype == object:
        assert [list(np.asarray(v)) if v is not None else None for v in got] \
            == [list(np.asarray(v)) if v is not None else None for v in want]
    else:
        np.testing.assert_array_equal(got, np.asarray(want))


TOKENIZERS = {
    "default": {},
    "keep_case": dict(toLowercase=False),
    "find_tokens": dict(gaps=False, pattern=r"[a-z]+"),
    "min_length_3": dict(minTokenLength=3),
}


@pytest.mark.parametrize("case", sorted(TOKENIZERS))
def test_tokenizer_matches_jax(case):
    jdf, tdf = _frames()
    kw = dict(TOKENIZERS[case], inputCol="text", outputCol="tokens")
    _same_cells(tt.Tokenizer(**kw).transform(tdf)["tokens"],
                jt.Tokenizer(**kw).transform(jdf)["tokens"])


def _tokens():
    jdf, tdf = _frames()
    kw = dict(inputCol="text", outputCol="tokens")
    return jt.Tokenizer(**kw).transform(jdf), tt.Tokenizer(**kw).transform(tdf)


TOKEN_STAGES = {
    "NGram_2": lambda m: m.NGram(inputCol="tokens", outputCol="out", n=2),
    "NGram_3": lambda m: m.NGram(inputCol="tokens", outputCol="out", n=3),
    "MultiNGram": lambda m: m.MultiNGram(inputCol="tokens", outputCol="out",
                                         lengths=[1, 3]),
    "StopWordsRemover": lambda m: m.StopWordsRemover(inputCol="tokens",
                                                     outputCol="out"),
    "StopWordsRemover_custom": lambda m: m.StopWordsRemover(
        inputCol="tokens", outputCol="out", stopWords=["The", "words"],
        caseSensitive=True),
    "HashingTF": lambda m: m.HashingTF(inputCol="tokens", outputCol="out",
                                       numFeatures=64),
    "HashingTF_binary": lambda m: m.HashingTF(
        inputCol="tokens", outputCol="out", numFeatures=32, binary=True),
}


@pytest.mark.parametrize("name", sorted(TOKEN_STAGES))
def test_token_stages_match_jax(name):
    jtok, ttok = _tokens()
    want = TOKEN_STAGES[name](jt).transform(jtok)["out"]
    got = TOKEN_STAGES[name](tt).transform(ttok)["out"]
    _same_cells(got, want)


def test_stop_words_language_must_be_known():
    jtok, ttok = _tokens()
    for m, df in ((jt, jtok), (tt, ttok)):
        with pytest.raises(ValueError, match="no built-in stop list"):
            m.StopWordsRemover(inputCol="tokens", outputCol="out",
                               language="klingon").transform(df)


@pytest.mark.parametrize("min_doc_freq", [0, 2])
def test_idf_matches_jax(min_doc_freq):
    jtok, ttok = _tokens()
    kw = dict(inputCol="tokens", outputCol="tf", numFeatures=48)
    jtf = jt.HashingTF(**kw).transform(jtok)
    ttf = tt.HashingTF(**kw).transform(ttok)
    kw = dict(inputCol="tf", outputCol="tfidf", minDocFreq=min_doc_freq)
    jmodel = jt.IDF(**kw).fit(jtf)
    tmodel = tt.IDF(**kw, device="cpu").fit(ttf)
    assert tmodel.get("idf") == jmodel.get("idf")
    got = tmodel.transform(ttf)["tfidf"]
    want = np.asarray(jmodel.transform(jtf)["tfidf"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


TEXT_FEATURIZERS = {
    "default": dict(numFeatures=128),
    "ngrams_binary": dict(numFeatures=64, useNGram=True, nGramLength=2,
                          binary=True),
    "stop_words_no_idf": dict(numFeatures=64, useStopWordsRemover=True,
                              useIDF=False),
    "min_doc_freq_pattern": dict(numFeatures=32, minDocFreq=2,
                                 tokenizerPattern=r"[a-z]+",
                                 tokenizerGaps=False, minTokenLength=2),
}


@pytest.mark.parametrize("case", sorted(TEXT_FEATURIZERS))
def test_text_featurizer_matches_jax(case):
    jdf, tdf = _frames()
    kw = dict(TEXT_FEATURIZERS[case], inputCol="text", outputCol="vec")
    jmodel = jt.TextFeaturizer(**kw).fit(jdf)
    tmodel = tt.TextFeaturizer(**kw, device="cpu").fit(tdf)
    assert [type(s).__name__ for s in tmodel.getStages()] == \
        [type(s).__name__ for s in jmodel.getStages()]
    jout, tout = jmodel.transform(jdf), tmodel.transform(tdf)
    assert tout.columns == jout.columns == ["text", "vec"]
    assert tout["vec"].dtype == np.float32
    np.testing.assert_array_equal(tout["vec"], np.asarray(jout["vec"]))


@pytest.mark.parametrize("lengths", [(40, 30), (25, 5), (7, 7)])
def test_page_splitter_matches_jax(lengths):
    jdf, tdf = _frames()
    kw = dict(inputCol="text", outputCol="pages",
              maximumPageLength=lengths[0], minimumPageLength=lengths[1])
    _same_cells(tt.PageSplitter(**kw).transform(tdf)["pages"],
                jt.PageSplitter(**kw).transform(jdf)["pages"])


def _corpus():
    rng = np.random.default_rng(8)
    words = ["lower", "lowest", "newer", "newest", "wider", "widest",
             "low", "new", "wide", "slow", "slower"]
    return np.asarray([" ".join(rng.choice(words, size=rng.integers(3, 9)))
                       for _ in range(60)] + [None, ""], object)


@pytest.mark.parametrize("vocab_size", [24, 60, 400])
def test_bpe_matches_jax(vocab_size):
    corpus = _corpus()
    jdf, tdf = _frames(values=corpus)
    kw = dict(vocabSize=vocab_size, maxLength=12, minPairCount=2)
    jmodel = jt.BpeTokenizer(**kw).fit(jdf)
    tmodel = tt.BpeTokenizer(**kw).fit(tdf)
    assert tmodel.get("merges") == jmodel.get("merges")
    assert tmodel.get("vocabulary") == jmodel.get("vocabulary")
    probe = np.asarray(list(corpus[:10]) + ["unseen qqq wordz"], object)
    jout = jmodel.transform(JDataFrame({"text": probe}))["tokens"]
    tout = tmodel.transform(DataFrame({"text": probe}))["tokens"]
    assert tout.dtype == np.int32
    np.testing.assert_array_equal(tout, np.asarray(jout))
    assert [tmodel.decode(r) for r in tout] == \
        [jmodel.decode(r) for r in np.asarray(jout)]
    assert tmodel.encode_word("slowest") == jmodel.encode_word("slowest")


def test_bpe_rejects_budgets_below_the_base_symbols():
    jdf, tdf = _frames(values=_corpus())
    for m, df in ((jt, jdf), (tt, tdf)):
        with pytest.raises(ValueError, match="cannot hold"):
            m.BpeTokenizer(vocabSize=5).fit(df)


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick",
         "brown", "fox", "cafe", "in", "zur", "##ich", "##s", "dog", "un",
         "##aff", "##able", ",", ".", "!", "?", "中", "a", "##b"]


@pytest.mark.parametrize("kw", [
    {}, dict(addSpecialTokens=False, maxLength=6),
    dict(toLowercase=False, maxCharsPerWord=4)])
def test_wordpiece_matches_jax(kw):
    text = np.asarray([
        "The quick brown fox, dogs!", "Café in Zürich?", "unaffable ab",
        "中文 zzz", "", "the the the the the the the the the the"], object)
    jmodel = jt.WordPieceTokenizerModel.from_vocab(VOCAB, **kw,
                                                   inputCol="text")
    tmodel = tt.WordPieceTokenizerModel.from_vocab(VOCAB, **kw,
                                                   inputCol="text")
    jout = np.asarray(jmodel.transform(JDataFrame({"text": text}))["tokens"])
    tout = tmodel.transform(DataFrame({"text": text}))["tokens"]
    assert tout.dtype == np.int32
    np.testing.assert_array_equal(tout, jout)
    assert [tmodel.decode(r) for r in tout] == [jmodel.decode(r) for r in jout]
    bad = ["[UNK]", "[PAD]"]
    for m in (jt, tt):
        with pytest.raises(ValueError, match=r"\[PAD\] must be id 0"):
            m.WordPieceTokenizerModel.from_vocab(bad)
