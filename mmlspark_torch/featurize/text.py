"""Text featurization: raw strings → token ids for the text encoder.

The port of ``mmlspark_tpu/featurize/text.py``'s tokenization path
(``_tokenize``, ``:24-34``) and ``TokenIdEncoder`` (``:360-433``). Both run
on the host, as in the JAX package. The rest of that module (``Tokenizer``,
n-grams, hashing TF, IDF, ``BpeTokenizer``, ``PageSplitter``) comes with the
featurize slice (ROADMAP.md §1 item 3).
"""

from __future__ import annotations

import re

import numpy as np

from ..core import Param, Transformer, TypeConverters as TC
from ..core.contracts import HasInputCol, HasOutputCol
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
