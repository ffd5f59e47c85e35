"""Featurization stages (the port of ``mmlspark_tpu/featurize``): the
auto-featurizer, imputation, indexing, conversion, slot selection, vector
assembly and one-hot encoding, the text stages and Word2Vec. Numeric work
runs in torch on each stage's ``device``; string work stays on the host."""

from .featurize import Featurize, FeaturizeModel
from .value_indexer import ValueIndexer, ValueIndexerModel, IndexToValue
from .clean_missing_data import CleanMissingData, CleanMissingDataModel
from .data_conversion import DataConversion
from .count_selector import CountSelector, CountSelectorModel
from .text import (BpeTokenizer, BpeTokenizerModel,
                   WordPieceTokenizerModel,
                   StopWordsRemover, Tokenizer, TokenIdEncoder, NGram,
                   MultiNGram, HashingTF, IDF, IDFModel,
                   TextFeaturizer, TextFeaturizerModel, PageSplitter)
from .vector import VectorAssembler, OneHotEncoder, OneHotEncoderModel
from .embedding import Word2Vec, Word2VecModel

__all__ = [
    "Featurize", "FeaturizeModel",
    "ValueIndexer", "ValueIndexerModel", "IndexToValue",
    "CleanMissingData", "CleanMissingDataModel",
    "DataConversion", "CountSelector", "CountSelectorModel",
    "BpeTokenizer", "BpeTokenizerModel", "WordPieceTokenizerModel",
    "StopWordsRemover", "Tokenizer", "TokenIdEncoder", "NGram", "MultiNGram",
    "HashingTF", "IDF", "IDFModel",
    "TextFeaturizer", "TextFeaturizerModel", "PageSplitter",
    "VectorAssembler", "OneHotEncoder", "OneHotEncoderModel",
    "Word2Vec", "Word2VecModel",
]
