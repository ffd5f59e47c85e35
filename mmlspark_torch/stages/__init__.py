"""Generic pipeline stages: column plumbing, mini-batching, data shaping
and profiling (the port of ``mmlspark_tpu/stages``, eager paths)."""

from .basic import (DropColumns, SelectColumns, RenameColumn, UDFTransformer,
                    Lambda, MultiColumnAdapter, Repartition, Cacher, Explode,
                    Timer)
from .batching import (FixedMiniBatchTransformer, DynamicMiniBatchTransformer,
                       TimeIntervalMiniBatchTransformer, FlattenBatch,
                       DynamicBufferedBatcher, PartitionConsolidator)
from .misc import (SummarizeData, ClassBalancer, ClassBalancerModel,
                   StratifiedRepartition, EnsembleByKey, TextPreprocessor,
                   UnicodeNormalize)

__all__ = [
    "DropColumns", "SelectColumns", "RenameColumn", "UDFTransformer",
    "Lambda", "MultiColumnAdapter", "Repartition", "Cacher", "Explode",
    "Timer",
    "FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
    "TimeIntervalMiniBatchTransformer", "FlattenBatch",
    "DynamicBufferedBatcher", "PartitionConsolidator",
    "SummarizeData", "ClassBalancer", "ClassBalancerModel",
    "StratifiedRepartition", "EnsembleByKey", "TextPreprocessor",
    "UnicodeNormalize",
]
