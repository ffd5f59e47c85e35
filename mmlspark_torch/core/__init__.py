# the bindings() sugar stays submodule-only, as in the JAX package
from .bindings import ColumnMetadata, DataclassBindings
from .dataframe import DataFrame, Row, GroupedData
from .param import (Param, Params, ComplexParam, TypeConverters,
                    StageParam, StageListParam, UDFParam)
from .pipeline import (PipelineStage, Transformer, Estimator, Model, Pipeline,
                       PipelineModel, ml_transform, ml_fit)
from .serialize import load_stage, register_stage
from .compile import CompiledPipeline, compile_pipeline
from .utils import (ClusterUtil, StopWatch, as_2d_features,
                    find_unused_column_name, retry_with_timeout,
                    stable_sigmoid)
from . import contracts

__all__ = [
    "ColumnMetadata", "DataclassBindings",
    "DataFrame", "Row", "GroupedData",
    "Param", "Params", "ComplexParam", "TypeConverters",
    "StageParam", "StageListParam", "UDFParam",
    "PipelineStage", "Transformer", "Estimator", "Model", "Pipeline",
    "PipelineModel", "ml_transform", "ml_fit",
    "CompiledPipeline", "compile_pipeline",
    "load_stage", "register_stage",
    "ClusterUtil", "StopWatch", "retry_with_timeout",
    "find_unused_column_name", "as_2d_features", "stable_sigmoid",
    "contracts",
]
