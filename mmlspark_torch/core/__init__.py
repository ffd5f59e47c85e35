from .bindings import ColumnMetadata
from .dataframe import DataFrame, Row, GroupedData
from .param import (Param, Params, ComplexParam, TypeConverters,
                    StageListParam, UDFParam)
from .pipeline import (PipelineStage, Transformer, Estimator, Model, Pipeline,
                       PipelineModel, ml_transform, ml_fit)
from .serialize import load_stage, register_stage
from .utils import as_2d_features, stable_sigmoid
from . import contracts

__all__ = [
    "ColumnMetadata",
    "DataFrame", "Row", "GroupedData",
    "Param", "Params", "ComplexParam", "TypeConverters",
    "StageListParam", "UDFParam",
    "PipelineStage", "Transformer", "Estimator", "Model", "Pipeline",
    "PipelineModel", "ml_transform", "ml_fit",
    "load_stage", "register_stage",
    "as_2d_features", "stable_sigmoid", "contracts",
]
