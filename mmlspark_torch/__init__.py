"""mmlspark_torch — the PyTorch/CUDA port of mmlspark_tpu for NVIDIA Hopper.

The same SparkML-shaped surface (DataFrame, Params, Estimator/Transformer,
Pipeline, the LightGBM stages, the text-embedding stages, masked-LM
pretraining, causal-LM generation, the paged LLM serving engine, image
featurization over the ResNet/ViT zoo with its image stages, and pipelines
served over HTTP from the threaded or the native epoll front) with
tensor work in PyTorch and hand-written CUDA kernels. Entry points run on
CUDA unless given ``device="cpu"``.
"""

from .core import DataFrame, Pipeline, PipelineModel, load_stage

__all__ = ["DataFrame", "Pipeline", "PipelineModel", "load_stage"]
