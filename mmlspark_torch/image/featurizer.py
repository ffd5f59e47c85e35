"""ImageFeaturizer — transfer-learning feature extraction, the port of
``mmlspark_tpu/image/featurizer.py``.

Reference ``image/ImageFeaturizer.scala:40-197``: ResizeImageTransformer,
UnrollImage and CNTKModel composed, ``cutOutputLayers`` choosing how many
layers to cut off the pretrained net. Here layers are the zoo model's named
endpoints: ``cutOutputLayers=k`` picks ``layer_names[-(k+1)]`` (0 = logits,
1 = pooled features, 2 = the last stage, ...). ``autoResize`` resizes to
the schema's ``input_size`` first (on the stage's device), then
``TPUModel`` runs the model in minibatches; ``quantize=True`` scores a
ResNet's pooled endpoint through the int8 path (``models.quantize``).
"""

from __future__ import annotations

import os

import torch

from ..core import ComplexParam, Param, Transformer, TypeConverters as TC
from ..core.contracts import HasDevice, HasInputCol, HasOutputCol
from ..dl.model import TPUModel
from ..models.zoo import LoadedModel, ModelDownloader
from .stages import ResizeImageTransformer


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol, HasDevice):
    modelName = Param("modelName", "zoo model name", TC.toString,
                      default="ResNet50", has_default=True)
    model = ComplexParam("model", "explicit LoadedModel (overrides name)",
                         default=None, has_default=True)
    cutOutputLayers = Param(
        "cutOutputLayers",
        "layers to cut from the top: 0 = logits, 1 = pooled features",
        TC.toInt, default=1, has_default=True)
    autoResize = Param("autoResize", "resize inputs to the model's input "
                       "size first", TC.toBoolean, default=True,
                       has_default=True)
    miniBatchSize = Param("miniBatchSize", "device batch size", TC.toInt,
                          default=64, has_default=True)
    transferDtype = Param(
        "transferDtype", "host->device wire dtype (see TPUModel); "
        "'auto' additionally narrows float inputs to bfloat16 here when "
        "the zoo model computes in bf16 (its first op is the cast, so "
        "the wire narrowing is lossless)", TC.toString, default="auto",
        has_default=True)
    pipelineDepth = Param(
        "pipelineDepth", "max in-flight device batches (see TPUModel)",
        TC.toInt, default=2, has_default=True)
    quantize = Param(
        "quantize", "score through the int8 post-training-quantized "
        "path (models.quantize_resnet: BN folded, per-channel int8 "
        "weights, dynamic int8 activations); pooled endpoint "
        "(cutOutputLayers=1) only",
        TC.toBoolean, default=False, has_default=True)

    # class-level fallbacks: load_stage rebuilds stages without __init__
    _tpu_model = None
    _loaded_cache = None
    _quant_cache = None

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="image", outputCol="features")

    def setModel(self, name_or_model):
        """A zoo name or a LoadedModel (reference ``setModel(ModelSchema)``,
        ``ImageFeaturizer.scala:81-85``)."""
        if isinstance(name_or_model, str):
            return self.set("modelName", name_or_model)
        return self.set("model", name_or_model)

    def _loaded(self) -> LoadedModel:
        m = self.get("model")
        if m is not None:
            return m
        # one zoo resolution per (name, model dir): a fresh LoadedModel per
        # transform would defeat TPUModel's module cache
        key = (self.get("modelName"),
               os.environ.get("MMLSPARK_TPU_MODEL_DIR", ""))
        if self._loaded_cache is None or self._loaded_cache[0] != key:
            self._loaded_cache = (
                key, ModelDownloader().download_by_name(key[0]))
        return self._loaded_cache[1]

    def _transform(self, df):
        loaded = self._loaded()
        layers = loaded.layer_names
        cut = self.get("cutOutputLayers")
        if not 0 <= cut < len(layers):
            raise ValueError(
                f"cutOutputLayers={cut} out of range for {layers}")
        endpoint = layers[-(cut + 1)]
        # the wire dtype comes from the source module, before any int8
        # substitution
        wire = self.get("transferDtype")
        if wire == "auto" and \
                getattr(loaded.module, "dtype", None) == torch.bfloat16:
            wire = "bfloat16"
        if self.get("quantize"):
            from ..models.resnet import ResNet
            if not isinstance(loaded.module, ResNet):
                raise ValueError(
                    "quantize=True supports ResNet zoo models only "
                    f"(got {type(loaded.module).__name__}); the text "
                    "path is models.quantize_text_encoder")
            if endpoint != "pooled":
                raise ValueError(
                    "quantize=True scores the pooled endpoint only "
                    f"(cutOutputLayers=1); requested {endpoint!r}")
            loaded = self._quantized(loaded)

        col = self.getInputCol()
        if self.get("autoResize"):
            size = loaded.schema.input_size
            df = ResizeImageTransformer(
                inputCol=col, outputCol=col, height=size, width=size,
                device=self.get("device")).transform(df)
        # one TPUModel across transforms (its module is cached per model
        # identity)
        key = (id(loaded), endpoint, col, self.getOutputCol(),
               self.get("miniBatchSize"), wire, self.get("device"))
        if self._tpu_model is None or self._tpu_model[0] != key:
            self._tpu_model = (key, TPUModel(
                model=loaded, inputCol=col, outputCol=self.getOutputCol(),
                outputNode=endpoint, minibatchSize=self.get("miniBatchSize"),
                transferDtype=wire, device=self.get("device")), loaded)
        # depth only shapes the host loop, so it stays out of the key
        self._tpu_model[1].set("pipelineDepth", self.get("pipelineDepth"))
        return self._tpu_model[1].transform(df)

    def _quantized(self, loaded: LoadedModel) -> LoadedModel:
        """The folded int8 model, cached per source model (its identity
        keys TPUModel's module cache)."""
        if self._quant_cache is None or self._quant_cache[0] is not loaded:
            from ..models.quantize import QuantizedResNet
            self._quant_cache = (loaded, LoadedModel(
                schema=loaded.schema, module=QuantizedResNet(loaded.module)))
        return self._quant_cache[1]

    @property
    def last_transform_stats(self) -> dict | None:
        """Timing breakdown of the last transform's model leg
        (``TPUModel.last_stats``): prep, dispatch, drain and total ms."""
        return self._tpu_model[1].last_stats if self._tpu_model else None
