"""Model zoo, converters and int8 quantization, the port of
``mmlspark_tpu/models``: modules whose forward returns every named layer, so
``ImageFeaturizer``'s ``cutOutputLayers`` is a dict lookup."""

from .convert import (bert_encoder_from_flax, bert_encoder_from_torch,
                      convert_torch_checkpoint, masked_lm_from_flax,
                      module_from_torch, resnet_from_flax, resnet_from_torch,
                      save_converted, text_encoder_from_flax,
                      verify_checkpoint, vit_from_flax, vit_from_torch)
from .quantize import (QuantizedResNet, cosine_fidelity,
                       quantization_fidelity, quantize_resnet,
                       quantize_text_encoder)
from .resnet import ResNet, ResNet18, ResNet34, ResNet50, ResNet101
from .vit import ViT, ViT_B_16, ViT_L_16
from .zoo import (LoadedModel, ModelDownloader, ModelSchema, get_model,
                  register_bert_encoder, register_model,
                  register_text_encoder)

__all__ = ["LoadedModel", "ModelDownloader", "ModelSchema",
           "QuantizedResNet", "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ViT", "ViT_B_16", "ViT_L_16",
           "bert_encoder_from_flax", "bert_encoder_from_torch",
           "convert_torch_checkpoint", "cosine_fidelity", "get_model",
           "masked_lm_from_flax", "module_from_torch",
           "quantization_fidelity", "quantize_resnet",
           "quantize_text_encoder", "register_bert_encoder",
           "register_model", "register_text_encoder", "resnet_from_flax",
           "resnet_from_torch", "save_converted", "text_encoder_from_flax",
           "verify_checkpoint", "vit_from_flax", "vit_from_torch"]
