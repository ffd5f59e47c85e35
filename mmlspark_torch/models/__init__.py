from .convert import (bert_encoder_from_flax, bert_encoder_from_torch,
                      masked_lm_from_flax, text_encoder_from_flax)
from .zoo import (LoadedModel, ModelSchema, get_model, register_bert_encoder,
                  register_model, register_text_encoder)

__all__ = ["LoadedModel", "ModelSchema", "bert_encoder_from_flax",
           "bert_encoder_from_torch", "get_model", "masked_lm_from_flax",
           "register_bert_encoder", "register_model",
           "register_text_encoder", "text_encoder_from_flax"]
