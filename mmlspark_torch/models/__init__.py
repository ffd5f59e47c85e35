from .convert import masked_lm_from_flax, text_encoder_from_flax
from .zoo import (LoadedModel, ModelSchema, get_model, register_model,
                  register_text_encoder)

__all__ = ["LoadedModel", "ModelSchema", "get_model", "masked_lm_from_flax",
           "register_model", "register_text_encoder",
           "text_encoder_from_flax"]
