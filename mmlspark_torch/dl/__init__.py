# the switch ``flash_attention`` stays in its module
# (``mmlspark_torch.dl.flash_attention.flash_attention``): exported here, the
# function would shadow the module's name on the package
from .flash_attention import flash_attention_lse, flash_cuda, flash_torch
from .text_encoder import (EncoderBlock, TextEncoder, TextEncoderFeaturizer,
                           make_attention_fn)

__all__ = ["EncoderBlock", "TextEncoder", "TextEncoderFeaturizer",
           "flash_attention_lse", "flash_cuda", "flash_torch",
           "make_attention_fn"]
