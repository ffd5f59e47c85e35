# the switch ``flash_attention`` stays in its module
# (``mmlspark_torch.dl.flash_attention.flash_attention``): exported here, the
# function would shadow the module's name on the package
from .flash_attention import (flash_attention_lse, flash_bwd_cuda,
                              flash_bwd_torch, flash_cuda, flash_lse_cuda,
                              flash_lse_torch, flash_torch)
from .pretrain import (MaskedLMModel, assert_causal, encoder_variables,
                       mask_batch, masked_xent, pretrain_causal_lm,
                       pretrain_masked_lm)
from .text_encoder import (EncoderBlock, TextEncoder, TextEncoderFeaturizer,
                           make_attention_fn)
from .train import TrainState, make_train_step, softmax_xent, train_epoch

__all__ = ["EncoderBlock", "MaskedLMModel", "TextEncoder",
           "TextEncoderFeaturizer", "TrainState", "assert_causal",
           "encoder_variables", "flash_attention_lse", "flash_bwd_cuda",
           "flash_bwd_torch", "flash_cuda", "flash_lse_cuda",
           "flash_lse_torch", "flash_torch", "make_attention_fn",
           "make_train_step", "mask_batch", "masked_xent",
           "pretrain_causal_lm", "pretrain_masked_lm", "softmax_xent",
           "train_epoch"]
