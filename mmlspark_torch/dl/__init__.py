# the switch ``flash_attention`` stays in its module
# (``mmlspark_torch.dl.flash_attention.flash_attention``): exported here, the
# function would shadow its module's name on the package. ``generate`` is
# exported, as the JAX package exports it, so ``dl.generate`` is the
# function; the module is ``sys.modules["mmlspark_torch.dl.generate"]``.
from .bert import BertEncoder
from .flash_attention import (flash_attention_lse, flash_bwd_cuda,
                              flash_bwd_torch, flash_causal_cuda, flash_cuda,
                              flash_lse_cuda, flash_lse_torch, flash_torch)
from .generate import ContinuousGenerator, TextGenerator, generate
from .paged_attention import (paged_cuda, paged_decode_cuda, paged_torch,
                              paged_window_attention)
from .paged_kv import (TRASH_BLOCK, OutOfBlocks, PagedKVManager,
                       SequenceHandle, gather_dense, init_pools,
                       scatter_positions, take_positions)
from .pretrain import (MaskedLMModel, assert_causal, encoder_variables,
                       mask_batch, masked_xent, pretrain_causal_lm,
                       pretrain_masked_lm)
from .speculative import generate_speculative
from .text_encoder import (EncoderBlock, TextEncoder, TextEncoderFeaturizer,
                           make_attention_fn)
from .train import TrainState, make_train_step, softmax_xent, train_epoch

__all__ = ["BertEncoder", "ContinuousGenerator", "EncoderBlock",
           "MaskedLMModel",
           "OutOfBlocks", "PagedKVManager", "SequenceHandle", "TRASH_BLOCK",
           "TextEncoder", "TextEncoderFeaturizer", "TextGenerator",
           "TrainState", "assert_causal", "encoder_variables",
           "flash_attention_lse", "flash_bwd_cuda", "flash_bwd_torch",
           "flash_causal_cuda", "flash_cuda", "flash_lse_cuda",
           "flash_lse_torch", "flash_torch", "gather_dense", "generate",
           "generate_speculative", "init_pools", "make_attention_fn",
           "make_train_step", "mask_batch", "masked_xent", "paged_cuda", "paged_decode_cuda",
           "paged_torch", "paged_window_attention", "pretrain_causal_lm",
           "pretrain_masked_lm", "scatter_positions", "softmax_xent",
           "take_positions", "train_epoch"]
