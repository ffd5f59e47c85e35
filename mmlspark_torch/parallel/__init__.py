from .ring_attention import blockwise_attention

__all__ = ["blockwise_attention"]
