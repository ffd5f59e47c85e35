from .murmur import murmur3_32

__all__ = ["murmur3_32"]
