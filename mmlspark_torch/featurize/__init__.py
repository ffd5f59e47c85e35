from .text import TokenIdEncoder

__all__ = ["TokenIdEncoder"]
