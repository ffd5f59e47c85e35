"""Serving for the port: the paged LLM engine (``serving/llm.py``).

The HTTP fronts, the distributed tier and the deploy plane of the JAX
package's ``serving`` come with ROADMAP.md §1 item 9.
"""

from .llm import (DecodeExecutor, HandoffQueue, LLMEngine, PrefillExecutor,
                  pack_handoff, unpack_handoff)

__all__ = ["DecodeExecutor", "HandoffQueue", "LLMEngine", "PrefillExecutor",
           "pack_handoff", "unpack_handoff"]
