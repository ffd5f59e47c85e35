"""Autoregressive generation for causal-LM models.

The port of ``mmlspark_tpu/dl/generate.py``'s ``generate``. The ids buffer
is a fixed ``[B, max_len]`` tensor on the device. The default path keeps
per-block KV caches: one batched causal forward (``MaskedLMModel.prefill``,
through the encoder's own attention: K2c for ``make_attention_fn("pallas",
causal=True)``) seeds them for the prefix every row shares, then a Python
loop over positions embeds one token per step and attends over the caches
(``decode_step``, the dense formulation, no kernel). ``use_cache=False``
re-encodes the whole buffer every step through the encoder's attention
(the reference the cached path is held against).

Where the JAX package runs the decode as one ``lax.scan`` under ``jit``,
here each step is eager PyTorch on device tensors: the loop index is a host
int, tokens, write masks and caches stay on the device, and nothing is
copied to the host until the buffer is returned. The JAX package's
``_RUN_CACHE`` of compiled programs has nothing to hold here; its
``_CAUSAL_OK`` is kept, keyed weakly on the module.

Not ported yet: ``ContinuousGenerator`` (``dl.generate:247-386``) and
``TextGenerator`` (``:389-474``, which needs ``BpeTokenizer``), ROADMAP.md §1
item 8.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..device import resolve_device
from .pretrain import MaskedLMModel, assert_causal

# modules whose causality probe already passed: the property is fixed per
# module architecture, so re-probing every call would cost two full
# forwards per request on the serving path
_CAUSAL_OK: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_CACHE_LOCK = threading.Lock()


def _sample(logits, temperature: float, pad_id: int,
            generator: torch.Generator | None):
    """Shared sampling epilogue: never emits pad (it would end the row's
    mask early). Greedy for ``temperature == 0``; otherwise a sample from
    ``softmax(logits / temperature)`` by the Gumbel-max rule with uniforms
    from ``generator``."""
    logits = logits.float().clone()
    logits[:, pad_id] = float("-inf")
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        logits = logits / temperature - torch.log(-torch.log(u))
    return logits.argmax(-1).to(torch.int32)


def _check_prompts(prompt_ids, max_new_tokens, max_len, pad_id):
    prompt_ids = np.asarray(prompt_ids, np.int32)
    B, Tp = prompt_ids.shape
    max_len = max_len or (Tp + max_new_tokens)
    if max_len < Tp + max_new_tokens:
        raise ValueError(
            f"max_len={max_len} cannot hold the prompt ({Tp}) plus "
            f"{max_new_tokens} new tokens")
    # per-row write pointer = non-pad count: only correct for strictly
    # right-padded prompts, so validate instead of silently scrambling
    ptr = (prompt_ids != pad_id).sum(axis=1).astype(np.int32)
    if (ptr == 0).any():
        raise ValueError("empty (all-pad) prompt row")
    if not np.all((np.arange(Tp)[None, :] < ptr[:, None])
                  == (prompt_ids != pad_id)):
        raise ValueError(
            f"prompts must be RIGHT-padded with pad_id={pad_id} "
            "(found a pad before a real token)")
    return prompt_ids, ptr, max_len


def _probe_causal(module, prompt_ids, ptr) -> None:
    with _CACHE_LOCK:
        if _CAUSAL_OK.get(module):
            return
    probe = prompt_ids[:1, :max(int(ptr[0]), 2)]
    if probe.shape[1] < 2:
        # a single-token prompt would make the probe a silent no-op
        probe = np.repeat(probe, 2, axis=1)
    assert_causal(module, probe, module.encoder.vocab)
    with _CACHE_LOCK:
        _CAUSAL_OK[module] = True


def _prefill_len(ptr) -> int:
    """Positions ``[0, min(ptr) - 1)`` hold real tokens in every row, so
    one causal forward seeds their caches; bucketed down as the JAX package
    does (a multiple of 64 from 64 up, else a power of two), so the prefix
    the two packages prefill is the same."""
    n = max(int(ptr.min()) - 1, 0)
    if n >= 64:
        return n - n % 64
    return 1 << (n.bit_length() - 1) if n > 0 else 0


def _run_cached(module, buf, ptr, max_new_tokens, scan_len, prefill_len,
                sample):
    enc = module.encoder
    B, L = buf.shape
    hd = enc.width // enc.heads
    caches = [tuple(torch.zeros(B, enc.heads, L, hd, dtype=enc.dtype,
                                device=buf.device) for _ in range(2))
              for _ in range(enc.depth)]
    if prefill_len > 0:
        module.prefill(buf[:, :prefill_len], caches)
    for pos in range(prefill_len, min(scan_len, L - 1)):
        nxt = sample(module.decode_step(buf[:, pos], caches, pos))
        # write at pos + 1 only inside this row's generation window;
        # prompt positions keep their tokens, the rest stays pad
        write = (pos + 1 >= ptr) & (pos + 1 < ptr + max_new_tokens)
        buf[:, pos + 1] = torch.where(write, nxt, buf[:, pos + 1])


def _run_reencode(module, buf, ptr, max_new_tokens, sample):
    rows = torch.arange(buf.shape[0], device=buf.device)
    ptr = ptr.long()
    for _ in range(max_new_tokens):
        logits = module(buf)["logits"]
        # logits at the last written position predict the next token
        buf[rows, ptr] = sample(logits[rows, ptr - 1])
        ptr = ptr + 1


def generate(module: MaskedLMModel, prompt_ids, *, max_new_tokens: int,
             max_len: int | None = None, temperature: float = 0.0,
             seed: int = 0, pad_id: int = 0, use_cache: bool = True,
             device: str | torch.device | None = None) -> np.ndarray:
    """Generate continuations for a batch of prompts.

    ``module``: a ``MaskedLMModel`` (trunk + LM head) whose encoder runs
    causal attention, which the JAX package's perturbation probe
    (:func:`assert_causal`) enforces on the first call per module. It moves
    to ``device`` (CUDA unless ``"cpu"`` is asked for; without a GPU the
    default raises) and carries its own weights (the JAX function takes
    ``variables``).

    ``prompt_ids``: [B, Tp] int32, RIGHT-padded with ``pad_id`` (a
    left-padded or empty row raises). Returns [B, max_len] int32 numpy:
    prompts, then generated tokens, then pad. ``temperature`` 0 = greedy
    (token-identical to the JAX package on the same weights); > 0 samples
    from ``torch.Generator(device).manual_seed(seed)``, a stream that
    differs from ``jax.random``'s for the same seed (reproducible by seed,
    never pad).

    ``use_cache`` (default): KV-cached decode. ``use_cache=False``
    re-encodes the whole buffer every step through the encoder's own
    attention."""
    prompt_ids, ptr_np, max_len = _check_prompts(prompt_ids, max_new_tokens,
                                                 max_len, pad_id)
    dev = resolve_device(device)
    module.to(dev)
    _probe_causal(module, prompt_ids, ptr_np)
    B, Tp = prompt_ids.shape
    generator = (torch.Generator(device=dev).manual_seed(seed)
                 if temperature > 0 else None)

    def sample(logits):
        return _sample(logits, temperature, pad_id, generator)

    with torch.inference_mode():
        buf = torch.full((B, max_len), pad_id, dtype=torch.int32, device=dev)
        buf[:, :Tp] = torch.from_numpy(prompt_ids).to(dev)
        ptr = torch.from_numpy(ptr_np).to(dev)
        if use_cache:
            _run_cached(module, buf, ptr, max_new_tokens,
                        Tp + max_new_tokens - 1, _prefill_len(ptr_np),
                        sample)
        else:
            _run_reencode(module, buf, ptr, max_new_tokens, sample)
        return buf.cpu().numpy()
