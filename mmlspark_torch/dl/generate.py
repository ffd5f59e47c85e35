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

``ContinuousGenerator`` (continuous batching over a fixed slot pool) and
the pipeline stage ``TextGenerator`` (prompts → continuations through a
fitted ``BpeTokenizerModel``, ``generate`` or ``dl.speculative``) complete
the module.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..core.contracts import HasDevice, HasInputCol, HasOutputCol, HasSeed
from ..core.param import (ComplexParam, Param, StageParam,
                          TypeConverters as TC)
from ..core.pipeline import Transformer
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


class ContinuousGenerator:
    """Continuous batching for causal-LM decoding: a FIXED pool of sequence
    slots over a fixed ``[slots, max_len]`` token buffer on the device, new
    sequences admitted into free slots at step boundaries instead of
    waiting for the whole batch to drain (the port of the JAX class).

    Slot bookkeeping and admission order live in ``sched.SlotScheduler``;
    this class is the device half. Each step is one full causal forward of
    the buffer through the encoder's own attention (K2c for
    ``make_attention_fn("pallas", causal=True)``, one launch per block), and
    samples from the logits at each row's ``ptr - 1`` (``_sample``, the
    shared epilogue; the LM head runs on those rows only). Idle slots sit
    at ``ptr = 1`` and are masked out of writes. With ``temperature=0``
    each sequence's tokens are ``generate(use_cache=False)``'s; with
    ``temperature > 0`` they are samples drawn from
    ``torch.Generator(device).manual_seed(seed)``, a stream that depends on
    the admission order and differs from ``jax.random``'s.

    ``module`` (a ``MaskedLMModel`` with causal attention, carrying its
    weights) moves to ``device`` (CUDA unless ``"cpu"`` is asked for); the
    causality probe (:func:`assert_causal`) runs once, on the first
    submitted prompt."""

    def __init__(self, module: MaskedLMModel, *, slots: int = 4,
                 max_len: int = 64, temperature: float = 0.0,
                 pad_id: int = 0, seed: int = 0, service: str = "generate",
                 registry=None, device: str | torch.device | None = None):
        from ..sched import SlotScheduler

        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.pad_id = int(pad_id)
        self.sched = SlotScheduler(self.slots, service=service,
                                   registry=registry)
        self._buf = torch.full((self.slots, self.max_len), self.pad_id,
                               dtype=torch.int32, device=self.device)
        # free slots idle at ptr=1 (keeps the ptr-1 gather in bounds);
        # their sampled tokens are never written (write mask)
        self._ptr = torch.ones(self.slots, dtype=torch.long,
                               device=self.device)
        self._active = np.zeros(self.slots, bool)
        self._generator = (torch.Generator(device=self.device)
                           .manual_seed(seed) if temperature > 0 else None)
        self._probed = False
        self.steps = 0

    # -- intake ------------------------------------------------------------
    def submit(self, seq_id, prompt_ids, max_new_tokens: int) -> None:
        """Queue one sequence. ``prompt_ids``: 1-D int32, no padding.
        Admitted at the next step boundary with a free slot."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if (prompt == self.pad_id).any():
            raise ValueError(f"prompt contains pad_id={self.pad_id}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + {max_new_tokens} new tokens "
                f"exceeds max_len={self.max_len}")
        if not self._probed:
            # generate()'s causality gate: a bidirectional encoder would
            # silently condition on its own padding
            probe = prompt[None, :] if prompt.size >= 2 else \
                np.repeat(prompt[None, :], 2, axis=1)
            assert_causal(self.module, probe, self.module.encoder.vocab)
            self._probed = True
        self.sched.offer(seq_id, prompt, int(max_new_tokens))

    # -- the boundary protocol ---------------------------------------------
    def _decode(self, active) -> None:
        rows = torch.arange(self.slots, device=self.device)
        with torch.inference_mode():
            x = self.module.encoder(self._buf)["tokens"]
            # logits at the last written position predict the next token
            logits = self.module.lm_head(x[rows, self._ptr - 1])   # [S, V]
            nxt = _sample(logits, self.temperature, self.pad_id,
                          self._generator)
            write = active & (self._ptr < self.max_len)
            at = self._ptr.clamp_max(self.max_len - 1)
            self._buf[rows, at] = torch.where(write, nxt,
                                              self._buf[rows, at])
            self._ptr += write.long()

    def step(self) -> list:
        """One step boundary: admit pending sequences into free slots, run
        one decode step, account completions. Returns ``(seq_id,
        output_row)`` pairs (``[max_len]`` int32 numpy) finished by this
        step."""
        for a in self.sched.admit():
            row = torch.full((self.max_len,), self.pad_id, dtype=torch.int32)
            row[:len(a.prompt)] = torch.from_numpy(np.asarray(a.prompt))
            self._buf[a.slot] = row.to(self.device)
            self._ptr[a.slot] = len(a.prompt)
            self._active[a.slot] = True
        if not self._active.any():
            return []
        self._decode(torch.from_numpy(self._active).to(self.device))
        self.steps += 1
        done = []
        for seq_id, slot in self.sched.step():
            self._active[slot] = False
            done.append((seq_id, self._buf[slot].cpu().numpy().copy()))
        return done

    def run_until_drained(self) -> dict:
        """Step until every offered sequence completes; returns ``{seq_id:
        [max_len] int32 row}`` (prompt, then generated tokens, then pad)."""
        out = {}
        while self.sched.busy:
            for seq_id, row in self.step():
                out[seq_id] = row
        return out


class TextGenerator(Transformer, HasInputCol, HasOutputCol, HasSeed,
                    HasDevice):
    """Pipeline stage: text prompts → generated continuations (the port of
    the JAX stage, with the same Params plus ``device``).

    A fitted ``BpeTokenizerModel`` encodes the prompts to id rows,
    :func:`generate` decodes them with the causal LM (KV-cached; K2c in the
    prefill with ``pallas`` attention), and the tokenizer's ``decode``
    renders each continuation, which starts at that row's own prompt
    length. Blank prompts become the UNK id 1. With ``draftLm`` the decode
    is speculative (:func:`~mmlspark_torch.dl.speculative.
    generate_speculative`), with the rows grouped by prompt length (one
    call per distinct length): greedy output equals the stage without the
    draft; sampled output is a sample of the lm's distribution, as a
    stream other than the plain stage's.

    ``lm`` and ``draftLm`` hold port ``MaskedLMModel``s that carry their own
    weights (the JAX stage holds ``(module, variables)`` pairs)."""

    tokenizer = StageParam("tokenizer", "fitted BpeTokenizerModel")
    lm = ComplexParam("lm", "a causal MaskedLMModel carrying its trained "
                      "weights")
    maxNewTokens = Param("maxNewTokens", "tokens to generate per row",
                         TC.toInt, default=16, has_default=True)
    temperature = Param("temperature", "0 = greedy; > 0 = sampling",
                        TC.toFloat, default=0.0, has_default=True)
    draftLm = ComplexParam(
        "draftLm", "a smaller same-vocab causal MaskedLMModel: when set, "
        "decoding runs speculatively (dl.speculative: the draft proposes, "
        "the lm verifies speculativeK positions per pass); rows are grouped "
        "by prompt length", default=None, has_default=True)
    speculativeK = Param(
        "speculativeK", "draft tokens proposed per verify pass",
        TC.toInt, default=4, has_default=True)
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._setDefault(inputCol="text", outputCol="generated")

    def _transform(self, df):
        tok = self.get("tokenizer")
        module = self.get("lm")
        if len(df) == 0:
            return df.with_column(self.getOutputCol(), np.empty(0, object))
        ids = tok.transform(
            df.with_column(tok.getInputCol(),
                           df[self.getInputCol()]))[tok.getOutputCol()]
        ids = np.asarray(ids, np.int32)
        # generate() needs non-empty rows: blank prompts get UNK
        ptr = (ids != 0).sum(axis=1)
        ids[ptr == 0, 0] = 1
        ptr = np.maximum(ptr, 1)
        n_new = self.get("maxNewTokens")
        kw = dict(max_new_tokens=n_new, temperature=self.get("temperature"),
                  seed=self.get("seed"), device=self._device())
        draft = self.get("draftLm")
        texts = np.empty(len(ids), object)
        if draft is not None:
            from .speculative import generate_speculative
            # speculation needs dense equal-length rows: one call per
            # distinct prompt length
            for plen in np.unique(ptr):
                rows = np.flatnonzero(ptr == plen)
                out, _ = generate_speculative(
                    module, draft, ids[rows, :plen],
                    k=self.get("speculativeK"), **kw)
                for r, row in zip(rows, out):
                    texts[r] = tok.decode(row[plen:plen + n_new])
            return df.with_column(self.getOutputCol(), texts)
        out = generate(module, ids, **kw)
        texts[:] = [tok.decode(row[p:p + n_new]) for row, p in zip(out, ptr)]
        return df.with_column(self.getOutputCol(), texts)
