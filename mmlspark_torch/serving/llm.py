"""LLM serving engine: prefill and decode over the paged KV cache, with
speculation inside the continuous batch.

The port of ``mmlspark_tpu/serving/llm.py``. Prefill and decode have
opposite profiles (a large causal forward against a tiny step bound by
launch latency), so they get separate executors, stitched together by a
handoff of (sequence, block chain) over the paged KV pool (``dl.paged_kv``):

- :class:`PrefillExecutor` fills KV blocks in padding-bucketed batches,
  starting after any prefix-reused blocks (a warm prompt skips the prefill
  the cache already holds: the TTFT win), and emits each row's first token.
- :class:`DecodeExecutor` runs the fixed-shape continuous-batching step
  over block tables: each step embeds the slots' tokens, scatters their
  k/v through the table in place and attends each slot's own chain with
  the paged attention kernel (K3, ``dl.paged_attention``), with no dense
  gather. With a draft model, the draft proposes k tokens by k + 1 window
  walks of width 1 and the target verifies them in one walk of width
  k + 1; each slot accepts its own longest agreeing prefix.
- The handoff rides :class:`HandoffQueue`; payloads round-trip
  :func:`pack_handoff` / :func:`unpack_handoff` (flat JSON).

Greedy output is token-identical to ``dl.generate`` on the CPU, where both
run the plain attention versions. Every step runs eager PyTorch on the
engine's device; the host fetches the committed tokens once per step (and
each prefill batch's first tokens once), and uploads each step's block
table and slot state in one copy. The pools are updated in place (the JAX
package donates them to its programs instead).

``MMLSPARK_TPU_PAGED_ATTN=0`` (the user's choice; the engine never picks
it itself) runs the JAX package's dense re-gather mode instead: each step
gathers every slot's chain into dense caches (``dl.paged_kv.gather_dense``),
runs the dense cached formulation over them at per-slot positions
(``MaskedLMModel.decode_window``, the JAX engine's vmapped one) and scatters
the written positions back (``take_positions``, ``scatter_positions``); K3
runs 0 times, and ``kv_dense_gather_bytes_total`` counts every gathered
byte.

Obs: ``gen_ttft_seconds{reuse=cold|warm}``, ``gen_tokens_total``,
``gen_spec_accept_ratio``, ``gen_spec_rejected_total``,
``gen_decode_steps_total``, ``gen_decode_attn_seconds{phase}`` and
``kv_dense_gather_bytes_total{phase}`` here, the ``kv_*`` families in
``dl.paged_kv``, in the port's registry.

Not ported yet (ROADMAP.md §1 item 9): AOT fingerprints (``core/aot.py``),
the compile tracker's steady state, cost attribution and the feature log.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..dl.paged_attention import paged_window_attention
from ..dl.paged_kv import (OutOfBlocks, PagedKVManager,
                           blocks_for_hbm_budget, gather_dense, init_pools,
                           paged_attention_enabled, pool_block_bytes,
                           scatter_positions, take_positions)
from ..obs import registry as _default_registry
from ..sched.continuous import SlotScheduler

__all__ = ["LLMEngine", "PrefillExecutor", "DecodeExecutor",
           "HandoffQueue", "pack_handoff", "unpack_handoff"]

_ATTN_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5, 1.,
                 2.5)


def _bucket_window(n: int) -> int:
    """Pad a prefill window to the JAX package's grid (≥64: a multiple of
    64; below: a power of two), so both packages run the same windows."""
    n = max(int(n), 1)
    if n >= 64:
        return ((n + 63) // 64) * 64
    p = 1
    while p < n:
        p <<= 1
    return p


def _paged_window_walk(module, toks, pools, rows, pos, valid, last=None,
                       head: bool = True):
    """The paged forward: [S, w] token ids at per-slot positions
    ``[pos[s], pos[s] + w)`` through every block, reading and writing the
    pools in place through the block table ``rows``.

    Per block: project qkv, scatter the window's k/v through the table
    (write, then attend, as ``decode_window`` does; ``valid`` False sends a
    row's writes to the trash block), then K3 over each slot's chain. The
    embedding, projections and feed-forward are ``embed_window →
    decode_window_blocks``'s. Returns the f32 logits [S, w, V], or with
    ``last`` [S] those of window row ``last[s]`` only ([S, 1, V]: the rows
    are independent, so the head runs where the caller reads), or None
    with ``head=False`` (a cache-fill walk)."""
    enc = module.encoder
    S, w = toks.shape
    at = pos[:, None] + torch.arange(w, device=toks.device)      # [S, w]
    x = enc.embed_window(toks, pos)
    for blk, (kp, vp) in zip(enc.blocks, pools):
        q, k, v = blk._project_qkv(x)                            # [S, H, w, hd]
        scatter_positions(((kp, vp),), rows, at,
                          ((k.transpose(1, 2), v.transpose(1, 2)),), valid)
        o = paged_window_attention(q, kp, vp, rows, pos)
        x = blk.ffn(x + blk._merge_out(o))
    if not head:
        return None
    if last is not None:
        x = x[torch.arange(S, device=x.device), last][:, None]
    return module.lm_head(enc.ln(x.float()))


def _dense_window_walk(module, toks, dense, pos, last=None,
                       head: bool = True):
    """The dense re-gather mode's walk: [S, w] token ids at per-slot
    positions ``[pos[s], pos[s] + w)`` through every block over dense
    caches (``gather_dense``'s, written in place), with
    ``decode_window``'s per-row formulation. Returns what
    :func:`_paged_window_walk` returns."""
    enc = module.encoder
    x = enc.decode_window_blocks(enc.embed_window(toks, pos), dense, pos)
    if not head:
        return None
    if last is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return module.lm_head(x)


def _step_walks(paged: bool, module, pools, draft_module, draft_pools,
                rows):
    """One step's forwards: ``(walk, draft_walk, finish)``, each walk
    called as ``walk(toks, pos, valid, last=None, head=True)``. Paged:
    :func:`_paged_window_walk` over the pools in place, and ``finish`` does
    nothing. Dense: each model's chains are gathered once here, the walks
    run over the dense caches, and ``finish(wrote, valid)`` scatters the
    positions ``wrote`` [S, w] back into the pools (``valid`` False to the
    trash block)."""
    if paged:
        def walker(mod, p):
            return lambda toks, pos, valid, **kw: _paged_window_walk(
                mod, toks, p, rows, pos, valid, **kw)

        draft_walk = None if draft_module is None else walker(
            draft_module, draft_pools)
        return walker(module, pools), draft_walk, lambda wrote, valid: None
    pairs = [(m, p, gather_dense(p, rows, m.encoder.width // m.encoder.heads))
             for m, p in ((module, pools), (draft_module, draft_pools))
             if m is not None]

    def walker(mod, dense):
        return lambda toks, pos, valid, **kw: _dense_window_walk(
            mod, toks, dense, pos, **kw)

    def finish(wrote, valid):
        for _, p, dense in pairs:
            scatter_positions(p, rows, wrote, take_positions(dense, wrote),
                              valid)

    walks = [walker(m, dense) for m, _, dense in pairs]
    return walks[0], walks[1] if len(walks) > 1 else None, finish


def _dense_gather_bytes(module, n_rows: int, max_blocks: int,
                        block_len: int) -> int:
    """Bytes ONE ``gather_dense`` over ``n_rows`` chains materializes for
    ``module``'s pools: what the dense mode moves per call and the paged
    mode does not."""
    enc = module.encoder
    return int(2 * enc.depth * n_rows * max_blocks * block_len * enc.width
               * torch.empty(0, dtype=enc.dtype).element_size())


def _gather_counter(reg):
    return reg.counter(
        "kv_dense_gather_bytes_total",
        "bytes materialized by gather_dense in the dense-attention mode "
        "(0 on the paged-kernel path), by service/phase")


def _upload(device, *arrays):
    """Host int arrays (each [S] or [S, n]) → one int64 copy to ``device``,
    split back into its parts."""
    cols = [np.asarray(a, np.int64).reshape(len(a), -1) for a in arrays]
    packed = torch.from_numpy(np.concatenate(cols, 1)).to(device)
    out, at = [], 0
    for a, c in zip(arrays, cols):
        part = packed[:, at:at + c.shape[1]]
        out.append(part if np.ndim(a) == 2 else part[:, 0])
        at += c.shape[1]
    return out


def _masked_argmax(logits, pad_id: int):
    logits[..., pad_id] = float("-inf")
    return logits.argmax(-1)


# ----------------------------------------------------------------- handoff

def pack_handoff(payload: dict) -> bytes:
    """Serialize a prefill→decode handoff for the wire."""
    return json.dumps(payload, sort_keys=True).encode()


def unpack_handoff(data: bytes) -> dict:
    return json.loads(data.decode())


class HandoffQueue:
    """The prefill→decode boundary: prefill pushes exported sequences,
    decode pulls AT MOST its free-slot count per boundary (load-aware).
    Payloads round-trip :func:`pack_handoff` so the in-process queue and a
    cross-host path would carry identical bytes."""

    def __init__(self):
        self._q: list[dict] = []

    def push(self, payload: dict) -> None:
        self._q.append(unpack_handoff(pack_handoff(payload)))

    def pull(self, max_items: int) -> list[dict]:
        n = max(int(max_items), 0)
        out, self._q = self._q[:n], self._q[n:]
        return out

    def __len__(self) -> int:
        return len(self._q)


def _attn_histogram(reg):
    return reg.histogram(
        "gen_decode_attn_seconds",
        "attention-program wall time, by service and phase",
        buckets=_ATTN_BUCKETS)


# --------------------------------------------------------------- executors

class PrefillExecutor:
    """Fills KV blocks for admitted prompts in padding-bucketed batches:
    the paged window walk over each prompt's SUFFIX (past the prefix-reused
    blocks) at per-row start positions, emitting each row's first
    generated token (the logits at its last prompt position; TTFT is
    measured here). With a draft model the same window also fills the draft
    pools, so prefix-reused blocks hold both models' k/v."""

    def __init__(self, module, kv: PagedKVManager, pools, *,
                 draft_module=None, draft_pools=None, max_blocks: int,
                 batch: int = 4, pad_id: int = 0, service: str = "llm",
                 registry=None, device=None):
        self.module = module
        self.draft_module = draft_module
        self.kv = kv
        self.pools, self.draft_pools = pools, draft_pools
        self.max_blocks = int(max_blocks)
        self.batch = max(int(batch), 1)
        self.pad_id = int(pad_id)
        self.service = service
        self.device = resolve_device(device)
        self.paged = paged_attention_enabled()
        reg = registry if registry is not None else _default_registry
        self._h_attn = _attn_histogram(reg)
        self._c_gather = _gather_counter(reg)
        self._gather_bytes = sum(
            _dense_gather_bytes(m, self.batch, self.max_blocks, kv.block_len)
            for m in (module, draft_module) if m is not None)

    def _run(self, rows, toks, pos, lens) -> np.ndarray:
        """One batch: host arrays in, the first tokens [P] out."""
        rows, toks, pos, lens = _upload(self.device, rows, toks, pos, lens)
        w = toks.shape[1]
        valid = (torch.arange(w, device=self.device)[None] < lens[:, None]) \
            & (lens[:, None] > 0)
        last = (lens - 1).clamp(0, w - 1)
        with torch.inference_mode():
            walk, draft_walk, finish = _step_walks(
                self.paged, self.module, self.pools, self.draft_module,
                self.draft_pools, rows)
            logits = walk(toks, pos, valid, last=last)[:, 0]
            if draft_walk is not None:
                draft_walk(toks, pos, valid, head=False)
            finish(pos[:, None] + torch.arange(w, device=self.device), valid)
            return _masked_argmax(logits, self.pad_id).cpu().numpy()

    def prefill(self, jobs: list) -> dict:
        """``jobs``: ``(seq_id, prompt_tokens)`` pairs whose chains are
        already allocated in ``kv``. Runs bucketed batches, commits lengths
        (``kv.advance`` + ``kv.publish``), returns ``seq_id ->
        (first_token, suffix_len)``."""
        out: dict = {}
        for start in range(0, len(jobs), self.batch):
            chunk = jobs[start:start + self.batch]
            metas = []
            for seq_id, prompt in chunk:
                h = self.kv.handle(seq_id)
                # a fully reused prompt still re-feeds its last token: the
                # window must emit logits for the first generated position
                s0 = min(h.reused_tokens, h.prompt_len - 1)
                metas.append((seq_id, list(prompt), s0, h.prompt_len - s0))
            w = _bucket_window(max(m[3] for m in metas))
            P = self.batch
            toks = np.zeros((P, w), np.int64)
            pos = np.zeros(P, np.int64)
            lens = np.zeros(P, np.int64)
            for i, (_, prompt, s0, n) in enumerate(metas):
                toks[i, :n] = prompt[s0:]
                pos[i] = s0
                lens[i] = n
            ids = [m[0] for m in metas]
            rows = self.kv.block_rows(ids + [None] * (P - len(ids)),
                                      self.max_blocks)
            t0 = time.perf_counter()
            first = self._run(rows, toks, pos, lens)
            self._h_attn.observe(time.perf_counter() - t0,
                                 service=self.service, phase="prefill")
            if not self.paged:
                self._c_gather.inc(self._gather_bytes, service=self.service,
                                   phase="prefill")
            for i, (seq_id, _, _, n) in enumerate(metas):
                h = self.kv.handle(seq_id)
                self.kv.advance(seq_id, h.prompt_len - h.length)
                self.kv.publish(seq_id)
                out[seq_id] = (int(first[i]), int(n))
        return out

    def warm(self, windows=(1,)) -> None:
        """Run one batch per window bucket against the trash block only
        (every row padded): builds the kernels and warms the libraries."""
        P = self.batch
        for w in windows:
            w = _bucket_window(w)
            self._run(np.zeros((P, self.max_blocks), np.int64),
                      np.zeros((P, w), np.int64), np.zeros(P, np.int64),
                      np.zeros(P, np.int64))


class DecodeExecutor:
    """The fixed-shape continuous-batching decode step over block tables:
    ``[slots]`` state vectors and ``[slots, max_blocks]`` tables.

    Plain mode: one paged window walk of width 1 (embed the slots' last
    tokens, scatter k/v through the table, K3 over each chain in place,
    greedy argmax with pad masked): the numerics of ``dl.generate``'s
    cached path. Spec mode (a draft model): k width-1 draft walks and one
    more that fills the draft cache with the last proposal, then one
    width-(k + 1) target walk; each slot accepts its own longest agreeing
    prefix, so block chains advance independently."""

    def __init__(self, module, kv: PagedKVManager, pools, *,
                 draft_module=None, draft_pools=None, slots: int,
                 max_blocks: int, spec_k: int = 0, pad_id: int = 0,
                 service: str = "llm", registry=None, device=None):
        if spec_k and draft_module is None:
            raise ValueError("spec_k > 0 needs a draft model")
        self.module = module
        self.draft_module = draft_module
        self.kv = kv
        self.pools, self.draft_pools = pools, draft_pools
        self.slots = int(slots)
        self.max_blocks = int(max_blocks)
        self.spec_k = int(spec_k)
        self.pad_id = int(pad_id)
        self.service = service
        self.device = resolve_device(device)
        self.paged = paged_attention_enabled()
        reg = registry if registry is not None else _default_registry
        self._h_attn = _attn_histogram(reg)
        self._c_gather = _gather_counter(reg)
        self._gather_bytes = sum(
            _dense_gather_bytes(m, self.slots, self.max_blocks, kv.block_len)
            for m in (module, draft_module) if m is not None)
        # host-side slot state (the engine owns seq metadata)
        self.seq_ids: list = [None] * self.slots
        self.ptr = np.ones(self.slots, np.int64)    # committed tokens
        self.end = np.ones(self.slots, np.int64)    # commit cap
        self.last = np.zeros(self.slots, np.int64)  # token @ ptr-1
        self.active = np.zeros(self.slots, bool)

    @property
    def free_slots(self) -> int:
        return int(self.slots - self.active.sum())

    # -- slot lifecycle -----------------------------------------------------
    def activate(self, slot_hint, state: dict) -> int:
        """Adopt a handoff payload into a free slot: ``slot_hint`` (the
        scheduler's assignment) when free, any free slot otherwise."""
        slot = slot_hint if (slot_hint is not None
                             and not self.active[slot_hint]) else \
            int(np.flatnonzero(~self.active)[0])
        handle = self.kv.adopt(state["seq"])
        self.seq_ids[slot] = handle.seq_id
        # the cache holds [0, prompt_len); the first generated token (from
        # prefill) is committed at position prompt_len, pending its embed
        self.ptr[slot] = handle.length + 1
        self.end[slot] = handle.length + int(state["max_new_tokens"])
        self.last[slot] = int(state["first"])
        self.active[slot] = True
        return slot

    def deactivate(self, slot: int) -> None:
        self.seq_ids[slot] = None
        self.active[slot] = False
        self.ptr[slot] = 1
        self.end[slot] = 1
        self.last[slot] = self.pad_id

    # -- the step -----------------------------------------------------------
    def _verify(self, walk, draft_walk, last, ptr, end, active):
        """The speculative step on the device: returns the committed
        tokens [S, k + 1], the counts committed and the counts accepted."""
        k, S, pad = self.spec_k, self.slots, self.pad_id
        pos, av = ptr - 1, active[:, None]
        tok, drafts = last[:, None], []
        for j in range(k):
            ld = draft_walk(tok, pos + j, av)[:, 0]
            tok = _masked_argmax(ld, pad)[:, None]
            drafts.append(tok[:, 0])
        # the cache-fill walk: d_k's k/v, or after a full accept the next
        # round's draft would attend a hole
        draft_walk(tok, pos + k, av, head=False)
        d = torch.stack(drafts, 1)                              # [S, k]
        window = torch.cat([last[:, None], d], 1)
        lt = walk(window, pos, av.expand(S, k + 1))             # [S, k+1, V]
        t = _masked_argmax(lt, pad)
        n_acc = torch.cumprod((d == t[:, :k]).long(), 1).sum(1)  # per slot
        bonus = t.gather(1, n_acc[:, None])[:, 0]
        ar = torch.arange(k + 1, device=d.device)[None]
        d_ext = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
        committed = torch.where(
            ar < n_acc[:, None], d_ext,
            torch.where(ar == n_acc[:, None], bonus[:, None],
                        torch.full_like(d_ext, pad)))
        # never commit past the slot's budget (end - ptr tokens remain;
        # runnable slots have at least 1)
        n_new = torch.minimum(n_acc + 1, (end - ptr).clamp_min(1))
        return committed, n_new, n_acc

    def _run(self, rows, last, ptr, end, active) -> np.ndarray:
        """One step on the device; returns ``[S, k + 3]`` on the host: the
        committed tokens, the count committed, the count accepted."""
        rows, last, ptr, end, active = _upload(self.device, rows, last, ptr,
                                               end, active)
        active = active.bool()
        with torch.inference_mode():
            walk, draft_walk, finish = _step_walks(
                self.paged, self.module, self.pools, self.draft_module,
                self.draft_pools, rows)
            if self.spec_k == 0:
                logits = walk(last[:, None], ptr - 1, active[:, None])[:, 0]
                committed = _masked_argmax(logits, self.pad_id)[:, None]
                n_new = n_acc = torch.ones_like(ptr)
            else:
                committed, n_new, n_acc = self._verify(
                    walk, draft_walk, last, ptr, end, active)
            w = committed.shape[1]
            finish(ptr[:, None] - 1 + torch.arange(w, device=ptr.device),
                   active[:, None].expand(-1, w))
            zero = torch.zeros_like(n_new)
            out = torch.cat([committed,
                             torch.where(active, n_new, zero)[:, None],
                             torch.where(active, n_acc, zero)[:, None]], 1)
            return out.cpu().numpy()          # the step's one fetch

    @property
    def runnable(self) -> np.ndarray:
        """Slots that decode this step: active AND budget remaining (a
        1-token sequence is complete once its prefill token lands)."""
        return self.active & (self.ptr < self.end)

    def step(self) -> dict:
        """One decode step over every runnable slot. Returns ``slot ->
        (tokens_committed list, n_accepted)``; the caller commits tokens,
        advances the block table and retires finished sequences."""
        runnable = self.runnable
        if not runnable.any():
            return {}
        # capacity for this step's writes: positions up to ptr - 1 + k
        for s in range(self.slots):
            if runnable[s]:
                self.kv.ensure_capacity(self.seq_ids[s],
                                        int(self.ptr[s]) + self.spec_k)
        rows = self.kv.block_rows(
            [sid if runnable[i] else None
             for i, sid in enumerate(self.seq_ids)], self.max_blocks)
        t0 = time.perf_counter()
        out = self._run(rows, self.last, self.ptr, self.end, runnable)
        self._h_attn.observe(time.perf_counter() - t0,
                             service=self.service, phase="decode")
        if not self.paged:
            self._c_gather.inc(self._gather_bytes, service=self.service,
                               phase="decode")
        k1 = self.spec_k + 1
        result = {}
        for s in np.flatnonzero(runnable):
            n = int(out[s, k1])
            toks = [int(t) for t in out[s, :n]]
            self.kv.advance(self.seq_ids[s], n)
            self.ptr[s] += n
            self.last[s] = toks[-1]
            result[int(s)] = (toks, int(out[s, k1 + 1]))
        return result

    def warm(self) -> None:
        """Run the step once with every slot inactive (every write lands in
        the trash block): builds the kernels and warms the libraries."""
        S = self.slots
        self._run(np.zeros((S, self.max_blocks), np.int64),
                  np.zeros(S, np.int64), np.ones(S, np.int64),
                  np.full(S, 2, np.int64), np.zeros(S, np.int64))


# ------------------------------------------------------------------ engine

@dataclass
class _SeqMeta:
    prompt: list
    max_new_tokens: int
    t_submit: float
    slot: int | None = None
    t_first: float | None = None
    first_token: int | None = None
    reused_tokens: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    generated: list = field(default_factory=list)


class LLMEngine:
    """The assembled serving engine: paged KV pool + prefill executor +
    decode executor + continuous-batching scheduler.

    ``module`` (and ``draft_module``) are ``MaskedLMModel``s with causal
    attention that carry their weights (the JAX engine takes ``variables``
    beside each); they move to ``device`` (CUDA unless ``"cpu"`` is asked
    for; without a GPU the default raises). Greedy only (``dl.generate``'s
    temperature-0 semantics: the output contract is token identity).

    ``num_blocks=None`` sizes the pools (the draft's included, at the
    paged kernel's head dim) to ``hbm_fraction`` of the free device memory
    (``torch.cuda.mem_get_info``), or on the CPU to
    ``1 + 2 * slots * max_blocks``; the block budget is read the same way.

    The attention mode is read from ``MMLSPARK_TPU_PAGED_ATTN`` when the
    engine is built: paged (K3) unless it is ``0``, then the dense
    re-gather mode (module docstring).

    ``submit`` then ``step`` at boundaries (or ``run_until_drained``): each
    boundary admits pending sequences through the scheduler (shedding
    expired deadlines), prefills their suffixes in bucketed batches, hands
    off to decode through the load-aware queue, and runs one decode step."""

    def __init__(self, module, *, draft_module=None, slots: int = 2,
                 block_len: int = 8, max_seq_len: int = 128,
                 num_blocks: int | None = None, spec_k: int = 0,
                 pad_id: int = 0, prefill_batch: int = 2,
                 hbm_fraction: float = 0.5, service: str = "llm",
                 registry=None, clock=time.monotonic,
                 device: str | torch.device | None = None):
        dev = resolve_device(device)
        reg = registry if registry is not None else _default_registry
        self.device = dev
        self.module = module.to(dev)
        if draft_module is not None:
            draft_module.to(dev)
        self.pad_id = int(pad_id)
        self.service = service
        self.clock = clock
        self.max_seq_len = int(max_seq_len)
        self.block_len = int(block_len)
        self.max_blocks = -(-self.max_seq_len // self.block_len)
        enc = module.encoder
        # what one block takes in the pools as init_pools allocates them
        # (head dim padded to K3's), the draft's pools included
        block_bytes = sum(pool_block_bytes(m.encoder, self.block_len)
                          for m in (module, draft_module) if m is not None)
        if num_blocks is None:
            num_blocks = blocks_for_hbm_budget(
                block_bytes, fraction=hbm_fraction,
                default=1 + 2 * slots * self.max_blocks, device=dev)
        self.kv = PagedKVManager(
            num_blocks, self.block_len,
            block_budget=blocks_for_hbm_budget(
                block_bytes, fraction=hbm_fraction,
                default=num_blocks - 1, device=dev),
            service=service, registry=reg)
        # per-layer (k, v) pools, the target's and the draft's, which both
        # executors address and update in place
        self.pools = init_pools(enc, num_blocks, self.block_len, dev)
        self.draft_pools = None if draft_module is None else init_pools(
            draft_module.encoder, num_blocks, self.block_len, dev)
        self.sched = SlotScheduler(slots, service=service, registry=reg,
                                   clock=clock)
        self.prefiller = PrefillExecutor(
            module, self.kv, self.pools, draft_module=draft_module,
            draft_pools=self.draft_pools, max_blocks=self.max_blocks, batch=prefill_batch, pad_id=pad_id,
            service=service, registry=reg, device=dev)
        self.decoder = DecodeExecutor(
            module, self.kv, self.pools, draft_module=draft_module,
            draft_pools=self.draft_pools, slots=slots, max_blocks=self.max_blocks, spec_k=spec_k,
            pad_id=pad_id, service=service, registry=reg, device=dev)
        self.handoff = HandoffQueue()
        self._meta: dict = {}
        self._to_prefill: list = []
        self._first_credit: dict = {}
        self._done: dict = {}
        self.expired: list = []
        self._spec_acc = [0, 0]     # accepted, offered
        self._h_ttft = reg.histogram(
            "gen_ttft_seconds",
            "submit→first-token latency, by service and prefix reuse",
            buckets=(.001, .0025, .005, .01, .025, .05, .1, .25, .5,
                     1., 2.5, 5., 10.))
        self._c_tokens = reg.counter(
            "gen_tokens_total", "generated tokens committed, by service")
        self._c_steps = reg.counter(
            "gen_decode_steps_total", "decode steps executed, by service")
        self._g_accept = reg.gauge(
            "gen_spec_accept_ratio",
            "rolling fraction of offered draft tokens accepted, "
            "by service")
        self._c_spec_rejected = reg.counter(
            "gen_spec_rejected_total",
            "offered draft tokens rejected at verification, by service")

    # -- intake ------------------------------------------------------------
    def submit(self, seq_id, prompt, max_new_tokens: int,
               deadline: float | None = None) -> None:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if len(prompt) + int(max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len="
                f"{self.max_seq_len}")
        self._meta[seq_id] = _SeqMeta(prompt=prompt,
                                      max_new_tokens=int(max_new_tokens),
                                      t_submit=self.clock())
        self.sched.offer(seq_id, prompt, max_new_tokens, deadline=deadline)

    # -- one step boundary --------------------------------------------------
    def step(self) -> list:
        """Admit → prefill → handoff → decode. Returns ``(seq_id, tokens)``
        pairs (the full sequence: prompt then generated) finished at this
        boundary."""
        for a in self.sched.admit():
            self._to_prefill.append(a)
        for seq_id in self.sched.drain_expired():
            self._meta.pop(seq_id, None)
            self.expired.append(seq_id)
        self._run_prefill()
        for payload in self.handoff.pull(self.decoder.free_slots):
            meta = self._meta[payload["seq"]["seq_id"]]
            slot = self.decoder.activate(meta.slot, payload)
            meta.slot = slot
            meta.first_token = int(payload["first"])
            # the prefill-produced first token spends 1 of the slot's
            # budget; credit it at this boundary's scheduler step
            self._first_credit[slot] = 1
        finished = []
        results = self.decoder.step()
        if results:
            self._c_steps.inc(1, service=self.service)
        tokens_by_slot = dict(self._first_credit)
        self._first_credit = {}
        for slot, (toks, n_acc) in results.items():
            meta = self._meta[self.decoder.seq_ids[slot]]
            meta.generated.extend(toks)
            meta.decode_steps += 1
            tokens_by_slot[slot] = tokens_by_slot.get(slot, 0) + len(toks)
            self._c_tokens.inc(len(toks), service=self.service)
            if self.decoder.spec_k:
                self._spec_acc[0] += n_acc
                self._spec_acc[1] += self.decoder.spec_k
                rejected = self.decoder.spec_k - n_acc
                if rejected > 0:
                    self._c_spec_rejected.inc(rejected,
                                              service=self.service)
        if self._spec_acc[1]:
            self._g_accept.set(self._spec_acc[0] / self._spec_acc[1],
                               service=self.service)
        active = self.sched.active_slots
        if active:
            # sequences still in prefill/handoff hold scheduler slots but
            # committed nothing this step
            for slot in active:
                tokens_by_slot.setdefault(slot, 0)
            for seq_id, slot in self.sched.step(tokens_by_slot):
                if self.decoder.active[slot] and \
                        self.decoder.seq_ids[slot] == seq_id:
                    self.decoder.deactivate(slot)
                finished.append((seq_id, self._finish(seq_id)))
        return finished

    def _run_prefill(self) -> None:
        ready, still_stalled = [], []
        for a in self._to_prefill:
            try:
                h = self.kv.allocate(a.seq_id, a.prompt)
            except OutOfBlocks:
                # pool saturated: the slot idles (0-token step entries)
                # until decode completions release blocks
                still_stalled.append(a)
                continue
            meta = self._meta[a.seq_id]
            meta.slot = a.slot
            meta.reused_tokens = h.reused_tokens
            ready.append(a)
        self._to_prefill = still_stalled
        if not ready:
            return
        firsts = self.prefiller.prefill([(a.seq_id, a.prompt)
                                         for a in ready])
        now = self.clock()
        for a in ready:
            first, suffix_len = firsts[a.seq_id]
            meta = self._meta[a.seq_id]
            meta.t_first = now
            meta.prefill_tokens = suffix_len
            self._h_ttft.observe(
                now - meta.t_submit, service=self.service,
                reuse="warm" if meta.reused_tokens else "cold")
            self.handoff.push({"seq": self.kv.export_seq(a.seq_id),
                               "first": first,
                               "max_new_tokens": a.max_new_tokens})

    def _finish(self, seq_id) -> np.ndarray:
        meta = self._meta.pop(seq_id)
        self.kv.release(seq_id)
        # prompt + [prefill's first token] + decode commits, trimmed to the
        # budget (the decode step clamps a final speculative burst already)
        full = meta.prompt + [int(meta.first_token)] + \
            [int(t) for t in meta.generated]
        return np.asarray(full[:len(meta.prompt) + meta.max_new_tokens],
                          np.int32)

    # -- warmup --------------------------------------------------------------
    def warm(self, prefill_windows=(1,)) -> dict:
        """Run both phases once against the trash block: prefill for the
        given window buckets, then the decode step. This builds the kernels
        and warms the libraries before the first request. Returns ``{}``:
        the JAX engine returns its programs' AOT fingerprints and can
        declare the compile tracker's steady state (``mark_steady``), but
        eager PyTorch compiles no programs, and the port's AOT store and
        compile tracker come with ROADMAP.md §1 item 9."""
        self.prefiller.warm(prefill_windows)
        self.decoder.warm()
        return {}

    def run_until_drained(self) -> dict:
        """Step until every submitted sequence completes or expires;
        returns ``seq_id -> [prompt + generated] int32 array``."""
        stalled = 0
        while self.sched.busy or self._to_prefill or len(self.handoff):
            before = len(self._done)
            for seq_id, toks in self.step():
                self._done[seq_id] = toks
            # deadlock guard: prefill permanently out of blocks with no
            # in-flight decode to release any is unrecoverable
            if len(self._done) == before and self._to_prefill and \
                    not self.decoder.active.any() and \
                    not len(self.handoff):
                stalled += 1
                if stalled > 3:
                    raise OutOfBlocks(
                        f"{len(self._to_prefill)} sequence(s) cannot "
                        "allocate KV blocks and no in-flight decode can "
                        "release any — the pool is too small for this "
                        "workload")
            else:
                stalled = 0
        out, self._done = self._done, {}
        return out
