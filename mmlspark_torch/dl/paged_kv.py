"""Paged (block) KV cache for LLM serving: host block table + device pools.

The port of ``mmlspark_tpu/dl/paged_kv.py``. The cache is carved into fixed
``[num_blocks, block_len, heads, head_dim]`` pools per layer and each
sequence holds a CHAIN of block indices: memory is taken in
``block_len``-token quanta as decoding advances, and a block holding a
popular prompt prefix is shared copy-free between sequences via refcounts.

- **Host half** (:class:`PagedKVManager`, pure Python): free-list
  allocation, per-sequence chains, refcounted prefix reuse keyed by a
  rolling prompt-prefix hash, LRU eviction of retired-but-cached blocks,
  handoff export/adopt, and the ``kv_*`` series, with the JAX package's
  semantics line for line.
- **Device half**: :func:`init_pools` (``torch.zeros``: a masked key still
  meets its value in the attention product, so pools never hold stale
  NaNs; head dim padded to the paged kernel's, :func:`pool_head_dim`)
  and :func:`scatter_positions`, which writes a window's k/v through the
  block table IN PLACE (the JAX package returns new pools instead).

Block 0 is RESERVED as the trash block: padded batch rows and inactive
slots point their block-table entries at it, so fixed-shape steps can
always write "somewhere" without corrupting a live sequence; the paged
attention kernel skips it.

The dense re-gather mode behind ``MMLSPARK_TPU_PAGED_ATTN=0``
(:func:`paged_attention_enabled`) uses :func:`gather_dense` and
:func:`take_positions`: the engine gathers each slot's chain into dense
caches, runs the dense cached formulation over them and scatters the
written positions back.
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs import registry as _default_registry
from .flash_attention import kernel_head_dim, pad_head_dim

__all__ = ["PagedKVManager", "SequenceHandle", "OutOfBlocks", "TRASH_BLOCK",
           "blocks_for_hbm_budget", "gather_dense", "init_pools",
           "paged_attention_enabled", "pool_block_bytes", "pool_head_dim",
           "scatter_positions", "take_positions"]

#: the reserved trash block — device steps route padded/inactive writes
#: here; the host half never hands it to a sequence
TRASH_BLOCK = 0

def paged_attention_enabled() -> bool:
    """The JAX package's switch: ``MMLSPARK_TPU_PAGED_ATTN=0`` asks for the
    dense re-gather mode (the paged attention kernel, K3, then runs 0
    times); anything else, or unset, the paged mode. Only the user's
    setting picks the dense mode."""
    return os.environ.get("MMLSPARK_TPU_PAGED_ATTN", "1") != "0"


class OutOfBlocks(RuntimeError):
    """The pool cannot serve an allocation: every non-reserved block is
    referenced by a live sequence (nothing evictable). Callers queue the
    sequence and retry at a later step boundary — admission control,
    not a crash."""


@dataclass
class SequenceHandle:
    """One sequence's view of the pool: the block chain and how many
    token positions are filled. ``prompt_len`` rides along so executors
    can split prefill cost from decode cost without a side channel."""
    seq_id: object
    chain: list[int]
    length: int
    prompt_len: int
    reused_tokens: int = 0
    # hashes for the full prompt chunks this sequence must publish into
    # the prefix index once prefill has actually filled them
    pending_publish: list[tuple[str, int]] = field(default_factory=list)

    def to_state(self) -> dict:
        """JSON-able handoff payload (the mesh ``__lease__`` envelope
        carries dicts): everything the decode side needs to adopt the
        sequence."""
        return {"seq_id": self.seq_id, "chain": list(self.chain),
                "length": int(self.length),
                "prompt_len": int(self.prompt_len),
                "reused_tokens": int(self.reused_tokens)}

    @classmethod
    def from_state(cls, state: dict) -> "SequenceHandle":
        return cls(seq_id=state["seq_id"],
                   chain=[int(b) for b in state["chain"]],
                   length=int(state["length"]),
                   prompt_len=int(state["prompt_len"]),
                   reused_tokens=int(state.get("reused_tokens", 0)))


def _chunk_hash(prev: str, tokens) -> str:
    """Rolling hash for one full ``block_len`` chunk: commits to the
    previous chunk's hash, so equal blocks match only on equal whole
    prefixes (prefix reuse must never splice a block into a different
    history)."""
    h = hashlib.blake2b(prev.encode(), digest_size=16)
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.hexdigest()


class PagedKVManager:
    """Host-side block table: pure-Python bookkeeping, no device.

    ``num_blocks`` counts the WHOLE pool including the reserved trash
    block 0; ``block_budget`` (optional, defaults to every allocatable
    block) caps how many blocks may be used+cached at once — set it
    from :func:`blocks_for_hbm_budget` to keep the KV pools under the
    live HBM headroom, or lower it at runtime via
    :meth:`set_block_budget` (cached blocks are LRU-evicted to fit).

    Lifecycle per sequence::

        h = mgr.allocate(seq_id, prompt_tokens)   # prefix reuse happens here
        mgr.publish(seq_id)                       # after prefill fills blocks
        mgr.ensure_capacity(seq_id, n)            # before writes past capacity
        mgr.advance(seq_id, k)                    # after k tokens committed
        mgr.release(seq_id)                       # blocks cached for reuse

    A released sequence's published prompt blocks stay in the prefix
    index (refcount 0, LRU-ordered) until eviction recycles them — the
    "cache" in KV cache hit rate.
    """

    def __init__(self, num_blocks: int, block_len: int, *,
                 block_budget: int | None = None, service: str = "llm",
                 registry=None):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the "
                             "reserved trash block)")
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        reg = registry if registry is not None else _default_registry
        self.num_blocks = int(num_blocks)
        self.block_len = int(block_len)
        self.service = service
        self._free: deque[int] = deque(range(1, self.num_blocks))
        self._ref: dict[int, int] = {}
        self._seqs: dict[object, SequenceHandle] = {}
        # published full prompt chunks: hash -> block, block -> hash
        self._prefix_index: dict[str, int] = {}
        self._block_hash: dict[int, str] = {}
        # zero-ref published blocks, least-recently-retired first
        self._lru: OrderedDict[int, str] = OrderedDict()
        self._budget = int(block_budget) if block_budget else \
            self.num_blocks - 1
        self._budget = max(min(self._budget, self.num_blocks - 1), 1)
        self._g_used = reg.gauge(
            "kv_blocks_used",
            "KV blocks referenced by live sequences, by service")
        self._g_free = reg.gauge(
            "kv_blocks_free",
            "KV blocks on the free list (never-written or recycled), "
            "by service")
        self._g_cached = reg.gauge(
            "kv_blocks_cached",
            "retired zero-ref KV blocks still indexed for prefix "
            "reuse, by service")
        self._c_hits = reg.counter(
            "kv_prefix_hits_total",
            "prompt-prefix blocks served copy-free from the index, "
            "by service")
        self._c_misses = reg.counter(
            "kv_prefix_misses_total",
            "full prompt chunks that found no indexed block, by service")
        self._c_reused = reg.counter(
            "kv_prefix_tokens_reused_total",
            "prompt tokens whose prefill was skipped via prefix reuse, "
            "by service")
        self._c_evict = reg.counter(
            "kv_evictions_total",
            "cached KV blocks recycled under pool/HBM pressure, "
            "by service")
        self._publish_gauges()

    # -- internals ---------------------------------------------------------
    def _publish_gauges(self) -> None:
        self._g_used.set(len(self._ref), service=self.service)
        self._g_free.set(len(self._free), service=self.service)
        self._g_cached.set(len(self._lru), service=self.service)

    def _in_budget(self) -> bool:
        return len(self._ref) + len(self._lru) < self._budget

    def _evict_one(self) -> int | None:
        """Recycle the least-recently-retired cached block onto the
        free list; None when nothing is evictable."""
        if not self._lru:
            return None
        block, h = self._lru.popitem(last=False)
        self._prefix_index.pop(h, None)
        self._block_hash.pop(block, None)
        self._free.append(block)
        self._c_evict.inc(1, service=self.service)
        return block

    def _take_block(self) -> int:
        # budget first: even with free blocks in hand, used+cached must
        # stay under the HBM-derived cap, so pressure evicts the cache
        # before it grows the working set
        while not self._in_budget():
            if self._evict_one() is None:
                raise OutOfBlocks(
                    f"block budget {self._budget} exhausted by live "
                    f"sequences ({len(self._ref)} blocks referenced)")
        if not self._free and self._evict_one() is None:
            raise OutOfBlocks(
                f"all {self.num_blocks - 1} blocks referenced by live "
                "sequences — queue the request and retry at the next "
                "step boundary")
        return self._free.popleft()

    # -- intake ------------------------------------------------------------
    def allocate(self, seq_id, prompt_tokens) -> SequenceHandle:
        """Build ``seq_id``'s chain for ``prompt_tokens``: reuse indexed
        blocks for the longest matching whole-chunk prefix (refcount++,
        copy-free), allocate fresh blocks for the rest. The handle's
        ``reused_tokens`` tells the prefill executor where to start —
        the TTFT win is exactly the prefill it skips."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        prompt = [int(t) for t in np.asarray(prompt_tokens).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        bl = self.block_len
        full_chunks = len(prompt) // bl
        chain: list[int] = []
        pending: list[tuple[str, int]] = []
        reused = 0
        h = ""
        matching = True
        try:
            for c in range(full_chunks):
                h = _chunk_hash(h, prompt[c * bl:(c + 1) * bl])
                block = self._prefix_index.get(h) if matching else None
                if block is not None:
                    self._c_hits.inc(1, service=self.service)
                    self._ref[block] = self._ref.get(block, 0) + 1
                    if block in self._lru:       # revived from cache
                        del self._lru[block]
                    chain.append(block)
                    reused += bl
                    continue
                if matching:
                    matching = False
                self._c_misses.inc(1, service=self.service)
                block = self._take_block()
                self._ref[block] = 1
                chain.append(block)
                pending.append((h, block))
            # tail block for the partial prompt chunk; decode growth is
            # on-demand via ensure_capacity
            if len(prompt) % bl:
                block = self._take_block()
                self._ref[block] = 1
                chain.append(block)
        except OutOfBlocks:
            # unwind: a half-allocated chain must not leak references
            for b in chain:
                self._unref(b)
            self._publish_gauges()
            raise
        if reused:
            self._c_reused.inc(reused, service=self.service)
        handle = SequenceHandle(seq_id=seq_id, chain=chain,
                                length=reused, prompt_len=len(prompt),
                                reused_tokens=reused,
                                pending_publish=pending)
        self._seqs[seq_id] = handle
        self._publish_gauges()
        return handle

    def publish(self, seq_id) -> int:
        """Index ``seq_id``'s freshly prefilled full prompt chunks for
        future prefix reuse. Call AFTER the prefill executor has written
        the blocks — publishing earlier would let a concurrent allocate
        share a block whose kv is still zeros. Returns chunks published."""
        handle = self._seqs[seq_id]
        n = 0
        for h, block in handle.pending_publish:
            # first writer wins: two identical prompts racing through
            # prefill both hold private blocks; only one gets indexed
            if h not in self._prefix_index and block in self._ref:
                self._prefix_index[h] = block
                self._block_hash[block] = h
                n += 1
        handle.pending_publish = []
        return n

    # -- growth / accounting -----------------------------------------------
    def capacity(self, seq_id) -> int:
        return len(self._seqs[seq_id].chain) * self.block_len

    def length(self, seq_id) -> int:
        return self._seqs[seq_id].length

    def handle(self, seq_id) -> SequenceHandle:
        return self._seqs[seq_id]

    def ensure_capacity(self, seq_id, tokens: int) -> SequenceHandle:
        """Grow ``seq_id``'s chain until it can hold ``tokens`` positions
        (speculative decode writes up to k+1 ahead each step)."""
        handle = self._seqs[seq_id]
        while len(handle.chain) * self.block_len < tokens:
            block = self._take_block()
            self._ref[block] = 1
            handle.chain.append(block)
        self._publish_gauges()
        return handle

    def advance(self, seq_id, n: int = 1) -> int:
        """Account ``n`` committed token positions; returns the new
        length. Positions must already be within capacity."""
        handle = self._seqs[seq_id]
        new_len = handle.length + int(n)
        if new_len > len(handle.chain) * self.block_len:
            raise ValueError(
                f"sequence {seq_id!r} advanced past capacity "
                f"({new_len} > {len(handle.chain)} blocks × "
                f"{self.block_len})")
        handle.length = new_len
        return handle.length

    # -- retirement --------------------------------------------------------
    def _unref(self, block: int) -> None:
        refs = self._ref.get(block, 0) - 1
        if refs > 0:
            self._ref[block] = refs
            return
        self._ref.pop(block, None)
        h = self._block_hash.get(block)
        if h is not None and self._prefix_index.get(h) == block:
            self._lru[block] = h        # retire into the reuse cache
            self._lru.move_to_end(block)
        else:
            self._block_hash.pop(block, None)
            self._free.append(block)

    def release(self, seq_id) -> None:
        """Drop the sequence: published blocks retire into the LRU reuse
        cache, everything else returns to the free list."""
        handle = self._seqs.pop(seq_id)
        for block in handle.chain:
            self._unref(block)
        self._publish_gauges()

    # -- handoff (prefill -> decode over the mesh lease plumbing) ----------
    def export_seq(self, seq_id) -> dict:
        """Detach the sequence for handoff: ownership of its block
        references moves WITH the returned payload (the manager keeps
        the refcounts; the seq is simply no longer addressable here
        until :meth:`adopt` re-registers it). Round-trips through JSON
        — the shape the mesh ``__lease__`` envelope carries."""
        handle = self._seqs.pop(seq_id)
        if handle.pending_publish:
            raise ValueError(
                f"sequence {seq_id!r} still has unpublished prefill "
                "blocks — publish() before handoff")
        self._publish_gauges()
        return handle.to_state()

    def adopt(self, state: dict) -> SequenceHandle:
        """Re-register an exported sequence (same pool — prefill and
        decode executors share the device pools on a host; cross-host
        adoption additionally ships the block contents)."""
        handle = SequenceHandle.from_state(state)
        if handle.seq_id in self._seqs:
            raise ValueError(f"sequence {handle.seq_id!r} already "
                             "registered")
        for block in handle.chain:
            if block not in self._ref:
                raise ValueError(
                    f"handoff chain references unowned block {block} — "
                    "the payload does not match this pool")
        self._seqs[handle.seq_id] = handle
        self._publish_gauges()
        return handle

    # -- device bridge -----------------------------------------------------
    def block_rows(self, seq_ids, max_blocks: int) -> np.ndarray:
        """``[len(seq_ids), max_blocks]`` int32 block table for the
        fixed-shape device step: each row is the sequence's chain padded
        with the trash block. ``None`` entries (empty slots) become
        all-trash rows."""
        rows = np.full((len(seq_ids), int(max_blocks)), TRASH_BLOCK,
                       np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None:
                continue
            chain = self._seqs[sid].chain
            if len(chain) > max_blocks:
                raise ValueError(
                    f"sequence {sid!r} has {len(chain)} blocks > "
                    f"max_blocks={max_blocks}")
            rows[i, :len(chain)] = chain
        return rows

    # -- budget / introspection --------------------------------------------
    def set_block_budget(self, budget: int) -> int:
        """Lower (or raise) the used+cached cap; cached blocks are
        LRU-evicted immediately to fit. Returns blocks evicted — the
        fleet health plane calls this when ``mem_hbm_*`` pressure
        crosses its watermark.

        Eviction here aligns with :meth:`_take_block`'s strict
        ``used + cached < budget`` pre-allocation invariant: a shrink
        pays its whole eviction debt now (counted
        ``kv_evictions_total``), so the next ``allocate`` never evicts
        on the lowered budget's behalf. Stopping at ``== budget`` — the
        old behaviour — left exactly one cached block to be reclaimed
        lazily at the next allocation."""
        self._budget = max(min(int(budget), self.num_blocks - 1), 1)
        evicted = 0
        while len(self._ref) + len(self._lru) >= self._budget:
            if self._evict_one() is None:
                break
            evicted += 1
        self._publish_gauges()
        return evicted

    @property
    def block_budget(self) -> int:
        return self._budget

    def stats(self) -> dict:
        """One-glance pool state (the bench banks hit rate from the
        registry; this is the debugging view)."""
        return {
            "blocks": self.num_blocks,
            "block_len": self.block_len,
            "budget": self._budget,
            "used": len(self._ref),
            "free": len(self._free),
            "cached": len(self._lru),
            "sequences": len(self._seqs),
            "indexed_prefixes": len(self._prefix_index),
        }


def blocks_for_hbm_budget(block_bytes: int, *, fraction: float = 0.5,
                          default: int = 0,
                          device: str | torch.device | None = None) -> int:
    """How many KV blocks fit in ``fraction`` of the CURRENT free memory of
    ``device`` (``torch.cuda.mem_get_info``) when it is a CUDA device;
    ``default`` otherwise (the CPU has no device budget to read)."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or block_bytes <= 0:
        return int(default)
    free, _ = torch.cuda.mem_get_info(dev)
    return max(int(free * float(fraction)) // int(block_bytes), 0)


# --------------------------------------------------------------- device half

def pool_head_dim(encoder) -> int:
    """The head dim of ``encoder``'s KV pools on every device: K3's
    (``kernel_head_dim``: the next of 32/64/128/256, above 256 the next
    multiple of 128), so the kernels read the pools in place at any width
    and the extra columns stay zero."""
    return kernel_head_dim(encoder.width // encoder.heads)


def pool_block_bytes(encoder, block_len: int) -> int:
    """Bytes one block takes in ``encoder``'s k and v pools over all its
    layers, as :func:`init_pools` allocates them."""
    return (2 * encoder.depth * int(block_len) * encoder.heads
            * pool_head_dim(encoder)
            * torch.empty(0, dtype=encoder.dtype).element_size())


def init_pools(encoder, num_blocks: int, block_len: int,
               device: str | torch.device | None = None):
    """Per-layer ``[num_blocks, block_len, heads, pool_head_dim]`` k and v
    pools for ``encoder`` (a ``TextEncoder``), zeroed, in its compute
    dtype: ``num_blocks * pool_block_bytes(encoder, block_len)`` bytes."""
    shape = (int(num_blocks), int(block_len), encoder.heads,
             pool_head_dim(encoder))
    return [tuple(torch.zeros(shape, dtype=encoder.dtype, device=device)
                  for _ in range(2)) for _ in range(encoder.depth)]


def _flat_positions(rows, pos, block_len: int):
    """[S, w] absolute positions -> flat pool rows via the block table:
    ``rows[s, p // bl] * bl + p % bl``. Out-of-chain positions clamp into
    the table's last entry (the trash block for a padded row)."""
    bi = (pos // block_len).clamp(0, rows.shape[1] - 1)
    return torch.gather(rows, 1, bi) * block_len + pos % block_len


def scatter_positions(pools, rows, pos, new_kv, valid=None):
    """Write per-layer ``[S, w, H, hd]`` k/v into the pools IN PLACE at
    absolute positions ``pos`` ([S, w], int64) through the block table
    ``rows`` ([S, max_blocks], int64). Positions with ``valid`` ([S, w]
    bool) false (padded prefill rows, inactive decode slots) go to the
    trash block's first row: every step writes a fixed index set without
    touching a live chain. Live chains are disjoint, so real blocks never
    collide; trash writes may, harmlessly (the trash block is never
    attended). The window's head dim is zero-padded to the pools'
    (:func:`pool_head_dim`). Returns ``pools``."""
    for (k_pool, v_pool), (kw, vw) in zip(pools, new_kv):
        NB, BL, H, hd = k_pool.shape
        kw, vw = pad_head_dim(kw, hd), pad_head_dim(vw, hd)
        fidx = _flat_positions(rows, pos, BL)
        if valid is not None:
            fidx = torch.where(valid, fidx, TRASH_BLOCK * BL)
        fidx = fidx.reshape(-1)
        k_pool.view(NB * BL, H, hd).index_copy_(0, fidx,
                                                kw.reshape(-1, H, hd))
        v_pool.view(NB * BL, H, hd).index_copy_(0, fidx,
                                                vw.reshape(-1, H, hd))
    return pools



def gather_dense(pools, rows, head_dim: int):
    """Gather each slot's chained blocks into dense per-layer caches
    ``[S, heads, max_blocks * block_len, head_dim]``: the cache layout
    ``MaskedLMModel.decode_step``/``decode_window`` run over. Positions at
    or past a slot's length hold stale or trash data, which the decode mask
    never attends. ``rows``: the block table ``[S, max_blocks]`` (int64);
    ``head_dim``: the model's head dim (the pools' padding past it, to K3's
    head dim, is left out). The dense re-gather mode counts what this
    materializes in ``kv_dense_gather_bytes_total``."""
    S, MB = rows.shape
    out = []
    for k_pool, v_pool in pools:
        NB, BL, H, _ = k_pool.shape
        idx = (rows[:, :, None] * BL + torch.arange(BL, device=rows.device)
               ).reshape(S, MB * BL)
        out.append(tuple(
            pool.view(NB * BL, H, -1)[:, :, :head_dim][idx].transpose(1, 2)
            .contiguous() for pool in (k_pool, v_pool)))
    return out


def take_positions(dense, pos):
    """The k/v written at absolute positions ``pos`` ([S, w], int64) of
    dense caches ``[S, H, L, hd]`` → per-layer ``[S, w, H, hd]``, what the
    step scatters back into the pools (:func:`scatter_positions`).
    Positions past the cache read its last entry (padding rows only)."""
    out = []
    for k, v in dense:
        idx = pos.clamp_max(k.shape[2] - 1)[:, None, :, None].expand(
            k.shape[0], k.shape[1], pos.shape[1], k.shape[3])
        out.append((k.gather(2, idx).transpose(1, 2),
                    v.gather(2, idx).transpose(1, 2)))
    return out
