"""K3 (paged window attention), the paged KV cache's bookkeeping and
scatter, the slot scheduler and the metrics registry against the JAX
package.

- ``paged_torch`` (K3's plain version) against the JAX ``_paged_reference``
  and ``_paged_pallas`` in Pallas interpret mode at w = 1, 3 and 8 with
  block_len 4 and 8: chains of distinct block ids shuffled across the pool,
  trash padding and an inactive (all-trash) slot; the trash block holds
  zeros, as the engine's pools start, so all three agree there; f32 at
  atol 2e-5;
- ``scatter_positions`` (in place) against the JAX function (new pools),
  invalid rows included: every block but the trash block exactly, since
  colliding trash writes may land in either order;
- ``PagedKVManager`` against the JAX one over one scripted sequence of
  allocate, publish, prefix reuse, ensure_capacity, advance, export/adopt,
  budget eviction and release: ``block_rows`` and ``stats()`` after every
  step, and the ``kv_*`` series, exactly;
- ``SlotScheduler`` the same way, deadline shedding included;
- ``MetricsRegistry``: snapshot and exposition of the same observations,
  and histogram quantiles, exactly;
- K3's split-KV decode kernel: ``decode_plan`` from the shape alone, its
  chunks covering every live chain position of every slot exactly once
  (block_len 8, 16 and 128, all-trash slots included), more than one chunk
  at the smoke's decode shape, one for a short table and at least 132 CTAs
  for one 4096-position chain; ``paged_window_attention`` routing windows
  of up to 16 rows to the decode kernel and wider ones to the window kernel,
  checked through a stand-in for the compiled libraries that computes each
  launch from the pointers and strides it is handed (the decode kernel's
  per-chunk partials written to the wrapper's scratch and merged from there,
  the window kernel with ``paged_torch``), equal to ``paged_torch`` and the
  JAX ``_paged_reference`` (f32, atol 1e-5);
- K3's window kernel: ``window_plan`` from the shape alone, its chunks
  covering every live chain position once at w = 17, 32 and 192 with
  block_len 8, 16 and 128 (one chunk wherever the items fill the card or
  the table is short, as at the engine's and the smoke's shapes); the
  plain version of its two passes (per-chunk partials, then the combine)
  against the JAX ``_paged_reference`` and ``paged_window_attention`` in
  Pallas interpret mode (f32, atol 2e-5), all-trash slots exactly 0; and
  the wrapper's split route through the stand-in (the kernel's partials in
  the scratch, the combine merging them: one launch of each).

On the card, one ``cuda``-marked class holds ``paged_cuda`` (a split chain
and register copies too), ``paged_decode_cuda`` and ``flash_causal_cuda``
against their plain versions; it skips without a GPU.
"""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.dl import paged_kv as jkv
from mmlspark_tpu.dl import pallas_paged_attention as jpaged
from mmlspark_tpu.dl.pallas_paged_attention import (_paged_pallas,
                                                    _paged_reference)
from mmlspark_tpu.obs.metrics import MetricsRegistry as JRegistry
from mmlspark_tpu.sched.continuous import SlotScheduler as JSlotScheduler
import mmlspark_torch.dl.paged_attention as k3
from mmlspark_torch.dl import paged_kv
from mmlspark_torch.dl.flash_attention import flash_causal_cuda, flash_torch
from mmlspark_torch.dl.paged_attention import (decode_plan, paged_cuda,
                                               paged_decode_cuda, paged_torch,
                                               paged_window_attention)
from mmlspark_torch.obs import MetricsRegistry
from mmlspark_torch.sched import SlotScheduler

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for this module: tier-1 runs in several
    worker processes at once, and torch's intra-op threads in each of
    them oversubscribe the cores (small ops then wait on spinning
    threads, ~20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def paged_inputs(S=4, H=2, hd=8, w=1, BL=4, MB=5, seed=0):
    """Seeded q [S, H, w, hd], pools [NB, BL, H, hd] with a zero trash block,
    a block table of shuffled distinct chains padded with the trash block
    (the last slot all trash: inactive) and positions with the window at
    the end of each context."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(w, MB * BL + 1, size=S)
    nblk = -(-ctx // BL)
    nblk[-1] = 0
    NB = 1 + int(nblk.sum()) + 2                 # two spare blocks
    ids = rng.permutation(np.arange(1, NB))
    rows = np.zeros((S, MB), np.int32)
    at = 0
    for s in range(S):
        rows[s, :nblk[s]] = ids[at:at + nblk[s]]
        at += nblk[s]
    pools = rng.normal(size=(2, NB, BL, H, hd)).astype(np.float32)
    pools[:, 0] = 0.0                            # the trash block
    q = rng.normal(size=(S, H, w, hd)).astype(np.float32)
    pos = np.maximum(ctx - w, 0).astype(np.int32)
    return q, pools[0], pools[1], rows, pos


# (w, block_len)
PAGED_CASES = [(1, 4), (3, 4), (8, 8), (3, 8)]


class TestPagedTorch:
    @pytest.mark.parametrize("w,BL", PAGED_CASES)
    def test_matches_jax_reference_and_pallas(self, w, BL):
        q, kp, vp, rows, pos = paged_inputs(w=w, BL=BL, seed=w * 10 + BL)
        jargs = [jnp.asarray(a) for a in (q, kp, vp, rows, pos)]
        ref = np.asarray(_paged_reference(*jargs))
        pallas = np.asarray(_paged_pallas(*jargs, block_kv=BL, slots_tile=2,
                                          interpret=True))
        got = paged_torch(*[torch.from_numpy(a)
                            for a in (q, kp, vp, rows, pos)]).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
        assert (got[-1] == 0).all()              # the inactive slot

    def test_switch(self):
        q, kp, vp, rows, pos = (torch.from_numpy(a)
                                for a in paged_inputs(w=3, seed=5))
        # CPU tensors take the plain version
        assert torch.equal(paged_window_attention(q, kp, vp, rows, pos),
                           paged_torch(q, kp, vp, rows, pos))
        with pytest.raises(ValueError, match="CUDA tensors"):
            paged_cuda(q, kp, vp, rows, pos)
        with pytest.raises(ValueError, match="heads"):
            paged_torch(q[:, :1], kp, vp, rows, pos)


class TestScatter:
    def test_matches_jax_with_invalid_rows(self):
        rng = np.random.default_rng(3)
        S, w, BL, H, hd, NB = 3, 4, 4, 2, 8, 9
        rows = np.array([[3, 5, 0], [7, 1, 0], [0, 0, 0]], np.int32)
        pos = np.array([[2, 3, 4, 5], [0, 1, 2, 3], [0, 1, 2, 3]], np.int32)
        valid = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], bool)
        pools = rng.normal(size=(2, NB, BL, H, hd)).astype(np.float32)
        kv = rng.normal(size=(2, S, w, H, hd)).astype(np.float32)
        (jk, jv), = jkv.scatter_positions(
            ((jnp.asarray(pools[0]), jnp.asarray(pools[1])),),
            jnp.asarray(rows), jnp.asarray(pos),
            ((jnp.asarray(kv[0]), jnp.asarray(kv[1])),),
            valid=jnp.asarray(valid))
        tp = [tuple(torch.from_numpy(p.copy()) for p in pools)]
        out = paged_kv.scatter_positions(
            tp, torch.from_numpy(rows).long(), torch.from_numpy(pos).long(),
            [tuple(torch.from_numpy(a) for a in kv)],
            valid=torch.from_numpy(valid))
        assert out is tp
        for got, want in zip(tp[0], (jk, jv)):
            np.testing.assert_array_equal(got.numpy()[1:],
                                          np.asarray(want)[1:])
        # slot 0's position 4 lands in its second block (5) at offset 0
        assert np.array_equal(tp[0][0].numpy()[5, 0], kv[0][0, 2])


def step_both(port, ref, fn):
    """Apply ``fn`` to both managers; an exception of the same name (each
    package has its own ``OutOfBlocks``), or the same result, in both."""
    try:
        want = fn(ref)
    except Exception as e:                      # noqa: BLE001
        with pytest.raises(Exception) as info:
            fn(port)
        assert type(info.value).__name__ == type(e).__name__
        return None
    got = fn(port)
    if isinstance(want, jkv.SequenceHandle):
        assert got.to_state() == want.to_state()
    elif not isinstance(want, (type(None), jkv.SequenceHandle)):
        assert got == want
    return got


class TestPagedKVManager:
    def test_scripted_lifecycle_matches_jax(self):
        jreg, reg = JRegistry(), MetricsRegistry()
        ref = jkv.PagedKVManager(12, 4, service="t", registry=jreg)
        port = paged_kv.PagedKVManager(12, 4, service="t", registry=reg)
        prefix = [5, 6, 7, 8, 9, 10, 11, 12]
        script = [
            lambda m: m.allocate("a", prefix + [3, 4]),
            lambda m: m.publish("a"),
            lambda m: m.advance("a", 10),
            lambda m: m.allocate("b", prefix + [13]),        # reuses 2 blocks
            lambda m: m.ensure_capacity("a", 15),
            lambda m: m.advance("a", 5),
            lambda m: m.advance("a", 9),                     # past capacity
            lambda m: m.publish("b"),
            lambda m: m.export_seq("b"),
            lambda m: m.adopt({"seq_id": "b", "chain": [1, 2, 11],
                               "length": 9, "prompt_len": 9,
                               "reused_tokens": 8}),         # unowned block
            lambda m: m.adopt({"seq_id": "b", "chain": [1, 2, 4],
                               "length": 9, "prompt_len": 9,
                               "reused_tokens": 8}),
            lambda m: m.release("a"),
            lambda m: m.allocate("c", [1, 2, 3, 4, 9, 9, 9, 9, 2]),
            lambda m: m.publish("c"),
            lambda m: m.release("b"),            # prefix blocks to the cache
            lambda m: m.set_block_budget(5),     # evicts one
            lambda m: m.allocate("d", list(range(2, 30))),   # OutOfBlocks
            lambda m: m.allocate("e", prefix),   # evicts the other, misses
            lambda m: m.capacity("e"),
            lambda m: m.length("c"),
        ]
        for i, fn in enumerate(script):
            step_both(port, ref, fn)
            live = [s for s in ("a", "b", "c", "e") if s in ref._seqs]
            assert port.stats() == ref.stats(), i
            np.testing.assert_array_equal(
                port.block_rows(live + [None], 8),
                ref.block_rows(live + [None], 8))
        snap = reg.snapshot()
        assert snap == jreg.snapshot()
        # the script reached reuse and eviction
        assert snap['kv_prefix_hits_total{service="t"}'] >= 2
        assert snap['kv_evictions_total{service="t"}'] >= 1
        assert port.block_budget == ref.block_budget

    def test_budget_and_pools(self):
        assert paged_kv.blocks_for_hbm_budget(1024, default=7) == 7
        assert paged_kv.blocks_for_hbm_budget(1024, default=7,
                                              device="cpu") == 7

        class Enc:
            width, heads, depth, dtype = 16, 2, 3, torch.bfloat16

        pools = paged_kv.init_pools(Enc, 5, 4, "cpu")
        assert len(pools) == 3
        for k, v in pools:
            # head dim 8 padded to K3's 32 on every device
            assert k.shape == (5, 4, 2, 32) and k.dtype == torch.bfloat16
            assert not k.any() and not v.any()
        assert sum(t.numel() * t.element_size() for kv in pools
                   for t in kv) == 5 * paged_kv.pool_block_bytes(Enc, 4)


class TestSlotScheduler:
    def test_matches_jax(self):
        now = [0.0]
        jreg, reg = JRegistry(), MetricsRegistry()
        ref = JSlotScheduler(2, service="s", registry=jreg,
                             clock=lambda: now[0])
        port = SlotScheduler(2, service="s", registry=reg,
                             clock=lambda: now[0])
        for m in (ref, port):
            m.offer("a", [1], 2)
            m.offer("b", [2], 1)
            m.offer("late", [3], 3, deadline=0.5)
            m.offer("c", [4], 2)
        script = [lambda m: [(a.slot, a.seq_id, a.max_new_tokens)
                             for a in m.admit()],
                  lambda m: m.step(),
                  lambda m: (now.__setitem__(0, 1.0), [
                      (a.slot, a.seq_id) for a in m.admit()])[1],
                  lambda m: m.drain_expired(),
                  lambda m: m.step({0: 0, 1: 2}),
                  lambda m: (m.busy, m.pending_count, m.active_slots),
                  lambda m: m.step(),
                  lambda m: (m.busy, m.active_slots)]
        for fn in script:
            assert fn(port) == fn(ref)
        with pytest.raises(ValueError):
            port.offer("x", [1], 0)
        assert reg.snapshot() == jreg.snapshot()


class TestMetricsRegistry:
    def test_snapshot_exposition_and_quantiles_match_jax(self):
        regs = (JRegistry(), MetricsRegistry())
        for r in regs:
            r.counter("gen_tokens_total", "tokens").inc(3, service="llm")
            r.gauge("kv_blocks_used", "used").set(4, service="llm")
            h = r.histogram("gen_ttft_seconds", "ttft",
                            buckets=(.001, .01, .1, 1.))
            for v in (.002, .004, .05, 2.):
                h.observe(v, service="llm", reuse="cold")
        (jr, pr) = regs
        assert pr.snapshot() == jr.snapshot()
        assert pr.exposition() == jr.exposition()
        jh, ph = (r.metrics("gen_ttft_seconds")[0] for r in regs)
        for q in (0.1, 0.5, 0.99):
            assert ph.quantile(q, service="llm", reuse="cold") == \
                jh.quantile(q, service="llm", reuse="cold")
        with pytest.raises(TypeError):
            pr.gauge("gen_tokens_total")


# ------------------------------------------------- the split-KV decode plan

H100_SMS = 132


def chunk_positions(plan, pos: int, w: int, BL: int,
                    rows) -> list[list[int]]:
    """The chain positions each chunk of ``plan`` reads for one slot whose
    window starts at ``pos`` with block-table row ``rows`` (block ids), as
    the decode kernel walks them: live ones (not the trash block 0, below
    the reachable end ``pos + w``), in chunk order."""
    end = max(0, min(pos + w, len(rows) * BL))
    return [[t for t in range(c * plan.L, min((c + 1) * plan.L, end))
             if rows[t // BL] != 0]
            for c in range(plan.n_chunks)]


class TestDecodePlan:
    @pytest.mark.parametrize("w", [1, 5])
    @pytest.mark.parametrize("BL,MB", [(8, 12), (16, 6), (128, 2)])
    def test_chunks_cover_every_live_position_once(self, BL, MB, w):
        rng = np.random.default_rng(BL + w)
        S = 6
        rows = rng.integers(1, 50, size=(S, MB))
        rows[-1] = 0                                   # an all-trash slot
        rows[1, MB // 2:] = 0                          # trash padding
        rows[2, 0] = 0                                 # a trash entry first
        pos = rng.integers(0, MB * BL, size=S)
        pos[0] = MB * BL - w                           # a full chain
        for n_sm in (1, 8, H100_SMS):
            plan = decode_plan(S, 8, w, 64, BL, MB, 2, n_sm)
            assert plan.L % 16 == 0
            assert (plan.n_chunks - 1) * plan.L < MB * BL \
                <= plan.n_chunks * plan.L
            for s in range(S):
                chunks = chunk_positions(plan, int(pos[s]), w, BL,
                                            list(rows[s]))
                got = [t for c in chunks for t in c]
                want = [t for t in range(min(pos[s] + w, MB * BL))
                        if rows[s, t // BL] != 0]
                assert got == want                     # each once, in order
                for c, ts in enumerate(chunks):
                    assert all(c * plan.L <= t < (c + 1) * plan.L for t in ts)
            assert chunk_positions(plan, int(pos[-1]), w, BL,
                                      list(rows[-1])) == \
                [[] for _ in range(plan.n_chunks)]

    def test_shapes_of_the_smoke(self):
        # the decode shape: 32 slots of 256 blocks of 16, 8 heads of 64
        dec = decode_plan(32, 8, 1, 64, 16, 256, 2, H100_SMS)
        assert dec.n_chunks > 1 and dec.hg == 8 and dec.P == 16
        assert H100_SMS <= dec.ctas <= 3 * H100_SMS
        # one 4096-position chain: at least one CTA per SM
        long = decode_plan(1, 8, 1, 64, 128, 32, 2, H100_SMS)
        assert long.ctas >= H100_SMS
        # a short table: one chunk, no combine
        assert decode_plan(32, 8, 1, 64, 16, 1, 2, H100_SMS).n_chunks == 1
        # wide heads: a CTA takes fewer heads or column groups, never more
        # than 8 consumer warps
        for D, w in ((512, 1), (512, 16), (4096, 1), (384, 5)):
            plan = decode_plan(4, 8, w, D, 16, 16, 4, H100_SMS)
            assert plan.hg * plan.dpc <= 8
            assert plan.n_hg * plan.hg >= 8 and plan.n_dg * plan.dpc >= \
                plan.dch
            assert plan.dch * (128 if w <= 8 else 64) >= D


# ------------------------------------ the switch's route, through a stand-in

def _view(ptr, shape, strides, ctype=ctypes.c_float, dtype=np.float32):
    """A numpy view of memory at ``ptr`` with element strides."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = np.ctypeslib.as_array((ctype * n).from_address(ptr))
    item = np.dtype(dtype).itemsize
    return np.lib.stride_tricks.as_strided(
        buf.view(dtype), shape, [st * item for st in strides])


def _contig(shape):
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


class _FakeLibraries:
    """Stands in for K3's two compiled libraries on CPU f32 tensors: each
    launch rebuilds its tensors from the pointers and strides it is
    handed. The decode launch computes the per-chunk partials with the
    plain first pass, writes them to the wrapper's scratch and merges them
    from there (one chunk: o directly); the window launch runs
    ``paged_torch``."""

    def __init__(self):
        self.calls = []

    def _inputs(self, q, kp, vp, rows, pos, S, H, w, D, NB, BL, MB, qs):
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        return (t(_view(q, (S, H, w, D), (*qs, 1))),
                t(_view(kp, (NB, BL, H, D), _contig((NB, BL, H, D)))),
                t(_view(vp, (NB, BL, H, D), _contig((NB, BL, H, D)))),
                t(_view(rows, (S, MB), (MB, 1), ctypes.c_int32, np.int32)),
                t(_view(pos, (S,), (1,), ctypes.c_int32, np.int32)))

    def mmlspark_paged_decode_launch(self, q, kp, vp, rows, pos, o, pacc,
                                     pml, dtype, S, H, w, D, NB, BL, MB,
                                     q_ss, q_sh, q_sw, o_ss, o_sh, o_sw,
                                     scale, hg, dpc, P, L, n_chunks, *_):
        assert dtype == 1 and w <= k3.DECODE_MAX_ROWS
        self.calls.append(("decode", w, n_chunks))
        q_, kp_, vp_, rows_, pos_ = self._inputs(
            q, kp, vp, rows, pos, S, H, w, D, NB, BL, MB, (q_ss, q_sh, q_sw))
        m, l, acc = k3.paged_partials_torch(q_, kp_, vp_, rows_, pos_, L,
                                            n_chunks, scale)
        n_live = -(-(pos_.long() + w).clamp(0, MB * BL) // L)
        if n_chunks > 1:                     # through the scratch
            C = n_chunks
            pa = _view(pacc, (S, C, H, w, D), _contig((S, C, H, w, D)))
            ml = _view(pml, (S, C, H, w, 2), _contig((S, C, H, w, 2)))
            pa[...] = acc.numpy()
            ml[..., 0], ml[..., 1] = m.numpy(), l.numpy()
            m, l, acc = (torch.from_numpy(np.array(ml[..., 0])),
                         torch.from_numpy(np.array(ml[..., 1])),
                         torch.from_numpy(np.array(pa)))
        else:
            n_live = torch.ones_like(n_live)
        out = k3.paged_combine_torch(m, l, acc, n_live, torch.float32)
        _view(o, (S, H, w, D), (o_ss, o_sh, o_sw, 1))[...] = out.numpy()
        return 0

    def mmlspark_paged_launch(self, q, kp, vp, rows, pos, o, pacc, pml,
                              dtype, S, H, w, D, NB, BL, MB, q_ss, q_sh, q_sw,
                              o_ss, o_sh, o_sw, scale, L, n_chunks, *_):
        assert dtype in (0, 1) and scale == D ** -0.5
        assert L % 128 == 0 and L * n_chunks >= MB * BL
        self.calls.append(("window", w, n_chunks))
        args = self._inputs(q, kp, vp, rows, pos, S, H, w, D, NB, BL, MB,
                            (q_ss, q_sh, q_sw))
        if n_chunks == 1:
            out = paged_torch(*args)
            _view(o, (S, H, w, D), (o_ss, o_sh, o_sw, 1))[...] = out.numpy()
            return 0
        # the kernel's first pass: each chunk's partials into the scratch,
        # o left to the combine
        m, l, acc = k3.paged_partials_torch(*args, L, n_chunks, scale)
        C = n_chunks
        _view(pacc, (S, C, H, w, D), _contig((S, C, H, w, D)))[...] = \
            acc.numpy()
        ml = _view(pml, (S, C, H, w, 2), _contig((S, C, H, w, 2)))
        ml[..., 0], ml[..., 1] = m.numpy(), l.numpy()
        return 0

    def mmlspark_paged_combine_launch(self, pos, o, pacc, pml, dtype, S, H,
                                      w, D, BL, MB, o_ss, o_sh, o_sw, scale,
                                      L, n_chunks, *_):
        self.calls.append(("combine", w, n_chunks))
        C = n_chunks
        acc = torch.from_numpy(np.array(
            _view(pacc, (S, C, H, w, D), _contig((S, C, H, w, D)))))
        ml = np.array(_view(pml, (S, C, H, w, 2), _contig((S, C, H, w, 2))))
        pos_ = torch.from_numpy(np.array(
            _view(pos, (S,), (1,), ctypes.c_int32, np.int32))).long()
        n_live = -(-(pos_ + w).clamp(0, MB * BL) // L)
        out = k3.paged_combine_torch(torch.from_numpy(ml[..., 0]),
                                     torch.from_numpy(ml[..., 1]), acc,
                                     n_live, torch.float32)
        _view(o, (S, H, w, D), (o_ss, o_sh, o_sw, 1))[...] = out.numpy()
        return 0


@pytest.fixture
def decode_route(monkeypatch):
    """The switch's CUDA route on CPU f32 tensors: the stand-in libraries,
    the device check on stand-ins that pass it, an H100's SM count."""
    fake = _FakeLibraries()
    real_check = k3._check_card

    def on_card(t):
        return types.SimpleNamespace(
            device=torch.device("cuda"), dtype=t.dtype, shape=t.shape,
            stride=t.stride, element_size=t.element_size,
            is_contiguous=t.is_contiguous, data_ptr=lambda: 0)

    monkeypatch.setattr(k3, "_check_card", lambda fn, *ts: real_check(
        fn, *map(on_card, ts)))
    monkeypatch.setattr(k3, "_route", lambda q: True)
    monkeypatch.setattr(k3, "_decode_library", lambda: fake)
    monkeypatch.setattr(k3, "_library", lambda: fake)
    monkeypatch.setattr(k3, "_sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return fake


class TestDecodeRoute:
    @pytest.mark.parametrize("w,BL", [(1, 4), (5, 8), (16, 4), (17, 8),
                                      (32, 4)])
    def test_routes_by_window_and_matches_plain_and_jax(self, decode_route,
                                                        w, BL):
        q, kp, vp, rows, pos = paged_inputs(S=4, hd=32, w=w, BL=BL,
                                            MB=-(-40 // BL), seed=w + BL)
        before = (paged_decode_cuda.launches,
                  paged_decode_cuda.combine_launches, paged_cuda.launches)
        args = [torch.from_numpy(a) for a in (q, kp, vp, rows, pos)]
        got = paged_window_attention(*args).numpy()
        want = paged_torch(*args).numpy()
        ref = np.asarray(_paged_reference(*[jnp.asarray(a) for a in
                                            (q, kp, vp, rows, pos)]))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        (kind, rows_w, chunks), = decode_route.calls
        assert kind == ("decode" if w <= 16 else "window") and rows_w == w
        after = (paged_decode_cuda.launches,
                 paged_decode_cuda.combine_launches, paged_cuda.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, int(chunks > 1), 0] if w <= 16 else [0, 0, 1])
        assert w <= 16 or chunks == 1        # a short table: one chunk
        if w <= 16:
            assert chunks > 1                # the merge is exercised

    def test_one_chunk_writes_o_directly(self, decode_route):
        q, kp, vp, rows, pos = (torch.from_numpy(a) for a in paged_inputs(
            S=4, hd=32, w=3, BL=4, MB=2, seed=9))
        before = paged_decode_cuda.combine_launches
        got = paged_window_attention(q, kp, vp, rows, pos)
        np.testing.assert_allclose(got, paged_torch(q, kp, vp, rows, pos),
                                   rtol=0, atol=1e-5)
        assert decode_route.calls == [("decode", 3, 1)]
        assert k3.plan_of(q, kp, rows).n_chunks == 1
        assert paged_decode_cuda.combine_launches == before


class TestWindowPlan:
    """K3's window kernel cuts the chain into chunks only where its work
    items (slot, head, 128-row q tile) are fewer than the SMs and the table
    holds at least two chunks of 512 positions."""

    @pytest.mark.parametrize("w", [17, 32, 192])
    @pytest.mark.parametrize("BL,MB", [(8, 160), (16, 80), (128, 10)])
    def test_chunks_cover_every_live_position_once(self, BL, MB, w):
        rng = np.random.default_rng(BL + w)
        S = 3
        rows = rng.integers(1, 400, size=(S, MB))
        rows[-1] = 0                                   # an all-trash slot
        rows[1, MB // 2:] = 0                          # trash padding
        rows[0, 0] = 0                                 # a trash entry first
        pos = rng.integers(0, MB * BL - w, size=S)
        pos[1] = MB * BL - w                           # a full chain
        for n_sm in (1, 8, H100_SMS):
            plan = k3.window_plan(S, 8, w, 64, BL, MB, 2, n_sm)
            assert plan.L % 128 == 0 and plan.n_qt == -(-w // 128)
            assert (plan.n_chunks - 1) * plan.L < MB * BL \
                <= plan.n_chunks * plan.L
            assert plan.n_chunks == 1 or plan.L >= 512
            assert plan.ctas == min(S * 8 * plan.n_qt * plan.n_chunks, n_sm)
            for s in range(S):
                chunks = chunk_positions(plan, int(pos[s]), w, BL,
                                         list(rows[s]))
                got = [t for c in chunks for t in c]
                want = [t for t in range(min(pos[s] + w, MB * BL))
                        if rows[s, t // BL] != 0]
                assert got == want                     # each once, in order
            assert chunk_positions(plan, int(pos[-1]), w, BL,
                                   list(rows[-1])) == \
                [[] for _ in range(plan.n_chunks)]

    def test_shapes_of_the_smoke_and_the_engine(self):
        def plan(S, w, BL, MB, elem=2, D=64):
            return k3.window_plan(S, 8, w, D, BL, MB, elem, H100_SMS)
        # phase 9's prefill window and the long prompt: enough items, one
        # chunk
        assert plan(32, 128, 16, 256).n_chunks == 1
        long = plan(1, 4096, 128, 32)
        assert long.n_chunks == 1 and long.n_qt == 32
        assert long.ctas == H100_SMS
        # the engine's tables of 18 blocks of 16: under two chunks of 512
        for S, w in ((1, 192), (4, 192), (1, 32)):
            assert plan(S, w, 16, 18).n_chunks == 1
        # a warm suffix over a 4096-position table: split, about an SM each
        warm = plan(1, 32, 16, 256)
        assert warm.n_chunks == 8 and warm.L == 512 and warm.ctas == 64
        # f32 keeps its one-chunk kernel
        assert plan(1, 32, 16, 256, elem=4).n_chunks == 1


class TestWindowPartials:
    """The plain version of the window kernel's two passes at w > 16: each
    chunk's (m, l, acc), then the combine, against the JAX package's
    ``_paged_reference`` and its ``paged_window_attention`` in Pallas
    interpret mode (f32, atol 2e-5: one softmax summed in chunks against
    one in VMEM blocks); all-trash slots exactly 0."""

    @pytest.mark.parametrize("w,BL,L", [(17, 8, 128), (32, 4, 128),
                                        (24, 16, 256)])
    def test_partials_and_combine_match_jax(self, w, BL, L):
        q, kp, vp, rows, pos = paged_inputs(S=4, hd=16, w=w, BL=BL,
                                            MB=-(-(2 * L + 40) // BL),
                                            seed=w + BL)
        cap = rows.shape[1] * BL
        n_chunks = -(-cap // L)
        args = [torch.from_numpy(a) for a in (q, kp, vp, rows, pos)]
        m, l, acc = k3.paged_partials_torch(*args, L, n_chunks)
        n_live = -(-(args[4].long() + w).clamp(0, cap) // L)
        got = k3.paged_combine_torch(m, l, acc, n_live,
                                     torch.float32).numpy()
        jargs = [jnp.asarray(a) for a in (q, kp, vp, rows, pos)]
        ref = np.asarray(_paged_reference(*jargs))
        pallas = np.asarray(jpaged.paged_window_attention(
            *jargs, block_kv=BL, slots_tile=2, impl="pallas",
            interpret=True))
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
        assert (got[-1] == 0).all()

    def test_split_route_matches_plain_and_jax(self, decode_route,
                                               monkeypatch):
        # the wrapper's split route on f32 stand-ins, with the plan a bf16
        # call of this shape gets (f32 itself never splits): the stand-in
        # kernel writes each chunk's partials to the wrapper's scratch, the
        # stand-in combine merges them from there
        q, kp, vp, rows, pos = paged_inputs(S=2, hd=32, w=24, BL=8, MB=160,
                                            seed=3)
        plan = k3.window_plan(2, 2, 24, 32, 8, 160, 2, H100_SMS)
        assert plan.n_chunks > 1
        monkeypatch.setattr(k3, "window_plan_of", lambda *a: plan)
        args = [torch.from_numpy(a) for a in (q, kp, vp, rows, pos)]
        before = (paged_cuda.launches, paged_cuda.combine_launches)
        got = paged_window_attention(*args).numpy()
        assert decode_route.calls == [("window", 24, plan.n_chunks),
                                      ("combine", 24, plan.n_chunks)]
        assert (paged_cuda.launches - before[0],
                paged_cuda.combine_launches - before[1]) == (1, 1)
        np.testing.assert_allclose(got, paged_torch(*args).numpy(), rtol=0,
                                   atol=1e-5)
        ref = np.asarray(_paged_reference(*[jnp.asarray(a) for a in
                                            (q, kp, vp, rows, pos)]))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert (got[-1] == 0).all()


@pytest.mark.cuda
class TestCudaKernels:
    def test_kernels_match_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (K2c and K3 are CUDA-only; "
                        "their plain versions are held against the JAX "
                        "package on the CPU)")
        dev = torch.device("cuda")
        for dtype, atol in ((torch.float32, ATOL), (torch.bfloat16, 2e-2)):
            q, kp, vp, rows, pos = (torch.from_numpy(a).to(dev)
                                    for a in paged_inputs(w=5, hd=64,
                                                          BL=8, seed=1))
            q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
            got = paged_cuda(q, kp, vp, rows, pos)
            torch.testing.assert_close(got.float(),
                                       paged_torch(q, kp, vp, rows,
                                                   pos).float(),
                                       rtol=0, atol=atol)
            assert (got[-1] == 0).all()
            x = [torch.randn(2, 2, 100, 64, device=dev, dtype=dtype)
                 for _ in range(3)]
            mask = torch.rand(2, 100, device=dev) > 0.3
            for offs in ((0, 0), (20, 3), (0, 200)):
                got = flash_causal_cuda(*x, mask, q_offset=offs[0],
                                        k_offset=offs[1])
                want = flash_torch(*x, mask, causal=True, q_offset=offs[0],
                                   k_offset=offs[1])
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=0, atol=atol)
        torch.cuda.synchronize()

    def test_window_kernel_matches_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the window kernel is "
                        "CUDA-only; its plan and its two passes are held "
                        "on the CPU)")
        dev = torch.device("cuda")
        # a split chain (one slot, a 2560-position table), block lengths
        # 16, 8 and 4 (TMA boxes) and 5 at hd 32 (register copies)
        for S, w, BL, MB, hd in ((1, 24, 16, 160, 64), (4, 40, 8, 20, 64),
                                 (4, 40, 4, 20, 64), (4, 40, 5, 16, 32)):
            q, kp, vp, rows, pos = (torch.from_numpy(a).to(dev)
                                    for a in paged_inputs(
                                        S=S, hd=hd, w=w, BL=BL, MB=MB,
                                        seed=w + BL))
            q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
            got = paged_cuda(q, kp, vp, rows, pos)
            torch.testing.assert_close(
                got.float(), paged_torch(q, kp, vp, rows, pos).float(),
                rtol=0, atol=2e-2)
            if S > 1:
                assert (got[-1] == 0).all()
            assert torch.equal(got, paged_cuda(q, kp, vp, rows, pos))
        torch.cuda.synchronize()

    def test_decode_kernel_matches_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the split-KV decode kernel is "
                        "CUDA-only; its plan and route are held on the CPU)")
        dev = torch.device("cuda")
        for w, BL, MB in ((1, 8, 64), (5, 16, 32), (16, 128, 4), (3, 4, 2)):
            for dtype, atol in ((torch.float32, ATOL),
                                (torch.bfloat16, 2e-2)):
                q, kp, vp, rows, pos = (torch.from_numpy(a).to(dev)
                                        for a in paged_inputs(
                                            S=6, hd=64, w=w, BL=BL, MB=MB,
                                            seed=w))
                q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
                got = paged_decode_cuda(q, kp, vp, rows, pos)
                torch.testing.assert_close(
                    got.float(), paged_torch(q, kp, vp, rows, pos).float(),
                    rtol=0, atol=atol)
                assert (got[-1] == 0).all()
                assert torch.equal(got, paged_decode_cuda(q, kp, vp, rows,
                                                          pos))
        torch.cuda.synchronize()
