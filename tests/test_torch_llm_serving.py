"""The port's LLM serving engine (``serving/llm.py``) against its own
``generate`` and the JAX package's engine: the counterparts of
``tests/test_llm_serving.py``.

The contract is token identity: greedy paged serving (plain, speculative
with a disagreeing draft, and self-draft) gives byte for byte the tokens
the port's ``generate`` gives per prompt, and those of the JAX
``LLMEngine`` on the same weights (carried across by
``masked_lm_from_flax``; the tiny causal LM of vocab 32, width 16, depth 1,
heads 2, f32). Prefix reuse, the TTFT split, deadline shedding, the
``OutOfBlocks`` guard and the handoff are asserted on the port's registry
and bookkeeping. The dense re-gather mode (``MMLSPARK_TPU_PAGED_ATTN=0``):
``gather_dense`` and ``take_positions`` equal the JAX package's exactly, the
engine's tokens equal the paged mode's (and the JAX dense engine's) without
a paged-attention call, and ``kv_dense_gather_bytes_total`` counts one
gather per prefill batch and per decode step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.dl import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl import TextEncoder as JTextEncoder
from mmlspark_tpu.dl import make_attention_fn as jmake_attention
from mmlspark_tpu.dl.paged_kv import gather_dense as jgather_dense
from mmlspark_tpu.dl.paged_kv import take_positions as jtake_positions
from mmlspark_tpu.obs.metrics import MetricsRegistry as JRegistry
from mmlspark_tpu.serving.llm import LLMEngine as JLLMEngine
import mmlspark_torch.serving.llm as port_llm
from mmlspark_torch.dl import (OutOfBlocks, gather_dense, generate,
                               make_attention_fn, take_positions)
from mmlspark_torch.models import masked_lm_from_flax
from mmlspark_torch.obs import MetricsRegistry
from mmlspark_torch.serving import (HandoffQueue, LLMEngine, pack_handoff,
                                    unpack_handoff)

VOCAB, MAXNEW = 32, 4
ARCH = dict(vocab=VOCAB, width=16, depth=1, heads=2, mlp_dim=32)


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


def _jax_lm(seed):
    jm = JMaskedLMModel(JTextEncoder(**ARCH, dtype=jnp.float32,
                                     attention_fn=jmake_attention(
                                         "dense", causal=True)))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                 np.zeros((1, 8), np.int32))
    port = masked_lm_from_flax(jax.tree.map(np.asarray, variables),
                               heads=2, dtype=torch.float32,
                               attention_fn=make_attention_fn(
                                   "pallas", causal=True))
    return jm, variables, port


@pytest.fixture(scope="module")
def lm():
    return _jax_lm(0)


@pytest.fixture(scope="module")
def draft(lm):
    # same architecture, other weights: a draft that disagrees with the
    # target some of the time
    return _jax_lm(7)[2]


def _prompts(seed=0, sizes=(3, 5, 2, 6, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, VOCAB, size=n).astype(np.int32) for n in sizes]


def _ref(model, prompts, max_new=MAXNEW):
    return {i: generate(model, p[None, :], max_new_tokens=max_new,
                        device="cpu")[0][:len(p) + max_new]
            for i, p in enumerate(prompts)}


def _engine(model, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return LLMEngine(model, block_len=4, device="cpu", **kw)


def _serve(eng, prompts, max_new=MAXNEW):
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new)
    return eng.run_until_drained()


class TestHandoff:
    def test_pack_unpack_roundtrip(self):
        payload = {"seq": {"seq_id": "s0", "chain": [3, 1, 2],
                           "length": 9, "prompt_len": 9,
                           "reused_tokens": 4},
                   "first": 17, "max_new_tokens": 8}
        assert unpack_handoff(pack_handoff(payload)) == payload
        assert pack_handoff(payload) == pack_handoff(
            dict(reversed(list(payload.items()))))

    def test_queue_is_fifo_and_wire_shaped(self):
        q = HandoffQueue()
        q.push({"seq": {"seq_id": 0}, "first": 1, "max_new_tokens": 2})
        q.push({"seq": {"seq_id": 1}, "first": 2, "max_new_tokens": 2})
        assert len(q) == 2
        assert [p["seq"]["seq_id"] for p in q.pull(1)] == [0]
        assert q.pull(5)[0]["seq"]["seq_id"] == 1
        assert q.pull(1) == []


class TestGreedyIdentity:
    def test_paged_matches_generate_and_the_jax_engine(self, lm):
        jm, variables, model = lm
        prompts = _prompts()
        got = _serve(_engine(model, slots=2, max_seq_len=16), prompts)
        jeng = JLLMEngine(jm, variables, slots=2, block_len=4,
                          max_seq_len=16, registry=JRegistry())
        want = _serve(jeng, prompts)
        ref = _ref(model, prompts)
        assert set(got) == set(want) == set(ref)
        for i in ref:
            assert got[i].dtype == np.int32
            np.testing.assert_array_equal(got[i], ref[i])
            np.testing.assert_array_equal(got[i], want[i])

    def test_speculative_matches_generate(self, lm, draft):
        model = lm[2]
        prompts = _prompts(seed=3)
        reg = MetricsRegistry()
        got = _serve(_engine(model, draft_module=draft, slots=2,
                             max_seq_len=16, spec_k=2, registry=reg),
                     prompts)
        ref = _ref(model, prompts)
        for i in ref:
            np.testing.assert_array_equal(got[i], ref[i])
        ratio = reg.snapshot()['gen_spec_accept_ratio{service="llm"}']
        assert 0.0 <= ratio < 1.0           # the draft disagrees sometimes

    def test_self_draft_accepts_everything(self, lm):
        model = lm[2]
        prompts = _prompts(seed=5, sizes=(4, 3))
        reg = MetricsRegistry()
        got = _serve(_engine(model, draft_module=model, slots=2,
                             max_seq_len=16, spec_k=2, registry=reg),
                     prompts)
        ref = _ref(model, prompts)
        for i in ref:
            np.testing.assert_array_equal(got[i], ref[i])
        assert reg.snapshot()['gen_spec_accept_ratio{service="llm"}'] == 1.0

    def test_single_token_budget(self, lm):
        # the prefill-produced first token IS the whole budget: the
        # sequence finishes without a decode step
        model = lm[2]
        p = _prompts(seed=9, sizes=(5,))
        reg = MetricsRegistry()
        got = _serve(_engine(model, slots=1, max_seq_len=16, registry=reg),
                     p, max_new=1)
        np.testing.assert_array_equal(got[0], _ref(model, p, 1)[0])
        assert 'gen_decode_steps_total{service="llm"}' not in reg.snapshot()


class TestPrefixReuseAndTTFT:
    def test_repeated_prefix_hits_and_ttft_split(self, lm):
        model = lm[2]
        reg = MetricsRegistry()
        eng = _engine(model, slots=1, max_seq_len=24, service="llmttft",
                      registry=reg)
        p = _prompts(seed=11, sizes=(16,))[0]
        ref = _ref(model, [p])[0]
        eng.submit("cold", p, MAXNEW)
        got1 = eng.run_until_drained()
        eng.submit("warm", p, MAXNEW)
        got2 = eng.run_until_drained()
        # reuse is invisible to the tokens
        np.testing.assert_array_equal(got1["cold"], ref)
        np.testing.assert_array_equal(got2["warm"], ref)
        snap = reg.snapshot()
        assert snap['kv_prefix_hits_total{service="llmttft"}'] >= 1.0
        assert snap[
            'kv_prefix_tokens_reused_total{service="llmttft"}'] >= 4.0
        h = reg.metrics("gen_ttft_seconds")[0]
        assert h.count(service="llmttft", reuse="cold") == 1
        assert h.count(service="llmttft", reuse="warm") == 1

    def test_expired_deadline_is_shed_not_served(self, lm):
        eng = _engine(lm[2], slots=1, max_seq_len=16)
        p = _prompts(sizes=(3,))[0]
        eng.submit("dead", p, 2, deadline=-1.0)     # already expired
        eng.submit("live", p, 2)
        got = eng.run_until_drained()
        assert "dead" not in got and "live" in got
        assert eng.expired == ["dead"]

    def test_pool_too_small_raises_instead_of_spinning(self, lm):
        eng = _engine(lm[2], slots=1, max_seq_len=16, num_blocks=2)
        eng.submit(0, _prompts(sizes=(9,))[0], MAXNEW)  # needs 3 blocks
        with pytest.raises(OutOfBlocks):
            eng.run_until_drained()


class TestSurface:
    def test_warm_device_and_left_out_modes(self, lm, monkeypatch):
        model = lm[2]
        eng = _engine(model, slots=2, max_seq_len=16)
        fps = eng.warm(prefill_windows=(1, 4))
        P = eng.prefiller.batch
        # the JAX engine's program names, each with its AOT fingerprints
        assert sorted(fps) == ["llm_decode_paged_llm_S2_k0",
                               f"llm_prefill_llm_w1_b{P}",
                               f"llm_prefill_llm_w4_b{P}"]
        assert all(len(fp) == 64 for pair in fps.values() for fp in pair)
        assert eng.kv.stats()["used"] == 0         # warm writes only trash
        got = _serve(eng, _prompts(seed=13, sizes=(3, 6)))
        assert len(got) == 2
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.submit("long", np.arange(2, 20), 4)
        assert eng.prefiller.paged and eng.decoder.paged
        # the dense re-gather mode is ported: the switch builds it
        monkeypatch.setenv("MMLSPARK_TPU_PAGED_ATTN", "0")
        dense = _engine(model)
        assert not dense.prefiller.paged and not dense.decoder.paged
        monkeypatch.delenv("MMLSPARK_TPU_PAGED_ATTN")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            LLMEngine(model)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            generate(model, np.array([[3, 4]], np.int32), max_new_tokens=1)


class TestDenseMode:
    def test_gather_and_take_equal_jax(self):
        rng = np.random.default_rng(21)
        NB, BL, H, hd, S, MB = 7, 4, 2, 8, 3, 3
        pools = [tuple(rng.normal(size=(NB, BL, H, hd)).astype(np.float32)
                       for _ in range(2)) for _ in range(2)]
        rows = np.array([[3, 1, 0], [2, 5, 6], [0, 0, 0]], np.int64)
        pos = np.array([[2, 3], [9, 10], [0, 1]], np.int64)
        want = jgather_dense(jax.tree.map(jnp.asarray, pools),
                             jnp.asarray(rows))
        # the port's pools carry K3's head dim (32): zero columns past hd
        padded = [tuple(torch.nn.functional.pad(torch.from_numpy(a),
                                                (0, 32 - hd)) for a in layer)
                  for layer in pools]
        got = gather_dense(padded, torch.from_numpy(rows), head_dim=hd)
        for (gk, gv), (wk, wv) in zip(got, want):
            assert gk.shape == (S, H, MB * BL, hd)
            np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        want_t = jtake_positions(want, jnp.asarray(pos))
        got_t = take_positions(got, torch.from_numpy(pos))
        for (gk, gv), (wk, wv) in zip(got_t, want_t):
            assert gk.shape == (S, 2, H, hd)
            np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))

    @pytest.mark.parametrize("spec", ["plain", "draft", "self_draft"])
    def test_dense_tokens_equal_paged_and_count_bytes(self, lm, draft,
                                                      spec, monkeypatch):
        jm, variables, model = lm
        prompts = _prompts(seed=6, sizes=(7, 3, 5))
        kw = dict(slots=2, max_seq_len=16, prefill_batch=2)
        if spec != "plain":
            kw.update(draft_module=model if spec == "self_draft" else draft,
                      spec_k=2)
        paged = _serve(_engine(model, **kw), prompts)
        calls = []
        real = port_llm.paged_window_attention
        monkeypatch.setattr(port_llm, "paged_window_attention",
                            lambda *a: calls.append(1) or real(*a))
        monkeypatch.setenv("MMLSPARK_TPU_PAGED_ATTN", "0")
        reg = MetricsRegistry()
        eng = _engine(model, registry=reg, **kw)
        dense = _serve(eng, prompts)
        assert calls == []                       # K3 never ran
        ref = _ref(model, prompts)
        for i in ref:
            np.testing.assert_array_equal(dense[i], paged[i])
            np.testing.assert_array_equal(dense[i], ref[i])
        if spec == "plain":
            jeng = JLLMEngine(jm, variables, block_len=4,
                              registry=JRegistry(), **kw)
            assert not jeng.decoder.paged
            want = _serve(jeng, prompts)
            for i in ref:
                np.testing.assert_array_equal(dense[i], want[i])
        # one gather of every model's chains per prefill batch and decode
        # step: 2 (k, v) x depth 1 x rows x 4 blocks x 4 positions x width
        # 16 x 4 bytes
        h = reg.metrics("gen_decode_attn_seconds")[0]
        models = 1 if spec == "plain" else 2
        per_row = models * 2 * 1 * 4 * 4 * 16 * 4
        c = reg.metrics("kv_dense_gather_bytes_total")[0]
        for phase, rows in (("prefill", 2), ("decode", 2)):
            n = h.count(service="llm", phase=phase)
            assert n > 0
            assert c.value(service="llm", phase=phase) == n * rows * per_row
