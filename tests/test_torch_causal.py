"""Causal attention, cached decoding and ``generate`` (the LLM slice)
against the JAX package.

The same seeded inputs (numpy) and, for the models, the same weights
(carried across by ``masked_lm_from_flax``) go through both packages, with
the tiny causal LM of ``tests/test_llm_serving.py`` (vocab 32, width 16,
depth 1, heads 2, mlp 32, f32):
- the causal ``flash_torch`` (K2c's plain version) against the JAX
  ``_flash_forward(causal=True)`` in Pallas interpret mode, on the packed
  path (K2c) and, with ``_PACKED_KV_BYTES`` set to 0 for the call, on the
  streaming path (causal K2a): offsets (including none reachable), a key
  mask with a fully masked row, a ragged T; f32 at atol 2e-5;
- ``_dense_attention(causal=True)`` and ``make_attention_fn(impl,
  causal=True)`` for ``dense``/``pallas``/``blockwise``: atol 2e-5;
- ``decode_step``, ``prefill``, ``decode_window`` and ``prefill_caches``:
  logits at atol 1e-4, caches at atol 2e-5;
- ``assert_causal``: a causal model passes, a bidirectional one raises;
- greedy ``generate``: tokens equal the JAX package's on ragged
  right-padded prompts, cached and re-encoding, with prefill lengths on
  both sides of 64; the input errors match; ``temperature > 0`` is
  reproducible by seed and never emits the pad id.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.dl import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl import TextEncoder as JTextEncoder
from mmlspark_tpu.dl import generate as jgenerate
from mmlspark_tpu.dl import pallas_attention as jpa
from mmlspark_tpu.dl.text_encoder import _dense_attention as jdense
from mmlspark_tpu.dl.text_encoder import make_attention_fn as jmake_attention
from mmlspark_torch.dl import assert_causal, generate, make_attention_fn
from mmlspark_torch.dl.flash_attention import flash_attention, flash_torch
from mmlspark_torch.dl.text_encoder import _dense_attention
from mmlspark_torch.models import masked_lm_from_flax

ATOL = 2e-5            # tests/test_pallas_attention.py's f32 tolerance
LOGIT_ATOL = 1e-4      # the text encoder tests' f32 logit tolerance
VOCAB = 32
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


def make_inputs(B=2, H=2, T=48, D=16, seed=0, empty_row=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((B, T)) > 0.3
    if empty_row:
        mask[0] = False
    return q, k, v, mask


def t(*xs):
    return [torch.from_numpy(x) for x in xs]


# (T, q_offset, k_offset): (0, 64) leaves nothing reachable; T=40 is ragged
# for the 16-wide blocks
FLASH_CASES = {"plain": (48, 0, 0), "q_ahead": (48, 16, 0),
               "nothing_reachable": (48, 0, 64), "ragged": (40, 5, 3)}


class TestCausalFlashTorch:
    @pytest.mark.parametrize("path", ["packed", "streaming"])
    @pytest.mark.parametrize("case", sorted(FLASH_CASES))
    def test_matches_jax_flash_interpret(self, case, path, monkeypatch):
        T, q_off, k_off = FLASH_CASES[case]
        q, k, v, mask = make_inputs(T=T, seed=T + q_off + k_off)
        if path == "streaming":
            # the streaming grid with the `_block_reachable` skip (causal
            # K2a) takes over when K/V exceed the packed budget; unjitted,
            # so the constant is read in this call
            monkeypatch.setattr(jpa, "_PACKED_KV_BYTES", 0)
        want = np.asarray(jpa._flash_forward.__wrapped__(
            *[jnp.asarray(x) for x in (q, k, v)], jnp.asarray(mask),
            jnp.asarray([[q_off, k_off]], jnp.int32), block_q=16,
            block_k=16, interpret=True, causal=True))
        got = flash_torch(*t(q, k, v, mask), causal=True, q_offset=q_off,
                          k_offset=k_off).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert (got[0] == 0).all()                   # the fully masked row
        if case == "nothing_reachable":
            assert (got == 0).all()

    def test_switch_without_grad_and_what_still_raises(self):
        q, k, v, mask = make_inputs(T=24, seed=3)
        tq, tk, tv, tm = t(q, k, v, mask)
        want = flash_torch(tq, tk, tv, tm, causal=True, q_offset=4)
        with torch.inference_mode():
            got = flash_attention(tq, tk, tv, tm, causal=True, q_offset=4)
        assert torch.equal(got, want)
        # under grad (the causal-training slice) the same output through
        # the autograd Function, with a gradient
        tk.requires_grad_(True)
        out = flash_attention(tq, tk, tv, tm, causal=True, q_offset=4)
        assert type(out.grad_fn).__name__ == "_FlashBackward"
        assert torch.equal(out.detach(), want)
        out.sum().backward()
        assert torch.isfinite(tk.grad).all()


class TestDenseAndSwitches:
    def test_dense_causal_matches_jax(self):
        q, k, v, mask = make_inputs(T=40, seed=7)
        want = np.asarray(jdense(*[jnp.asarray(x) for x in (q, k, v)],
                                 key_mask=jnp.asarray(mask), causal=True))
        got = _dense_attention(*t(q, k, v, mask), causal=True).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert (got[0] == 0).all()

    @pytest.mark.parametrize("impl", ["dense", "pallas", "blockwise"])
    def test_make_attention_fn_causal(self, impl):
        q, k, v, mask = make_inputs(T=40, seed=8)
        want = np.asarray(jmake_attention("dense", causal=True)(
            *[jnp.asarray(x) for x in (q, k, v)], jnp.asarray(mask)))
        fn = make_attention_fn(impl, block_size=16, causal=True)
        got = fn(*t(q, k, v, mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        # causal differs from the default
        assert not np.allclose(make_attention_fn(impl, block_size=16)(
            *t(q, k, v, mask)).numpy(), want, atol=1e-3)


# --------------------------------------------------------------- the LM

@pytest.fixture(scope="module")
def lm():
    """The tiny causal LM in both packages on the same weights: the JAX
    module with dense causal attention, the port's with ``pallas`` causal
    (its CPU route is the plain K2c)."""
    jm = JMaskedLMModel(JTextEncoder(**ARCH, dtype=jnp.float32,
                                     attention_fn=jmake_attention(
                                         "dense", causal=True)))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 np.zeros((1, 8), np.int32))
    params = jax.tree.map(np.asarray, variables)
    pm = masked_lm_from_flax(params, heads=2, dtype=torch.float32,
                             attention_fn=make_attention_fn(
                                 "pallas", causal=True))
    return jm, variables, pm


def empty_caches(B, L, depth=1, heads=2, hd=8):
    return [tuple(torch.zeros(B, heads, L, hd) for _ in range(2))
            for _ in range(depth)]


def jcaches(B, L, depth=1, heads=2, hd=8):
    return tuple((jnp.zeros((B, heads, L, hd)), jnp.zeros((B, heads, L, hd)))
                 for _ in range(depth))


def assert_caches(got, want):
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                                   atol=ATOL)


class TestCachedDecoding:
    def test_prefill_decode_step_and_window(self, lm):
        jm, variables, pm = lm
        B, L, P = 2, 12, 5
        ids = np.random.default_rng(4).integers(2, VOCAB, (B, L)) \
            .astype(np.int32)
        # prefill (prefill_caches) of the first P positions
        # jitted: flax's eager apply compiles op by op
        jc = jax.jit(lambda v, x, c: jm.apply(v, x, c, method="prefill"))(
            variables, jnp.asarray(ids[:, :P]), jcaches(B, L))
        caches = empty_caches(B, L)
        with torch.inference_mode():
            assert pm.prefill(torch.from_numpy(ids[:, :P]), caches) \
                is caches
        assert_caches(caches, jc)
        # one decode step at position P
        jl, jc = jax.jit(lambda v, x, c, p: jm.apply(
            v, x, c, p, method="decode_step"))(
            variables, jnp.asarray(ids[:, P]), jc, jnp.int32(P))
        with torch.inference_mode():
            logits = pm.decode_step(torch.from_numpy(ids[:, P]), caches, P)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        assert_caches(caches, jc)
        # a window of 4 positions after it
        w = ids[:, P + 1:P + 5]
        jl, jc = jax.jit(lambda v, x, c, p: jm.apply(
            v, x, c, p, method="decode_window"))(
            variables, jnp.asarray(w), jc, jnp.int32(P + 1))
        with torch.inference_mode():
            logits = pm.decode_window(torch.from_numpy(w), caches, P + 1)
        assert logits.shape == (B, 4, VOCAB)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        assert_caches(caches, jc)
        # the cached logits equal the full causal forward's
        with torch.inference_mode():
            full = pm(torch.from_numpy(ids[:, :P + 5]))["logits"]
        np.testing.assert_allclose(logits.numpy(), full[:, P + 1:].numpy(),
                                   rtol=0, atol=LOGIT_ATOL)

    def test_block_prefill_matches_jax(self, lm):
        jm, variables, pm = lm
        x = np.random.default_rng(5).normal(size=(2, 7, 16)) \
            .astype(np.float32)
        jy, jk, jv = jax.jit(lambda v, x: jm.apply(
            v, x, method=lambda m, x: m.encoder.blocks[0].prefill(x)))(
            variables, jnp.asarray(x))
        with torch.inference_mode():
            y, k, v = pm.encoder.blocks[0].prefill(torch.from_numpy(x))
        for got, want in ((y, jy), (k, jk), (v, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)

    def test_assert_causal(self, lm):
        _, _, pm = lm
        probe = np.random.default_rng(6).integers(2, VOCAB, (1, 9))
        assert assert_causal(pm, probe, VOCAB) <= 1e-4
        bidirectional = copy.deepcopy(pm)
        bidirectional.encoder = bidirectional.encoder.with_attention(
            make_attention_fn("dense"))
        with pytest.raises(ValueError, match="FUTURE"):
            assert_causal(bidirectional, probe, VOCAB)


def ragged_prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    out = np.zeros((len(lengths), max(lengths)), np.int32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.integers(2, VOCAB, n)
    return out


# prompt lengths: the shared prefix min(ptr) - 1 is prefilled, bucketed to
# a power of two below 64 and to a multiple of 64 from 64 up
GEN_CASES = {"short": ((5, 9, 6), 6), "long": ((70, 90), 5)}


class TestGenerate:
    @pytest.mark.parametrize("use_cache", [True, False])
    @pytest.mark.parametrize("case", sorted(GEN_CASES))
    def test_greedy_matches_jax(self, lm, case, use_cache):
        jm, variables, pm = lm
        lengths, new = GEN_CASES[case]
        prompts = ragged_prompts(lengths, len(lengths))
        want = np.asarray(jgenerate(jm, variables, prompts,
                                    max_new_tokens=new, use_cache=use_cache))
        got = generate(pm, prompts, max_new_tokens=new, use_cache=use_cache,
                       device="cpu")
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_input_errors_match(self, lm):
        jm, variables, pm = lm
        bad = {"RIGHT-padded": np.array([[0, 3, 4], [5, 6, 7]], np.int32),
               "empty": np.array([[0, 0, 0], [5, 6, 7]], np.int32)}
        for match, prompts in bad.items():
            for fn in (lambda p: jgenerate(jm, variables, p,
                                           max_new_tokens=2),
                       lambda p: generate(pm, p, max_new_tokens=2,
                                          device="cpu")):
                with pytest.raises(ValueError, match=match):
                    fn(prompts)
        ok = np.array([[3, 4, 5]], np.int32)
        for fn in (lambda: jgenerate(jm, variables, ok, max_new_tokens=4,
                                     max_len=5),
                   lambda: generate(pm, ok, max_new_tokens=4, max_len=5,
                                    device="cpu")):
            with pytest.raises(ValueError, match="cannot hold"):
                fn()

    def test_sampling_is_reproducible_and_never_pad(self, lm):
        _, _, pm = lm
        prompts = ragged_prompts((4, 6), 9)
        kw = dict(max_new_tokens=6, temperature=5.0, device="cpu")
        a = generate(pm, prompts, seed=3, **kw)
        np.testing.assert_array_equal(a, generate(pm, prompts, seed=3, **kw))
        assert not np.array_equal(a, generate(pm, prompts, seed=4, **kw))
        for row, n in zip(a, (4, 6)):
            assert (row[n:n + 6] != 0).all()
        assert (generate(pm, prompts, use_cache=False, seed=3, **kw)
                [:, :4] == prompts[:, :4]).all()
