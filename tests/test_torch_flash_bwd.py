"""K2b, K2d and K2e (the flash forward with the lse, and the fused
backward) against the JAX package.

The same seeded inputs (numpy, f32) go through the port's plain versions
and autograd Functions and through the JAX package's Pallas kernels in
interpret mode, as ``tests/test_pallas_attention.py`` runs them, at tiny
shapes (B=2, H=2, T <= 64, blocks of 16):
- ``flash_lse_torch`` against ``_flash_forward(with_lse=True)`` (K2b), with a
  ragged T and a fully masked row;
- ``flash_bwd_torch`` against ``_flash_backward`` (K2d, K2e) from the JAX
  forward's o and lse and the same cotangent, with and without ``dlse``;
- ``flash_attention``'s gradients (fused and blockwise backward) against
  ``jax.grad`` of the JAX ``flash_attention`` with the same ``bwd_impl``,
  and against autograd through the port's ``_dense_attention``;
- ``flash_attention_lse``'s gradients through both outputs against the JAX
  function with its fused backward forced on (``_FORCE_FUSED_LSE_BWD``, the
  test hook the JAX package's own tests set).
Tolerance: f32 at atol 2e-5 (``tests/test_pallas_attention.py``'s), with
an rtol of 1e-5 for the gradients, whose sums run over up to 64 terms of
either sign in other orders.

On the card, one ``cuda``-marked test holds the kernels against their plain
versions; it skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmlspark_tpu.dl.pallas_attention as jpa
import mmlspark_torch.dl.flash_attention as k2
from mmlspark_torch.dl.text_encoder import _dense_attention
from mmlspark_torch.parallel import blockwise_attention

ATOL = 2e-5           # tests/test_pallas_attention.py's f32 tolerance
GRAD_RTOL = 1e-5
BLOCK = 16
BF16_ULP = 2.0 ** -7  # bf16 spacing at 1 (8 significand bits)


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


def make_inputs(T=40, D=16, seed=0, empty_row=True, B=2, H=2):
    """q, k, v, g [B, H, T, D] f32, dlse [B, H, T] f32 and a [B, T] key
    mask; ``empty_row`` makes batch row 0 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, H, T, D)).astype(np.float32)
                  for _ in range(4))
    dlse = rng.normal(size=(B, H, T)).astype(np.float32)
    mask = rng.random((B, T)) > 0.3
    if empty_row:
        mask[0] = False
    return q, k, v, g, dlse, mask


def t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]   # writable copies


def jx(*xs):
    return [jnp.asarray(x) for x in xs]


def close(got, want, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=ATOL)


# (T, D, empty_row): T=40 and T=50 divide by no block
CASES = {"ragged_empty_row": (40, 16, True), "ragged": (50, 32, False),
         "even": (64, 16, True)}


@pytest.fixture(scope="module")
def jax_forward():
    """The JAX K2b output (o, lse) for every case, computed once."""
    out = {}
    for case, (T, D, empty) in CASES.items():
        q, k, v, _, _, mask = make_inputs(T, D, seed=T + D, empty_row=empty)
        o, lse = jpa._flash_forward(*jx(q, k, v, mask), block_q=BLOCK,
                                    block_k=BLOCK, interpret=True,
                                    with_lse=True)
        out[case] = (np.asarray(o), np.asarray(lse))
    return out


class TestLseForward:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_jax_interpret(self, case, jax_forward):
        T, D, empty = CASES[case]
        q, k, v, _, _, mask = make_inputs(T, D, seed=T + D, empty_row=empty)
        want_o, want_lse = jax_forward[case]
        o, lse = k2.flash_lse_torch(*t(q, k, v, mask))
        assert lse.dtype == torch.float32 and lse.shape == (2, 2, T)
        close(o, want_o)
        close(lse, want_lse, rtol=1e-6)
        if empty:
            assert torch.equal(o[0], torch.zeros_like(o[0]))
            assert (lse[0] <= -1e29).all() and (want_lse[0] <= -1e29).all()

    def test_matches_blockwise_lse(self):
        # the port's blockwise_attention(return_lse=True) is the CPU oracle
        q, k, v, _, _, mask = make_inputs(50, 16, seed=4)
        o, lse = k2.flash_lse_torch(*t(q, k, v, mask))
        bo, blse = blockwise_attention(*t(q, k, v), key_mask=t(mask)[0],
                                       block_size=BLOCK, return_lse=True)
        close(o, bo)
        close(lse, blse, rtol=1e-6)


class TestBackwardPlain:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("with_dlse", [False, True])
    def test_matches_jax_interpret(self, case, with_dlse, jax_forward):
        T, D, empty = CASES[case]
        q, k, v, g, dlse, mask = make_inputs(T, D, seed=T + D,
                                             empty_row=empty)
        o, lse = jax_forward[case]
        dl = dlse if with_dlse else None
        want = jpa._flash_backward(*jx(q, k, v, mask, o, lse, g),
                                   dlse=None if dl is None
                                   else jnp.asarray(dl),
                                   block_q=BLOCK, block_k=BLOCK,
                                   interpret=True)
        got = k2.flash_bwd_torch(*t(q, k, v, mask, o, lse, g),
                                 None if dl is None else t(dl)[0])
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)
        if empty:
            dq, dk, dv = got
            assert torch.equal(dq[0], torch.zeros_like(dq[0]))
            invalid = ~t(mask)[0]
            assert (dk.transpose(1, 2)[invalid] == 0).all()
            assert (dv.transpose(1, 2)[invalid] == 0).all()

    def test_dq_and_dkv_are_the_fused_backward(self):
        q, k, v, g, dlse, mask = make_inputs(40, 16, seed=9)
        tq, tk, tv, tg, tdl, tm = t(q, k, v, g, dlse, mask)
        o, lse = k2.flash_lse_torch(tq, tk, tv, tm)
        dsum = k2.flash_dsum(o, tg, tdl)
        assert dsum.shape == (2, 2, 40) and dsum.is_contiguous()
        torch.testing.assert_close(
            dsum, (tg * o).sum(-1) - tdl, rtol=0, atol=1e-6)
        dq, dk, dv = k2.flash_bwd_torch(tq, tk, tv, tm, o, lse, tg, tdl)
        assert torch.equal(dq, k2.flash_dq_torch(tq, tk, tv, tm, tg, lse,
                                                 dsum))
        got_dk, got_dv = k2.flash_dkv_torch(tq, tk, tv, tm, tg, lse, dsum)
        assert torch.equal(dk, got_dk) and torch.equal(dv, got_dv)

    def test_bf16_rounds_ds_and_p_like_the_tpu(self):
        # bf16 inputs: ds rounds to k's dtype for dq, to q's for dk, p to
        # dO's for dv, and the results come back in the inputs' dtypes;
        # against the f32 algorithm on the same bf16 values the outputs
        # differ by a few bf16 ulps of the largest element at most
        q, k, v, g, _, mask = make_inputs(48, 32, seed=11)
        b16 = [x.to(torch.bfloat16) for x in t(q, k, v, g)]
        tm = t(mask)[0]
        o, lse = k2.flash_lse_torch(*b16[:3], tm)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        got = k2.flash_bwd_torch(*b16[:3], tm, o, lse, b16[3])
        f32 = [x.float() for x in b16]
        want = k2.flash_bwd_torch(*f32[:3], tm, o.float(), lse, f32[3])
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            torch.testing.assert_close(
                a.float(), b, rtol=2 * BF16_ULP,
                atol=4 * BF16_ULP * float(b.abs().max()))


def port_grads(fn, q, k, v, mask, g, **kw):
    leaves = [x.requires_grad_() for x in t(q, k, v)]
    out = fn(*leaves, t(mask)[0], **kw)
    return [x.numpy() for x in torch.autograd.grad(out, leaves, t(g)[0])]


def jax_grads(bwd_impl, q, k, v, mask, g):
    def loss(q, k, v):
        o = jpa.flash_attention(q, k, v, key_mask=jnp.asarray(mask),
                                block_q=BLOCK, block_k=BLOCK, interpret=True,
                                bwd_impl=bwd_impl)
        return jnp.sum(o * g)
    return jax.grad(loss, argnums=(0, 1, 2))(*jx(q, k, v))


class TestAutograd:
    @pytest.mark.parametrize("bwd_impl", ["pallas", "blockwise"])
    def test_flash_attention_grads_match_jax(self, bwd_impl):
        q, k, v, g, _, mask = make_inputs(40, 16, seed=12)
        want = jax_grads(bwd_impl, q, k, v, mask, g)
        got = port_grads(k2.flash_attention, q, k, v, mask, g,
                         bwd_impl=bwd_impl)
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)

    @pytest.mark.parametrize("bwd_impl", ["auto", "blockwise"])
    def test_flash_attention_grads_match_dense(self, bwd_impl):
        q, k, v, g, _, mask = make_inputs(50, 32, seed=13)
        want = port_grads(_dense_attention, q, k, v, mask, g)
        got = port_grads(k2.flash_attention, q, k, v, mask, g,
                         bwd_impl=bwd_impl)
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)

    def test_flash_attention_lse_grads_match_jax(self, monkeypatch):
        monkeypatch.setattr(jpa, "_FORCE_FUSED_LSE_BWD", True)
        q, k, v, g, dlse, mask = make_inputs(40, 16, seed=14)

        def f(q, k, v):
            return jpa.flash_attention_lse(
                q, k, v, key_mask=jnp.asarray(mask), block_q=BLOCK,
                block_k=BLOCK, interpret=True)
        (jo, jlse), vjp = jax.vjp(f, *jx(q, k, v))
        want = vjp((jnp.asarray(g), jnp.asarray(dlse)))
        leaves = [x.requires_grad_() for x in t(q, k, v)]
        o, lse = k2.flash_attention_lse(*leaves, t(mask)[0])
        close(o.detach(), jo)
        close(lse.detach(), jlse, rtol=1e-6)
        got = torch.autograd.grad((o, lse), leaves, t(g, dlse))
        for a, b in zip(got, want):
            close(a, b, rtol=GRAD_RTOL)

    def test_lse_grads_through_one_output(self):
        # an unused output's cotangent is zero: grads through o alone equal
        # flash_attention's, through lse alone they are p-weighted k / q
        q, k, v, g, dlse, mask = make_inputs(40, 16, seed=15)
        leaves = [x.requires_grad_() for x in t(q, k, v)]
        o, _ = k2.flash_attention_lse(*leaves, t(mask)[0])
        got = torch.autograd.grad(o, leaves, t(g)[0])
        want = port_grads(k2.flash_attention, q, k, v, mask, g)
        for a, b in zip(got, want):
            close(a, b)
        _, lse = k2.flash_attention_lse(*leaves, t(mask)[0])
        dq, dk, dv = torch.autograd.grad(lse, leaves, t(dlse)[0])
        assert torch.equal(dv, torch.zeros_like(dv))
        _, blse = blockwise_attention(*leaves, key_mask=t(mask)[0],
                                      block_size=BLOCK, return_lse=True)
        bdq, bdk, _ = torch.autograd.grad(blse, leaves, t(dlse)[0],
                                          allow_unused=True)
        close(dq, bdq, rtol=GRAD_RTOL)
        close(dk, bdk, rtol=GRAD_RTOL)


class TestSwitch:
    def test_grad_mode_picks_the_function_and_no_grad_the_forward(self):
        q, k, v, _, _, mask = make_inputs(40, 16, seed=16)
        leaves = [x.requires_grad_() for x in t(q, k, v)]
        tm = t(mask)[0]
        counts = (k2.flash_cuda.launches, k2.flash_lse_cuda.launches,
                  k2.flash_dq_cuda.launches, k2.flash_dkv_cuda.launches)
        out = k2.flash_attention(*leaves, tm)
        assert type(out.grad_fn).__name__ == "_FlashBackward"
        with torch.inference_mode():
            plain = k2.flash_attention(*(x.detach() for x in leaves), tm)
        assert plain.grad_fn is None
        torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
        with torch.no_grad():
            assert k2.flash_attention(*leaves, tm).grad_fn is None
        out.sum().backward()
        # CPU tensors: the plain versions, no kernel launched
        assert counts == (k2.flash_cuda.launches, k2.flash_lse_cuda.launches,
                          k2.flash_dq_cuda.launches,
                          k2.flash_dkv_cuda.launches)

    def test_kernels_refuse_cpu_tensors_and_bad_options(self):
        q, k, v, g, _, mask = make_inputs(16, 16, seed=17)
        tq, tk, tv, tg, tm = t(q, k, v, g, mask)
        lse = torch.zeros(2, 2, 16)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k2.flash_lse_cuda(tq, tk, tv, tm)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k2.flash_dq_cuda(tq, tk, tv, tm, tg, lse, lse)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k2.flash_dkv_cuda(tq, tk, tv, tm, tg, lse, lse)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k2.flash_attention_lse(tq, tk, tv, tm, impl="cuda")
        with pytest.raises(ValueError, match="bwd_impl"):
            k2.flash_attention(tq, tk, tv, tm, bwd_impl="xla")
        with pytest.raises(ValueError, match="lse must be f32"):
            k2.flash_dq_torch(tq, tk, tv, tm, tg, lse.double(), lse)
        # the causal lse variant runs (its plain version on CPU tensors),
        # and its kernel refuses CPU tensors like the others
        o, lse = k2.flash_attention_lse(tq, tk, tv, causal=True)
        assert o.shape == tq.shape and lse.shape == (2, 2, 16)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k2.flash_lse_cuda(tq, tk, tv, tm, causal=True)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k2.flash_dq_cuda(tq, tk, tv, tm, tg, lse, lse, causal=True)

    def test_layout_rule_for_the_incoming_gradient(self):
        # the backward wrapper copies a dO that its vector loads cannot
        # read (D stride != 1) instead of refusing it; q/k/v views of a
        # fused projection fit as they are
        B, T, H, D = 2, 8, 2, 16
        qkv = torch.zeros(B, T, 3 * H * D)
        q = qkv[..., :H * D].view(B, T, H, D).transpose(1, 2)
        assert k2._fits_layout(q)
        assert not k2._fits_layout(torch.zeros(B, H, D, T).transpose(2, 3))


@pytest.mark.cuda
class TestCudaKernels:
    def test_kernels_match_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (K2b, K2d and K2e are "
                        "CUDA-only; their plain versions are tested above)")
        dev = torch.device("cuda")
        for dtype in (torch.bfloat16, torch.float32):
            for D in (32, 64, 128):
                for T in (64, 200):
                    x = make_inputs(T, D, seed=D + T, B=2, H=3)
                    q, k, v, g, dl = (torch.from_numpy(a).to(dev, dtype)
                                      for a in x[:5])
                    m = torch.from_numpy(x[5]).to(dev)
                    dl = dl.float()
                    o, lse = k2.flash_lse_cuda(q, k, v, m)
                    want_o, want_lse = k2.flash_lse_torch(q, k, v, m)
                    got = k2.flash_bwd_cuda(q, k, v, m, o, lse, g, dl)
                    want = k2.flash_bwd_torch(q, k, v, m, o, lse, g, dl)
                    torch.cuda.synchronize()
                    assert torch.equal(o[0], torch.zeros_like(o[0]))
                    assert torch.equal(got[0][0],
                                       torch.zeros_like(got[0][0]))
                    torch.testing.assert_close(lse[1], want_lse[1],
                                               rtol=0, atol=1e-4)
                    bf16 = dtype == torch.bfloat16
                    for a, b in zip((o, *got), (want_o, *want)):
                        scale = float(b.float().abs().max())
                        torch.testing.assert_close(
                            a.float(), b.float(),
                            rtol=2 * BF16_ULP if bf16 else 1e-4,
                            atol=(BF16_ULP if bf16 else 1e-4) * scale
                            + (4e-3 if bf16 else ATOL))
