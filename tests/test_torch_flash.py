"""K2a and the port's other attention functions against the JAX package.

The same seeded inputs (numpy) go through
- ``flash_torch`` (K2a's plain version, the CPU route of ``flash_attention``)
  and the JAX ``flash_attention`` in Pallas interpret mode, as
  ``tests/test_pallas_attention.py`` runs it, and the JAX
  ``_dense_attention``: f32 at atol 2e-5, that test file's own tolerance;
- the port's ``_dense_attention`` and ``blockwise_attention`` and their JAX
  counterparts, f32 at atol 2e-5.

On the card, one ``cuda``-marked test holds ``flash_cuda`` against
``flash_torch``; it skips without a GPU. The lse variant and the backward
(K2b, K2d, K2e) are held in ``tests/test_torch_flash_bwd.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.dl.pallas_attention import flash_attention as jflash
from mmlspark_tpu.dl.text_encoder import _dense_attention as jdense
from mmlspark_tpu.parallel.ring_attention import \
    blockwise_attention as jblockwise
from mmlspark_torch.dl.flash_attention import (flash_attention,
                                               flash_attention_lse,
                                               flash_cuda, flash_torch)
from mmlspark_torch.dl.text_encoder import _dense_attention
from mmlspark_torch.parallel import blockwise_attention

ATOL = 2e-5          # tests/test_pallas_attention.py's f32 tolerance
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


def make_inputs(B=2, H=2, T=96, D=32, seed=0, masked=True,
                empty_row=False):
    """q, k, v [B, H, T, D] f32 and a [B, T] key mask (None if unmasked);
    ``empty_row`` makes batch row 0 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = rng.random((B, T)) > 0.3
        if empty_row:
            mask[0] = False
    return q, k, v, mask


def port(fn, q, k, v, mask, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return fn(*t, m, **kw)


def jax_args(q, k, v, mask, dtype=jnp.float32):
    return ([jnp.asarray(x, dtype) for x in (q, k, v)],
            None if mask is None else jnp.asarray(mask))


# (T, D, masked, empty_row, block): T=100 divides by no block size
CASES = {
    "unmasked": (128, 32, False, False, 64),
    "masked": (96, 32, True, False, 32),
    "ragged_masked": (100, 64, True, False, 64),
    "ragged_empty_row": (100, 32, True, True, 32),
}


class TestFlashTorch:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_jax_flash_interpret(self, case):
        T, D, masked, empty, block = CASES[case]
        q, k, v, mask = make_inputs(T=T, D=D, masked=masked,
                                    empty_row=empty, seed=T + D)
        (jq, jk, jv), jm = jax_args(q, k, v, mask)
        want = np.asarray(jflash(jq, jk, jv, key_mask=jm, block_q=block,
                                 block_k=block))
        got = port(flash_torch, q, k, v, mask).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_jax_dense(self, case):
        T, D, masked, empty, _ = CASES[case]
        q, k, v, mask = make_inputs(T=T, D=D, masked=masked,
                                    empty_row=empty, seed=T + D + 1)
        (jq, jk, jv), jm = jax_args(q, k, v, mask)
        want = np.asarray(jdense(jq, jk, jv, key_mask=jm))
        np.testing.assert_allclose(port(flash_torch, q, k, v, mask).numpy(),
                                   want, rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            port(_dense_attention, q, k, v, mask).numpy(), want, rtol=0,
            atol=ATOL)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_fully_masked_row_is_exactly_zero(self, dtype):
        q, k, v, mask = make_inputs(T=100, empty_row=True, seed=3)
        out = port(flash_torch, q, k, v, mask, dtype=dtype)
        assert out.dtype == dtype
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        assert torch.isfinite(out).all() and out[1].abs().max() > 0

    def test_bf16_matches_jax_flash_one_k_block(self):
        # one k-block (block_k >= T): the TPU kernel's p is relative to the
        # row max, as flash_torch's is, so the two differ only by f32
        # summation order before the final bf16 rounding: at most one bf16
        # ulp of the output, 2^-7 relative
        q, k, v, mask = make_inputs(T=128, D=32, seed=5)
        (jq, jk, jv), jm = jax_args(q, k, v, mask, jnp.bfloat16)
        want = np.asarray(jflash(jq, jk, jv, key_mask=jm, block_q=64,
                                 block_k=128).astype(jnp.float32))
        got = port(flash_torch, q, k, v, mask,
                   dtype=torch.bfloat16).float().numpy()
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)

    def test_strided_views_match_contiguous(self):
        # the encoder hands q/k/v over as views of one fused projection
        rng = np.random.default_rng(6)
        B, T, H, D = 2, 40, 2, 32
        qkv = torch.from_numpy(
            rng.normal(size=(B, T, 3 * H * D)).astype(np.float32))
        q, k, v = (a.view(B, T, H, D).transpose(1, 2)
                   for a in qkv.split(H * D, dim=-1))
        mask = torch.from_numpy(rng.random((B, T)) > 0.2)
        torch.testing.assert_close(
            flash_torch(q, k, v, mask),
            flash_torch(q.contiguous(), k.contiguous(), v.contiguous(),
                        mask), rtol=0, atol=0)


class TestBlockwise:
    @pytest.mark.parametrize("variant", ["masked", "causal_offsets",
                                         "lse_empty_row", "unmasked_ragged"])
    def test_matches_jax_blockwise(self, variant):
        T = 100
        q, k, v, mask = make_inputs(T=T, masked=variant != "unmasked_ragged",
                                    empty_row=variant == "lse_empty_row",
                                    seed=7)
        kw = dict(block_size=32)
        if variant == "causal_offsets":
            kw.update(causal=True, q_offset=16, k_offset=8)
        if variant == "lse_empty_row":
            kw.update(return_lse=True)
        (jq, jk, jv), jm = jax_args(q, k, v, mask)
        want = jblockwise(jq, jk, jv, key_mask=jm, **kw)
        got = blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  key_mask=None if mask is None
                                  else torch.from_numpy(mask), **kw)
        if variant == "lse_empty_row":
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=1e-6, atol=ATOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=ATOL)


class TestSwitchAndRaises:
    def test_switch_picks_plain_on_cpu_and_rejects_cuda(self):
        q, k, v, mask = make_inputs(T=40, seed=8)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        m = torch.from_numpy(mask)
        launches = flash_cuda.launches
        assert torch.equal(flash_attention(*t, m), flash_torch(*t, m))
        assert torch.equal(flash_attention(*t, m, impl="torch"),
                           flash_torch(*t, m))
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_attention(*t, m, impl="cuda")
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_cuda(*t, m)
        with pytest.raises(ValueError, match="impl"):
            flash_attention(*t, m, impl="triton")
        assert flash_cuda.launches == launches

    def test_cuda_route_refuses_inputs_that_need_grad(self):
        # K2a alone is the forward without a graph; under grad the switch
        # takes the autograd Function instead (K2b forward, K2d/K2e
        # backward; their plain versions for CPU tensors), so inputs that
        # need grad train through it
        q, k, v, mask = make_inputs(T=40, seed=9)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        t[1].requires_grad_(True)
        m = torch.from_numpy(mask)
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_cuda(*t, m)
        out = flash_attention(*t, m)
        assert type(out.grad_fn).__name__ == "_FlashBackward"
        out.sum().backward()
        assert t[1].grad is not None and torch.isfinite(t[1].grad).all()
        # the plain route is differentiable too, to the same gradient
        grad = t[1].grad.clone()
        t[1].grad = None
        flash_torch(*t, m).sum().backward()
        torch.testing.assert_close(t[1].grad, grad, rtol=1e-5, atol=ATOL)

    def test_causal_offsets_and_lse_wait_for_later_slices(self):
        q, k, v, mask = make_inputs(T=16)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        m = torch.from_numpy(mask)
        # causal without grad is ported (K2c; its plain version here)
        with torch.inference_mode():
            out = flash_attention(*t, m, causal=True, q_offset=4)
        assert torch.equal(out, flash_torch(*t, m, causal=True, q_offset=4))
        assert not torch.allclose(out, flash_torch(*t, m))
        # offsets without causal change nothing, as in the JAX package
        assert torch.equal(flash_attention(*t, m, q_offset=4),
                           flash_torch(*t, m))
        # causal under grad (the causal-training slice: K2c-lse and the
        # causal fused backward, their plain versions here) is the causal
        # forward, differentiable
        t[0].requires_grad_(True)
        out = flash_attention(*t, causal=True)
        assert type(out.grad_fn).__name__ == "_FlashBackward"
        torch.testing.assert_close(out.detach(),
                                   flash_torch(*t, causal=True),
                                   rtol=0, atol=0)
        out.sum().backward()
        assert torch.isfinite(t[0].grad).all()
        # the causal lse variant is the causal forward and its row
        # logsumexp; offsets without causal change nothing
        o, lse = flash_attention_lse(*t, m, causal=True, q_offset=4)
        torch.testing.assert_close(o, flash_torch(*t, m, causal=True,
                                                  q_offset=4),
                                   rtol=0, atol=0)
        o4, lse4 = flash_attention_lse(*t, m, k_offset=4)
        o, lse = flash_attention_lse(*t, m)
        assert torch.equal(o4, o) and torch.equal(lse4, lse)
        # the lse variant (K2b) is ported: the output of flash_torch and
        # the row logsumexp
        torch.testing.assert_close(o, flash_torch(*t, m), rtol=0, atol=0)
        assert lse.shape == (2, 2, 16) and lse.dtype == torch.float32

    def test_rejects_bad_inputs(self):
        q, k, v, mask = make_inputs(T=16)
        t = [torch.from_numpy(x) for x in (q, k, v)]
        with pytest.raises(ValueError, match="one shape"):
            flash_torch(t[0], t[1][:, :, :8], t[2])
        with pytest.raises(ValueError, match="key_mask"):
            flash_torch(*t, torch.from_numpy(mask).int())
        with pytest.raises(TypeError, match="dtypes differ"):
            flash_torch(t[0], t[1].double(), t[2])


@pytest.mark.cuda
class TestCudaKernel:
    def test_kernel_matches_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (K2a is CUDA-only; its plain "
                        "version is tested above)")
        dev = torch.device("cuda")
        for dtype in (torch.bfloat16, torch.float32):
            for D in (32, 64, 128):
                for T in (64, 200):
                    q, k, v, mask = make_inputs(B=2, H=3, T=T, D=D,
                                                empty_row=True, seed=D + T)
                    t = [torch.from_numpy(x).to(dev, dtype)
                         for x in (q, k, v)]
                    m = torch.from_numpy(mask).to(dev)
                    want = flash_torch(*t, m)
                    got = flash_cuda(*t, m)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], torch.zeros_like(got[0]))
                    if dtype == torch.float32:
                        torch.testing.assert_close(got, want, rtol=0,
                                                   atol=ATOL)
                    else:
                        # bf16 output rounding plus two summation orders
                        torch.testing.assert_close(
                            got.float(), want.float(), rtol=2 * BF16_ULP,
                            atol=4e-3)
