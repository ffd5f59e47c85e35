"""K1 in the port: the plain histogram against the JAX package's Pallas
kernel (interpret mode on the CPU) and the scatter reference, the plain
version of the kernel's two passes (a histogram per row range of
``hist_plan``, summed in order) against both, the plan's row ranges, and
the CUDA kernel against the plain version on the card.

Tolerance: rtol = atol = 1e-5 (f32 sums of the same terms in another
order), as ``tests/test_pallas_hist.py`` holds the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.lightgbm.pallas_hist import hist_pallas
from mmlspark_torch.lightgbm.hist import (hist, hist_cuda, hist_partials_torch,
                                          hist_plan, hist_torch)

TOL = dict(rtol=1e-5, atol=1e-5)


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


def scatter_reference(bins, vals, num_bins):
    n, F = bins.shape
    out = np.zeros((F, num_bins, 3), np.float32)
    for r in range(n):
        for f in range(F):
            b = int(bins[r, f])
            if 0 <= b < num_bins:
                out[f, b] += vals[r]
    return out


def port(bins, vals, num_bins, **kw):
    return hist_torch(torch.from_numpy(bins), torch.from_numpy(vals),
                      num_bins=num_bins, **kw).numpy()


def pallas(bins, vals, num_bins, **kw):
    return np.asarray(hist_pallas(jnp.asarray(bins), jnp.asarray(vals),
                                  num_bins=num_bins, block_rows=32,
                                  interpret=True, **kw))


class TestPlainHistogram:
    @pytest.mark.parametrize("dtype", [np.uint8, np.int32])
    def test_matches_pallas_and_scatter(self, dtype):
        rng = np.random.default_rng(0)
        n, F, B = 96, 3, 16
        bins = rng.integers(0, B, size=(n, F)).astype(dtype)
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        got = port(bins, vals, B)
        np.testing.assert_allclose(got, scatter_reference(bins, vals, B),
                                   **TOL)
        np.testing.assert_allclose(got, pallas(bins, vals, B), **TOL)

    def test_row_padding_excluded(self):
        # n not a multiple of the Pallas block: padded rows add nothing
        rng = np.random.default_rng(1)
        n, F, B = 50, 2, 8
        bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
        vals = np.ones((n, 3), np.float32)
        got = port(bins, vals, B)
        assert float(got[..., 2].sum()) == n * F
        np.testing.assert_allclose(got, pallas(bins, vals, B), **TOL)

    @pytest.mark.parametrize("dtype", [np.uint8, np.int32])
    def test_out_of_range_bins_add_nothing(self, dtype):
        rng = np.random.default_rng(3)
        n, F, B = 80, 4, 16
        bins = rng.integers(0, B + 8, size=(n, F)).astype(dtype)
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        got = port(bins, vals, B)
        np.testing.assert_allclose(got, scatter_reference(bins, vals, B),
                                   **TOL)
        np.testing.assert_allclose(got, pallas(bins, vals, B), **TOL)

    @pytest.mark.parametrize("count_kind", ["int", "tensor"])
    def test_count_with_padding_rows(self, count_kind):
        # rows past `count` are padding (out-of-range bins), as the engine
        # contract demands: the TPU kernel's block skip and the port's row
        # skip give the same sums
        rng = np.random.default_rng(2)
        n, F, B, c = 128, 3, 16, 40
        bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
        bins[c:] = B
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        count = c if count_kind == "int" else torch.tensor(c)
        got = port(bins, vals, B, count=count)
        np.testing.assert_allclose(
            got, scatter_reference(bins[:c], vals[:c], B), **TOL)
        np.testing.assert_allclose(
            got, pallas(bins, vals, B, count=jnp.int32(c)), **TOL)

    def test_count_skips_garbage_rows(self):
        # the port skips per row: garbage past `count` never reaches the
        # histogram, even inside the block that holds row `count`
        rng = np.random.default_rng(4)
        n, F, B, c = 100, 3, 16, 37
        bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        np.testing.assert_allclose(
            port(bins, vals, B, count=c),
            scatter_reference(bins[:c], vals[:c], B), **TOL)

    def test_switch_picks_plain_on_cpu_and_rejects_cuda(self):
        rng = np.random.default_rng(5)
        bins = torch.from_numpy(rng.integers(0, 8, (20, 2)).astype(np.uint8))
        vals = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
        np.testing.assert_array_equal(hist(bins, vals, num_bins=8).numpy(),
                                      hist_torch(bins, vals,
                                                 num_bins=8).numpy())
        launches = hist_cuda.launches
        with pytest.raises(ValueError, match="CUDA tensors"):
            hist(bins, vals, num_bins=8, impl="cuda")
        with pytest.raises(ValueError, match="CUDA tensors"):
            hist_cuda(bins, vals, num_bins=8)
        assert hist_cuda.launches == launches

    def test_rejects_bad_inputs(self):
        bins = torch.zeros(4, 2, dtype=torch.int64)
        vals = torch.zeros(4, 3)
        with pytest.raises(TypeError):
            hist_torch(bins, vals, num_bins=4)
        with pytest.raises(ValueError):
            hist_torch(bins.to(torch.uint8), vals[:, :2], num_bins=4)


class TestTwoPass:
    """The kernel's two passes in plain PyTorch: a histogram per row range
    of the plan, then their sum in range order."""

    @pytest.mark.parametrize("dtype", [np.uint8, np.int32])
    @pytest.mark.parametrize("count_kind", [None, "int", "tensor"])
    def test_partials_sum_to_pallas_and_scatter(self, dtype, count_kind):
        rng = np.random.default_rng(7)
        n, F, B, c = 200, 3, 16, 123
        bins = rng.integers(0, B + 4, size=(n, F)).astype(dtype)
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        vals[:, 2] = rng.random(n) < 0.5            # 0/1 count weights
        count = {None: None, "int": c, "tensor": torch.tensor(c)}[
            count_kind]
        rows = n if count is None else c
        plan = hist_plan(n, F, B, np.dtype(dtype).itemsize, 8)
        assert plan.grid_x > 1 and plan.rows_per_cta % 16 == 0
        parts = hist_partials_torch(torch.from_numpy(bins),
                                    torch.from_numpy(vals), num_bins=B,
                                    rows_per_cta=plan.rows_per_cta,
                                    count=count)
        assert parts.shape == (plan.grid_x, F, B, 3)
        got = parts.sum(0).numpy()
        want = scatter_reference(bins[:rows], vals[:rows], B)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
        kw = {} if count is None else {"count": jnp.int32(c)}
        bins_p = bins.copy()
        bins_p[rows:] = B                 # padding past count, as in use
        np.testing.assert_allclose(got, pallas(bins_p, vals, B, **kw), **TOL)

    @pytest.mark.parametrize("n,F,B,bin_bytes", [
        (500_000, 28, 256, 1), (500_000, 28, 256, 4), (1000, 200, 256, 1),
        (17, 2, 8, 4), (50_000, 28, 64, 1)])
    def test_plan_covers_every_row_once(self, n, F, B, bin_bytes):
        plan = hist_plan(n, F, B, bin_bytes, 132)
        assert plan.rows_per_cta % 16 == 0 and plan.stage_rows % 16 == 0
        assert (plan.grid_x - 1) * plan.rows_per_cta < n \
            <= plan.grid_x * plan.rows_per_cta
        assert plan.grid_x * plan.n_fb <= max(132, plan.n_fb)
        assert plan.fb * plan.n_fb >= F > plan.fb * (plan.n_fb - 1)
        # the histogram and the stages fit a CTA's shared memory
        smem = plan.fb * B * 16 + 4 * (
            plan.stage_rows * (F * bin_bytes + 12) + 8)
        assert smem <= 232448

    def test_plan_refuses_a_histogram_that_cannot_fit(self):
        with pytest.raises(ValueError, match="shared memory"):
            hist_plan(1000, 4, 20_000, 1, 132)


@pytest.mark.cuda
class TestCudaKernel:
    def test_kernel_matches_plain_on_card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (K1 is CUDA-only; its plain "
                        "version is tested above)")
        rng = np.random.default_rng(6)
        n, F, B = 50_000, 28, 256
        dev = torch.device("cuda")
        bins = torch.from_numpy(rng.integers(0, B, (n, F)).astype(np.uint8))
        vals = rng.normal(size=(n, 3)).astype(np.float32)
        vals[:, 2] = rng.random(n) < 0.3           # 0/1 count weights
        vals[vals[:, 2] == 0] = 0.0                # masked rows
        vals = torch.from_numpy(vals)
        for b in (bins, bins.to(torch.int32)):
            for count in (None, n - 1000):
                want = hist_torch(b.to(dev), vals.to(dev), num_bins=B,
                                  count=count)
                got = hist_cuda(b.to(dev), vals.to(dev), num_bins=B,
                                count=count)
                torch.cuda.synchronize()
                assert torch.equal(got[..., 2], want[..., 2])
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
