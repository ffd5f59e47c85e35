"""Binning in the port against the JAX package: boundaries bit-equal, bin
ids equal (tolerance: none — both are exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.lightgbm import binning as jbin
from mmlspark_torch.lightgbm import binning as tbin


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


def _data(seed=0, n=3000, F=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    x[:, 1] = rng.integers(0, 5, n)                 # low cardinality
    x[:, 2] = np.round(x[:, 2], 1)                  # many ties
    x[rng.random(n) < 0.05, 3] = np.nan             # missing values
    x[:, 4] = np.nan                                # all missing
    return x


@pytest.mark.parametrize("max_bin,sample", [(255, 200_000), (63, 1000)])
def test_boundaries_bit_equal(max_bin, sample):
    x = _data()
    want = jbin.compute_bin_boundaries(x, max_bin, sample_cnt=sample, seed=3)
    got = tbin.compute_bin_boundaries(x, max_bin, sample_cnt=sample, seed=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("max_bin", [255, 15])
def test_bin_ids_equal_including_nan_and_boundary_values(max_bin):
    x = _data(seed=1)
    bounds = jbin.compute_bin_boundaries(x, max_bin)
    # values exactly on a boundary (searchsorted side='left' puts them in
    # the bin the boundary closes), plus +-inf
    finite = bounds[np.isfinite(bounds)]
    edge = np.resize(finite, x.shape).astype(np.float32)
    x = np.concatenate([x, edge, np.full((2, x.shape[1]), np.inf,
                                         np.float32),
                        np.full((2, x.shape[1]), -np.inf, np.float32)])
    want = np.asarray(jbin.bin_features(jnp.asarray(x), jnp.asarray(bounds)))
    got = tbin.bin_features(torch.from_numpy(x),
                            torch.from_numpy(bounds)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got[np.isnan(x)] == tbin.MISSING_BIN).all()


def test_bin_upper_value_matches():
    x = _data(seed=2)
    bounds = jbin.compute_bin_boundaries(x, 31)
    for f in range(x.shape[1]):
        for b in (0, 1, 5, 30, 31):
            want = jbin.bin_upper_value(bounds, f, b)
            got = tbin.bin_upper_value(bounds, f, b)
            assert got == want or (np.isnan(got) and np.isnan(want))
