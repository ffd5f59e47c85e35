"""Every objective of the port against the JAX package's ``get_objective``.

The same seeded scores, labels and weights go through both: gradients,
hessians and the output transform agree within 1e-6 relative (NaN and inf
where the JAX package gives them, as ``cross_entropy_lambda`` does past
|score| = 20), init scores exactly after the float32 rounding the trainers
apply. XLA's exp and log differ from PyTorch's by an ulp in about one
value in ten, so where an objective subtracts two terms (p - y, ex - y,
b - y·a) the 1e-6 is relative to the larger term, not to the difference.
``cross_entropy_lambda`` forms p = 1 - exp(-lambda) and 1 - p in float32,
so an ulp of exp is amplified by 1/p + 1/(1 - p): its gradients and
hessians are held within 1e-6 relative plus 4 float32 ulps (2^-22) of that
factor. ``multiclass`` and ``multiclassova`` run at K = 3 and 5, with a
label outside [0, K) (``jax.nn.one_hot`` gives it a zero row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.lightgbm import objectives as jobj
from mmlspark_torch.lightgbm import objectives as tobj

RTOL = 1e-6
N = 257


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(kind, rng, n):
    if kind == "real":
        return rng.normal(1.0, 2.0, n)
    if kind == "positive":
        return rng.gamma(2.0, 1.5, n) + 0.05
    if kind == "count":
        return rng.poisson(2.0, n).astype(np.float64)
    if kind == "binary":
        return (rng.random(n) < 0.35).astype(np.float64)
    if kind == "prob":
        return rng.random(n)
    k = int(kind[1:])          # "K3": class ids, one out of range
    y = rng.integers(0, k, n).astype(np.float64)
    y[5] = k
    return y


CASES = {
    "regression": ("real", {}),
    "regression_l1": ("real", {}),
    "huber": ("real", dict(alpha=0.7)),
    "fair": ("real", dict(fair_c=0.5)),
    "poisson": ("count", {}),
    "gamma": ("positive", {}),
    "tweedie": ("positive", dict(tweedie_variance_power=1.3)),
    "quantile": ("real", dict(alpha=0.25)),
    "mape": ("real", {}),
    "binary": ("binary", dict(sigmoid=1.5, pos_weight=2.0)),
    "binary_no_average": ("binary", dict(boost_from_average=False)),
    "multiclass_3": ("K3", dict(num_class=3)),
    "multiclass_5": ("K5", dict(num_class=5)),
    "multiclass_5_no_average": ("K5", dict(num_class=5,
                                           boost_from_average=False)),
    "multiclassova_3": ("K3", dict(num_class=3, sigmoid=0.8)),
    "multiclassova_5": ("K5", dict(num_class=5)),
    "multiclassova_5_no_average": ("K5", dict(num_class=5,
                                              boost_from_average=False)),
    "cross_entropy": ("prob", {}),
    "cross_entropy_lambda": ("prob", {}),
    "cross_entropy_lambda_saturated": ("prob", {}),
    "l2_alias": ("real", {}),
    "xentlambda_alias": ("prob", {}),
}
ALIASES = {"l2_alias": "l2", "xentlambda_alias": "xentlambda"}


def _name(case):
    if case in ALIASES:
        return ALIASES[case]
    for base in ("multiclassova", "multiclass", "binary",
                 "cross_entropy_lambda"):
        if case.startswith(base):
            return base
    return case


def _close(got, want, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    ok = np.isfinite(want)
    np.testing.assert_array_equal(got[~ok & ~np.isnan(want)],
                                  want[~ok & ~np.isnan(want)])
    bound = RTOL * np.abs(want[ok]) + np.broadcast_to(atol, want.shape)[ok]
    bad = np.abs(got[ok] - want[ok]) > bound
    assert not bad.any(), (got[ok][bad][:5], want[ok][bad][:5])


def _term_scale(name, kw, s, y, w):
    """(grad, hess) bounds of the terms each objective subtracts, in
    float64: 1e-6 of them is an ulp-level difference of exp or log."""
    s, y = s.astype(np.float64), y.astype(np.float64)
    w = w.astype(np.float64)
    if name in ("multiclass", "multiclassova"):
        sc = kw.get("sigmoid", 1.0)
        return sc * w[:, None], sc * sc * w[:, None]
    if name in ("binary", "cross_entropy"):
        return kw.get("pos_weight", 1.0) * kw.get("sigmoid", 1.0) * w, 0.0
    if name == "poisson":
        return w * (np.exp(s) + np.abs(y)), 0.0
    if name == "gamma":
        return w * (1.0 + y * np.exp(-s)), 0.0
    if name == "tweedie":
        rho = kw["tweedie_variance_power"]
        a, b = np.exp((1.0 - rho) * s), np.exp((2.0 - rho) * s)
        return w * (y * a + b), w * (abs(1.0 - rho) * y * a
                                     + (2.0 - rho) * b)
    if name in ("cross_entropy_lambda", "xentlambda"):
        g = _xlam_atol(s, w) / RTOL
        return g, g
    return 0.0, 0.0


def _xlam_atol(s, w):
    """4 float32 ulps of the cancellation factor 1/p + 1/(1 - p)."""
    q = -np.expm1(-np.logaddexp(0.0, s.astype(np.float64)))
    with np.errstate(divide="ignore"):
        return 2.0 ** -22 * w * (1.0 / q + 1.0 / (1.0 - q))


@pytest.mark.parametrize("case", sorted(CASES))
def test_objective_matches_jax(case):
    kind, kw = CASES[case]
    name = _name(case)
    rng = np.random.default_rng(sorted(CASES).index(case))
    y = _labels(kind, rng, N).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N).astype(np.float32)
    k = kw.get("num_class", 1)
    shape = (N, k) if name.startswith("multiclass") else (N,)
    s = rng.normal(0.0, 2.0, shape).astype(np.float32)
    if case.endswith("saturated"):     # |score| > 30: exact 0/inf/NaN
        s[:40] = np.concatenate([np.linspace(-80.0, -30.5, 20),
                                 np.linspace(30.5, 80.0, 20)])
    jo = jobj.get_objective(name, **kw)
    to = tobj.get_objective(name, **kw)
    assert to.name == jo.name
    assert to.num_model_per_iter == jo.num_model_per_iter

    jg, jh = jo.grad_hess(jnp.asarray(s), jnp.asarray(y), jnp.asarray(w))
    tg, th = to.grad_hess(torch.from_numpy(s), torch.from_numpy(y),
                          torch.from_numpy(w))
    assert tg.dtype == th.dtype == torch.float32
    gs, hs = _term_scale(name, kw, s, y, w)
    _close(tg, jg, RTOL * gs)
    _close(th, jh, RTOL * hs)
    if case.endswith("saturated"):      # the case reaches both clips
        assert np.isinf(np.asarray(jg)[20:40]).all()
        np.testing.assert_allclose(np.asarray(jh)[:20],
                                   np.float32(1e-12) * w[:20], rtol=1e-6)

    # init scores are float64 on the host; both trainers round once
    ji = np.asarray(jo.init_score(y, w), np.float32)
    ti = np.asarray(to.init_score(y, w), np.float32)
    np.testing.assert_array_equal(ti, ji)

    _close(to.transform(torch.from_numpy(s)), jo.transform(jnp.asarray(s)))


def test_one_hot_gives_zero_rows_out_of_range():
    y = torch.tensor([0.0, 2.0, 3.0, -1.0, 1.7])
    np.testing.assert_array_equal(
        tobj.one_hot(y, 3).numpy(),
        np.asarray(jnp.asarray(__import__("jax").nn.one_hot(
            jnp.asarray(y.numpy()).astype(jnp.int32), 3))))


def test_custom_objective_and_lambdarank():
    def fobj(s, y, w):
        return (s - y) * w, w
    o = tobj.custom_objective(fobj)
    assert o.name == "custom" and o.init_score(None, None) == 0.0
    with pytest.raises(NotImplementedError, match="GBDT breadth"):
        tobj.get_objective("lambdarank")
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get_objective("nope")
