"""Objective functions: gradients and hessians on device tensors.

Reference surface: ``lightgbm/params/TrainParams.scala:10-180`` objective
strings and the custom-``fobj`` hook (``lightgbm/params/FObjParam.scala``).
The port of ``mmlspark_tpu/lightgbm/objectives.py``: every objective of the
JAX package (``lambdarank``'s group-aware gradients come from the ranker,
``ranker_objective.py``). Each is a plain function
``(scores, labels, weights) -> (grad, hess)`` on tensors, with scores [n]
or [n, K] (``multiclass``, ``multiclassova``), an init score computed on
the host in float64, and an output transform on tensors. A user ``fobj``
is a torch callable of the same shape (``custom_objective``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

class Objective(NamedTuple):
    name: str
    grad_hess: Callable  # (scores [n] or [n, K], y [n], w [n]) -> (g, h)
    init_score: Callable  # (y, w) numpy -> float or [K] floats
    transform: Callable   # raw score tensor -> output tensor
    num_model_per_iter: int = 1


# ----------------------------------------------------------------- regression
def _l2(scores, y, w):
    return (scores - y) * w, w


def _l1(scores, y, w):
    return torch.sign(scores - y) * w, w


def _huber(alpha):
    def gh(scores, y, w):
        g = torch.clamp(scores - y, -alpha, alpha)
        return g * w, w
    return gh


def _fair(c):
    def gh(scores, y, w):
        r = scores - y
        g = c * r / (torch.abs(r) + c)
        h = c * c / (torch.abs(r) + c) ** 2
        return g * w, h * w
    return gh


def _poisson(scores, y, w):
    ex = torch.exp(scores)
    return (ex - y) * w, ex * w


def _gamma(scores, y, w):
    ey = y * torch.exp(-scores)
    return (1.0 - ey) * w, ey * w


def _tweedie(rho):
    def gh(scores, y, w):
        a = torch.exp((1.0 - rho) * scores)
        b = torch.exp((2.0 - rho) * scores)
        g = -y * a + b
        h = -(1.0 - rho) * y * a + (2.0 - rho) * b
        return g * w, h * w
    return gh


def _quantile(alpha):
    def gh(scores, y, w):
        g = torch.where(scores >= y, 1.0 - alpha, -alpha)
        return g * w, w
    return gh


def _mape(scores, y, w):
    scale = 1.0 / torch.clamp(torch.abs(y), min=1.0)
    return torch.sign(scores - y) * scale * w, scale * w


# ------------------------------------------------------------- classification
def _binary(sigmoid_coef: float, pos_weight: float):
    def gh(scores, y, w):
        p = torch.sigmoid(sigmoid_coef * scores)
        wl = torch.where(y > 0, pos_weight, 1.0) * w
        g = sigmoid_coef * (p - y) * wl
        h = sigmoid_coef * sigmoid_coef * p * (1.0 - p) * wl
        return g, h
    return gh


def one_hot(y: torch.Tensor, num_class: int) -> torch.Tensor:
    """``jax.nn.one_hot`` of float labels: a zero row for a label outside
    [0, K) (``torch.nn.functional.one_hot`` raises there)."""
    k = torch.arange(num_class, device=y.device)
    return (y.to(torch.int32)[:, None] == k).to(torch.float32)


def softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in its operation order."""
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def _multiclass(num_class):
    def gh(scores, y, w):
        p = softmax(scores)
        onehot = one_hot(y, num_class)
        factor = num_class / (num_class - 1.0)
        g = (p - onehot) * w[:, None]
        h = factor * p * (1.0 - p) * w[:, None]
        return g, h
    return gh


def _xlam_row_loss(s, y):
    lam = torch.logaddexp(torch.zeros_like(s), s)
    p = torch.clamp(1.0 - torch.exp(-lam), 1e-12, 1.0 - 1e-12)
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


_ALIASES = {
    "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mae": "regression_l1",
    "softmax": "multiclass",
    "multiclass_ova": "multiclassova", "ova": "multiclassova",
    "ovr": "multiclassova",
    "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda",
}


def canonical_objective(name: str) -> str:
    """Map LightGBM objective aliases to one canonical name."""
    return _ALIASES.get(name, name)


def get_objective(name: str, *, num_class: int = 1, alpha: float = 0.9,
                  fair_c: float = 1.0, tweedie_variance_power: float = 1.5,
                  sigmoid: float = 1.0, pos_weight: float = 1.0,
                  boost_from_average: bool = True) -> Objective:
    """Build the named objective (LightGBM config strings; aliases resolve
    through :func:`canonical_objective`)."""
    name = canonical_objective(name)

    def const_init(value_fn):
        def init(y, w):
            if not boost_from_average:
                return 0.0
            return float(value_fn(y, w))
        return init

    def wavg(y, w):
        return np.average(y, weights=w)

    def log_wavg(y, w):
        return np.log(max(wavg(y, w), 1e-9))

    def ident(s):
        return s

    # the regression_l1, quantile and mape inits are unweighted, as in the
    # JAX package
    if name == "regression":
        return Objective(name, _l2, const_init(wavg), ident)
    if name == "regression_l1":
        return Objective(name, _l1, const_init(lambda y, w: np.median(y)),
                         ident)
    if name == "huber":
        return Objective(name, _huber(alpha), const_init(wavg), ident)
    if name == "fair":
        return Objective(name, _fair(fair_c), const_init(wavg), ident)
    if name == "poisson":
        return Objective(name, _poisson, const_init(log_wavg), torch.exp)
    if name == "gamma":
        return Objective(name, _gamma, const_init(log_wavg), torch.exp)
    if name == "tweedie":
        return Objective(name, _tweedie(tweedie_variance_power),
                         const_init(log_wavg), torch.exp)
    if name == "quantile":
        return Objective(name, _quantile(alpha),
                         const_init(lambda y, w: np.quantile(y, alpha)),
                         ident)
    if name == "mape":
        return Objective(name, _mape, const_init(lambda y, w: np.median(y)),
                         ident)
    if name == "binary":
        def binary_init(y, w):
            if not boost_from_average:
                return 0.0
            # float64 before clipping: float32 would round 1-1e-12 to 1.0
            p = float(np.average(np.asarray(y, np.float64), weights=w))
            p = min(max(p, 1e-12), 1.0 - 1e-12)
            return float(np.log(p / (1 - p)) / sigmoid)
        return Objective(name, _binary(sigmoid, pos_weight), binary_init,
                         lambda s: torch.sigmoid(sigmoid * s))
    if name == "lambdarank":
        # the ranker injects the group-aware gradients
        # (``ranker_objective``); the objective supplies the init score
        # and the transform
        return Objective(name, _l2, lambda y, w: 0.0, ident)
    if name == "multiclass":
        def mc_init(y, w):
            # ignores boost_from_average, as the JAX package's does
            counts = np.bincount(y.astype(np.int64),
                                 minlength=num_class).astype(np.float64)
            p = np.clip(counts / counts.sum(), 1e-12, 1.0)
            return np.log(p)
        return Objective(name, _multiclass(num_class), mc_init, softmax,
                         num_model_per_iter=num_class)
    if name == "multiclassova":
        # one-vs-all: K sigmoid binary objectives, unnormalized output
        def ova_gh(scores, y, w):
            onehot = one_hot(y, num_class)
            p = torch.sigmoid(sigmoid * scores)
            g = sigmoid * (p - onehot) * w[:, None]
            h = sigmoid * sigmoid * p * (1.0 - p) * w[:, None]
            return g, h

        def ova_init(y, w):
            if not boost_from_average:
                return np.zeros(num_class)
            counts = np.bincount(y.astype(np.int64),
                                 minlength=num_class).astype(np.float64)
            p = np.clip(counts / counts.sum(), 1e-12, 1.0 - 1e-12)
            return np.log(p / (1.0 - p)) / sigmoid
        return Objective(name, ova_gh, ova_init,
                         lambda s: torch.sigmoid(sigmoid * s),
                         num_model_per_iter=num_class)
    if name == "cross_entropy":
        # probabilistic labels in [0, 1] (LightGBM xentropy)
        def xent_gh(scores, y, w):
            p = torch.sigmoid(scores)
            return (p - y) * w, p * (1.0 - p) * w

        def xent_init(y, w):
            if not boost_from_average:
                return 0.0
            p = float(np.clip(np.average(np.asarray(y, np.float64),
                                         weights=w), 1e-12, 1 - 1e-12))
            return float(np.log(p / (1 - p)))
        return Objective(name, xent_gh, xent_init, torch.sigmoid)
    if name == "cross_entropy_lambda":
        # intensity-weighted cross entropy (LightGBM xentlambda). The
        # gradients are autodiff of the JAX package's row loss, clip
        # included: 0 where p saturates low, and the hessian floored at
        # 1e-12 (NaN stays NaN, as under jnp.maximum)
        d1 = torch.func.grad(_xlam_row_loss)
        d2 = torch.func.grad(d1)

        def xlam_gh(scores, y, w):
            g = torch.func.vmap(d1)(scores, y) * w
            h = torch.clamp(torch.func.vmap(d2)(scores, y), min=1e-12) * w
            return g, h

        def xlam_init(y, w):
            if not boost_from_average:
                return 0.0
            p = float(np.clip(np.average(np.asarray(y, np.float64),
                                         weights=w), 1e-12, 1 - 1e-12))
            lam = -np.log1p(-p)
            return float(np.log(np.expm1(lam))) if lam > 1e-12 else -30.0
        # the output is the intensity log1p(exp(s)), not a probability
        return Objective(name, xlam_gh, xlam_init,
                         lambda s: torch.logaddexp(torch.zeros_like(s), s))
    raise ValueError(f"unknown objective {name!r}")


def custom_objective(fobj: Callable) -> Objective:
    """Wrap a user torch callable ``(scores, labels, weights) -> (grad,
    hess)`` on tensors — the reference's FObjTrait."""
    return Objective("custom", fobj, lambda y, w: 0.0, lambda s: s)
