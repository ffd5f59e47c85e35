"""Objective functions: gradients and hessians on device tensors.

Reference surface: ``lightgbm/params/TrainParams.scala:10-180`` objective
strings. Each objective is a plain function ``(scores, labels, weights) ->
(grad, hess)`` on tensors. This slice ports the ``binary`` objective (the
JAX package's ``objectives.py:92-100`` and ``:185-193``) with
``boost_from_average``, ``sigmoid`` and ``pos_weight``; the others come with
the GBDT breadth slice and raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

LATER_SLICE = "the GBDT breadth slice (ROADMAP.md module queue item 5)"


class Objective(NamedTuple):
    name: str
    grad_hess: Callable  # (scores [n], y [n], w [n]) -> (g, h)
    init_score: Callable  # (y, w) numpy -> float
    transform: Callable   # raw score tensor -> probability tensor
    num_model_per_iter: int = 1


def _binary(sigmoid_coef: float, pos_weight: float):
    def gh(scores, y, w):
        p = torch.sigmoid(sigmoid_coef * scores)
        wl = torch.where(y > 0, pos_weight, 1.0) * w
        g = sigmoid_coef * (p - y) * wl
        h = sigmoid_coef * sigmoid_coef * p * (1.0 - p) * wl
        return g, h
    return gh


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

_KNOWN = {"regression", "regression_l1", "huber", "fair", "poisson", "gamma",
          "tweedie", "quantile", "mape", "binary", "lambdarank",
          "multiclass", "multiclassova", "cross_entropy",
          "cross_entropy_lambda"}


def canonical_objective(name: str) -> str:
    """Map LightGBM objective aliases to one canonical name."""
    return _ALIASES.get(name, name)


def get_objective(name: str, *, num_class: int = 1, sigmoid: float = 1.0,
                  pos_weight: float = 1.0,
                  boost_from_average: bool = True) -> Objective:
    """Build the named objective (LightGBM config strings)."""
    name = canonical_objective(name)
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
    if name in _KNOWN:
        raise NotImplementedError(
            f"objective {name!r} is not ported yet; it comes with "
            f"{LATER_SLICE}")
    raise ValueError(f"unknown objective {name!r}")
