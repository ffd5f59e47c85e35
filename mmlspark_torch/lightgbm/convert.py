"""Carry a trained model from the JAX package into the port.

Two bridges exist. The LightGBM text format (``Booster.save_native`` /
``load_native``) works between the packages in both directions. This
module is the direct one: it takes the plain numpy arrays of a JAX
``Booster`` (``Booster.arrays``, ``mmlspark_tpu/lightgbm/booster.py:29-39``)
or of one engine ``Tree``, and builds the port's counterpart without
importing anything of the JAX package.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .booster import Booster
from .engine import Tree
from .objectives import LATER_SLICE


def booster_from_arrays(arrays: Mapping[str, np.ndarray], *, num_class: int,
                        objective: str, sigmoid: float, init_score,
                        feature_names: list[str] | None,
                        max_depth_bound: int,
                        tree_weights: np.ndarray | None = None,
                        average_output: bool = False,
                        best_iteration: int = -1) -> Booster:
    """The port's ``Booster`` from a JAX ``Booster``'s arrays and scalars
    (``b.arrays``, ``b.num_class``, ``b.objective``, ``b.sigmoid``,
    ``b.init_score``, ``b.feature_names``, ``b.max_depth_bound``,
    ``b.tree_weights``, ``b.average_output``, ``b.best_iteration``):
    multiclass, DART and rf models and an early-stopped one's best
    iteration carry over."""
    booster = Booster({k: np.array(v) for k, v in arrays.items()},
                      num_class=num_class, objective=objective,
                      sigmoid=sigmoid,
                      init_score=np.asarray(init_score, np.float32),
                      feature_names=None if feature_names is None
                      else list(feature_names),
                      max_depth_bound=max_depth_bound,
                      tree_weights=tree_weights,
                      average_output=average_output)
    booster.best_iteration = int(best_iteration)
    return booster


def tree_from_arrays(arrays: Mapping[str, np.ndarray], *,
                     device: str | torch.device = "cpu") -> Tree:
    """The port's engine ``Tree`` from one JAX engine ``Tree``'s fields as
    numpy arrays (e.g. ``{k: np.asarray(v) for k, v in
    tree._asdict().items()}``), on ``device``."""
    if "cat_flag" in arrays and np.asarray(arrays["cat_flag"]).any():
        raise NotImplementedError(
            f"trees with categorical splits are not ported yet; they come "
            f"with {LATER_SLICE}")

    def t(key, dtype):
        return torch.as_tensor(np.asarray(arrays[key]), dtype=dtype,
                               device=device)
    return Tree(feature=t("feature", torch.int32),
                split_bin=t("split_bin", torch.int32),
                left=t("left", torch.int32), right=t("right", torch.int32),
                leaf_value=t("leaf_value", torch.float32),
                is_leaf=t("is_leaf", torch.bool),
                split_gain=t("split_gain", torch.float32),
                node_value=t("node_value", torch.float32),
                node_weight=t("node_weight", torch.float32),
                node_count=t("node_count", torch.float32),
                num_nodes=t("num_nodes", torch.int32).reshape(()))
