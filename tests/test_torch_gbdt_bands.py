"""The port's GBDT breadth inside the benchmark bands, on its own: the four
``benchmarks_LightGBMClassifier.csv`` rows (gbdt, goss, dart, rf on the
seeded ``test_benchmarks.tabular`` frame, 40 iterations), the
``benchmarks_LightGBMRegressor.csv`` rows (regression, regression_l1,
huber on ``tabular(seed=1)``) and ``test_reference_parity.py``'s sklearn
oracle margin for multiclass accuracy on digits and wine. The fits
against the JAX package are in ``test_torch_gbdt_breadth.py``; these
port-only fits are apart so that the two files run on different workers.
"""

import os

import numpy as np
import pytest
import torch
from sklearn.datasets import load_digits, load_wine

import mmlspark_torch.lightgbm as tl
from mmlspark_torch.core import DataFrame
from mmlspark_torch.lightgbm import trainer as ttr
from test_benchmarks import tabular

BENCH = os.path.join(os.path.dirname(__file__), "resources", "benchmarks")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bands(csv):
    rows = {}
    with open(os.path.join(BENCH, csv)) as fh:
        for line in fh:
            if line.strip() and not line.startswith("#"):
                name, value, tol = line.strip().split(",")
                rows[name] = (float(value), float(tol))
    return rows


def data(name):
    d = {"digits": load_digits, "wine": load_wine}[name]()
    return d.data.astype(np.float32), d.target.astype(np.float32)


@pytest.mark.parametrize("mode", ["gbdt", "goss", "dart", "rf"])
def test_synthetic_classifier_benchmark_band(mode):
    x, y = tabular()[:2]
    kw = {"boostingType": mode, "numIterations": 40, "seed": 0}
    if mode == "rf":
        kw.update(baggingFraction=0.8, baggingFreq=1)
    model = tl.LightGBMClassifier(device="cpu", **kw).fit(
        DataFrame({"features": x, "label": y}))
    auc = ttr.roc_auc(y, model.transform(DataFrame({"features": x}))[
        "probability"][:, 1])
    value, tol = _bands("benchmarks_LightGBMClassifier.csv")[
        f"synthetic.{mode}"]
    assert abs(auc - value) <= tol, (mode, auc, value)


@pytest.mark.parametrize("objective", ["regression", "regression_l1",
                                       "huber"])
def test_synthetic_regressor_benchmark_band(objective):
    x, _, y = tabular(seed=1)
    model = tl.LightGBMRegressor(device="cpu", objective=objective,
                                 numIterations=40, seed=0).fit(
        DataFrame({"features": x, "label": y}))
    pred = model.transform(DataFrame({"features": x}))["prediction"]
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    value, tol = _bands("benchmarks_LightGBMRegressor.csv")[
        f"synthetic.{objective}"]
    assert abs(rmse - value) <= tol, (objective, rmse, value)


@pytest.mark.parametrize("loader,iters", [("digits", 8), ("wine", 20)])
def test_multiclass_accuracy_against_sklearn_oracle(loader, iters):
    """``test_reference_parity.py``'s margin: within 0.03 of sklearn's
    histogram GBDT at matched hyperparameters (on digits at 8 iterations
    on both sides, not 20: 200 trees of 15 leaves take the port 34 s on
    one CPU thread)."""
    from sklearn.ensemble import HistGradientBoostingClassifier
    x, y = data(loader)
    oracle = HistGradientBoostingClassifier(
        max_iter=iters, max_leaf_nodes=15, learning_rate=0.1,
        min_samples_leaf=20, early_stopping=False).fit(x, y)
    oracle_acc = float((oracle.predict(x) == y).mean())
    m = tl.LightGBMClassifier(device="cpu", objective="multiclass",
                              numIterations=iters, numLeaves=15,
                              minDataInLeaf=20, seed=0).fit(
        DataFrame({"features": x, "label": y}))
    acc = float((np.asarray(m.transform(DataFrame({"features": x}))[
        "prediction"]) == y).mean())
    assert acc >= oracle_acc - 0.03, (acc, oracle_acc)
