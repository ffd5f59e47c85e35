"""The port's core (DataFrame, Params, Pipeline, save/load) and
ComputeModelStatistics against the JAX package's on the same inputs.
Metrics must match to 1e-12 (the same numpy code on the same columns)."""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JDataFrame
from mmlspark_tpu.train.statistics import \
    ComputeModelStatistics as JComputeModelStatistics
from mmlspark_torch.core import DataFrame, Pipeline, PipelineModel, \
    load_stage
from mmlspark_torch.lightgbm import LightGBMClassifier
from mmlspark_torch.train import ComputeModelStatistics


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


def test_dataframe_tensor_column():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    df = DataFrame({"features": x, "label": np.array([0, 1, 0, 1])})
    t = df.tensor("features", device="cpu")
    assert t.dtype == torch.float32 and t.shape == (4, 3)
    np.testing.assert_array_equal(t.numpy(), x)
    assert df.tensor("label", device="cpu",
                     dtype=torch.float32).dtype == torch.float32
    # tensors go back into columns as host numpy arrays
    out = df.with_column("double", t * 2)
    np.testing.assert_array_equal(out["double"], x * 2)


def test_params_accessors_and_defaults():
    clf = LightGBMClassifier(numLeaves=7, device="cpu")
    assert clf.getNumLeaves() == 7 and clf.getDevice() == "cpu"
    assert clf.getLearningRate() == 0.1 and not clf.isSet("learningRate")
    clf.setLearningRate(0.3)
    assert clf.getLearningRate() == 0.3
    with pytest.raises(TypeError):
        clf.setNumLeaves("many")
    with pytest.raises(AttributeError):
        clf.setNoSuchParam(1)


def test_pipeline_fit_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    df = DataFrame({"features": x, "label": y})
    model = Pipeline(stages=[LightGBMClassifier(
        device="cpu", numIterations=3, numLeaves=4)]).fit(df)
    assert isinstance(model, PipelineModel)
    path = str(tmp_path / "pipe")
    model.save(path)
    loaded = load_stage(path)
    np.testing.assert_allclose(
        np.asarray(loaded.transform(df)["probability"]),
        np.asarray(model.transform(df)["probability"]), atol=1e-6)


@pytest.mark.parametrize("kind", ["classification", "regression"])
def test_compute_model_statistics_matches_reference(kind):
    rng = np.random.default_rng(1)
    n = 400
    if kind == "classification":
        y = (rng.random(n) > 0.4).astype(np.float64)
        p = np.clip(y * 0.6 + rng.random(n) * 0.5, 0, 1)
        cols = {"label": y, "prediction": (p > 0.5).astype(np.float64),
                "probability": np.stack([1 - p, p], axis=1)}
    else:
        y = rng.normal(size=n)
        cols = {"label": y, "prediction": y + rng.normal(0, 0.3, n)}
    want = JComputeModelStatistics(labelCol="label").transform(
        JDataFrame(cols))
    got = ComputeModelStatistics(labelCol="label").transform(DataFrame(cols))
    assert got.columns == want.columns
    for c in want.columns:
        assert float(got[c][0]) == pytest.approx(float(want[c][0]),
                                                 rel=1e-12, abs=1e-12), c


def test_cuda_loader_keys_builds_by_the_headers_too(tmp_path):
    """A header the kernel sources include (``flash_common.cuh``, and the
    forward's body ``flash_fwd.cuh``) changes the library's build key as
    the sources do, so an edit to it rebuilds every library that includes
    it."""
    from mmlspark_torch.dl import flash_attention, paged_attention
    from mmlspark_torch.native.loader import CudaLoader
    src, hdr = tmp_path / "k.cu", tmp_path / "common.cuh"
    src.write_text('#include "common.cuh"\n')
    hdr.write_text("// one\n")
    loader = CudaLoader("keyed", [str(src)], headers=(str(hdr),))
    first = loader.so_path()
    assert CudaLoader("keyed", [str(src)]).so_path() != first
    hdr.write_text("// two\n")
    assert loader.so_path() != first
    both = ["flash_common.cuh", "flash_fwd.cuh"]
    for lib, want in ((flash_attention._LOADER, both),
                      (flash_attention._LOADER_BWD, ["flash_common.cuh"]),
                      (paged_attention._LOADER, both),
                      (paged_attention._LOADER_DECODE, ["flash_common.cuh"])):
        assert [h.rsplit("/", 1)[-1] for h in lib.headers] == want
