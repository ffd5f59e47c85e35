"""The port's generic stages (``stages/basic.py``, ``batching.py``,
``misc.py``) against the JAX package's, on the CPU.

The same seeded frames go through both packages. Column plumbing,
batching, profiling, class weights and string normalization are host work
in both and must match exactly (NaN where NaN). ``EnsembleByKey``'s group
means (float32 sums in another order) match within 1e-6.
``StratifiedRepartition`` draws another permutation than ``jax.random``:
it must keep the row multiset, and its per-partition label counts (which
depend only on the group sizes) must equal the JAX package's.
``DynamicBufferedBatcher`` and ``Timer`` start threads or wait: each such
test runs under its own time limit and asserts no wall-clock time tighter
than 1 s.
"""

import math
import threading
import unicodedata

import numpy as np
import pytest
import torch

import mmlspark_tpu.featurize as jf
import mmlspark_tpu.stages as js
from mmlspark_tpu.core import DataFrame as JDataFrame
import mmlspark_torch.featurize as tf
import mmlspark_torch.stages as ts
from mmlspark_torch.core import DataFrame, PipelineModel
from mmlspark_torch.stages.basic import _cuda_devices

GROUP_ATOL = 1e-6
THREAD_LIMIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _within(seconds, fn):
    """Run ``fn`` in a thread and fail if it has not returned after
    ``seconds`` (this test's own time limit)."""
    result = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            result["error"] = e

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(seconds)
    assert not worker.is_alive(), f"still running after {seconds} s"
    if "error" in result:
        raise result["error"]
    return result["value"]


def _frame(n=12, seed=0):
    rng = np.random.default_rng(seed)
    cells = np.empty(n, object)
    cells[:] = [list(rng.integers(0, 5, rng.integers(0, 4)))
                for _ in range(n)]
    return {"x": rng.normal(size=n), "k": rng.integers(0, 3, n),
            "v": rng.normal(size=(n, 2)).astype(np.float32),
            "s": np.asarray([f"Word{i % 4} ÉTÉ" for i in range(n)], object),
            "lists": cells}


def _assert_frames_equal(got, want):
    assert got.columns == want.columns
    assert got.num_partitions == want.num_partitions
    for c in want.columns:
        g, w = got[c], np.asarray(want[c])
        assert g.dtype == w.dtype, c
        if g.dtype == object:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(g, w)


def _double(x):
    return x * 2


def _sum_cols(a, b):
    return a + b


def _add_len(df):
    return df.with_column("n", np.asarray([len(v) for v in df["lists"]]))


BASIC = {
    "DropColumns": lambda m: m.DropColumns(cols=["x", "absent"]),
    "SelectColumns": lambda m: m.SelectColumns(cols=["k", "s"]),
    "RenameColumn": lambda m: m.RenameColumn(inputCol="x", outputCol="y"),
    "UDFTransformer_one": lambda m: m.UDFTransformer(
        inputCol="x", outputCol="x2", udf=_double),
    "UDFTransformer_many": lambda m: m.UDFTransformer(
        inputCols=["x", "k"], outputCol="xk", udf=_sum_cols),
    "Lambda": lambda m: m.Lambda(transformFunc=_add_len),
    "Repartition": lambda m: m.Repartition(n=3),
    "Repartition_disabled": lambda m: m.Repartition(n=3, disable=True),
    "Cacher": lambda m: m.Cacher(),
    "Explode": lambda m: m.Explode(inputCol="lists", outputCol="item"),
    "FixedMiniBatchTransformer": lambda m: m.FixedMiniBatchTransformer(
        batchSize=5),
    "DynamicMiniBatchTransformer": lambda m: m.DynamicMiniBatchTransformer(
        maxBatchSize=4),
    "TimeIntervalMiniBatchTransformer_single":
        lambda m: m.TimeIntervalMiniBatchTransformer(),
    "PartitionConsolidator": lambda m: m.PartitionConsolidator(),
    "TextPreprocessor": lambda m: m.TextPreprocessor(
        inputCol="s", outputCol="t", normFunc="lower",
        map={"word1": "one", "été": "summer", "word": "w"}),
    "UnicodeNormalize_NFKD": lambda m: m.UnicodeNormalize(
        inputCol="s", outputCol="u", form="NFKD", lower=True),
    "UnicodeNormalize_NFC": lambda m: m.UnicodeNormalize(
        inputCol="s", outputCol="u", form="NFC", lower=False),
    "SummarizeData": lambda m: m.SummarizeData(),
}


@pytest.mark.parametrize("name", sorted(BASIC))
def test_host_stages_match_jax(name):
    data = _frame()
    jout = BASIC[name](js).transform(JDataFrame(data, num_partitions=2))
    tout = BASIC[name](ts).transform(DataFrame(data, num_partitions=2))
    _assert_frames_equal(tout, jout)


def test_summarize_data_nan_and_strings():
    x = np.asarray([1.5, np.nan, 2.5, 0.1, np.nan, 1e9])
    s = np.asarray(["a", None, "b", "a", "c", None], object)
    data = {"x": x, "x32": x.astype(np.float32), "s": s,
            "i": np.asarray([3, 1, 3, 2, 2, 2 ** 40])}
    jrows = js.SummarizeData().transform(JDataFrame(data)).collect()
    trows = ts.SummarizeData().transform(DataFrame(data)).collect()
    assert len(trows) == len(jrows) == 4
    for t, j in zip(trows, jrows):
        assert t.keys() == j.keys()
        for k in j:
            if isinstance(j[k], float) and math.isnan(j[k]):
                assert math.isnan(t[k]), k
            else:
                assert t[k] == j[k], (k, t[k], j[k])


def test_time_interval_batches_and_flatten_match_jax():
    rng = np.random.default_rng(4)
    n = 40
    ts_ms = 1_700_000_000_000 + np.sort(rng.integers(0, 5000, n))
    ts_ms = ts_ms[rng.permutation(n)].astype(np.int64)
    data = {"ts": ts_ms, "x": rng.normal(size=n),
            "v": rng.integers(0, 9, (n, 3)),
            "s": np.asarray([f"r{i}" for i in range(n)], object)}
    kw = dict(timestampCol="ts", millisToWait=700, maxBatchSize=6)
    jb = js.TimeIntervalMiniBatchTransformer(**kw).transform(
        JDataFrame(data))
    tb = ts.TimeIntervalMiniBatchTransformer(**kw).transform(DataFrame(data))
    _assert_frames_equal(tb, jb)
    jflat = js.FlattenBatch().transform(jb)
    tflat = ts.FlattenBatch().transform(tb)
    _assert_frames_equal(tflat, jflat)
    assert tflat["ts"].dtype == np.int64          # epoch millis stay exact
    order = np.argsort(ts_ms, kind="stable")
    np.testing.assert_array_equal(tflat["ts"], ts_ms[order])
    np.testing.assert_array_equal(tflat["s"], data["s"][order])


def test_multi_column_adapter_matches_jax():
    data = {"a": np.asarray(["The cat sat", "A dog"], object),
            "b": np.asarray(["Hello, world", ""], object)}
    kw = dict(inputCols=["a", "b"], outputCols=["ta", "tb"])
    jout = js.MultiColumnAdapter(baseStage=jf.Tokenizer(), **kw).transform(
        JDataFrame(data))
    tout = ts.MultiColumnAdapter(baseStage=tf.Tokenizer(), **kw).transform(
        DataFrame(data))
    _assert_frames_equal(tout, jout)


@pytest.mark.parametrize("labels", ["float", "string"])
def test_class_balancer_matches_jax(labels):
    rng = np.random.default_rng(9)
    y = rng.choice([0.1, 0.2, 0.7], size=30, p=[0.6, 0.3, 0.1])
    if labels == "string":
        y = np.asarray([f"c{v}" for v in y], object)
    jm = js.ClassBalancer(inputCol="y").fit(JDataFrame({"y": y}))
    tm = ts.ClassBalancer(inputCol="y").fit(DataFrame({"y": y}))
    assert tm.getWeights() == jm.getWeights()
    _assert_frames_equal(tm.transform(DataFrame({"y": y})),
                         jm.transform(JDataFrame({"y": y})))


@pytest.mark.parametrize("seed", [0, 3])
def test_stratified_repartition_invariants(seed):
    rng = np.random.default_rng(seed)
    n, parts = 101, 4
    label = rng.choice([0, 1, 2], size=n, p=[0.6, 0.3, 0.1])
    data = {"label": label, "row": np.arange(n)}
    kw = dict(labelCol="label", seed=seed)
    jout = js.StratifiedRepartition(**kw).transform(
        JDataFrame(data, num_partitions=parts))
    tout = ts.StratifiedRepartition(**kw, device="cpu").transform(
        DataFrame(data, num_partitions=parts))
    assert tout.num_partitions == parts
    assert sorted(tout["row"]) == list(range(n))          # same multiset
    np.testing.assert_array_equal(label[tout["row"]], tout["label"])
    counts = [np.bincount(p["label"], minlength=3)
              for p in tout.partitions()]
    jcounts = [np.bincount(np.asarray(p["label"]), minlength=3)
               for p in jout.partitions()]
    np.testing.assert_array_equal(counts, jcounts)
    assert (counts[0] > 0).all()   # the interleave leads with every label
    again = ts.StratifiedRepartition(**kw, device="cpu").transform(
        DataFrame(data, num_partitions=parts))
    np.testing.assert_array_equal(again["row"], tout["row"])


def test_ensemble_by_key_matches_jax():
    rng = np.random.default_rng(2)
    n = 40
    cells = np.empty(n, object)
    cells[:] = [rng.normal(size=3) for _ in range(n)]
    data = {"a": rng.integers(0, 3, n),
            "b": np.asarray([f"g{v}" for v in rng.integers(0, 2, n)], object),
            "score": rng.normal(size=n), "vec": rng.normal(size=(n, 2)),
            "cells": cells}
    kw = dict(keys=["a", "b"], cols=["score", "vec", "cells"])
    jout = js.EnsembleByKey(**kw).transform(JDataFrame(data))
    tout = ts.EnsembleByKey(**kw, device="cpu").transform(DataFrame(data))
    assert tout.columns == jout.columns
    for c in ("a", "b"):
        np.testing.assert_array_equal(tout[c], jout[c])
    for c in ("mean(score)", "mean(vec)", "mean(cells)"):
        got = np.stack([np.asarray(v, np.float64) for v in tout[c]])
        want = np.stack([np.asarray(v, np.float64) for v in jout[c]])
        np.testing.assert_allclose(got, want, rtol=0, atol=GROUP_ATOL)
    assert isinstance(tout["mean(score)"][0], float)


@pytest.mark.parametrize("max_batch", [None, 7])
def test_dynamic_buffered_batcher(max_batch):
    """Both packages' batchers hand every item over once, in order, in
    batches no larger than the bound (batch sizes depend on timing)."""
    def drain(cls):
        return list(cls(iter(range(200)), max_buffer_size=16,
                        max_batch=max_batch))

    for cls in (js.DynamicBufferedBatcher, ts.DynamicBufferedBatcher):
        batches = _within(THREAD_LIMIT_S, lambda: drain(cls))
        assert [i for b in batches for i in b] == list(range(200))
        assert all(0 < len(b) <= (max_batch or 16) for b in batches)


def test_dynamic_buffered_batcher_linger_grows_batches():
    def slow_source():
        for i in range(12):
            if i % 4 == 0:
                threading.Event().wait(0.05)
            yield i

    batches = _within(THREAD_LIMIT_S, lambda: list(
        ts.DynamicBufferedBatcher(slow_source(), max_batch=4, linger=2.0)))
    assert [i for b in batches for i in b] == list(range(12))
    # a 2 s linger fills each batch to its bound before closing
    assert [len(b) for b in batches] == [4, 4, 4]


def test_timer_times_estimators_and_transformers():
    x = np.asarray([1.0, np.nan, 3.0], np.float32)
    clean = tf.CleanMissingData(inputCols=["x"], device="cpu")
    timer = ts.Timer(stage=clean)
    out = _within(THREAD_LIMIT_S, lambda: timer.transform(
        DataFrame({"x": x})))
    jout = js.Timer(stage=jf.CleanMissingData(inputCols=["x"])).transform(
        JDataFrame({"x": x}))
    np.testing.assert_array_equal(out["x"], np.asarray(jout["x"]))
    assert 0 <= timer.lastDispatch <= timer.lastDuration < 60
    assert _cuda_devices(clean) == set()
    # a default-device stage, alone or inside a pipeline, is synced on CUDA
    inner = PipelineModel([tf.FeaturizeModel(encodingPlan=[])])
    assert _cuda_devices(ts.Timer(stage=inner)) == {"cuda"}
    assert _cuda_devices(ts.Timer(stage=tf.TextFeaturizer(
        device="cuda:1"))) == {"cuda:1"}


def test_unicode_normalize_keeps_none():
    data = {"s": np.asarray(["Ǆ", None, unicodedata.normalize(
        "NFD", "é")], object)}
    jout = js.UnicodeNormalize(inputCol="s", outputCol="u").transform(
        JDataFrame(data))
    tout = ts.UnicodeNormalize(inputCol="s", outputCol="u").transform(
        DataFrame(data))
    assert list(tout["u"]) == list(jout["u"]) == ["dž", None, "é"]
