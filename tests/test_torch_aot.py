"""The port's AOT store (``mmlspark_torch/core/aot.py``) on the CPU.

The scenarios of ``test_aot.py`` that need neither the autoscaler
(ROADMAP.md §1 item 9d-2) nor ``scrubbed_cpu_env`` (item 10) run against
the port with the same names, inputs and assertions:
``TestFingerprints`` (stable across processes and torch-free, param and
bucket moves, callables refused, fitted state), ``TestStore`` (build then
load bit-equal with zero runtime compiles, a request-path miss that
backfills, a corrupt entry's loud fallback, stale and version-stale
entries, the unfingerprintable runtime path, atomic writes),
``TestSteadyState`` and ``TestCli`` (slow, as in the reference; one fast
test drives the same verbs in-process through ``_cli``). Where the
reference reads or writes ``exe.bin`` the port's payload is the bucket's
``program.json``; where it calls ``compat.jit`` the port's tracked callable
is ``compile_tracker.track``.

The port's own parts: kernel libraries in the store (a miss builds and
backfills, a hit runs no build, a flipped byte is one loud miss, a build
failure is raised) on a stand-in loader whose "nvcc" copies the C math
library; a segment whose traced form loads a library carries it; and
both packages' canonical stage fingerprints and the engine's program
names and key fields are equal.
"""

import contextlib
import ctypes.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mmlspark_torch.device as tdevice
from mmlspark_torch.core import DataFrame, Param, Transformer, aot
from mmlspark_torch.core import compile_pipeline as _compile
from mmlspark_torch.core.aot import AotStore
from mmlspark_torch.native import loader as tloader
from mmlspark_torch.native.loader import CudaLoader, KernelBuildError
from mmlspark_torch.obs.metrics import registry as _reg
from mmlspark_torch.obs.profile import compile_tracker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_pipeline(stages, df, **kw):
    kw.setdefault("device", "cpu")
    return _compile(stages, df, **kw)


def _spec(n=8, width=4, seed=3, cat_size=3):
    """Deterministic fully-param pipeline + example (the reference's)."""
    from mmlspark_torch.featurize import CleanMissingData, VectorAssembler
    from mmlspark_torch.featurize.vector import OneHotEncoderModel

    rng = np.random.default_rng(seed)
    aux = rng.normal(size=n).astype(np.float32)
    aux[::3] = np.nan
    df = DataFrame({
        "x": rng.normal(size=(n, width)).astype(np.float32),
        "aux": aux,
        "cat": (np.arange(n) % cat_size).astype(np.int32),
    })
    stages = [
        CleanMissingData(inputCols=["aux"], cleaningMode="Mean",
                         device="cpu").fit(df),
        OneHotEncoderModel(inputCol="cat", outputCol="onehot",
                           categorySize=cat_size, handleInvalid="keep"),
        VectorAssembler(inputCols=["x", "aux", "onehot"],
                        outputCol="features", handleInvalid="keep"),
    ]
    return stages, df


@pytest.fixture(autouse=True)
def _no_active_store():
    """Each test owns its store; never leak one into other suites."""
    prev = aot.active_store()
    aot.uninstall()
    compile_tracker.unmark_steady()
    yield
    compile_tracker.unmark_steady()
    if prev is not None:
        aot.install(prev)
    else:
        aot.uninstall()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch (tier-1 runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counter_sum(prefix: str, reason: str | None = None) -> float:
    return sum(v for k, v in _reg.snapshot().items()
               if k.startswith(prefix)
               and (reason is None or f'reason="{reason}"' in k))


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


# ------------------------------------------------------------ fingerprints
FP_STAGES = """
from mmlspark_torch.core import Param, Transformer

class FpScale(Transformer):
    k = Param("k", "factor")
    inputCol = Param("inputCol", "input")

stages = [FpScale(k=3.0, inputCol="x"), FpScale(k=0.1, inputCol="cat")]
"""

NO_TORCH_FP_SNIPPET = FP_STAGES + """
import sys, json
from mmlspark_torch.core import aot
assert 'torch' not in sys.modules, 'the core package pulled in torch'
key = aot.segment_static_key(stages, no_donate=('cat',),
                             expected_host=('id',), platform='cpu')
donated = [['x', 'float32', [8, 4]]]
dropped = [['cat', 'int32', [8]]]
print(json.dumps(aot.fingerprints(key, donated, dropped)))
assert 'torch' not in sys.modules, 'fingerprints() pulled in torch'
"""


class TestFingerprints:
    def _fp_here(self):
        ns: dict = {}
        exec(FP_STAGES, ns)
        key = aot.segment_static_key(ns["stages"], no_donate=("cat",),
                                     expected_host=("id",),
                                     platform="cpu")
        return aot.fingerprints(key, [["x", "float32", [8, 4]]],
                                [["cat", "int32", [8]]])

    def test_stable_across_processes_and_torch_free(self):
        """The exact key this process computes, a fresh torch-free
        process computes too."""
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "-c", NO_TORCH_FP_SNIPPET],
            capture_output=True, text=True, cwd=REPO, env=env, check=True,
            timeout=120)
        child = tuple(json.loads(out.stdout.strip()))
        assert child == self._fp_here()

    def test_param_change_moves_static_fingerprint(self):
        from mmlspark_torch.featurize.vector import OneHotEncoderModel
        a = aot.segment_static_key(
            [OneHotEncoderModel(inputCol="c", outputCol="o",
                                categorySize=3, handleInvalid="keep")],
            platform="cpu")
        b = aot.segment_static_key(
            [OneHotEncoderModel(inputCol="c", outputCol="o",
                                categorySize=4, handleInvalid="keep")],
            platform="cpu")
        assert aot.fingerprints(a, [], [])[0] != \
            aot.fingerprints(b, [], [])[0]

    def test_bucket_moves_full_not_static(self):
        from mmlspark_torch.featurize.vector import OneHotEncoderModel
        key = aot.segment_static_key(
            [OneHotEncoderModel(inputCol="c", outputCol="o",
                                categorySize=3, handleInvalid="keep")],
            platform="cpu")
        s4, f4 = aot.fingerprints(key, [["c", "int32", [4]]], [])
        s8, f8 = aot.fingerprints(key, [["c", "int32", [8]]], [])
        assert s4 == s8 and f4 != f8

    def test_callable_param_is_unfingerprintable(self):
        from mmlspark_torch.stages import UDFTransformer
        stage = UDFTransformer(inputCol="b", outputCol="d", jitSafe=True,
                               udf=lambda b: b * 2.0)
        with pytest.raises(aot.Unfingerprintable):
            aot.segment_static_key([stage], platform="cpu")

    def test_fitted_state_moves_fingerprint(self):
        stages_a, df = _spec(seed=3)
        stages_b, _ = _spec(seed=4)
        ka = aot.segment_static_key(stages_a, platform="cpu")
        kb = aot.segment_static_key(stages_b, platform="cpu")
        assert aot.fingerprints(ka, [], [])[0] != \
            aot.fingerprints(kb, [], [])[0]

    def test_versions_name_torch_cuda_nvcc_and_arch(self):
        v = aot.runtime_versions()
        assert set(v) == {"torch", "torch_cuda", "nvcc", "arch"}
        assert v["arch"] == "sm_90a"
        assert v["torch"].split("+")[0] == torch.__version__.split("+")[0]
        assert v["torch_cuda"] == (torch.version.cuda or "none")
        # a device Param does not key the program: the segment's
        # platform does
        from mmlspark_torch.featurize.vector import VectorAssembler
        a = aot.stage_fingerprint(VectorAssembler(inputCols=["x"],
                                                  device="cpu"))
        b = aot.stage_fingerprint(VectorAssembler(inputCols=["x"]))
        assert a == b and "device" not in a["params"]


# ------------------------------------------------------------------ store
class TestStore:
    def _build(self, tmp_path, stages=None, df=None, service="t"):
        if stages is None:
            stages, df = _spec()
        store = AotStore(str(tmp_path / "store"))
        cp = compile_pipeline(stages, df, service=service)
        records = aot.build_pipeline(cp, df, store)
        return store, records, stages, df

    def test_build_then_load_bit_equal_zero_compiles(self, tmp_path):
        store, records, stages, df = self._build(tmp_path)
        assert any(r.get("built") for r in records)
        ref = compile_pipeline(stages, df, service="t-ref").transform(df)
        aot.install(store)
        fresh = compile_pipeline(stages, df, service="t")
        assert fresh.warm_aot() >= 1
        compile_tracker.mark_steady()
        out = fresh.transform(df)
        assert compile_tracker.runtime_compiles() == 0, \
            compile_tracker.runtime_compiled()
        for c in ref.columns:
            assert _equal(ref[c], out[c]), c  # bit-equal, atol 0

    def test_request_path_miss_backfills(self, tmp_path):
        stages, df = _spec()
        store = aot.install(AotStore(str(tmp_path / "store")))
        misses0 = _counter_sum("aot_store_miss_total")
        cp = compile_pipeline(stages, df, service="t")
        out = cp.transform(df)
        assert _counter_sum("aot_store_miss_total") == misses0 + 1
        assert store.stats()["entries"] == 1
        hits0 = _counter_sum("aot_store_hit_total")
        cp2 = compile_pipeline(stages, df, service="t")
        assert cp2.warm_aot() == 1
        assert _counter_sum("aot_store_hit_total") == hits0 + 1
        for c in out.columns:
            assert _equal(out[c], cp2.transform(df)[c])

    def test_corrupt_entry_loud_fallback(self, tmp_path, caplog):
        """A flipped byte in the bucket's payload → checksum mismatch →
        counted corrupt miss + warning + rebuild; never a wrong (or
        crashed) answer."""
        store, records, stages, df = self._build(tmp_path)
        ref = compile_pipeline(stages, df, service="t-ref").transform(df)
        entry = store.entries()[0]
        path = os.path.join(entry["_dir"], "program.json")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        aot.install(store)
        corrupt0 = _counter_sum("aot_store_miss_total", "corrupt")
        cp = compile_pipeline(stages, df, service="t")
        assert cp.warm_aot() == 0  # nothing loadable
        with caplog.at_level("WARNING",
                             logger="mmlspark_torch.core.aot"):
            out = cp.transform(df)  # miss → rebuild-and-backfill
        assert any("corrupt" in r.message for r in caplog.records)
        assert _counter_sum("aot_store_miss_total", "corrupt") > corrupt0
        for c in ref.columns:
            assert _equal(ref[c], out[c]), c
        # the backfill REPLACED the corrupt entry: next process loads
        cp2 = compile_pipeline(stages, df, service="t")
        assert cp2.warm_aot() == 1

    def test_stale_param_change_rebuilds_not_wrong(self, tmp_path):
        stages, df = self._build(tmp_path)[2:]
        store = AotStore(str(tmp_path / "store"))
        assert store.stats()["entries"] == 1
        old_fp = store.entries()[0]["static_fp"]
        stages2, df2 = _spec(cat_size=4)
        aot.install(store)
        cp = compile_pipeline(stages2, df2, service="t")
        assert cp.warm_aot() == 0  # stale entry must NOT load
        out = cp.transform(df2)     # miss → rebuild under the new fp
        assert store.stats()["entries"] == 2
        ref = compile_pipeline(stages2, df2,
                               service="t-ref").transform(df2)
        for c in ref.columns:
            assert _equal(ref[c], out[c]), c
        live = {m["static_fp"] for m in store.entries()} - {old_fp}
        removed = store.gc(keep_static=live)
        assert len(removed) == 1
        assert store.stats()["entries"] == 1
        assert store.entries()[0]["static_fp"] != old_fp

    def test_version_stale_entries_gc(self, tmp_path):
        store = self._build(tmp_path)[0]
        meta_path = os.path.join(store.entries()[0]["_dir"],
                                 "meta.json")
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        meta["versions"] = {"torch": "0.0.1", "torch_cuda": "0.0",
                            "nvcc": "0.0", "arch": "sm_90a"}
        with open(meta_path, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        assert len(store.gc()) == 1
        assert store.stats()["entries"] == 0

    def test_unfingerprintable_segment_keeps_jit_path(self, tmp_path):
        from mmlspark_torch.stages import UDFTransformer
        rng = np.random.default_rng(0)
        df = DataFrame({"b": rng.normal(size=8).astype(np.float32)})
        stages = [UDFTransformer(inputCol="b", outputCol="d",
                                 jitSafe=True,
                                 udf=lambda b: torch.tanh(b) * 2.0)]
        store = aot.install(AotStore(str(tmp_path / "store")))
        n0 = _counter_sum("aot_store_miss_total", "unfingerprintable")
        cp = compile_pipeline(stages, df, service="t")
        assert cp.compiled_segments == 1
        out = cp.transform(df)
        np.testing.assert_allclose(
            np.asarray(out["d"]), np.tanh(np.asarray(df["b"])) * 2.0,
            atol=1e-6)
        assert _counter_sum("aot_store_miss_total",
                            "unfingerprintable") == n0 + 1
        assert store.stats()["entries"] == 0

    def test_atomic_writes_no_tmp_left(self, tmp_path):
        store = self._build(tmp_path)[0]
        leftovers = [p for p, _, _ in os.walk(store.root)
                     if os.path.basename(p).startswith(".tmp-")]
        assert leftovers == []

    def test_entry_carries_meta_and_cost(self, tmp_path):
        store, records, stages, df = self._build(tmp_path)
        (meta,) = store.entries()
        assert meta["tier"] == "program" and meta["libraries"] == []
        assert meta["stages"] == [type(s).__name__ for s in stages]
        assert meta["versions"] == aot.runtime_versions()
        assert meta["platform"] == "cpu"
        assert meta["cost"]["bytes"] > 0 and meta["cost"]["flops"] >= 0
        assert [c for c, _, _ in meta["donated"]] == ["aux", "cat", "x"]

    def test_auto_install_and_foreign_root(self, tmp_path, monkeypatch,
                                           caplog):
        """``maybe_warm`` installs the configured root when this user
        owns it, and refuses it (loudly, warming nothing) otherwise."""
        store, _, stages, df = self._build(tmp_path)
        monkeypatch.setenv("MMLSPARK_TPU_AOT_STORE", store.root)
        cp = compile_pipeline(stages, df, service="t")
        uid = os.getuid()
        monkeypatch.setattr(os, "getuid", lambda: uid + 1)
        with caplog.at_level("WARNING", logger="mmlspark_torch.core.aot"):
            assert aot.maybe_warm(cp) == 0
        assert any("not owned" in r.message for r in caplog.records)
        assert aot.active_store() is None
        monkeypatch.setattr(os, "getuid", lambda: uid)
        assert aot.maybe_warm(cp) == 1
        assert aot.active_store().root == store.root

# ------------------------------------------- the serving half's store part
class TestServingIntegration:
    """The scenarios of the reference's class that need no autoscaler: a
    ``run`` callable carrying its stages, the serving DSL's
    ``compile_pipeline(aot_buckets=)`` registration, the build CLI's
    body."""

    def test_warm_walks_dsl_run_closure(self, tmp_path):
        stages, df = _spec()
        store, _, _, _ = TestStore()._build(tmp_path, stages, df)
        aot.install(store)
        cp = compile_pipeline(stages, df, service="t")

        def run(frame):
            return cp.transform(frame)
        run.stages = [cp]
        assert aot.maybe_warm(run, service="t") >= 1
        compile_tracker.mark_steady()
        run(df)
        assert compile_tracker.runtime_compiles() == 0

    def test_dsl_compile_pipeline_registers_buildable(self):
        from mmlspark_torch.serving.dsl import read_stream
        stages, df = _spec()
        stream = (read_stream().server()
                  .address("127.0.0.1", 0, "aot-reg-test").load())
        try:
            for s in stages:
                stream.transform(s)
            stream.compile_pipeline(df, aot_buckets=(4, 8), device="cpu")
            assert "aot-reg-test" in aot.buildable_services()
            spec = aot._BUILDERS["aot-reg-test"]()
            assert spec["buckets"] == (4, 8)
            assert spec["stages"] == stages
        finally:
            aot._BUILDERS.pop("aot-reg-test", None)
            stream.server._httpd.server_close()

    def test_build_registered_covers_buckets(self, tmp_path):
        stages, df = _spec()
        aot.register_buildable(
            "aot-build-test",
            lambda: {"stages": stages, "example": df, "buckets": (8, 4)})
        try:
            store = AotStore(str(tmp_path / "store"))
            report = aot.build_registered("aot-build-test", store,
                                          log=lambda *_: None,
                                          device="cpu")
            assert store.stats()["entries"] == 2  # one per bucket
            built = report["services"]["aot-build-test"]
            assert built["buckets"] == [4, 8]
            assert built["build_order"] == [4, 8]
            assert report["coverage"]["covered"] >= 3
            assert "VectorAssembler" in aot.traceable_stage_classes()
        finally:
            aot._BUILDERS.pop("aot-build-test", None)



# ----------------------------------------------- CompileTracker steady mode
class TestSteadyState:
    def test_runtime_compile_counted_and_raises(self):
        base = _counter_sum("profile_runtime_compiles_total")
        compile_tracker.mark_steady()
        try:
            fn = compile_tracker.track(lambda x: x + 1,
                                       name="steady-violator")
            fn(torch.tensor(1.0))  # a compile AFTER steady — a violation
            assert compile_tracker.runtime_compiles() == 1
            assert "steady-violator" in compile_tracker.runtime_compiled()
            assert _counter_sum("profile_runtime_compiles_total") \
                == base + 1
            with pytest.raises(AssertionError, match="steady-violator"):
                compile_tracker.assert_steady_state()
        finally:
            compile_tracker.unmark_steady()

    def test_clean_steady_state_passes(self):
        fn = compile_tracker.track(lambda x: x * 2, name="steady-clean")
        fn(torch.tensor(1.0))  # warmup compile
        compile_tracker.mark_steady()
        try:
            fn(torch.tensor(2.0))  # cache hit
            assert compile_tracker.runtime_compiles() == 0
            compile_tracker.assert_steady_state()
        finally:
            compile_tracker.unmark_steady()


# -------------------------------------------------------- kernel libraries
LIBM = ctypes.util.find_library("m")


@contextlib.contextmanager
def _build_dir(path):
    old = os.environ.get("MMLSPARK_TORCH_BUILD_DIR")
    os.environ["MMLSPARK_TORCH_BUILD_DIR"] = str(path)
    try:
        yield
    finally:
        if old is None:
            del os.environ["MMLSPARK_TORCH_BUILD_DIR"]
        else:
            os.environ["MMLSPARK_TORCH_BUILD_DIR"] = old


@pytest.fixture
def fake_loader(tmp_path, monkeypatch):
    """A loader over a stand-in source whose "nvcc" copies the C math
    library (a real shared object, so ``ctypes`` loads it); builds are
    counted."""
    src = tmp_path / "k.cu"
    src.write_text("// stand-in kernel source\n")
    loader = CudaLoader("aot_test_kernel", [str(src)])
    builds = []

    def build(self, so_path):
        if self.name != "aot_test_kernel":
            raise AssertionError(f"unexpected build of {self.name}")
        builds.append(so_path)
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        shutil.copy(os.path.realpath(find_libm()), so_path)
        store = aot.active_store()
        if store is not None:
            store.save_library(self, so_path, backfill=True)

    monkeypatch.setattr(CudaLoader, "build", build)
    monkeypatch.setattr(aot, "_NVCC_VERSION", "12.9.41")
    yield loader, builds
    CudaLoader._loaded.pop("aot_test_kernel", None)
    CudaLoader.registry.pop("aot_test_kernel", None)


def find_libm():
    for cand in (LIBM, "/lib/x86_64-linux-gnu/libm.so.6",
                 "/usr/lib/x86_64-linux-gnu/libm.so.6",
                 "/lib64/libm.so.6"):
        if cand and os.path.exists(cand):
            return cand
    return ctypes.CDLL(LIBM)._name


class TestLibraries:
    def test_miss_builds_and_backfills_then_hits(self, tmp_path,
                                                 fake_loader):
        loader, builds = fake_loader
        store = aot.install(AotStore(str(tmp_path / "store")))
        absent0 = _counter_sum("aot_store_miss_total", "absent")
        with _build_dir(tmp_path / "b1"):
            so = loader.ensure_built()
        assert len(builds) == 1
        assert _counter_sum("aot_store_miss_total", "absent") == absent0 + 1
        (meta,) = store.entries()
        assert meta["tier"] == "library"
        assert meta["key"] == aot.library_key(loader)
        assert meta["key"]["nvcc"] == "12.9.41"
        hits0 = _counter_sum("aot_store_hit_total")
        with _build_dir(tmp_path / "b2"):          # a fresh machine
            so2 = loader.ensure_built()
        assert len(builds) == 1                    # no nvcc
        assert _counter_sum("aot_store_hit_total") == hits0 + 1
        assert open(so, "rb").read() == open(so2, "rb").read()
        assert os.path.basename(so) == os.path.basename(so2)

    def test_flipped_byte_is_one_loud_miss(self, tmp_path, fake_loader,
                                           caplog):
        loader, builds = fake_loader
        store = AotStore(str(tmp_path / "store"))
        with _build_dir(tmp_path / "b1"):
            aot.build_libraries(store, ["aot_test_kernel"],
                                log=lambda *_: None)
        (meta,) = store.entries()
        path = os.path.join(meta["_dir"], "lib.so")
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 3] ^= 0xFF
        open(path, "wb").write(bytes(blob))
        aot.install(store)
        corrupt0 = _counter_sum("aot_store_miss_total", "corrupt")
        with _build_dir(tmp_path / "b2"), caplog.at_level(
                "WARNING", logger="mmlspark_torch.core.aot"):
            so = loader.ensure_built()
        assert _counter_sum("aot_store_miss_total", "corrupt") \
            == corrupt0 + 1
        assert any("corrupt" in r.message for r in caplog.records)
        assert len(builds) == 2                    # rebuilt...
        good = open(so, "rb").read()
        assert open(path, "rb").read() == good     # ...and backfilled
        with _build_dir(tmp_path / "b3"):
            assert open(loader.ensure_built(), "rb").read() == good
        assert len(builds) == 2

    def test_mismatched_entry_and_nvcc_version(self, tmp_path,
                                               fake_loader, monkeypatch):
        loader, builds = fake_loader
        store = AotStore(str(tmp_path / "store"))
        with _build_dir(tmp_path / "b1"):
            aot.build_libraries(store, ["aot_test_kernel"],
                                log=lambda *_: None)
        full = aot.library_fingerprints(loader)[1]
        monkeypatch.setattr(aot, "_NVCC_VERSION", "12.8.0")
        assert aot.library_fingerprints(loader)[1] != full
        monkeypatch.setattr(aot, "_NVCC_VERSION", "12.9.41")
        meta_path = os.path.join(store.entry_dir(full), "meta.json")
        meta = json.load(open(meta_path))
        meta["key"]["name"] = "another"
        json.dump(meta, open(meta_path, "w"))
        aot.install(store)
        n0 = _counter_sum("aot_store_miss_total", "mismatch")
        with _build_dir(tmp_path / "b2"):
            loader.ensure_built()
        assert _counter_sum("aot_store_miss_total", "mismatch") == n0 + 1
        assert len(builds) == 2

    def test_build_failure_is_raised(self, tmp_path, monkeypatch):
        src = tmp_path / "bad.cu"
        src.write_text("// does not build\n")
        loader = CudaLoader("aot_test_broken", [str(src)])

        def build(self, so_path):
            raise KernelBuildError("nvcc failed building aot_test_broken")
        monkeypatch.setattr(CudaLoader, "build", build)
        aot.install(AotStore(str(tmp_path / "store")))
        try:
            with _build_dir(tmp_path / "b"), \
                    pytest.raises(KernelBuildError):
                loader.ensure_built()
        finally:
            CudaLoader.registry.pop("aot_test_broken", None)

    def test_segment_carries_the_libraries_it_loads(self, tmp_path,
                                                    fake_loader):
        """A segment whose traced form launches a kernel: its entry lists
        the library, and a warm boot on a fresh build directory loads it
        from the store (no build)."""
        loader, builds = fake_loader

        class KernelStage(Transformer):
            k = Param("k", "factor")

            def _transform(self, df):
                return df.with_column("o", df["v"] * self.get("k"))

            def _trace(self, cols):
                loader.load()
                out = dict(cols)
                out["o"] = cols["v"] * self.get("k")
                return out

        df = DataFrame({"v": np.arange(4, dtype=np.float32)})
        stages = [KernelStage(k=2.0)]
        store = AotStore(str(tmp_path / "store"))
        with _build_dir(tmp_path / "b1"):
            cp = compile_pipeline(stages, df, service="kern")
            CudaLoader._loaded.pop("aot_test_kernel", None)
            aot.build_pipeline(cp, df, store)
        seg = [m for m in store.entries() if m["tier"] == "program"]
        assert seg[0]["libraries"] == ["aot_test_kernel"]
        assert len(builds) == 1
        CudaLoader._loaded.pop("aot_test_kernel", None)
        aot.install(store)
        with _build_dir(tmp_path / "b2"):
            cp2 = compile_pipeline(stages, df, service="kern")
            CudaLoader._loaded.pop("aot_test_kernel", None)
            assert cp2.warm_aot() == 1
            assert "aot_test_kernel" in CudaLoader._loaded
        assert len(builds) == 1


# ---------------------------------------------------------- across packages
class TestAcrossPackages:
    def test_stage_fingerprints_equal_jax(self):
        """The 20 stage cases' canonical dicts are the JAX package's (the
        versions component differs by design: keys here pass none)."""
        import test_pipeline_compile as jref
        from mmlspark_tpu.core import aot as jaot
        from test_torch_compile import JAX_CASES, PORT_CASES
        assert sorted(JAX_CASES) == sorted(PORT_CASES)
        keyed = 0
        for name in sorted(PORT_CASES):
            pstage, _ = PORT_CASES[name]
            jstage, _ = JAX_CASES[name]
            try:
                want = jaot.stage_fingerprint(jstage)
            except jaot.Unfingerprintable:
                with pytest.raises(aot.Unfingerprintable):
                    aot.stage_fingerprint(pstage)
                continue
            assert aot.stage_fingerprint(pstage) == want, name
            pk = aot.segment_static_key([pstage], platform="cpu",
                                        versions={})
            jk = jaot.segment_static_key([jstage], platform="cpu",
                                         versions={})
            assert aot.fingerprints(pk, [], []) == \
                jaot.fingerprints(jk, [], []), name
            keyed += 1
        assert keyed == 19          # all but UDFTransformer's callable
        assert jref is not None

    def test_engine_program_names_and_keys_equal_jax(self, monkeypatch):
        """The engine's programs are named and keyed as the JAX engine's
        for one tiny configuration (the versions component apart)."""
        import jax
        import jax.numpy as jnp

        from mmlspark_tpu.dl import MaskedLMModel as JLM
        from mmlspark_tpu.dl import TextEncoder as JEnc
        from mmlspark_tpu.dl import make_attention_fn as jattn
        from mmlspark_tpu.obs import MetricsRegistry as JReg
        from mmlspark_tpu.serving import llm as jllm
        from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                       make_attention_fn)
        from mmlspark_torch.obs import MetricsRegistry
        from mmlspark_torch.serving import llm as tllm

        keys = {"jax": [], "port": []}
        for mod, tag in ((jllm, "jax"), (tllm, "port")):
            real = mod.aot.fingerprints

            def rec(key, d, p, real=real, tag=tag):
                keys[tag].append({k: v for k, v in key.items()
                                  if k != "versions"})
                return real(key, d, p)
            monkeypatch.setattr(mod.aot, "fingerprints", rec)
        monkeypatch.setenv("MMLSPARK_TPU_PAGED_ATTN", "1")
        shape = dict(vocab=32, width=16, depth=1, heads=2, mlp_dim=32)
        jmod = JLM(JEnc(**shape, dtype=jnp.float32,
                        attention_fn=jattn("dense", causal=True)))
        jvars = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                   np.zeros((1, 8), np.int32))
        jeng = jllm.LLMEngine(jmod, jvars, slots=2, block_len=4,
                              max_seq_len=16, service="fp",
                              registry=JReg())
        g = torch.Generator().manual_seed(0)
        tmod = MaskedLMModel(TextEncoder(
            **shape, dtype=torch.float32, generator=g,
            attention_fn=make_attention_fn("dense", causal=True)), g)
        teng = tllm.LLMEngine(tmod, slots=2, block_len=4, max_seq_len=16,
                              service="fp", registry=MetricsRegistry(),
                              device="cpu")
        # build (not run) every program: prefill windows 1 and 4, decode
        for eng in (jeng, teng):
            eng.prefiller._program(1)
            eng.prefiller._program(4)
        jeng.decoder._build()
        jfps = {**jeng.prefiller.aot_fingerprints(),
                **jeng.decoder.aot_fingerprints()}
        tfps = {**teng.prefiller.aot_fingerprints(),
                **teng.decoder.aot_fingerprints()}
        assert sorted(tfps) == sorted(jfps)
        assert sorted(keys["port"], key=json.dumps) == \
            sorted(keys["jax"], key=json.dumps)
        # equal across two port engines of one configuration
        teng2 = tllm.LLMEngine(tmod, slots=2, block_len=4, max_seq_len=16,
                               service="fp", registry=MetricsRegistry(),
                               device="cpu")
        teng2.prefiller._program(1)
        teng2.prefiller._program(4)
        assert {**teng2.prefiller.aot_fingerprints(),
                **teng2.decoder.aot_fingerprints()} == tfps


# ------------------------------------------------------------------- CLI
def test_cli_verbs_in_process(tmp_path, capsys):
    """build, list, verify and gc through ``_cli`` (the CLI's own
    argument parsing and report lines), in this process."""
    root = str(tmp_path / "store")
    assert aot._cli(["build", "--service", "__selftest__", "--root", root,
                     "--device", "cpu"]) == 0
    assert "build: 2 entries" in capsys.readouterr().out
    assert aot._cli(["list", "--root", root]) == 0
    listing = capsys.readouterr().out
    rows = [ln.split() for ln in listing.splitlines()
            if ln.endswith("__selftest__:seg0")]
    assert len(rows) == 2 and all(r[1] == "program" for r in rows)
    assert json.loads(listing[listing.index("{"):])["entries"] == 2
    assert aot._cli(["verify", "--service", "__selftest__", "--root", root,
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "runtime_compiles=0" in out and "columns_equal=True" in out
    assert aot._cli(["gc", "--root", root, "--keep-static",
                     "0" * 64]) == 0
    assert "removed 2" in capsys.readouterr().out


def test_cli_build_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        aot._cli(["build", "--service", "__selftest__", "--root",
                  str(tmp_path / "s")])
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.slow
class TestCli:
    def _env(self):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["OMP_NUM_THREADS"] = "1"
        return env

    def test_selftest_round_trip(self):
        out = subprocess.run(
            [sys.executable, "-m", "mmlspark_torch.core.aot", "selftest",
             "--device", "cpu"],
            capture_output=True, text=True, cwd=REPO, env=self._env(),
            timeout=600)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "selftest OK" in out.stdout

    def test_list_and_gc_cli(self, tmp_path):
        root = str(tmp_path / "store")
        env = self._env()
        out = subprocess.run(
            [sys.executable, "-m", "mmlspark_torch.core.aot", "build",
             "--service", "__selftest__", "--root", root, "--device",
             "cpu"],
            capture_output=True, text=True, cwd=REPO, env=env,
            timeout=600)
        assert out.returncode == 0, out.stdout + out.stderr
        out = subprocess.run(
            [sys.executable, "-m", "mmlspark_torch.core.aot", "list",
             "--root", root],
            capture_output=True, text=True, cwd=REPO, env=env,
            timeout=600)
        assert out.returncode == 0 and "__selftest__:seg" in out.stdout
        out = subprocess.run(
            [sys.executable, "-m", "mmlspark_torch.core.aot", "gc",
             "--root", root, "--keep-static", "0" * 64],
            capture_output=True, text=True, cwd=REPO, env=env,
            timeout=600)
        assert out.returncode == 0 and "removed 2" in out.stdout
