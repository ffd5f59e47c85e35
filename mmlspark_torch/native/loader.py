"""CudaLoader — compile a CUDA source with nvcc on first use, bind it with ctypes.

The port's counterpart of ``mmlspark_tpu/native/loader.py``: source →
shared library keyed by a hash of the sources and the flags → ``ctypes.CDLL``,
one load per process. The library lands in ``mmlspark_torch/_build/`` inside
the checkout (``MMLSPARK_TORCH_BUILD_DIR`` moves it). Each kernel source
exposes a plain ``extern "C"`` launcher, so nvcc needs neither PyTorch's
headers nor ninja and builds in seconds.

With an AOT store installed (``core/aot.py``), a library missing from the
build directory is taken from the store before nvcc runs, and a library
built here is saved into the store: a fresh process on a new machine then
runs no nvcc. A corrupt or mismatched stored library is a loud miss
(counted, warned, rebuilt and backfilled).

Unlike the JAX package's optional host libraries, a kernel the port runs has
no fallback: a missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
#: the target every library is built for (``NVCC_FLAGS``' ``-gencode``)
TARGET_ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed: a kernel the path needs cannot exist."""


def build_dir() -> str:
    """Where libraries are built and loaded from: ``MMLSPARK_TORCH_BUILD_DIR``
    or the package's ``_build``."""
    return os.environ.get("MMLSPARK_TORCH_BUILD_DIR") or BUILD_DIR


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of mmlspark_torch are built "
        "from source on first use")


class CudaLoader:
    """Build and load one shared library from CUDA sources in the package."""

    # one lock per library, so different kernels build in parallel
    _guard = threading.Lock()
    _locks: dict[str, threading.Lock] = {}
    _loaded: dict[str, ctypes.CDLL] = {}
    #: every loader made in this process, by library name (the AOT
    #: store's build packs these)
    registry: dict[str, "CudaLoader"] = {}
    #: nvcc compiles run by this process
    nvcc_runs = 0

    def __init__(self, name: str, sources: list[str],
                 flags: tuple[str, ...] = NVCC_FLAGS,
                 headers: tuple[str, ...] = ()):
        self.name = name
        self.sources = [os.path.join(PACKAGE_DIR, s) for s in sources]
        # included by the sources: hashed with them, not compiled alone
        self.headers = [os.path.join(PACKAGE_DIR, s) for s in headers]
        self.flags = tuple(flags)
        CudaLoader.registry[name] = self

    def source_hash(self) -> str:
        """sha256 of the sources, the headers they include and the flags:
        what decides the library's bytes, with the compiler's version."""
        h = hashlib.sha256()
        for s in self.sources + self.headers:
            with open(s, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.flags).encode())
        return h.hexdigest()

    def so_path(self) -> str:
        return os.path.join(build_dir(),
                            f"lib{self.name}_{self.source_hash()[:16]}.so")

    def build(self, so_path: str) -> None:
        """nvcc into a per-process temp file, published with os.replace so
        concurrent builders never load a half-written library. The
        compiler's output (``-Xptxas -v``: registers, shared memory,
        spills) is kept beside the library as ``<lib>.log``."""
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.build"
        cmd = [find_nvcc(), *self.flags, *self.sources, "-o", tmp]
        try:
            CudaLoader.nvcc_runs += 1
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed building {self.name} "
                    f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            with open(f"{so_path}.log", "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        store = _active_store()
        if store is not None:
            store.save_library(self, so_path, backfill=True)

    def ensure_built(self) -> str:
        """The library's path, taken from the installed AOT store or built
        with nvcc when it is not in the build directory yet."""
        so = self.so_path()
        if not os.path.exists(so):
            store = _active_store()
            if store is None or not store.load_library(self, so):
                self.build(so)
        return so

    def load(self) -> ctypes.CDLL:
        with CudaLoader._guard:
            lock = CudaLoader._locks.setdefault(self.name, threading.Lock())
        with lock:
            lib = CudaLoader._loaded.get(self.name)
            if lib is not None:
                return lib
            lib = ctypes.CDLL(self.ensure_built())
            CudaLoader._loaded[self.name] = lib
            return lib

    def build_log(self) -> str:
        """What nvcc printed when it built this library ("" if the library
        came from an earlier process's build that left no log)."""
        log = f"{self.so_path()}.log"
        if not os.path.exists(log):
            return ""
        with open(log) as f:
            return f.read()


def _active_store():
    from ..core import aot
    return aot.active_store()
