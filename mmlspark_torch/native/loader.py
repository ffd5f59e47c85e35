"""CudaLoader — compile a CUDA source with nvcc on first use, bind it with ctypes.

The port's counterpart of ``mmlspark_tpu/native/loader.py``: source →
shared library keyed by a hash of the sources and the flags → ``ctypes.CDLL``,
one load per process. The library lands in ``mmlspark_torch/_build/`` inside
the checkout. Each kernel source exposes a plain ``extern "C"`` launcher, so
nvcc needs neither PyTorch's headers nor ninja and builds in seconds.

Unlike the JAX package's optional host libraries, a kernel the port runs has
no fallback: a missing ``nvcc`` or a failed build raises.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of mmlspark_torch are built "
        "from source on first use")


class CudaLoader:
    """Build and load one shared library from CUDA sources in the package."""

    # one lock per library, so different kernels build in parallel
    _guard = threading.Lock()
    _locks: dict[str, threading.Lock] = {}
    _loaded: dict[str, ctypes.CDLL] = {}

    def __init__(self, name: str, sources: list[str],
                 flags: tuple[str, ...] = NVCC_FLAGS,
                 headers: tuple[str, ...] = ()):
        self.name = name
        self.sources = [os.path.join(PACKAGE_DIR, s) for s in sources]
        # included by the sources: hashed with them, not compiled alone
        self.headers = [os.path.join(PACKAGE_DIR, s) for s in headers]
        self.flags = tuple(flags)

    def so_path(self) -> str:
        h = hashlib.sha256()
        for s in self.sources + self.headers:
            with open(s, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.flags).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}_{h.hexdigest()[:16]}.so")

    def build(self, so_path: str) -> None:
        """nvcc into a per-process temp file, published with os.replace so
        concurrent builders never load a half-written library. The
        compiler's output (``-Xptxas -v``: registers, shared memory,
        spills) is kept beside the library as ``<lib>.log``."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.build"
        cmd = [find_nvcc(), *self.flags, *self.sources, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {self.name} "
                    f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            with open(f"{so_path}.log", "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self) -> ctypes.CDLL:
        with CudaLoader._guard:
            lock = CudaLoader._locks.setdefault(self.name, threading.Lock())
        with lock:
            lib = CudaLoader._loaded.get(self.name)
            if lib is not None:
                return lib
            so = self.so_path()
            if not os.path.exists(so):
                self.build(so)
            lib = ctypes.CDLL(so)
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
