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

Beside it, :class:`NativeLoader` builds the host C++ libraries of the
serving plane (``native/src/httpfront.cpp``, the epoll front, and
``loadgen.cpp``, the closed-loop load generator) with ``g++`` into the same
build directory, keyed by the sources' hash, the flags and the host CPU
(``-march=native``). A failed build raises :class:`NativeBuildError` with
the compiler's output; :func:`get_httpfront` keeps the reference's
``None`` for callers that fall back (``serving_query(backend="auto")``),
and :func:`require_httpfront` raises that error for those that must not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
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


class _SharedLibrary:
    """One shared library built from sources on first use and loaded once a
    process; what the CUDA and the host loaders share. A subclass gives
    ``name``, ``sources``, ``source_hash()`` and ``build(so_path)``, and
    its own ``_guard``/``_locks``/``_loaded`` tables."""

    _guard: threading.Lock
    _locks: dict[str, threading.Lock]
    _loaded: dict[str, ctypes.CDLL]

    def so_path(self) -> str:
        return os.path.join(build_dir(),
                            f"lib{self.name}_{self.source_hash()[:16]}.so")

    def _compile(self, so_path: str, argv: list[str], error: type) -> None:
        """Run the compiler ``argv`` into a per-process temp file, published
        with os.replace so concurrent builders never load a half-written
        library; the compiler's output is kept beside it as ``<lib>.log``.
        A failed compile raises ``error`` with that output."""
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.build"
        cmd = [*argv, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise error(
                    f"{os.path.basename(argv[0])} failed building "
                    f"{self.name} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            with open(f"{so_path}.log", "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def ensure_built(self) -> str:
        so = self.so_path()
        if not os.path.exists(so):
            self.build(so)
        return so

    def load(self) -> ctypes.CDLL:
        # one lock per library, so different libraries build in parallel
        with self._guard:
            lock = self._locks.setdefault(self.name, threading.Lock())
        with lock:
            lib = self._loaded.get(self.name)
            if lib is not None:
                return lib
            lib = ctypes.CDLL(self.ensure_built())
            self._loaded[self.name] = lib
            return lib

    def forget(self) -> None:
        """Drop this process's load of the library (the next ``load``
        opens it again, building it if it is gone)."""
        with self._guard:
            lock = self._locks.setdefault(self.name, threading.Lock())
        with lock:
            self._loaded.pop(self.name, None)

    def build_log(self) -> str:
        """What the compiler printed when it built this library ("" if the
        library came from an earlier process's build that left no log)."""
        log = f"{self.so_path()}.log"
        if not os.path.exists(log):
            return ""
        with open(log) as f:
            return f.read()


class CudaLoader(_SharedLibrary):
    """Build and load one shared library from CUDA sources in the package."""

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
        return _hash(self.sources + self.headers, " ".join(self.flags))

    def build(self, so_path: str) -> None:
        """nvcc (``-Xptxas -v``: registers, shared memory and spills land
        in the build log), then a copy into the installed AOT store."""
        nvcc = find_nvcc()
        CudaLoader.nvcc_runs += 1
        self._compile(so_path, [nvcc, *self.flags, *self.sources],
                      KernelBuildError)
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


def _hash(paths: list[str], *extras: str) -> str:
    """sha256 of the files' bytes, then of the extra strings."""
    h = hashlib.sha256()
    for s in paths:
        with open(s, "rb") as f:
            h.update(f.read())
    for e in extras:
        h.update(e.encode())
    return h.hexdigest()


def _active_store():
    from ..core import aot
    return aot.active_store()


# ------------------------------------------------------------ host C++ build
#: the host libraries' g++ flags (the JAX package's ``NativeLoader``'s)
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread")


class NativeBuildError(RuntimeError):
    """g++ is missing or failed: a host library cannot be built."""


def _host_cpu() -> str:
    """The CPU ``-march=native`` compiles for: a library built on one
    machine is never loaded on another whose CPU differs."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + platform.processor()


class NativeLoader(_SharedLibrary):
    """Build and load one host shared library from C++ sources in
    ``native/src`` (the reference's ``NativeLoader``) with g++."""

    _guard = threading.Lock()
    _locks: dict[str, threading.Lock] = {}
    _loaded: dict[str, ctypes.CDLL] = {}

    def __init__(self, name: str, sources: list[str]):
        self.name = name
        self.sources = [os.path.join(SRC_DIR, s) for s in sources]
        self.flags = HOST_FLAGS

    def source_hash(self) -> str:
        """sha256 of the sources, the flags and the host CPU."""
        return _hash(self.sources, " ".join(self.flags), _host_cpu())

    def build(self, so_path: str) -> None:
        cxx = shutil.which("g++")
        if cxx is None:
            raise NativeBuildError(
                f"g++ not found on PATH: the host library {self.name} of "
                "mmlspark_torch is built from source on first use")
        self._compile(so_path, [cxx, *self.flags, *self.sources],
                      NativeBuildError)


#: the epoll front's loader (a test may swap it for one that fails)
HTTPFRONT = NativeLoader("httpfront", ["httpfront.cpp"])
_httpfront: list = []       # [lib] or [NativeBuildError] once tried
_httpfront_lock = threading.Lock()


def _configure_httpfront(lib) -> None:
    i64 = ctypes.c_int64
    u64 = ctypes.c_uint64
    lib.hf_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
    lib.hf_start.restype = i64
    lib.hf_poll.argtypes = [i64, ctypes.POINTER(u64), i64, ctypes.c_int]
    lib.hf_poll.restype = i64
    lib.hf_req_info.argtypes = [i64, u64, ctypes.c_char_p, i64,
                                ctypes.c_char_p, i64, ctypes.POINTER(i64),
                                ctypes.POINTER(i64)]
    lib.hf_req_info.restype = ctypes.c_int
    lib.hf_req_body.argtypes = [i64, u64, ctypes.c_char_p]
    lib.hf_req_body.restype = i64
    lib.hf_req_headers.argtypes = [i64, u64, ctypes.c_char_p]
    lib.hf_req_headers.restype = i64
    lib.hf_reply.argtypes = [i64, u64, ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_char_p, i64]
    lib.hf_reply.restype = ctypes.c_int
    lib.hf_stop.argtypes = [i64]
    lib.hf_stop.restype = None


def require_httpfront() -> ctypes.CDLL:
    """The native epoll HTTP front (``httpfront.cpp``), built at first use;
    raises :class:`NativeBuildError` (g++'s output included) when it
    cannot be built, every time it is asked for."""
    with _httpfront_lock:
        if not _httpfront:
            try:
                lib = HTTPFRONT.load()
                _configure_httpfront(lib)
                _httpfront.append(lib)
            except NativeBuildError as e:
                _httpfront.append(e)
        got = _httpfront[0]
    if isinstance(got, NativeBuildError):
        raise got
    return got


def get_httpfront():
    """The native epoll HTTP front, or None when it cannot be built (the
    reference's contract, for callers that fall back to the Python
    front)."""
    try:
        return require_httpfront()
    except NativeBuildError:
        return None


def reset_httpfront() -> None:
    """Forget the front's build outcome (the next call builds again)."""
    with _httpfront_lock:
        _httpfront.clear()
        HTTPFRONT.forget()
