"""On-demand ``torch.profiler`` captures, bundled for the debug surface.

The port's own copy of the JAX package's ``obs/xprof.py``: a capture
records host and device activity with ``torch.profiler.profile`` and
writes it as a Chrome trace (``trace.json``, open in Perfetto) beside a
``manifest.json`` into a rank-suffixed directory under the capture root;
:meth:`XprofCaptures.list_captures` lists finished captures and
:meth:`XprofCaptures.fetch` returns one as a zip archive.
:meth:`XprofCaptures.handle_query` is the ``/debug/xprof`` route's
adapter for a serving front.

Two ways to capture: :meth:`~XprofCaptures.capture` records whatever the
process does for a bounded duration (the route's form), and
:meth:`~XprofCaptures.region` records the enclosed block.

Contracts:

- **one capture at a time** — a second capture while one is open raises
  :class:`CaptureBusy` (409 on the route; the profiler is a
  process-global singleton and overlapping sessions corrupt each other),
- **bounded duration** — ``duration_ms`` is clamped to
  [1, ``MMLSPARK_TPU_XPROF_MAX_MS``] (default 30 s),
- **never initializes CUDA** — device activity is recorded only where a
  CUDA context already exists; without one the capture records host
  activity alone and its manifest says so (``"device": false`` with the
  reason).

Import is stdlib-only; torch is touched only inside a capture.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
import threading
import time
import urllib.parse
import zipfile

from .attribution import cuda_initialized
from .metrics import registry as _registry

#: duration ceiling (ms) — env-overridable for long captures
ENV_MAX_MS = "MMLSPARK_TPU_XPROF_MAX_MS"
#: capture root override (default: a per-process dir under the temp dir)
ENV_DIR = "MMLSPARK_TPU_XPROF_DIR"

_DEFAULT_MAX_MS = 30_000.0


def _cuda_ready() -> tuple[bool, str]:
    """Whether a capture can record device activity NOW, without
    initializing CUDA. The reason lands in the manifest when not."""
    if not cuda_initialized():
        return False, "no CUDA context in this process: host activity only"
    return True, ""


class XprofCaptures:
    """The per-process capture manager."""

    def __init__(self, root: str | None = None, registry=None):
        reg = registry if registry is not None else _registry
        self._root = root or os.environ.get(ENV_DIR) \
            or os.path.join(tempfile.gettempdir(),
                            f"mmlspark_torch_xprof_{os.getpid()}")
        self._lock = threading.Lock()
        self._active: str | None = None
        self._seq = 0
        self._c_captures = reg.counter(
            "profile_xprof_captures_total",
            "on-demand device-trace capture attempts, by outcome "
            "(ok | busy | unavailable | error)")

    @property
    def root(self) -> str:
        return self._root

    def _max_ms(self) -> float:
        try:
            return float(os.environ.get(ENV_MAX_MS, _DEFAULT_MAX_MS))
        except (TypeError, ValueError):
            return _DEFAULT_MAX_MS

    def _rank(self) -> str:
        from .profile import process_label
        return process_label() or "0"

    # -- capture -----------------------------------------------------------
    def _open(self, tag: str) -> str:
        with self._lock:
            if self._active is not None:
                self._c_captures.inc(1, outcome="busy")
                raise CaptureBusy(self._active)
            self._seq += 1
            name = f"capture-{self._seq:04d}"
            if tag:
                name += f"-{_clean(tag)}"
            name += f"-r{self._rank()}"
            self._active = name
        return name

    @contextlib.contextmanager
    def region(self, tag: str = ""):
        """Capture the enclosed block. Yields the manifest dict, which
        is complete (``files``, ``seconds``, ``trace``) once the block
        ends. Raises :class:`CaptureBusy` when a capture is open."""
        name = self._open(tag)
        log_dir = os.path.join(self._root, name)
        device, reason = _cuda_ready()
        manifest = {"capture": name, "dir": log_dir, "device": device,
                    "activities": ["cpu", "cuda"] if device else ["cpu"],
                    "reason": reason,
                    "trace": os.path.join(log_dir, "trace.json")}
        try:
            import torch.profiler as tp
            os.makedirs(log_dir, exist_ok=True)
            acts = [tp.ProfilerActivity.CPU]
            if device:
                acts.append(tp.ProfilerActivity.CUDA)
            t0 = time.perf_counter()
            with tp.profile(activities=acts) as prof:
                yield manifest
                if device:
                    # the block's last kernels end inside the capture
                    import torch
                    torch.cuda.synchronize()
            manifest["seconds"] = time.perf_counter() - t0
            prof.export_chrome_trace(manifest["trace"])
            manifest["files"] = _count_files(log_dir) + 1
            with open(os.path.join(log_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
        except BaseException:
            self._c_captures.inc(1, outcome="error")
            raise
        finally:
            with self._lock:
                self._active = None
        self._c_captures.inc(1, outcome="ok")

    def capture(self, duration_ms: float, tag: str = "") -> dict:
        """Run one bounded capture of whatever the process does,
        blocking for its duration. Raises :class:`CaptureBusy` (-> 409)
        when a capture is already open."""
        duration_ms = min(max(float(duration_ms), 1.0), self._max_ms())
        with self.region(tag) as manifest:
            time.sleep(duration_ms / 1e3)
        manifest["duration_ms"] = duration_ms
        return manifest

    # -- read surface ------------------------------------------------------
    def list_captures(self) -> dict:
        captures = []
        if os.path.isdir(self._root):
            for name in sorted(os.listdir(self._root)):
                d = os.path.join(self._root, name)
                if os.path.isdir(d):
                    captures.append({"capture": name,
                                     "files": _count_files(d)})
        ok, reason = _cuda_ready()
        with self._lock:
            active = self._active
        return {"root": self._root, "active": active,
                "available": ok, "reason": reason,
                "captures": captures}

    def fetch(self, name: str) -> bytes | None:
        """One finished capture as zip bytes (None when unknown). The
        name is sanitized against traversal — only direct children of
        the root are fetchable."""
        name = os.path.basename(name)
        d = os.path.join(self._root, name)
        if not name or not os.path.isdir(d):
            return None
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for base, _dirs, files in os.walk(d):
                for f in files:
                    full = os.path.join(base, f)
                    z.write(full, os.path.relpath(full, d))
        return buf.getvalue()

    # -- the /debug/xprof route adapter ------------------------------------
    def handle_query(self, query: str, body: bytes) -> tuple[int, bytes]:
        """A front's ``/debug/xprof`` handler: ``duration_ms=`` in the
        query runs a capture, ``fetch=<name>`` returns an archive,
        anything else lists."""
        q = urllib.parse.parse_qs(query or "")
        if "duration_ms" in q:
            try:
                duration = float(q["duration_ms"][0])
            except (TypeError, ValueError, IndexError):
                return 400, b'{"error": "bad duration_ms"}'
            tag = (q.get("tag") or [""])[0]
            try:
                out = self.capture(duration, tag=tag)
            except CaptureBusy as e:
                return 409, json.dumps(
                    {"error": "capture in flight",
                     "active": str(e)}).encode()
            except Exception as e:
                return 500, json.dumps(
                    {"error": "capture failed",
                     "reason": repr(e)}).encode()
            return 200, json.dumps(out, indent=1).encode()
        if "fetch" in q:
            blob = self.fetch((q.get("fetch") or [""])[0])
            if blob is None:
                return 404, b'{"error": "unknown capture"}'
            return 200, blob
        return 200, json.dumps(self.list_captures(),
                               indent=1).encode()


class CaptureBusy(RuntimeError):
    """A capture is already open -> HTTP 409."""


def _clean(tag: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(tag))[:48]


def _count_files(d: str) -> int:
    return sum(len(files) for _b, _d, files in os.walk(d))


#: THE process-wide capture manager.
xprof_captures = XprofCaptures()
