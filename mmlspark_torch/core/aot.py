"""Ahead-of-time store: what a fresh worker would otherwise pay at request
time, built once and keyed by fingerprint.

The port of ``mmlspark_tpu/core/aot.py``. There, every (route, padding
bucket, mesh) pays its XLA compile on first traffic, so the store keeps
serialized executables. The port compiles nothing per request: what a
fresh checkout or container pays on its first request is nvcc, building
each hand-written kernel's library (``native/loader.py``). So the store
keeps exactly those libraries, beside one entry per fused-segment bucket
(``core/compile.py``'s :class:`~.compile.FusedSegment`) that carries the
bucket's program description and its analytic cost, and that warm loading
runs once on zeros so the first request pays nothing. The forward's tuned
tile instances (``mmlspark_flash_tuned``, loaded only where a tuned winner
of ``perf.autotune`` asks for one) are a library entry like the others,
so a worker that boots with a registry and a store runs no nvcc either.

The store is a content-addressed directory tree::

    <root>/<ff[:2]>/<ff>/        ff = full fingerprint (sha256 hex)
        meta.json                key components, specs, tier, checksum,
                                 cost
        program.json             the segment bucket's canonical program
                                 (tier "program")
        lib.so                   a kernel's built library (tier "library")

Two fingerprints per entry, as in the reference:

- **static fingerprint** — stage classes + params (fitted state lives
  in params), donation split, host-column contract, mesh descriptor,
  device platform, runtime versions. Everything that decides WHAT
  program a segment runs, minus the input shapes. For a library: its
  name.
- **full fingerprint** — static + the column spec (names, dtypes,
  shapes): one entry per padding bucket. For a library: the hash of its
  sources and flags (the one ``CudaLoader`` names the file by), the nvcc
  version and the target arch.

A param change moves the static fingerprint, so stale entries can never
be served (they simply stop matching); :meth:`AotStore.gc` reclaims
them. A corrupt, truncated or mismatched entry is a LOUD miss
(``aot_store_miss_total{reason=...}`` + warning) followed by a rebuild and
backfill — never a wrong answer. A CUDA error or a failed kernel build is
raised, never absorbed.

Fingerprint computation and store bookkeeping import no torch: versions
come from ``importlib.metadata`` and the files of the installed packages
and toolkit, hashes from hashlib. Building and warming a segment run it
on its device.

Build CLI (segments run on CUDA unless ``--device cpu``)::

    python -m mmlspark_torch.core.aot build --import myapp.pipelines \\
        --root /var/mmlspark_torch/aot [--libraries]
    python -m mmlspark_torch.core.aot list|gc|selftest|verify ...

Warm loading: :meth:`~.compile.CompiledPipeline.warm_aot` and
:func:`maybe_warm` (a mesh compute worker calls it before its first
lease). The deploy plane's ``registry.json`` beside the tree pins the
entries of versions in a deploy state (and, with ``gc --keep-versions
N``, of the last N versions) against gc.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading

import numpy as np

_LOG = logging.getLogger("mmlspark_torch.core.aot")

#: default on-disk root (override with MMLSPARK_TPU_AOT_STORE, the
#: reference's switch). Under the process's temporary directory
#: (``TMPDIR``), per user, as the cost model's root is: the store holds
#: libraries a process loads and runs, so a shared path would let any
#: local user plant code another user's server boot would execute
#: (maybe_warm additionally refuses roots this uid does not own).
DEFAULT_STORE_ROOT = os.path.join(
    tempfile.gettempdir(),
    "mmlspark_torch_aot_store-" + str(getattr(os, "getuid", lambda: "u")()))
_META = "meta.json"
_PROGRAM = "program.json"
_LIB = "lib.so"
STORE_VERSION = 1
TIERS = ("program", "library")


def store_root() -> str:
    """The configured store root: ``MMLSPARK_TPU_AOT_STORE`` or the
    default."""
    return os.environ.get("MMLSPARK_TPU_AOT_STORE") or DEFAULT_STORE_ROOT


def compile_cache_dir() -> str:
    """The persistent compile cache a scrubbed child is pointed at
    (``core.utils.scrubbed_cpu_env``), by the reference's rule: an
    explicit ``JAX_COMPILATION_CACHE_DIR`` wins; with a configured store
    root (``MMLSPARK_TPU_AOT_STORE``) it lives under it, beside the
    store's entries; else the reference's default."""
    explicit = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if explicit:
        return explicit
    if os.environ.get("MMLSPARK_TPU_AOT_STORE"):
        return os.path.join(store_root(), "jax_cache")
    return "/tmp/mmlspark_tpu_jax_cache"


# ---------------------------------------------------------------- metrics
def _reg():
    from ..obs.metrics import registry
    return registry


def _metrics():
    reg = _reg()
    return {
        "hit": reg.counter(
            "aot_store_hit_total",
            "segment buckets and kernel libraries served from the AOT "
            "store, by segment/tier (program | library)"),
        "miss": reg.counter(
            "aot_store_miss_total",
            "AOT store lookups that fell through to a runtime build, "
            "by segment/reason (absent | corrupt | mismatch | "
            "unfingerprintable | error)"),
        "backfill": reg.counter(
            "aot_store_backfill_total",
            "runtime-built entries written back into the store"),
        "build": reg.histogram(
            "aot_build_seconds",
            "wall seconds per store build, by segment"),
        "entries": reg.gauge(
            "aot_store_entries", "entries resident in the store"),
        "gc_kept": reg.counter(
            "aot_gc_kept_versions",
            "gc-stale entries spared because a deploy-registry "
            "version still needs them (deploy state or keep-last-N)"),
    }


# ------------------------------------------------------- deploy registry
#: the deploy registry's file beside the store tree
#: (``serving/deploy.py`` writes it, gc and the CLI read it)
REGISTRY_FILE = "registry.json"

# the deploy registry's version lifecycle (``serving/deploy.py`` uses
# these names; gc reads them from the registry file)
REGISTERED = "registered"   # named, not yet warmed or routed
WARMING = "warming"         # executables pre-loading on live workers
CANDIDATE = "candidate"     # staged for traffic (canary slice/shadow)
ACTIVE = "active"           # owns the traffic pointer
DRAINING = "draining"       # flipped away; finishing admitted work
RETIRED = "retired"         # done; eligible for gc (subject to last-N)

#: states that pin a version's store entries against gc no matter what
#: keep-last-N says: collecting a rollback target (or the version
#: currently serving) mid-deploy would turn the next flip into a
#: compile storm
DEPLOY_STATES = (WARMING, CANDIDATE, ACTIVE, DRAINING)


def _registry_versions(root: str) -> list[dict]:
    """Version records from the deploy-plane registry persisted beside
    the store tree (``serving/deploy.py`` writes ``registry.json``
    there). Read as plain JSON — the gc/list paths must not grow a
    serving import."""
    try:
        with open(os.path.join(root, REGISTRY_FILE),
                  encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return []
    recs = payload.get("versions", [])
    return [r for r in recs if isinstance(r, dict) and r.get("name")]


def _protected_static_fps(root: str,
                          keep_model_versions: int | None) -> set:
    """Static fingerprints gc must spare: every registry version in a
    deploy state, plus — with ``keep_model_versions=N`` — the last N
    versions by registration order (the operator's rollback horizon)."""
    recs = _registry_versions(root)
    keep: set = set()
    for rec in recs:
        if rec.get("state") in DEPLOY_STATES:
            keep.update(rec.get("static_fps", []))
    if keep_model_versions:
        ordered = sorted(recs, key=lambda r: r.get("seq", 0))
        for rec in ordered[-int(keep_model_versions):]:
            keep.update(rec.get("static_fps", []))
    return keep


# ----------------------------------------------------------- fingerprints
class Unfingerprintable(ValueError):
    """A stage carries state that cannot be canonically serialized
    (e.g. a raw callable param): its segment must NEVER match a store
    entry — two different callables would otherwise share an entry. The
    segment stays on the runtime path."""


def _package_version(pkg: str) -> str:
    import importlib.metadata as md
    try:
        return md.version(pkg)
    except md.PackageNotFoundError:
        return "absent"


def _torch_cuda_version() -> str:
    """torch's CUDA version from the installed package's ``version.py``,
    read as text (no import of torch)."""
    import importlib.util
    try:
        spec = importlib.util.find_spec("torch")
    except (ImportError, ValueError):
        spec = None
    if spec is None or not spec.submodule_search_locations:
        return "absent"
    for loc in spec.submodule_search_locations:
        try:
            with open(os.path.join(loc, "version.py"),
                      encoding="utf-8") as f:
                text = f.read()
        except OSError:
            continue
        for line in text.splitlines():
            if line.startswith("cuda") and "=" in line:
                value = line.split("=", 1)[1].split("#")[0].strip()
                return value.strip("'\"") if value != "None" else "none"
    return "absent"


_NVCC_VERSION: str | None = None


def nvcc_version() -> str:
    """The release of the CUDA toolkit nvcc belongs to, read, not run:
    its ``version.json``'s nvcc entry, else ``include/cuda.h``'s
    ``CUDA_VERSION`` (12090 → "12.9"); ``nvcc --version`` only when the
    toolkit has neither; "absent" without a toolkit. Read once."""
    global _NVCC_VERSION
    if _NVCC_VERSION is not None:
        return _NVCC_VERSION
    from ..native.loader import KernelBuildError, find_nvcc
    try:
        nvcc = find_nvcc()
    except KernelBuildError:
        _NVCC_VERSION = "absent"
        return _NVCC_VERSION
    home = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    try:
        with open(os.path.join(home, "version.json"),
                  encoding="utf-8") as f:
            info = json.load(f)
        _NVCC_VERSION = str(info["cuda_nvcc"]["version"])
        return _NVCC_VERSION
    except (OSError, ValueError, KeyError, TypeError):
        pass
    try:
        with open(os.path.join(home, "include", "cuda.h"),
                  encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if parts[:2] == ["#define", "CUDA_VERSION"]:
                    v = int(parts[2])
                    _NVCC_VERSION = f"{v // 1000}.{v % 1000 // 10}"
                    return _NVCC_VERSION
    except (OSError, ValueError, IndexError):
        pass
    import subprocess
    proc = subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True)
    last = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    _NVCC_VERSION = last[-1].strip() if last else "unknown"
    return _NVCC_VERSION


def runtime_versions() -> dict:
    """torch, the CUDA it was built for, nvcc and the target arch,
    WITHOUT importing torch (fingerprint computation stays torch-free).
    Absent pieces fingerprint as "absent" — a store built with a toolkit
    can never match a process without it."""
    from ..native.loader import TARGET_ARCH
    return {"torch": _package_version("torch"),
            "torch_cuda": _torch_cuda_version(),
            "nvcc": nvcc_version(),
            "arch": TARGET_ARCH}


def _canon(value):
    """Reduce a param value to a deterministic JSON-able form; raise
    :class:`Unfingerprintable` for anything without one."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return repr(value)  # repr round-trips; str() loses precision
    if isinstance(value, np.generic):
        return _canon(value.item())
    if isinstance(value, (list, tuple)):
        return [_canon(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _canon(v) for k, v in sorted(value.items(),
                                                    key=lambda kv:
                                                    str(kv[0]))}
    if isinstance(value, np.ndarray) and value.dtype != object:
        return {"__ndarray__": [str(value.dtype), list(value.shape),
                                hashlib.sha256(
                                    np.ascontiguousarray(value)
                                    .tobytes()).hexdigest()]}
    if hasattr(value, "detach") and hasattr(value, "dtype"):
        # tensors canonicalize through their host bytes
        return _canon(value.detach().cpu().numpy())
    raise Unfingerprintable(
        f"param value of type {type(value).__name__} has no canonical "
        "form; its stage cannot be keyed into the AOT store")


#: params that do not decide a segment's program: the segment runs on
#: its own device, keyed by the platform component
_UNKEYED_PARAMS = frozenset({"device"})


def stage_fingerprint(stage) -> dict:
    """One stage's identity: class + every param value (fitted state —
    levels, fill values, idf vectors — lives in params, so a refit
    moves the fingerprint). A stage's ``device`` Param is left out: a
    fused segment runs every stage on the segment's device."""
    entry = {"class": type(stage).__name__}
    params = {}
    get = getattr(stage, "get", None)
    if callable(get) and hasattr(type(stage), "params"):
        for p in type(stage).params():
            if p.name in _UNKEYED_PARAMS:
                continue
            params[p.name] = _canon(get(p))
    entry["params"] = params
    return entry


def _dtype_name(dtype) -> str:
    """numpy's name for a numpy or torch dtype (torch's ``torch.float32``
    → ``float32``), read without importing torch."""
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    return str(np.dtype(dtype))


def column_spec(cols: dict) -> list:
    """Ordered (name, dtype, shape) triples for a column dict — numpy
    and torch columns alike."""
    return [[c, _dtype_name(v.dtype), list(v.shape)]
            for c, v in sorted(cols.items())]


def arg_sig(donated: dict, dropped: dict) -> tuple:
    """Hashable in-memory key for one (donated, dropped) argument pair
    — the per-bucket entry key inside a FusedSegment."""
    def one(cols):
        return tuple((c, _dtype_name(v.dtype), tuple(v.shape))
                     for c, v in sorted(cols.items()))
    return one(donated), one(dropped)


def sig_from_spec(donated_spec: list, dropped_spec: list) -> tuple:
    """The same key :func:`arg_sig` yields, rebuilt from a stored
    meta.json spec (warm loading has no arrays in hand)."""
    def one(spec):
        return tuple((c, dt, tuple(shape)) for c, dt, shape in spec)
    return one(donated_spec), one(dropped_spec)


def _sha(payload) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()


def mesh_descriptor(mesh) -> list | None:
    """A mesh's fingerprint-relevant identity. Compiled segments run on
    no mesh until ROADMAP.md §1 item 10-2, so every segment fingerprints
    None here."""
    if mesh is None:
        return None
    raise NotImplementedError(
        "a mesh in an AOT fingerprint: compiled segments over a mesh come "
        "with ROADMAP.md §1 item 10-2")


def _canon_rules(rules) -> list | None:
    """Partition rules' fingerprint form: (pattern, spec) pairs as
    deterministic strings. Rules change a segment's program, so they
    MUST move the key."""
    if not rules:
        return None
    try:
        return [[str(p), repr(s)] for p, s in rules]
    except (TypeError, ValueError) as e:
        raise Unfingerprintable(
            f"partition rules have no canonical form: {e}") from e


def segment_static_key(stages, *, no_donate=(), expected_host=(),
                       mesh=None, donate: bool = True, rules=None,
                       platform: str = "cpu",
                       versions: dict | None = None) -> dict:
    """Everything that decides WHAT program a segment runs, minus input
    shapes — incl. the donation flag and partition rules. Raises
    :class:`Unfingerprintable` when any stage cannot be
    canonicalized."""
    return {
        "v": STORE_VERSION,
        "stages": [stage_fingerprint(s) for s in stages],
        "no_donate": sorted(no_donate),
        "expected_host": sorted(expected_host),
        "mesh": mesh_descriptor(mesh),
        "donate": bool(donate),
        "rules": _canon_rules(rules),
        "platform": platform,
        "versions": versions if versions is not None
        else runtime_versions(),
    }


def fingerprints(static_key: dict, donated_spec: list,
                 dropped_spec: list) -> tuple[str, str]:
    """→ (static_fp, full_fp). The static fp groups every padding
    bucket of one segment program; the full fp is one bucket."""
    static_fp = _sha(static_key)
    full_fp = _sha({"static": static_fp, "donated": donated_spec,
                    "dropped": dropped_spec})
    return static_fp, full_fp


def _segment_key(segment) -> dict:
    return segment_static_key(
        segment.stages, no_donate=segment.no_donate,
        expected_host=segment.expected_host, mesh=segment.mesh,
        donate=segment.donate, rules=segment.rules,
        platform=segment.device.type)


def segment_fingerprints(segment, donated: dict,
                         dropped: dict) -> tuple[str, str, dict]:
    """Fingerprints for a live :class:`~.compile.FusedSegment` and one
    argument pair (host columns)."""
    key = _segment_key(segment)
    dspec, pspec = column_spec(donated), column_spec(dropped)
    static_fp, full_fp = fingerprints(key, dspec, pspec)
    return static_fp, full_fp, {"static_key": key, "donated": dspec,
                                "dropped": pspec}


def library_key(loader) -> dict:
    """A kernel library's identity: its name, the hash of its sources,
    headers and flags (``CudaLoader.source_hash``), the nvcc version
    and the target arch."""
    from ..native.loader import TARGET_ARCH
    return {"v": STORE_VERSION, "kind": "library", "name": loader.name,
            "sources": loader.source_hash(), "nvcc": nvcc_version(),
            "arch": TARGET_ARCH}


def library_fingerprints(loader) -> tuple[str, str, dict]:
    key = library_key(loader)
    static_fp = _sha({"v": STORE_VERSION, "kind": "library",
                      "name": loader.name})
    return static_fp, _sha(key), key


def _zeros_from_spec(spec: list) -> dict:
    return {c: np.zeros(tuple(shape), np.dtype(dt))
            for c, dt, shape in spec}


# ------------------------------------------------------------- the store
class AotStore:
    """On-disk store, content-addressed by full fingerprint.

    Writes are atomic (tmp dir + ``os.replace``) so a killed build never
    leaves a half-entry a loader could trust; every payload
    (``program.json``, ``lib.so``) carries its sha256 in ``meta.json`` and
    a mismatch is a loud ``corrupt`` miss, never a load."""

    def __init__(self, root: str | None = None):
        self.root = root or store_root()
        self._lock = threading.Lock()
        self._m = _metrics()
        # entry count cache: save/invalidate adjust it incrementally
        # (None = not yet counted)
        self._n_entries: int | None = None

    # -- layout --------------------------------------------------------
    def entry_dir(self, full_fp: str) -> str:
        return os.path.join(self.root, full_fp[:2], full_fp)

    def entries(self) -> list[dict]:
        """Every readable meta.json in the store (unreadable entries
        are skipped — they can only ever be misses anyway)."""
        out = []
        if not os.path.isdir(self.root):
            return out
        for shard in sorted(os.listdir(self.root)):
            sdir = os.path.join(self.root, shard)
            if len(shard) != 2 or not os.path.isdir(sdir):
                continue
            for fp in sorted(os.listdir(sdir)):
                # only finished entries: full fingerprints are 64-hex
                # dir names, so in-flight .tmp-* dirs never read as
                # corrupt entries or count in stats/gc
                if len(fp) != 64 or fp.startswith("."):
                    continue
                meta = self._read_meta(os.path.join(sdir, fp))
                if meta is not None:
                    out.append(meta)
        return out

    def entries_for(self, static_fp: str) -> list[dict]:
        return [m for m in self.entries()
                if m.get("static_fp") == static_fp]

    def _read_meta(self, edir: str) -> dict | None:
        try:
            with open(os.path.join(edir, _META), encoding="utf-8") as f:
                meta = json.load(f)
            meta["_dir"] = edir
            return meta
        except (OSError, ValueError):
            return None

    def _count_entries(self, delta: int | None = None) -> None:
        with self._lock:
            if delta is None or self._n_entries is None:
                self._n_entries = len(self.entries())
                if delta is not None:
                    delta = 0  # recount already includes the change
            self._n_entries = max(self._n_entries + (delta or 0), 0)
            self._m["entries"].set(self._n_entries)

    # -- write ---------------------------------------------------------
    def save(self, *, full_fp: str, static_fp: str, segment_name: str,
             meta_extra: dict, payload: bytes, tier: str = "program"
             ) -> None:
        """Atomically publish one entry: ``payload`` is the bucket's
        ``program.json`` (tier "program") or a library's bytes (tier
        "library")."""
        if tier not in TIERS:
            raise ValueError(f"tier {tier!r} is not one of {TIERS}")
        meta = {
            "store_version": STORE_VERSION,
            "full_fp": full_fp,
            "static_fp": static_fp,
            "segment": segment_name,
            "tier": tier,
            "payload_sha256": hashlib.sha256(payload).hexdigest(),
            "payload_bytes": len(payload),
        }
        meta.update(meta_extra)
        final = self.entry_dir(full_fp)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=os.path.dirname(final),
                               prefix=".tmp-")
        try:
            with open(os.path.join(tmp, _META), "w",
                      encoding="utf-8") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            name = _PROGRAM if tier == "program" else _LIB
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(payload)
            with self._lock:
                existed = os.path.isdir(final)
                if existed:
                    shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
        except Exception:
            # ANY failure must reclaim the tmp dir, or it lingers in the
            # shard forever
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._count_entries(0 if existed else 1)

    def invalidate(self, full_fp: str) -> bool:
        final = self.entry_dir(full_fp)
        with self._lock:
            if not os.path.isdir(final):
                return False
            shutil.rmtree(final, ignore_errors=True)
        self._count_entries(-1)
        return True

    def gc(self, keep_static: set[str] | None = None,
           keep_versions: bool = True,
           keep_model_versions: int | None = None) -> list[str]:
        """Remove stale entries: anything whose static fingerprint is
        not in ``keep_static`` (when given), plus — with
        ``keep_versions`` — anything built against other runtime
        versions than this process would fingerprint (torch, its CUDA,
        nvcc, the arch: those can never match again).

        Deploy-plane protection (``serving/deploy.py``,
        ``registry.json`` beside the tree): an entry a registry version
        in a deploy state (warming/candidate/active/draining) still
        points at is NEVER removed — whatever keep_static says — and
        ``keep_model_versions=N`` (CLI ``gc --keep-versions N``)
        additionally pins the last N registered versions, so a rollback
        target survives every gc that runs mid-deploy. Spared entries
        count in ``aot_gc_kept_versions``."""
        versions = runtime_versions()
        protected = _protected_static_fps(self.root,
                                          keep_model_versions)
        removed, kept = [], 0
        for meta in self.entries():
            stale = False
            if keep_static is not None \
                    and meta.get("static_fp") not in keep_static:
                stale = True
            if keep_versions and meta.get("versions") not in (
                    None, versions):
                stale = True
            if stale and meta.get("static_fp") in protected:
                kept += 1
                continue
            if stale:
                shutil.rmtree(meta["_dir"], ignore_errors=True)
                removed.append(meta["full_fp"])
        if kept:
            self._m["gc_kept"].inc(kept)
            _LOG.info("aot store gc: kept %d entries pinned by the "
                      "deploy registry", kept)
        if removed:
            _LOG.info("aot store gc: removed %d stale entries",
                      len(removed))
        self._count_entries()
        return removed

    # -- read ----------------------------------------------------------
    def _checked_payload(self, meta: dict) -> bytes | None:
        """The payload's bytes iff present AND matching the recorded
        sha256; a mismatch deletes nothing (evidence) but reads as
        corrupt."""
        name = _PROGRAM if meta.get("tier") == "program" else _LIB
        try:
            with open(os.path.join(meta["_dir"], name), "rb") as f:
                blob = f.read()
        except OSError:
            return None
        if hashlib.sha256(blob).hexdigest() != meta.get("payload_sha256"):
            return None
        return blob

    def _miss(self, name: str, reason: str, what: str, exc_info=False):
        self._m["miss"].inc(1, segment=name, reason=reason)
        _LOG.warning("aot store miss (%s) for %s: %s", reason, name, what,
                     exc_info=exc_info)

    def load_entry(self, meta: dict, *, segment=None):
        """One stored segment entry → its checked meta (with the kernel
        libraries it lists loaded), or None with the miss reason
        counted. ``segment`` is the reference's keyword (its retrace
        tier re-lowered the segment); a port entry needs none."""
        name = meta.get("segment", "?")
        blob = self._checked_payload(meta)
        if blob is None:
            self._miss(name, "corrupt",
                       f"entry {meta.get('full_fp', '?')[:12]} has a "
                       "checksum mismatch or an unreadable program.json; "
                       "rebuilding at runtime")
            return None
        try:
            program = json.loads(blob)
            full = fingerprints(program["static_key"], program["donated"],
                                program["dropped"])[1]
        except (ValueError, KeyError, TypeError):
            full = None
        if full != meta.get("full_fp"):
            self._miss(name, "mismatch",
                       f"entry {meta.get('full_fp', '?')[:12]}'s program "
                       "does not hash to its fingerprint; rebuilding at "
                       "runtime")
            return None
        for lib in meta.get("libraries", []):
            self.ensure_library(lib)
        self._m["hit"].inc(1, segment=name, tier="program")
        return meta

    # -- kernel libraries ----------------------------------------------
    def load_library(self, loader, so_path: str) -> bool:
        """Put ``loader``'s library at ``so_path`` from the store. True on
        a hit; False (counted, warned) on an absent, corrupt or
        mismatched entry — the caller then builds with nvcc, and the
        build backfills the store."""
        static_fp, full_fp, key = library_fingerprints(loader)
        name = f"lib:{loader.name}"
        meta = self._read_meta(self.entry_dir(full_fp))
        if meta is None:
            self._miss(name, "absent",
                       "not in the store; building with nvcc and "
                       "backfilling")
            return False
        blob = self._checked_payload(meta)
        if blob is None:
            self._miss(name, "corrupt",
                       f"entry {full_fp[:12]} has a checksum mismatch or "
                       "an unreadable lib.so; rebuilding with nvcc")
            return False
        if meta.get("key") != key or meta.get("tier") != "library":
            self._miss(name, "mismatch",
                       f"entry {full_fp[:12]} was stored for another "
                       "library; rebuilding with nvcc")
            return False
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.store"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._m["hit"].inc(1, segment=name, tier="library")
        return True

    def save_library(self, loader, so_path: str, *,
                     backfill: bool = False) -> str:
        """Store the library at ``so_path`` as ``loader``'s entry; returns
        its full fingerprint."""
        static_fp, full_fp, key = library_fingerprints(loader)
        with open(so_path, "rb") as f:
            blob = f.read()
        try:
            self.save(full_fp=full_fp, static_fp=static_fp,
                      segment_name=f"lib:{loader.name}",
                      meta_extra={"key": key, "library": loader.name,
                                  "versions": runtime_versions(),
                                  "platform": "cuda"},
                      payload=blob, tier="library")
            if backfill:
                self._m["backfill"].inc(1, segment=f"lib:{loader.name}")
        except OSError:
            _LOG.warning("aot store write failed for library %s",
                         loader.name, exc_info=True)
        return full_fp

    def ensure_library(self, name: str) -> None:
        """Load kernel library ``name`` (built, or from this store)."""
        from ..native.loader import CudaLoader
        _import_kernel_modules()
        loader = CudaLoader.registry.get(name)
        if loader is None:
            raise KeyError(f"no kernel library named {name!r}")
        loader.load()

    # -- the segment-facing surface -------------------------------------
    def load_or_compile(self, segment, donated: dict, dropped: dict,
                        *, building: bool = False, _fps=None):
        """The FusedSegment request path: a stored bucket → its meta
        (libraries loaded); a miss → LOUD counter, then build-and-
        backfill so the next fresh process hits. Returns None only for
        segments that cannot be fingerprinted (they keep the runtime
        path). ``building=True`` (the build CLI) treats an absent entry
        as the job, not a miss. ``_fps`` reuses a caller's fingerprints
        (hashing every fitted param array is the expensive part)."""
        try:
            if _fps is None:
                _fps = segment_fingerprints(segment, donated, dropped)
            static_fp, full_fp, specs = _fps
        except Unfingerprintable as e:
            self._miss(segment.name, "unfingerprintable",
                       f"not AOT-eligible: {e}")
            return None
        meta = self._read_meta(self.entry_dir(full_fp))
        if meta is not None:
            entry = self.load_entry(meta, segment=segment)
            if entry is not None:
                return entry
            # corrupt/mismatch miss already counted by load_entry
        elif not building:
            self._miss(segment.name, "absent",
                       f"bucket {[list(v.shape) for v in donated.values()] or [list(v.shape) for v in dropped.values()]} "
                       "is not in the store; running it at runtime and "
                       "backfilling (run the build CLI to cover this "
                       "bucket)")
        return self.build_segment(segment, donated, dropped,
                                  _fps=(static_fp, full_fp, specs),
                                  backfill=not building)

    def build_segment(self, segment, donated: dict, dropped: dict, *,
                      _fps=None, backfill: bool = False) -> dict:
        """Run one segment × bucket once on its device under the cost
        counter, and publish its entry: the program, the cost, and the
        kernel libraries the run loaded (each saved too). The build
        CLI's unit of work; also the miss path's backfill. Returns the
        entry's meta."""
        import time as _time

        from ..native.loader import CudaLoader
        from ..obs.attribution import count_cost, cost_attribution
        from .compile import upload
        if _fps is None:
            static_fp, full_fp, specs = segment_fingerprints(
                segment, donated, dropped)
        else:
            static_fp, full_fp, specs = _fps
        before = set(CudaLoader._loaded)
        t0 = _time.perf_counter()
        d_dev, _ = upload(donated, segment.device)
        p_dev, _ = upload(dropped, segment.device)
        with count_cost() as c:
            segment.call_device(d_dev, p_dev)
        if segment.device.type == "cuda":
            import torch
            torch.cuda.synchronize(segment.device)
        self._m["build"].observe(_time.perf_counter() - t0,
                                 segment=segment.name)
        cost = {"flops": c.flops, "bytes": c.bytes}
        cost_attribution.record_program(
            segment.name, cost["flops"], cost["bytes"],
            service=segment.name.split(":", 1)[0],
            platform=segment.device.type)
        libraries = sorted(set(CudaLoader._loaded) - before)
        for name in libraries:
            loader = CudaLoader.registry[name]
            self.save_library(loader, loader.so_path())
        program = {"static_key": specs["static_key"],
                   "donated": specs["donated"],
                   "dropped": specs["dropped"]}
        meta_extra = {"donated": specs["donated"],
                      "dropped": specs["dropped"],
                      "versions": specs["static_key"]["versions"],
                      "platform": specs["static_key"]["platform"],
                      "stages": [type(s).__name__ for s in segment.stages],
                      "libraries": libraries, "cost": cost}
        try:
            self.save(full_fp=full_fp, static_fp=static_fp,
                      segment_name=segment.name, meta_extra=meta_extra,
                      payload=json.dumps(program, sort_keys=True).encode())
            if backfill:
                self._m["backfill"].inc(1, segment=segment.name)
        except OSError:
            _LOG.warning("aot store write failed for segment %s",
                         segment.name, exc_info=True)
        return {"full_fp": full_fp, "static_fp": static_fp,
                "segment": segment.name, "tier": "program", **meta_extra}

    def warm_segment(self, segment, entries: list | None = None) -> int:
        """Warm every stored bucket of one segment: its libraries load
        from the store, then the bucket runs once on spec-shaped zeros
        through the tracked body (segment bodies are pure by the
        traceable-stage contract, so a zeros call has no side effects),
        so the first request pays neither nvcc nor first-call set-up.
        Returns the buckets now resident. ``entries`` lets a
        multi-segment warm walk the store ONCE and share the listing."""
        from .compile import is_device_error, upload
        try:
            static_fp = _sha(_segment_key(segment))
        except Unfingerprintable:
            return 0
        if entries is None:
            entries = self.entries()
        n = 0
        for meta in entries:
            if meta.get("static_fp") != static_fp:
                continue
            sig = sig_from_spec(meta.get("donated", []),
                                meta.get("dropped", []))
            if segment._exes.get(sig) is not None:
                continue
            entry = self.load_entry(meta, segment=segment)
            if entry is None:
                continue
            try:
                d_dev, _ = upload(_zeros_from_spec(meta.get("donated", [])),
                                  segment.device)
                p_dev, _ = upload(_zeros_from_spec(meta.get("dropped", [])),
                                  segment.device)
                segment.call_device(d_dev, p_dev)
            except Exception as e:
                if is_device_error(e):
                    raise
                _LOG.warning(
                    "aot warm run failed for segment %s; the first "
                    "request will pay the first call", segment.name,
                    exc_info=True)
            segment._exes[sig] = entry
            n += 1
            # re-export the entry's persisted analytic cost: warmed
            # processes report the same roofline gauges the build process did
            cost = meta.get("cost")
            if isinstance(cost, dict):
                from ..obs.attribution import cost_attribution
                cost_attribution.record_program(
                    segment.name,
                    cost.get("flops", 0.0), cost.get("bytes", 0.0),
                    service=segment.name.split(":", 1)[0],
                    platform=meta.get("platform") or None)
        return n

    def stats(self) -> dict:
        entries = self.entries()
        return {
            "root": self.root,
            "entries": len(entries),
            "segments": sorted({m.get("segment", "?")
                                for m in entries}),
            "tiers": {t: sum(1 for m in entries
                             if m.get("tier") == t)
                      for t in TIERS},
        }


# ------------------------------------------------- process-wide activation
_active: AotStore | None = None
_active_lock = threading.Lock()


def install(store: AotStore | str | None = None) -> AotStore:
    """Make a store the process-wide active one: every FusedSegment
    consults it on the first call of a novel bucket, and every kernel
    library missing from the build directory is taken from it."""
    global _active
    with _active_lock:
        if not isinstance(store, AotStore):
            store = AotStore(store)
        _active = store
        return store


def uninstall() -> None:
    global _active
    with _active_lock:
        _active = None


def active_store() -> AotStore | None:
    return _active


# ------------------------------------------------------- kernel libraries
#: the modules whose import makes the port's kernel loaders
KERNEL_MODULES = ("mmlspark_torch.lightgbm.hist",
                  "mmlspark_torch.dl.flash_attention",
                  "mmlspark_torch.dl.paged_attention")


def _import_kernel_modules() -> None:
    import importlib
    for mod in KERNEL_MODULES:
        importlib.import_module(mod)


def kernel_loaders(names=None) -> list:
    """The port's kernel library loaders (``CudaLoader`` over the
    package's ``csrc`` sources), or the loaders named (any made in this
    process)."""
    from ..native.loader import PACKAGE_DIR, CudaLoader
    _import_kernel_modules()
    out = [ld for name, ld in sorted(CudaLoader.registry.items())
           if (name in names if names is not None else
               all(s.startswith(PACKAGE_DIR) for s in ld.sources))]
    if names is not None and len(out) != len(set(names)):
        found = {ld.name for ld in out}
        raise KeyError(f"no kernel libraries named "
                       f"{sorted(set(names) - found)}")
    return out


def build_libraries(store: AotStore, names=None, log=print) -> list[dict]:
    """Build (with nvcc, where the build directory lacks them) and store
    the port's kernel libraries, all or those ``names``. Returns one
    record per library."""
    records = []
    for loader in kernel_loaders(names):
        so = loader.ensure_built()
        fp = store.save_library(loader, so)
        records.append({"library": loader.name, "full_fp": fp,
                        "bytes": os.path.getsize(so)})
        log(f"  [lib] {loader.name} OK {fp[:12]}")
    return records


# ------------------------------------------------------------ warm loading
def _owned_by_us(path: str) -> bool:
    getuid = getattr(os, "getuid", None)
    if getuid is None:  # platforms without uids: nothing to check
        return True
    try:
        return os.stat(path).st_uid == getuid()
    except OSError:
        return False


def _segments_of(obj):
    """Yield every FusedSegment reachable in a transform object: a
    CompiledPipeline, a stage list, or a ``run`` callable that carries
    its ``stages`` (the serving DSL's closures)."""
    from .compile import CompiledPipeline, FusedSegment
    if obj is None:
        return
    if isinstance(obj, FusedSegment):
        yield obj
        return
    if isinstance(obj, CompiledPipeline):
        for item in obj.plan:
            if isinstance(item, FusedSegment):
                yield item
        return
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _segments_of(o)
        return
    stages = getattr(obj, "stages", None)
    if isinstance(stages, (list, tuple)):
        yield from _segments_of(list(stages))


def maybe_warm(obj, service: str = "") -> int:
    """Warm every stored bucket of every fused segment reachable in
    ``obj``. Uses the installed store, or auto-installs one when the
    configured root already exists on disk and belongs to this user (so
    a fresh worker process boots hot with zero code changes once the
    build CLI has run). Returns the buckets warmed; never raises on a
    store fault — a warm failure must not stop a server from starting
    cold — but a CUDA error or a failed kernel build is raised."""
    from .compile import is_device_error
    try:
        store = active_store()
        if store is None:
            root = store_root()
            if not os.path.isdir(root):
                return 0
            if not _owned_by_us(root):
                # the store holds code: auto-trusting a root some OTHER
                # uid controls would run their libraries at boot. An
                # operator who really means it can install() it.
                _LOG.warning(
                    "aot store root %s is not owned by this user; "
                    "refusing to auto-install it (install() it "
                    "explicitly to override)", root)
                return 0
            store = install(AotStore(root))
        n = 0
        listing = None  # one store walk shared by every segment
        for seg in _segments_of(obj):
            if listing is None:
                listing = store.entries()
            n += store.warm_segment(seg, entries=listing)
        if n:
            _LOG.info("aot warm start%s: %d bucket(s) warmed from %s",
                      f" [{service}]" if service else "", n, store.root)
        return n
    except Exception as e:
        if is_device_error(e):
            raise
        _LOG.warning("aot warm start failed; serving will run cold",
                     exc_info=True)
        return 0


# ------------------------------------------------------ build registrations
#: service → builder() -> {"stages": [...], "example": DataFrame,
#: "buckets": (int, ...), "libraries": [names] (optional)}
_BUILDERS: dict[str, callable] = {}
_builders_lock = threading.Lock()


def register_buildable(service: str, builder) -> None:
    """Register a pipeline for the build CLI. ``builder`` is a zero-arg
    callable returning the dict above — called lazily so registration
    at import time stays free."""
    with _builders_lock:
        _BUILDERS[service] = builder


def buildable_services() -> list[str]:
    with _builders_lock:
        return sorted(_BUILDERS)


def _resize_example(df, n: int):
    """Tile/truncate an example frame to ``n`` rows — one padding
    bucket's worth of representative columns."""
    from .dataframe import DataFrame
    data = {}
    for c in df.columns:
        host = np.asarray(df[c])
        reps = -(-n // max(len(host), 1))
        if host.dtype == object:
            tiled = np.concatenate([host] * reps)[:n]
            out = np.empty(n, object)
            out[:] = list(tiled)
            data[c] = out
        else:
            data[c] = np.concatenate([host] * reps, axis=0)[:n]
    return DataFrame(data)


def build_pipeline(cp, example_df, store: AotStore) -> list[dict]:
    """Build every fused segment of one CompiledPipeline for the
    example's bucket, installing the entries in place (the plan is
    executed on the example so downstream segments see the traced
    layout, exactly like compile-time schema propagation)."""
    from .compile import FusedSegment, trace_columns
    records = []
    cur = example_df
    for item in cp.plan:
        if isinstance(item, FusedSegment):
            num = trace_columns(cur)
            donated, dropped = item._split(num)
            try:
                static_fp, full_fp, specs = segment_fingerprints(
                    item, donated, dropped)
                entry = store.load_or_compile(
                    item, donated, dropped, building=True,
                    _fps=(static_fp, full_fp, specs))
                if entry is not None:
                    item._exes[arg_sig(donated, dropped)] = entry
                records.append({
                    "segment": item.name, "static_fp": static_fp,
                    "full_fp": full_fp,
                    "built": entry is not None,
                    "stages": [type(s).__name__ for s in item.stages]})
            except Unfingerprintable as e:
                records.append({"segment": item.name, "built": False,
                                "error": str(e)})
        cur = item.run(cur)
    return records


def _bucket_build_order(service: str, buckets) -> list[int]:
    """Cost-model build planner: order a service's padding buckets by
    predicted traffic value — observed FeatureLog request share × the
    learned model's predicted execute cost
    (``perf.costmodel.bucket_build_priority``) — so an interrupted or
    time-boxed build covers the hot path first. Deterministic ascending
    order when nothing has been learned yet (a fresh process)."""
    try:
        from ..perf.costmodel import bucket_build_priority
        ranked = bucket_build_priority(service, buckets)
    except Exception:
        ranked = []
    if ranked:
        _LOG.info("AOT build order for %r by predicted traffic value: "
                  "%s", service, ranked)
        return ranked
    return sorted({int(x) for x in buckets})


def build_registered(service: str | None = None,
                     store: AotStore | None = None,
                     log=print, device=None) -> dict:
    """The build CLI body: for every registered service × padding
    bucket, build the pipeline's fused segments into the store — most-
    valuable buckets first (:func:`_bucket_build_order`) — and the
    kernel libraries a builder names. ``device``: CUDA unless "cpu"."""
    from .compile import compile_pipeline
    store = store or active_store() or install(AotStore())
    services = [service] if service else buildable_services()
    report = {"root": store.root, "services": {}, "entries": [],
              "libraries": []}
    built_stage_classes: set[str] = set()
    for svc in services:
        with _builders_lock:
            builder = _BUILDERS.get(svc)
        if builder is None:
            raise KeyError(f"no AOT builder registered for {svc!r} "
                           f"(registered: {buildable_services()})")
        spec = builder()
        buckets = tuple(spec.get("buckets") or
                        (len(spec["example"]),))
        svc_records = []
        build_order = _bucket_build_order(svc, buckets)
        for b in build_order:
            example = _resize_example(spec["example"], b)
            cp = compile_pipeline(
                spec["stages"], example, mesh=spec.get("mesh"),
                rules=spec.get("rules"), service=svc, device=device)
            recs = build_pipeline(cp, example, store)
            for r in recs:
                r["bucket"] = b
                built_stage_classes.update(r.get("stages", ()))
                log(f"  [{svc}] bucket={b} {r['segment']} "
                    f"{'OK ' + r['full_fp'][:12] if r.get('built') else 'SKIP ' + r.get('error', '')}")
            svc_records.extend(recs)
        if spec.get("libraries"):
            report["libraries"] += build_libraries(
                store, spec["libraries"], log=log)
        report["services"][svc] = {
            "buckets": sorted(set(int(x) for x in buckets)),
            "build_order": build_order,
            "segments": svc_records}
        report["entries"].extend(svc_records)
    report["coverage"] = _traceable_coverage(built_stage_classes)
    return report


def traceable_stage_classes() -> list[str]:
    """Names of the port's stage classes that carry a traced form (the
    population the store's coverage is counted over; the JAX package
    reads its own from ``analysis/traceability.json``, which comes with
    ROADMAP.md §1 item 11)."""
    import importlib
    from .serialize import _STAGE_REGISTRY
    for mod in ("mmlspark_torch.featurize", "mmlspark_torch.stages",
                "mmlspark_torch.image"):
        importlib.import_module(mod)
    return sorted({cls.__name__ for cls in _STAGE_REGISTRY.values()
                   if getattr(cls, "_trace", None) is not None
                   and cls.__module__.startswith("mmlspark_torch.")})


def _traceable_coverage(built_classes: set[str]) -> dict:
    """AOT coverage of the traceable stage population: how much of it
    the build report covers."""
    traceable = traceable_stage_classes()
    covered = sorted(s for s in traceable if s in built_classes)
    return {"traceable": len(traceable), "covered": len(covered),
            "missing": [s for s in traceable if s not in covered]}


# -------------------------------------------------------------- selftest
_SELFTEST_SERVICE = "__selftest__"


def _selftest_builder() -> dict:
    """A deterministic all-param pipeline (no callables → fully
    fingerprintable) used by the build-then-load round trip. Its fit
    runs on the CPU; the build runs the segments on the CLI's device."""
    from .dataframe import DataFrame
    from ..featurize import CleanMissingData, VectorAssembler
    from ..featurize.vector import OneHotEncoderModel

    n, width = 8, 4
    img = (np.arange(n * width, dtype=np.float32)
           .reshape(n, width) / 7.0)
    aux = np.arange(n, dtype=np.float32)
    aux[::3] = np.nan
    cat = (np.arange(n) % 3).astype(np.int32)
    df = DataFrame({"img": img, "aux": aux, "cat": cat})
    clean = CleanMissingData(inputCols=["aux"], cleaningMode="Mean",
                             device="cpu").fit(df)
    stages = [
        clean,
        OneHotEncoderModel(inputCol="cat", outputCol="onehot",
                           categorySize=3, handleInvalid="keep"),
        VectorAssembler(inputCols=["img", "aux", "onehot"],
                        outputCol="features", handleInvalid="keep"),
    ]
    return {"stages": stages, "example": df, "buckets": (4, 8)}


def register_selftest() -> None:
    register_buildable(_SELFTEST_SERVICE, _selftest_builder)


def _verify(root: str, service: str, device=None) -> int:
    """The load half of the round trip: fresh plan, warm from the store,
    steady-state declared BEFORE the first request — then the run must
    show zero runtime compiles, ≥1 store hit, and output bit-equal to a
    plan run without the store."""
    from .compile import compile_pipeline
    from ..obs.profile import compile_tracker

    if service == _SELFTEST_SERVICE:
        register_selftest()
    with _builders_lock:
        builder = _BUILDERS.get(service)
    if builder is None:
        print(f"verify: no builder registered for {service!r}")
        return 2
    spec = builder()
    store = install(AotStore(root))
    reg = _reg()

    # reference: the runtime path (store NOT consulted)
    uninstall()
    ref_cp = compile_pipeline(spec["stages"], spec["example"],
                              service=service + "-ref", device=device)
    ref = ref_cp.transform(spec["example"])

    install(store)
    before = {k: v for k, v in reg.snapshot().items()
              if k.startswith("aot_store_hit_total")}
    cp = compile_pipeline(spec["stages"], spec["example"],
                          service=service, device=device)
    warmed = maybe_warm(cp, service=service)
    compile_tracker.mark_steady()
    out = cp.transform(spec["example"])
    runtime = compile_tracker.runtime_compiles()
    compile_tracker.unmark_steady()
    ok = True
    if warmed < 1:
        print(f"verify FAIL: warm start loaded {warmed} buckets")
        ok = False
    if runtime:
        print(f"verify FAIL: {runtime} runtime compile(s) after "
              f"steady state: {compile_tracker.runtime_compiled()}")
        ok = False
    for c in ref.columns:
        a, b = np.asarray(ref[c]), np.asarray(out[c])
        if a.shape != b.shape or a.dtype != b.dtype or \
                not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            print(f"verify FAIL: column {c!r} differs from the "
                  "runtime reference")
            ok = False
    hits = sum(v for k, v in reg.snapshot().items()
               if k.startswith("aot_store_hit_total")) - \
        sum(before.values())
    print(f"verify: warmed={warmed} runtime_compiles={runtime} "
          f"hits={hits} columns_equal={ok}")
    return 0 if ok else 1


def _cli(argv=None) -> int:
    import argparse
    import subprocess
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_torch.core.aot",
        description="AOT store: build / list / gc / selftest / verify")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="build registered pipelines (and "
                       "kernel libraries) into the store")
    b.add_argument("--import", dest="imports", action="append",
                   default=[], metavar="MODULE",
                   help="module(s) to import first (they call "
                        "aot.register_buildable)")
    b.add_argument("--service", default=None)
    b.add_argument("--root", default=None)
    b.add_argument("--device", default=None,
                   help="where segments run: cuda (default) or cpu")
    b.add_argument("--libraries", nargs="*", default=None,
                   metavar="NAME",
                   help="also build and store the port's kernel "
                        "libraries (all, or those named)")
    ls = sub.add_parser("list", help="print store entries (and the "
                        "deploy registry's versions, when present)")
    ls.add_argument("--root", default=None)
    g = sub.add_parser("gc", help="drop version-stale entries (and "
                       "anything not matching --keep-static); "
                       "registry versions in a deploy state are "
                       "always spared")
    g.add_argument("--root", default=None)
    g.add_argument("--keep-static", action="append", default=None,
                   metavar="FP")
    g.add_argument("--keep-versions", type=int, default=None,
                   metavar="N",
                   help="additionally pin the last N deploy-registry "
                        "versions' entries (rollback horizon); spared "
                        "entries count in aot_gc_kept_versions")
    st = sub.add_parser("selftest", help="build-then-load round trip "
                        "in two subprocesses")
    st.add_argument("--root", default=None)
    st.add_argument("--device", default=None)
    v = sub.add_parser("verify", help="warm-load a service from the "
                       "store and assert zero runtime compiles")
    v.add_argument("--root", required=True)
    v.add_argument("--service", required=True)
    v.add_argument("--import", dest="imports", action="append",
                   default=[], metavar="MODULE")
    v.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    if args.cmd == "list":
        store = AotStore(args.root)
        entries = store.entries()
        for m in entries:
            print(f"{m['full_fp'][:16]} {m.get('tier', '?'):10s} "
                  f"{m.get('segment', '?')}")
        # deploy registry (serving/deploy.py persists registry.json
        # beside the tree): version names, fingerprints, and per-bucket
        # built/warm state — the operator's pre-flip checklist
        recs = _registry_versions(store.root)
        if recs:
            by_static: dict = {}
            for m in entries:
                by_static.setdefault(m.get("static_fp"), []).append(m)
            print("registry versions:")
            for rec in sorted(recs, key=lambda r: r.get("seq", 0)):
                fps = rec.get("static_fps", [])
                print(f"  {rec['name']:20s} "
                      f"{rec.get('state', '?'):10s} "
                      f"warmed={rec.get('warmed', 0)} "
                      f"fps={','.join(fp[:12] for fp in fps) or '-'}")
                for fp in fps:
                    for m in by_static.get(fp, []):
                        spec = m.get("donated") or []
                        bucket = spec[0][2][0] if spec and \
                            spec[0][2] else "?"
                        print(f"    bucket={bucket:<6} "
                              f"{m.get('tier', '?'):10s} "
                              f"{m['full_fp'][:16]}")
        print(json.dumps(store.stats(), indent=1))
        return 0

    if args.cmd == "gc":
        store = AotStore(args.root)
        keep = set(args.keep_static) if args.keep_static else None
        removed = store.gc(keep_static=keep,
                           keep_model_versions=args.keep_versions)
        print(f"gc: removed {len(removed)} entries; "
              f"{store.stats()['entries']} remain")
        return 0

    if args.cmd == "build":
        import importlib
        for mod in args.imports:
            importlib.import_module(mod)
        if args.service == _SELFTEST_SERVICE or (
                not args.imports and not buildable_services()):
            register_selftest()
        store = AotStore(args.root)
        report = build_registered(args.service, store, device=args.device)
        if args.libraries is not None:
            report["libraries"] += build_libraries(
                store, args.libraries or None)
        cov = report["coverage"]
        print(f"build: {len(report['entries'])} entries and "
              f"{len(report['libraries'])} libraries in {store.root}; "
              f"traceable-stage coverage "
              f"{cov['covered']}/{cov['traceable']}")
        return 0

    if args.cmd == "verify":
        import importlib
        for mod in args.imports:
            importlib.import_module(mod)
        return _verify(args.root, args.service, device=args.device)

    if args.cmd == "selftest":
        root = args.root or tempfile.mkdtemp(
            prefix="mmlspark_torch_aot_selftest_")
        dev = ["--device", args.device] if args.device else []
        rc = subprocess.call(
            [sys.executable, "-m", "mmlspark_torch.core.aot", "build",
             "--service", _SELFTEST_SERVICE, "--root", root, *dev])
        if rc:
            print("selftest FAILED at build")
            return rc
        rc = subprocess.call(
            [sys.executable, "-m", "mmlspark_torch.core.aot", "verify",
             "--service", _SELFTEST_SERVICE, "--root", root, *dev])
        print("selftest " + ("OK" if rc == 0 else "FAILED at verify"))
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
        return rc
    return 2


if __name__ == "__main__":  # pragma: no cover
    # `python -m mmlspark_torch.core.aot` executes this file as
    # ``__main__`` — a SECOND module object with its own _BUILDERS.
    # Delegate to the canonical import so `--import`ed app modules and
    # the CLI share one registry.
    from mmlspark_torch.core.aot import _cli as _canonical_cli
    raise SystemExit(_canonical_cli())
