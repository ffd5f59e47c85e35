"""Offline autotuner for the port's hand-written kernels (the port of
``mmlspark_tpu/perf/autotune.py``, with the same ``__all__``, registry
file, series, environment switch and CLI verbs).

A search in the manner of TVM (arXiv:1802.04799), scoped to the three
kernels whose cut the search can change on an H100:

- K1, the GBDT histogram (``lightgbm/hist.py``, kernel ``"hist"``):
  ``feat_block`` (the plan's ``fb``, features a CTA holds in shared
  memory) × ``block_rows`` (the rows a stage of its ring streams), the
  reference's names for the same two cuts;
- K2's forward, K2a/K2b/K2c/K2c-lse (``dl/flash_attention.py``, kernel
  ``"flash_attention"``): ``block_q`` × ``block_k`` × ``stages``.
  ``block_q`` is always 128, the CTA's two consumer warpgroups of 64 rows
  (a 64-row q tile would be another CTA, work for a performance change,
  not a tile of this one); ``block_k`` (the key tile) and ``stages`` (the
  TMA ring's depth) are template arguments of the kernel, so each choice
  is an instance: the default of each head dim in ``csrc/flash_attn.cu``,
  the others at D = 64 in their own library (``csrc/flash_tuned.cu``).
  Unlike the reference, whose backward takes the forward's blocks, the
  winner applies to the forward alone: K2d/K2e keep their tiles;
- K3's split-KV decode kernel (``dl/paged_attention.py``, kernel
  ``"paged_attn"``): ``chunk`` (the chain positions one CTA reduces, ``L``
  of ``decode_plan``, a multiple of 16) × ``stage_positions`` (the chain
  positions a stage of its ring copies, ``P``, 16 or less). These are the
  port's own names: the reference's ``block_kv`` (score-chunk width inside
  one pool block) and ``slots_tile`` (slots a grid row packs) cut a
  sequential TPU grid that the split-KV design replaced; ``chunk`` is what
  sets the parallel grid here, as ``slots_tile`` did there, and
  ``stage_positions`` the span of one copy, as ``block_kv`` did. The
  chunks are searched as grid targets, ``ctas_per_sm``, which each entry
  also carries: ``paged_key`` holds no slot count, so the wrapper cuts the
  winner's target into a length at each call's own slot count, and
  ``chunk`` records the length it gave at the slot count tuned. Windows
  wider than ``DECODE_MAX_ROWS`` (the window kernel) have no candidate:
  that kernel reads no winner and keeps its plan.

The tuner

- enumerates a DETERMINISTIC candidate grid whose candidate 0 is the
  kernel's untuned plan at that shape, filtered by the kernel's own limits
  (K1's shared-memory room beside its stages, ``Tile``'s 232,448 bytes,
  the decode kernel's ``kSmemMax`` and its combine's 48 KB), so every
  candidate is something the kernel can launch on an H100;
- measures each on the card (CUDA events around one launch after one warm
  launch, L2 flushed before each repetition and the host's launch work
  kept outside the events, best of ``reps``: :func:`device_times`; the
  measure function is injectable so tests feed synthetic timings), or,
  with ``interpret``, the plain partial versions at the candidate's cut on
  the CPU (the counterpart of the reference's interpret mode: the control
  flow end to end, no device timing);
- discards anything that raises or times non-finite or zero — a broken
  config can never become a winner
  (``perf_autotune_discarded_total{reason=error|nonfinite}``);
- persists winners keyed by ``(kernel, shape-bucket, platform)`` to a JSON
  registry under :func:`~.costmodel.perf_root` (or
  ``$MMLSPARK_TPU_TUNE_STORE``) that the kernel wrappers consult at call
  time on the CUDA route (platform ``"cuda"``): a registry there changes
  the tiles of every later process that finds it.

Determinism: same candidate grid + same measured timings → the same
winner file, byte for byte (ties break on candidate order, the file is
written sorted), and the same bytes as the reference's for the same grid
and timings.

The in-process winner table (:func:`kernel_winner`) is a PLAIN dict read
— no lock, no IO, no clock — because the wrappers consult it on every
launch, outside their ``lru_cache``d plan functions, whose arguments the
resolved tiles become (:func:`resolve`): a new winner takes effect at the
next call. :func:`load` populates it (automatically at import when a
registry file exists) and :func:`_search` updates it.

CLI::

    python -m mmlspark_torch.perf.autotune attention --t 512 --d 64
    python -m mmlspark_torch.perf.autotune hist --rows 500000 \\
        --features 28 --bins 256
    python -m mmlspark_torch.perf.autotune paged --context 4096 \\
        --block-len 16 --heads 8 --d 64 --slots 32
    python -m mmlspark_torch.perf.autotune list

Module import is stdlib + numpy + obs/sched only (no torch); the candidate
grids read the kernels' plan functions and the measure functions import
torch, both lazily.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time

from ..obs import registry as _default_registry
from ..sched.policy import bucket_of
from .costmodel import perf_root

_LOG = logging.getLogger("mmlspark_torch.perf")

__all__ = ["registry_path", "attn_key", "hist_key", "paged_key",
           "kernel_winner", "lookup_stats", "clear", "load",
           "maybe_load", "save", "attention_candidates",
           "hist_candidates", "paged_candidates", "tune_attention",
           "tune_hist", "tune_paged_attention"]

REGISTRY_VERSION = 1
#: the platform the kernel wrappers read winners under (the CUDA route)
CUDA = "cuda"
#: SMs of the card the grids are cut for when none is at hand (H100 SXM)
H100_SMS = 132
# overwritten before each timed launch: 20x the 50 MB L2, and ~0.3 ms of
# writes on an H100, behind which the next launch's host work stays hidden
_FLUSH_BYTES = 2 ** 30

# the candidate grids' axes, in order (ties resolve to the earlier entry,
# so the winner file is a pure function of the timings)
_HIST_STAGE_KB = (16, 8, 32)   # bytes a K1 stage streams: default first
_HIST_FB_SPLITS = (1, 2, 4)    # feature blocks of F, F/2, F/4
_PAGED_CTAS_PER_SM = (2, 1, 4)  # the grid the decode chunks aim at


def registry_path() -> str:
    return os.environ.get("MMLSPARK_TPU_TUNE_STORE") or \
        os.path.join(perf_root(), "autotune.json")


def attn_key(T: int, D: int, causal: bool = False) -> str:
    """Shape bucket for attention: sequence length rounded to its
    power-of-two bucket (one winner serves the whole padded bucket,
    mirroring serving's padding discipline), head dim exact."""
    return f"T{bucket_of(int(T))}-D{int(D)}-c{int(bool(causal))}"


def hist_key(n: int, F: int, num_bins: int) -> str:
    return f"n{bucket_of(int(n))}-F{int(F)}-B{int(num_bins)}"


def paged_key(context: int, D: int, w: int = 1) -> str:
    """Shape bucket for paged decode attention: resident context
    (``max_blocks × block_len``) rounded to its power-of-two bucket —
    one winner serves every table size padding into it — head dim and
    verify-window width exact (w=1 plain decode, w=k+1 speculative)."""
    return f"L{bucket_of(int(context))}-D{int(D)}-w{int(w)}"


# ------------------------------------------------- in-process winner table
_WINNERS: dict[str, dict] = {}
_lookup_hits: dict[str, int] = {}
_lookup_misses: dict[str, int] = {}
_refused: set[str] = set()


def kernel_winner(kernel: str, shape_key: str,
                  platform: str) -> dict | None:
    """The call-time consult: a plain dict read. ``None`` = untuned
    shape, the kernel keeps its default tiles. Hit/miss tallies are
    lock-free dict bumps (GIL-atomic)."""
    w = _WINNERS.get(f"{kernel}|{shape_key}|{platform}")
    if w is not None:
        _lookup_hits[kernel] = _lookup_hits.get(kernel, 0) + 1
    else:
        _lookup_misses[kernel] = _lookup_misses.get(kernel, 0) + 1
    return w


def lookup_stats() -> dict:
    return {"hits": dict(_lookup_hits), "misses": dict(_lookup_misses)}


def clear() -> None:
    """Drop the in-process table (tests)."""
    _WINNERS.clear()
    _lookup_hits.clear()
    _lookup_misses.clear()
    _refused.clear()


def _tile(value) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(f"a tile is an int, got {value!r}")
    return value


def resolve(kernel: str, shape_key: str, make, platform: str = CUDA,
            **explicit):
    """A kernel wrapper's tiles for one call: ``make(**tiles)`` with every
    tile the caller gave (not ``None``), the rest from this shape's winner
    on ``platform`` where there is one, else ``None`` (``make``'s default).
    An explicit tile beats a winner and a winner beats the default. A
    winner entry that is corrupt, lacks a tile or does not fit (``make``
    raises ``ValueError``) falls back to the defaults, warned once per
    entry, and never raises; an explicit tile that does not fit raises
    ``make``'s ``ValueError``. One dict read: no IO, no lock, no device
    work."""
    if any(v is None for v in explicit.values()):
        w = kernel_winner(kernel, shape_key, platform)
        if w is not None:
            try:
                return make(**{k: _tile(w[k]) if v is None else v
                               for k, v in explicit.items()})
            except (KeyError, TypeError, ValueError) as e:
                tiles = make(**explicit)  # the caller's own must fit
                entry = f"{kernel}|{shape_key}|{platform}"
                if entry not in _refused:
                    _refused.add(entry)
                    _LOG.warning("autotune winner %s = %r is not a tile "
                                 "of this kernel (%s): default tiles",
                                 entry, w, e)
                return tiles
    return make(**explicit)


def load(path: str | None = None) -> int:
    """Replace the in-process table from a registry file."""
    path = path or registry_path()
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != REGISTRY_VERSION:
        raise ValueError(
            f"autotune registry {path!r} has version "
            f"{payload.get('version')}; expected {REGISTRY_VERSION}")
    winners = {str(k): dict(v)
               for k, v in payload.get("winners", {}).items()}
    _WINNERS.clear()
    _WINNERS.update(winners)
    _refused.clear()
    return len(winners)


def maybe_load() -> int:
    """Best-effort boot load: absent registry → 0 winners, never an
    error (runs at module import so serving boots tuned)."""
    try:
        path = registry_path()
        if os.path.exists(path):
            n = load(path)
            _LOG.info("autotune registry loaded %d winners from %s",
                      n, path)
            return n
    except Exception:
        _LOG.warning("autotune registry load failed", exc_info=True)
    return 0


def save(path: str | None = None) -> str:
    """Persist the in-process table (atomic tmp+replace, sorted keys —
    identical winners produce an identical file)."""
    path = path or registry_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"version": REGISTRY_VERSION,
               "winners": {k: _WINNERS[k] for k in sorted(_WINNERS)}}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------ candidate grids
def attention_candidates(T: int, D: int, *, causal: bool = False,
                         itemsize: int = 2) -> list[dict]:
    """The ``block_q × block_k × stages`` grid for one attention shape
    (D the kernel's head dim): at D = 64 in bf16 every instance the
    forward is built at (``flash_attention.forward_instances``: the
    default first, then ``csrc/flash_tuned.cu``'s, each within ``Tile``'s
    shared memory); any other head dim, f32 (the tight check, one fixed
    tile) and the wide route take their default alone (``block_k`` and
    ``stages`` ``None``: the route's own). ``T`` and ``causal`` choose
    nothing: every instance runs every length."""
    from ..dl import flash_attention as k2
    return [{"block_q": bq, "block_k": bk, "stages": st}
            for bq, bk, st in k2.forward_instances(int(D), int(itemsize))]


def paged_candidates(context: int, block_len: int, heads: int,
                     head_dim: int, *, w: int = 1, slots: int = 4,
                     itemsize: int = 2) -> list[dict]:
    """The ``chunk × stage_positions`` grid of the split-KV decode kernel
    for ``slots`` chains of ``context // block_len`` blocks (head_dim the
    pools'), each chunk searched as the grid target ``ctas_per_sm`` it
    comes from. Candidate 0 is ``decode_plan``'s own (chunks aiming at two
    CTAs per SM, the widest stage that fits 16 KB); then chunks aiming at
    one and four CTAs per SM, each with that stage and half of it; a cut
    an earlier target gave at this slot count is dropped. Every candidate
    passes ``decode_plan``'s checks of the kernel's limits. Windows the
    window kernel takes (w > ``DECODE_MAX_ROWS``) have none: it reads no
    winner."""
    from ..dl import paged_attention as k3
    S, H, w, D = int(slots), int(heads), int(w), int(head_dim)
    if w > k3.DECODE_MAX_ROWS:
        return []
    BL = max(int(block_len), 1)
    MB = max(int(context) // BL, 1)
    plan0 = k3.decode_plan(S, H, w, D, BL, MB, itemsize, H100_SMS)
    seen, out = set(), []
    for per_sm in _PAGED_CTAS_PER_SM:
        for P in (plan0.P, plan0.P // 2):
            try:
                plan = k3.decode_plan(S, H, w, D, BL, MB, itemsize, H100_SMS,
                                      None, P, per_sm)
            except ValueError:
                continue
            cfg = (plan.L, plan.P)
            if cfg not in seen:
                seen.add(cfg)
                out.append({"chunk": plan.L, "stage_positions": plan.P,
                            "ctas_per_sm": per_sm})
    return out


def hist_candidates(n: int, F: int, num_bins: int, *,
                    bin_bytes: int = 1) -> list[dict]:
    """The ``feat_block × block_rows`` grid of K1 for one histogram shape
    (``bin_bytes`` 1 for uint8 bins, 4 for int32). Candidate 0 is
    ``hist_plan``'s own; then feature blocks of F, F/2 and F/4 (where
    shared memory allows them beside the stages, which may force smaller
    blocks) × stages of about 16, 8 and 32 KB, each as the plan cuts it at
    this shape (a stage never outgrows a CTA's rows), duplicates
    dropped."""
    from ..lightgbm import hist as k1
    n, F, B = int(n), int(F), int(num_bins)
    plan0 = k1.hist_plan(n, F, B, bin_bytes, H100_SMS)
    row_bytes = F * bin_bytes + 12
    seen = {(plan0.fb, plan0.stage_rows)}
    out = [{"feat_block": plan0.fb, "block_rows": plan0.stage_rows}]
    for fb in dict.fromkeys((plan0.fb,) + tuple(-(-F // s)
                                                for s in _HIST_FB_SPLITS)):
        for kb in _HIST_STAGE_KB:
            stage = max(16, kb * 1024 // row_bytes // 16 * 16)
            try:
                plan = k1.hist_plan(n, F, B, bin_bytes, H100_SMS, fb, stage)
            except ValueError:
                continue
            cfg = (plan.fb, plan.stage_rows)
            if cfg not in seen:
                seen.add(cfg)
                out.append({"feat_block": plan.fb,
                            "block_rows": plan.stage_rows})
    return out


# ------------------------------------------------------- measurement
def current_platform() -> str:
    """``"cuda"`` where the kernels' CUDA route would run (a CUDA device
    is visible), ``"cpu"`` otherwise: an H100 winner is never read on the
    CPU, and a ``"cpu"`` or ``"tpu"`` entry never on the card."""
    try:
        import torch
    except ImportError:
        return "cpu"
    return CUDA if torch.cuda.is_available() else "cpu"


def _time_best(run, reps: int) -> float:
    """Best-of-``reps`` host ms after one warm-up pass (the interpret
    route: the plain versions on the CPU)."""
    run()
    best = math.inf
    for _ in range(max(int(reps), 1)):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _card():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels are timed on the "
                           "card (interpret=True times the plain partial "
                           "versions on the CPU instead)")
    return torch.device("cuda", torch.cuda.current_device())


def device_times(run, reps: int) -> list[float]:
    """Device ms of ``reps`` launches of ``run`` after one warm launch (the
    kernel's build and first load happen there; a broken config raises
    there), each between its own pair of CUDA events with a 1 GiB buffer
    overwritten before it: inputs come from HBM, not the 50 MB L2, and
    the card is still busy with the overwrite (~0.3 ms on an H100) when
    the launch is queued, so the wrapper's host work before it (0.05-0.15
    ms, more on a loaded host) stays outside the events."""
    import torch
    run()
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=torch.cuda.current_device())
    times = []
    for _ in range(max(int(reps), 1)):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _time_card(run, reps: int) -> float:
    """The best of :func:`device_times` (the reference's rule: the
    minimum is the floor, contention only adds)."""
    return min(device_times(run, reps))


def _generator(dev, seed: int):
    import torch
    return torch.Generator(device=dev).manual_seed(int(seed))


def measure_attention(config: dict, *, T: int, D: int,
                      causal: bool = False, batch: int = 1,
                      heads: int = 1, reps: int = 3, seed: int = 0,
                      interpret: bool | None = None,
                      key_lengths=None) -> float:
    """ms of one forward at the config's tiles on seeded ``[batch, heads,
    T, D]`` inputs: K2a (K2c with ``causal``) in bf16 on the card, or with
    ``interpret`` the plain key-tiled online softmax
    (``blockwise_attention`` over key tiles of ``block_k``) in f32 on the
    CPU. ``key_lengths`` (one count a batch row) masks each row's keys
    from that count on, as a padded batch does, so that the tiles are
    ranked on the traffic they serve; ``None`` masks none. Raises when the
    tiles are not an instance, or the launch fails — the search discards
    such configs."""
    import torch

    from ..dl import flash_attention as k2
    from ..parallel.ring_attention import blockwise_attention

    dev = torch.device("cpu") if interpret else _card()
    dtype = torch.float32 if interpret else torch.bfloat16
    gen = _generator(dev, seed)
    q, k, v = (torch.randn(batch, heads, T, D, generator=gen, device=dev,
                           dtype=dtype) for _ in range(3))
    mask = None
    if key_lengths is not None:
        lens = torch.as_tensor(list(key_lengths), device=dev)
        if lens.shape != (batch,):
            raise ValueError(f"key_lengths holds {lens.numel()} counts for "
                             f"a batch of {batch}")
        mask = torch.arange(T, device=dev)[None, :] < lens[:, None]
    if interpret:
        def run():
            blockwise_attention(q, k, v, block_size=int(config["block_k"]),
                                causal=causal, key_mask=mask)
        return _time_best(run, reps)
    fn = k2.flash_causal_cuda if causal else k2.flash_cuda
    if int(config.get("block_q", k2.BLOCK_Q)) != k2.BLOCK_Q:
        raise ValueError(f"block_q {config['block_q']}: the forward's q "
                         f"tile is {k2.BLOCK_Q}")

    def run():
        fn(q, k, v, mask, block_k=config.get("block_k"),
           stages=config.get("stages"))
    return _time_card(run, reps)


def measure_paged_attention(config: dict, *, context: int,
                            block_len: int, heads: int, head_dim: int,
                            w: int = 1, slots: int = 4, reps: int = 3,
                            seed: int = 0,
                            interpret: bool | None = None) -> float:
    """ms of one decode-kernel launch (and its combine) at the config's
    cut: ``slots`` full chains of ``context // block_len`` pool blocks,
    seeded bf16 inputs on the card; or with ``interpret`` the plain
    versions of its two passes at that cut (``paged_partials_torch``, then
    ``paged_combine_torch``) in f32 on the CPU. Raises when the cut does
    not fit the kernel, or the window is wider than ``DECODE_MAX_ROWS`` —
    the search discards such configs."""
    import torch

    from ..dl import paged_attention as k3

    dev = torch.device("cpu") if interpret else _card()
    dtype = torch.float32 if interpret else torch.bfloat16
    BL = max(int(block_len), 1)
    mb = max(int(context) // BL, 1)
    nb = slots * mb + 1  # + the trash block
    gen = _generator(dev, seed)
    q = torch.randn(slots, heads, w, head_dim, generator=gen, device=dev,
                    dtype=dtype)
    kp, vp = (torch.randn(nb, BL, heads, head_dim, generator=gen,
                          device=dev, dtype=dtype) for _ in range(2))
    rows = (1 + torch.arange(slots * mb, device=dev,
                             dtype=torch.int32)).reshape(slots, mb)
    pos = torch.full((slots,), mb * BL - w, dtype=torch.int32, device=dev)
    chunk, P = int(config["chunk"]), int(config["stage_positions"])
    if interpret:
        plan = k3.decode_plan(slots, heads, w, head_dim, BL, mb,
                              q.element_size(), H100_SMS, chunk, P)
        n_live = (pos.long() + w + plan.L - 1) // plan.L

        def run():
            m, l, acc = k3.paged_partials_torch(q, kp, vp, rows, pos,
                                                plan.L, plan.n_chunks)
            k3.paged_combine_torch(m, l, acc, n_live, dtype)
        return _time_best(run, reps)

    def run():
        k3.paged_decode_cuda(q, kp, vp, rows, pos, chunk=chunk,
                             stage_positions=P)
    return _time_card(run, reps)


def measure_hist(config: dict, *, n: int, F: int, num_bins: int,
                 reps: int = 3, seed: int = 0,
                 interpret: bool | None = None) -> float:
    """ms of one K1 call at the config's tiles on seeded bins (uint8 up to
    256 bins, else int32) and vals (count weights 1, as the engine's row
    mask) on the card; or with ``interpret`` the plain version of its
    first pass at the config's cut (``hist_partials_torch`` over the
    plan's row ranges) and the sum over them, on the CPU."""
    import torch

    from ..lightgbm import hist as k1

    dev = torch.device("cpu") if interpret else _card()
    gen = _generator(dev, seed)
    bins = torch.randint(0, num_bins, (n, F), generator=gen, device=dev,
                         dtype=torch.uint8 if num_bins <= 256
                         else torch.int32)
    vals = torch.randn(n, 3, generator=gen, device=dev)
    vals[:, 2] = 1.0
    fb, br = int(config["feat_block"]), int(config["block_rows"])
    if interpret:
        plan = k1.hist_plan(n, F, num_bins, bins.element_size(), H100_SMS,
                            fb, br)

        def run():
            k1.hist_partials_torch(bins, vals, num_bins=num_bins,
                                   rows_per_cta=plan.rows_per_cta).sum(0)
        return _time_best(run, reps)

    def run():
        k1.hist_cuda(bins, vals, num_bins=num_bins, feat_block=fb,
                     block_rows=br)
    return _time_card(run, reps)


# ----------------------------------------------------------- the search
def _search(kernel: str, shape_key: str, candidates: list[dict],
            measure, *, platform: str, registry=None,
            persist: bool = True, path: str | None = None) -> dict:
    """Measure every candidate, keep the fastest VALID one, persist it.
    A config that raises (a build or launch failure) or times
    non-finite/zero is discarded and can never be persisted as a winner;
    ties break on candidate order so the registry is a pure function of
    the timings."""
    reg = registry if registry is not None else _default_registry
    c_trials = reg.counter(
        "perf_autotune_trials_total",
        "autotuner configs measured, by kernel")
    c_disc = reg.counter(
        "perf_autotune_discarded_total",
        "autotuner configs discarded, by kernel/reason "
        "(error | nonfinite)")
    c_win = reg.counter(
        "perf_autotune_winners_total",
        "winner entries recorded, by kernel")
    valid: list[tuple[float, int, dict]] = []
    trials = []
    for i, cfg in enumerate(candidates):
        c_trials.inc(1, kernel=kernel)
        try:
            ms = float(measure(cfg))
        except Exception as e:
            _LOG.warning("autotune %s %s: config %s DISCARDED "
                         "(failed: %s)", kernel, shape_key, cfg, e)
            c_disc.inc(1, kernel=kernel, reason="error")
            trials.append({**cfg, "ms": None, "discarded": "error"})
            continue
        if not math.isfinite(ms) or ms <= 0:
            _LOG.warning("autotune %s %s: config %s DISCARDED "
                         "(non-finite timing %r)", kernel, shape_key,
                         cfg, ms)
            c_disc.inc(1, kernel=kernel, reason="nonfinite")
            trials.append({**cfg, "ms": None, "discarded": "nonfinite"})
            continue
        trials.append({**cfg, "ms": round(ms, 4)})
        valid.append((ms, i, cfg))
    record = {"kernel": kernel, "key": shape_key, "platform": platform,
              "trials": trials, "candidates": len(candidates),
              "valid": len(valid), "winner": None}
    if not valid:
        _LOG.warning("autotune %s %s: NO valid config — nothing "
                     "persisted, kernel keeps its defaults",
                     kernel, shape_key)
        return record
    ms, _, cfg = min(valid, key=lambda r: (r[0], r[1]))
    entry = dict(cfg)
    entry["ms"] = round(ms, 4)
    _WINNERS[f"{kernel}|{shape_key}|{platform}"] = entry
    _refused.discard(f"{kernel}|{shape_key}|{platform}")
    c_win.inc(1, kernel=kernel)
    record["winner"] = entry
    if persist:
        record["path"] = save(path)
    return record


def _platform(platform, interpret) -> str:
    return platform or ("cpu" if interpret else current_platform())


def tune_attention(T: int, D: int, *, causal: bool = False,
                   batch: int = 1, heads: int = 1, reps: int = 3,
                   seed: int = 0, platform: str | None = None,
                   measure=None, interpret: bool | None = None,
                   persist: bool = True, path: str | None = None,
                   registry=None, key_lengths=None) -> dict:
    """The forward's search at one shape; ``key_lengths`` as
    :func:`measure_attention` (the reference's signature, plus it)."""
    platform = _platform(platform, interpret)
    cands = attention_candidates(T, D, causal=causal)
    meas = measure or (lambda cfg: measure_attention(
        cfg, T=T, D=D, causal=causal, batch=batch, heads=heads,
        reps=reps, seed=seed, interpret=interpret,
        key_lengths=key_lengths))
    return _search("flash_attention", attn_key(T, D, causal), cands,
                   meas, platform=platform, registry=registry,
                   persist=persist, path=path)


def tune_paged_attention(context: int, block_len: int, heads: int,
                         head_dim: int, *, w: int = 1, slots: int = 4,
                         reps: int = 3, seed: int = 0,
                         platform: str | None = None, measure=None,
                         interpret: bool | None = None,
                         persist: bool = True, path: str | None = None,
                         registry=None) -> dict:
    platform = _platform(platform, interpret)
    cands = paged_candidates(context, block_len, heads, head_dim, w=w,
                             slots=slots, itemsize=4 if interpret else 2)
    meas = measure or (lambda cfg: measure_paged_attention(
        cfg, context=context, block_len=block_len, heads=heads,
        head_dim=head_dim, w=w, slots=slots, reps=reps, seed=seed,
        interpret=interpret))
    return _search("paged_attn", paged_key(context, head_dim, w),
                   cands, meas, platform=platform, registry=registry,
                   persist=persist, path=path)


def tune_hist(n: int, F: int, num_bins: int, *, reps: int = 3,
              seed: int = 0, platform: str | None = None,
              measure=None, interpret: bool | None = None,
              persist: bool = True, path: str | None = None,
              registry=None) -> dict:
    platform = _platform(platform, interpret)
    cands = hist_candidates(n, F, num_bins,
                            bin_bytes=1 if num_bins <= 256 else 4)
    meas = measure or (lambda cfg: measure_hist(
        cfg, n=n, F=F, num_bins=num_bins, reps=reps, seed=seed,
        interpret=interpret))
    return _search("hist", hist_key(n, F, num_bins), cands, meas,
                   platform=platform, registry=registry,
                   persist=persist, path=path)


# ------------------------------------------------------------------- CLI
def _cli(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mmlspark_torch.perf.autotune",
        description="Offline kernel autotuner: measure tile configs on "
                    "the card, persist winners the kernel wrappers load "
                    "at call time")
    sub = ap.add_subparsers(dest="cmd", required=True)
    at = sub.add_parser("attention", help="tune flash-attention tiles")
    at.add_argument("--t", type=int, required=True)
    at.add_argument("--d", type=int, required=True)
    at.add_argument("--causal", action="store_true")
    at.add_argument("--batch", type=int, default=1)
    at.add_argument("--heads", type=int, default=1)
    hi = sub.add_parser("hist", help="tune GBDT-histogram tiles")
    hi.add_argument("--rows", type=int, required=True)
    hi.add_argument("--features", type=int, required=True)
    hi.add_argument("--bins", type=int, required=True)
    pg = sub.add_parser("paged",
                        help="tune paged-decode-attention tiles")
    pg.add_argument("--context", type=int, required=True)
    pg.add_argument("--block-len", type=int, required=True)
    pg.add_argument("--heads", type=int, required=True)
    pg.add_argument("--d", type=int, required=True)
    pg.add_argument("--w", type=int, default=1,
                    help="query window width (1 = plain decode, "
                         "k+1 = speculative verify)")
    pg.add_argument("--slots", type=int, default=4)
    for p in (at, hi, pg):
        p.add_argument("--reps", type=int, default=3)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--path", default=None,
                       help="registry file (default: "
                            "$MMLSPARK_TPU_TUNE_STORE or the per-user "
                            "perf root)")
        p.add_argument("--interpret", action="store_true",
                       help="time the plain partial versions at each "
                            "candidate's cut on the CPU (a check of the "
                            "search end to end; timings are NOT device "
                            "times, and are filed under platform cpu)")
    ls = sub.add_parser("list", help="print registry winners")
    ls.add_argument("--path", default=None)
    args = ap.parse_args(argv)

    if args.cmd == "list":
        path = args.path or registry_path()
        if os.path.exists(path):
            load(path)
        for key in sorted(_WINNERS):
            print(f"{key}: {json.dumps(_WINNERS[key], sort_keys=True)}")
        print(f"{len(_WINNERS)} winner(s) in {path}")
        return 0

    path = args.path or registry_path()
    if os.path.exists(path):
        load(path)  # accumulate into the existing registry
    interp = True if args.interpret else None
    if args.cmd == "attention":
        rec = tune_attention(args.t, args.d, causal=args.causal,
                             batch=args.batch, heads=args.heads,
                             reps=args.reps, seed=args.seed,
                             interpret=interp, path=path)
    elif args.cmd == "paged":
        rec = tune_paged_attention(args.context, args.block_len,
                                   args.heads, args.d, w=args.w,
                                   slots=args.slots, reps=args.reps,
                                   seed=args.seed, interpret=interp,
                                   path=path)
    else:
        rec = tune_hist(args.rows, args.features, args.bins,
                        reps=args.reps, seed=args.seed,
                        interpret=interp, path=path)
    print(json.dumps({k: v for k, v in rec.items() if k != "trials"},
                     indent=1, sort_keys=True))
    for t in rec["trials"]:
        print(f"  {t}")
    return 0 if rec["winner"] is not None else 1


# boot-time load: a registry built by the offline CLI is live for every
# kernel call in this process without any wiring
maybe_load()


if __name__ == "__main__":  # pragma: no cover
    import sys as _sys
    # `-m` executes this file as __main__ (a second module object);
    # delegate to the canonical import so the CLI and any library code
    # in-process share one winner table.
    from mmlspark_torch.perf.autotune import _cli as _canonical_cli
    _sys.exit(_canonical_cli())
