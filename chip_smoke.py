#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the checkout's sources (one
nvcc per source, all started together), then:

1. prints the build times, each kernel's ptxas lines, and the card
   (``nvidia-smi`` name, power limit);
2. holds K1 (``hist_cuda``) against ``hist_torch`` at the main path's
   shapes: the root histogram, a masked one (~30 % of rows) and a
   ``count < n`` one whose rows past ``count`` are padding, and times both
   beside ``index_add_`` alone and the bandwidth bound;
3. fits ``LightGBMClassifier`` (500,000 x 28, Higgs-shaped as in
   ``bench.py``'s GBDT workload; 31 leaves, 255 bins, 20 iterations) on the
   card through K1, transforms, and scores AUC with
   ``ComputeModelStatistics``, counting K1 launches in the fit;
4. fits again with the plain histogram on the card and holds the two fits
   together;
5. holds K2a (``flash_cuda``) against ``flash_torch`` at the text path's
   attention shape (B=32, H=8, T=2048, D=64, bf16, q/k/v as views of one
   fused projection, the key mask of the seeded documents plus one fully
   masked row, which must come out exactly 0), at a ragged T=2000 in f32,
   and at a ragged T=300 at head dims 32, 64 and 128 in both dtypes;
   times the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick only) beside
   the bound;
6. runs the text path at full width: 32 seeded documents of 1,024-2,048
   words → ``TokenIdEncoder(maxLength=2048, vocabSize=32768)`` →
   ``TextEncoderFeaturizer(attentionImpl="pallas")`` over a seeded
   ``TextEncoder(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)``
   (``bench.py``'s long-context encoder shape), counting K2a launches per
   transform, then the same transform with ``attentionImpl="dense"``, and
   holds the two sets of pooled embeddings together; the same encoder run
   through K2a with the key mask dropped (a planted fault) must fail that
   comparison.

Any failed build, launch or comparison exits non-zero. The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
``--rows``/``--iterations``/``--docs`` shrink the run for a quick first
check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

F32_EPS = float(np.finfo(np.float32).eps)
# grad/hess channels: two f32 summation orders of the same m terms differ by
# at most ~m·eps·Σ|x| in the worst case and ~sqrt(m)·eps·Σ|x| typically;
# 64·eps·Σ|x| per cell covers the typical case for m up to ~4000 rows per
# cell with room to spare. The count channel sums 0/1 weights and must match
# exactly.
SUM_TOL_EPS = 64
H100_BUS_BITS = 5120          # HBM3 interface of the H100 (NVIDIA data sheet)
F32_PEAK_FLOPS = 67e12        # H100 SXM, non-tensor-core f32 (data sheet)
FIT_RUNS = 3                  # warm fits timed in phase 3 (median reported)
BF16_PEAK_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores (data sheet)
BF16_EPS = 2.0 ** -7          # bf16 spacing at 1 (8 significand bits)
# K2a in bf16 against its plain version: both round the f32 result to bf16
# once, after summing in two different orders (the kernel's key tiles and
# mma.sync, the plain version's one dense product), and round the
# unnormalised p to bf16 against different running maxima; so outputs may
# differ by one bf16 ulp (2^-7 relative, taken twice for margin) plus a
# small absolute term for outputs near 0 whose p roundings do not cancel.
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2 * BF16_EPS, 4e-3
# f32: the same arithmetic in two summation orders over <= 2048 keys
FLASH_F32_ATOL = 2e-5
# the text path: pallas against dense pooled embeddings after 8 bf16
# blocks (the attention outputs differ by bf16 roundings, see above, and
# the residual stream carries them through every later block). The
# sinusoidal positions add a part common to every row that no attention
# fault moves, so the cosine is also taken after subtracting the dense
# rows' mean; a planted fault (K2a with the key mask dropped) must fail
# these limits.
POOLED_COS_FLOOR = 0.99999
POOLED_CENTRED_COS_FLOOR = 0.9999
POOLED_MAX_ABS = 5e-3
TEXT_SHAPE = dict(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)
TEXT_T = 2048
TRANSFORM_RUNS = 3            # warm transforms timed in phase 6 (median)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def higgs_like(rows: int):
    """bench.py's GBDT workload: 28 normal features, labels from a margin
    with an interaction term plus noise (seed 7)."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(rows, 28)).astype(np.float32)
    margin = feats[:, :4].sum(1) + feats[:, 4] * feats[:, 5]
    labels = (margin + rng.normal(size=rows) > 0).astype(np.float32)
    return feats, labels


def time_ms(fn, torch, *, runs: int = 25, warmup: int = 3,
            flush=None) -> float:
    """Median device time of ``fn`` over ``runs`` launches, each between
    its own pair of CUDA events, after ``warmup`` calls. ``flush`` (a large
    tensor) is overwritten before each run so inputs come from HBM, not
    from the 50 MB L2."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def memory_bandwidth(torch) -> tuple[float, str]:
    """Peak device-memory bytes/s: 2 transfers per memory clock times the
    bus width. The clock and width come from the device properties where
    PyTorch exposes them, else the clock from nvidia-smi and the H100's
    5120-bit bus."""
    prop = torch.cuda.get_device_properties(0)
    clock_khz = getattr(prop, "memory_clock_rate", None)
    bus = getattr(prop, "memory_bus_width", None)
    if clock_khz and bus:
        return 2 * clock_khz * 1e3 * bus / 8, \
            f"device properties: {clock_khz / 1e3:.0f} MHz x {bus} bit"
    mhz = float(nvidia_smi("clocks.max.memory", units=False))
    return 2 * mhz * 1e6 * H100_BUS_BITS / 8, \
        f"nvidia-smi clocks.max.memory {mhz:.0f} MHz x {H100_BUS_BITS} bit"


def check_hist(torch, k1, name, bins, vals, B, count=None):
    """Hold hist_cuda against hist_torch on one input; returns the largest
    grad/hess difference."""
    want = k1.hist_torch(bins, vals, num_bins=B, count=count)
    got = k1.hist_cuda(bins, vals, num_bins=B, count=count)
    scale = k1.hist_torch(bins, vals.abs(), num_bins=B, count=count)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"K1 {name}: non-finite output")
    if not torch.equal(got[..., 2], want[..., 2]):
        fail(f"K1 {name}: count channel differs from the plain version "
             f"(max |diff| {(got[..., 2] - want[..., 2]).abs().max():.6g})")
    diff = (got[..., :2] - want[..., :2]).abs()
    limit = SUM_TOL_EPS * F32_EPS * scale[..., :2]
    if (diff > limit).any():
        worst = int(torch.argmax(diff - limit))
        fail(f"K1 {name}: grad/hess outside {SUM_TOL_EPS}*eps*sum|x| "
             f"(worst flat cell {worst}: |diff| "
             f"{diff.reshape(-1)[worst]:.6g} > {limit.reshape(-1)[worst]:.6g})")
    err = float(diff.max())
    print(f"K1 {name}: count exact, grad/hess max |diff| {err:.3g} "
          f"(limit {SUM_TOL_EPS}*eps*sum|x| per cell)")
    return err


def build_all(builders: dict) -> dict:
    """Run every kernel's build at once (each is one nvcc process);
    returns ``{name: (seconds, nvcc output)}``. A failed build fails."""
    def timed(fn):
        t0 = time.perf_counter()
        log = fn()
        return time.perf_counter() - t0, log

    with ThreadPoolExecutor(len(builders)) as ex:
        futures = {name: ex.submit(timed, fn) for name, fn in builders.items()}
        out = {}
        for name, fut in futures.items():
            try:
                out[name] = fut.result()
            except RuntimeError as e:
                fail(f"building {name}: {e}")
        return out


def make_documents(n: int, seed: int = 5):
    """``n`` documents of words drawn from a seeded made-up vocabulary of
    20,000 lowercase words; word counts spread over 1,024-2,048, the first
    exactly 2,048. Returns the texts and the word counts (each word is one
    token for ``TokenIdEncoder``'s ``\\W+`` split)."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, size=rng.integers(2, 10)))
                      for _ in range(20_000)], dtype=object)
    lengths = rng.integers(1024, TEXT_T + 1, size=n)
    lengths[0] = TEXT_T
    texts = np.array([" ".join(vocab[rng.integers(0, len(vocab), size=m)])
                      for m in lengths], dtype=object)
    return texts, lengths


def check_flash(torch, k2, name, q, k, v, mask, rtol, atol):
    """Hold flash_cuda against flash_torch on one input; rows whose mask is
    all False must be exactly 0. Returns the largest |difference|."""
    want = k2.flash_torch(q, k, v, mask)
    got = k2.flash_cuda(q, k, v, mask)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"K2a {name}: {got.dtype} {tuple(got.shape)} vs plain "
             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"K2a {name}: non-finite output")
    empty = ~mask.any(1)
    if not (got[empty] == 0).all():
        fail(f"K2a {name}: a fully masked row is not exactly 0")
    diff = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if (diff > limit).any():
        worst = int(torch.argmax(diff - limit))
        fail(f"K2a {name}: outside atol {atol:g} + rtol {rtol:g} (worst flat "
             f"element {worst}: |diff| {diff.reshape(-1)[worst]:.6g} > "
             f"{limit.reshape(-1)[worst]:.6g})")
    err = float(diff.max())
    print(f"K2a {name}: max |diff| {err:.3g} (atol {atol:g}, rtol {rtol:g}); "
          f"{int(empty.sum())} fully masked row(s) exactly 0")
    return err


def text_phases(torch, k1, k2, dev, bw, flush, n_docs):
    """Phases 5 and 6: K2a against its plain version, then the text path at
    full width. Returns K2a's record for the kernels line."""
    import torch.nn.functional as F
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.featurize import TokenIdEncoder
    from mmlspark_torch.models import LoadedModel, register_text_encoder

    texts, lengths = make_documents(n_docs)
    B, T = n_docs, TEXT_T
    H, W = TEXT_SHAPE["heads"], TEXT_SHAPE["width"]
    D = W // H

    # ---- phase 5: K2a against the plain version at the path's shapes
    mask_np = np.arange(T)[None, :] < lengths[:, None]
    mask_np[-1] = False                           # one fully masked row
    mask = torch.from_numpy(mask_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    qkv = torch.randn(B, T, 3 * W, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    # the encoder's layout: views of one fused projection, no copies
    q, k, v = (a.view(B, T, H, D).transpose(1, 2)
               for a in qkv.split(W, dim=-1))
    max_err = check_flash(torch, k2, f"bf16 B={B} H={H} T={T} D={D}",
                          q, k, v, mask, FLASH_BF16_RTOL, FLASH_BF16_ATOL)
    Bf, Tf = min(B, 8), 2000
    qf, kf, vf = (torch.randn(Bf, H, Tf, D, generator=gen, device=dev)
                  for _ in range(3))
    mask_f = mask[:Bf, :Tf].clone()
    mask_f[0] = False
    check_flash(torch, k2, f"f32 ragged B={Bf} H={H} T={Tf} D={D}",
                qf, kf, vf, mask_f, 0.0, FLASH_F32_ATOL)
    del qf, kf, vf
    for d in (32, 64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            x = [torch.randn(2, 4, 300, d, generator=gen, device=dev,
                             dtype=dtype) for _ in range(3)]
            bf16 = dtype == torch.bfloat16
            check_flash(torch, k2, f"{str(dtype)[6:]} B=2 H=4 T=300 D={d}",
                        *x, mask_f[:2, :300],
                        FLASH_BF16_RTOL if bf16 else 0.0,
                        FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL)

    ms = time_ms(lambda: k2.flash_cuda(q, k, v, mask), torch, flush=flush)
    plain_ms = time_ms(lambda: k2.flash_torch(q, k, v, mask), torch,
                       runs=10, flush=flush)
    sdpa_mask = mask[:, None, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask), torch, flush=flush)
    # the work this mask needs: every query row against the valid keys of
    # its document (the kernel skips key tiles with no valid key)
    valid = int(mask.sum())
    ops = 4 * H * D * T * valid
    bytes_moved = 2 * (2 * B * H * T * D + 2 * H * D * valid) + B * T
    bound_ops_ms = ops / BF16_PEAK_FLOPS * 1e3
    bound_bytes_ms = bytes_moved / bw * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    print(f"phase 5: K2a {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.1f} GFLOP over "
          f"{valid} valid keys at 989 TFLOP/s; {bytes_moved / 1e6:.1f} MB); "
          f"median of CUDA-event runs, L2 flushed")
    del q, k, v, qkv

    # ---- phase 6: raw text → token ids → pooled embeddings at full width
    df = DataFrame({"text": texts})
    t0 = time.perf_counter()
    ids = TokenIdEncoder(maxLength=T, vocabSize=TEXT_SHAPE["vocab"]) \
        .transform(df)
    tokenize_s = time.perf_counter() - t0
    tokens = int((ids["tokens"] != 0).sum())
    if not np.array_equal((ids["tokens"] != 0).sum(1), lengths):
        fail("TokenIdEncoder's non-pad counts differ from the word counts")
    schema = register_text_encoder("TextEncoderLong", seq_len=T,
                                   **TEXT_SHAPE)
    t0 = time.perf_counter()
    loaded = LoadedModel(schema, schema.builder(
        generator=torch.Generator().manual_seed(0)))
    init_s = time.perf_counter() - t0
    kw = dict(vocabSize=TEXT_SHAPE["vocab"], width=W,
              depth=TEXT_SHAPE["depth"], heads=H, model=loaded)
    stage = TextEncoderFeaturizer(attentionImpl="pallas", **kw)
    stage.transform(ids)                          # warm-up
    torch.cuda.synchronize()
    times, counts = [], []
    for _ in range(TRANSFORM_RUNS):
        k1.hist_cuda.launches = k2.flash_cuda.launches = 0
        t0 = time.perf_counter()
        out = stage.transform(ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append((k2.flash_cuda.launches, k1.hist_cuda.launches))
    transform_s = float(np.median(times))
    launches = counts[-1][0]
    if any(c != (TEXT_SHAPE["depth"], 0) for c in counts):
        fail(f"(K2a, K1) launches per transform {counts}: expected "
             f"({TEXT_SHAPE['depth']}, 0), one K2a launch per block")
    pooled = out["features"]
    if pooled.shape != (B, W) or pooled.dtype != np.float32 \
            or not np.isfinite(pooled).all():
        fail(f"pooled embeddings {pooled.dtype} {pooled.shape}, "
             f"{(~np.isfinite(pooled)).sum()} non-finite")
    print(f"phase 6: tokenized {B} documents ({tokens} tokens) on the host "
          f"in {tokenize_s:.3f} s; seeded encoder init {init_s:.2f} s; warm "
          f"transform {transform_s:.4f} s, median of {TRANSFORM_RUNS} "
          f"({', '.join(f'{t:.4f}' for t in times)} s): "
          f"{B / transform_s:.2f} seqs/s, {tokens / transform_s:,.0f} "
          f"non-pad tokens/s; K2a launches per transform {launches}")

    k2.flash_cuda.launches = 0
    dense = TextEncoderFeaturizer(attentionImpl="dense", **kw) \
        .transform(ids)["features"]
    if k2.flash_cuda.launches != 0:
        fail("the dense transform launched K2a")

    def agreement(name, got):
        """Per-row cosine (raw and centred on the dense rows' mean) and
        max |diff| of ``got`` against the dense embeddings; True when all
        three are within the limits."""
        def min_cos(a, b):
            return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                            * np.linalg.norm(b, axis=1))
                          ).min())
        centre = dense.mean(0)
        cos = min_cos(got, dense)
        ccos = min_cos(got - centre, dense - centre)
        delta = float(np.abs(got - dense).max())
        ok = (cos >= POOLED_COS_FLOOR and ccos >= POOLED_CENTRED_COS_FLOOR
              and delta <= POOLED_MAX_ABS)
        print(f"phase 6: {name} vs dense pooled embeddings: per-row cosine "
              f"min {cos:.7f} (floor {POOLED_COS_FLOOR}), centred "
              f"{ccos:.7f} (floor {POOLED_CENTRED_COS_FLOOR}), max |diff| "
              f"{delta:.4g} (limit {POOLED_MAX_ABS}): "
              f"{'within' if ok else 'outside'} the limits")
        return ok

    print(f"phase 6: dense pooled |x| median {np.median(np.abs(dense)):.4g}, "
          f"max {np.abs(dense).max():.4g}; centred on the rows' mean, median "
          f"{np.median(np.abs(dense - dense.mean(0))):.4g}")
    if not agreement("pallas", pooled):
        fail("pallas and dense pooled embeddings disagree beyond the "
             "stated tolerance")
    # a planted fault: K2a with the key mask dropped must fail the limits
    no_mask = loaded.module.with_attention(
        lambda q, k, v, key_mask=None: k2.flash_cuda(q, k, v, None))
    with torch.inference_mode():
        faulty = no_mask.to(dev).eval()(torch.from_numpy(
            np.asarray(ids["tokens"])).to(dev))["pooled"].float().cpu().numpy()
    del no_mask
    if agreement("planted fault (key mask dropped)", faulty):
        fail("the pooled-embedding limits pass K2a with the key mask "
             "dropped: they cannot tell a faulty attention")
    return {"name": "flash", "route": "cuda",
            "source": "mmlspark_torch/dl/csrc/flash_attn.cu",
            "replaces": "mmlspark_tpu/dl/pallas_attention.py:77",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--docs", type=int, default=32)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    try:
        import mmlspark_torch.dl.flash_attention as k2
        import mmlspark_torch.lightgbm.hist as k1
        from mmlspark_torch.core import DataFrame
        from mmlspark_torch.lightgbm import LightGBMClassifier
        from mmlspark_torch.lightgbm.binning import (bin_features,
                                                     compute_bin_boundaries)
        from mmlspark_torch.train import ComputeModelStatistics
    except ImportError as e:
        fail(f"cannot import mmlspark_torch ({e}): run from the root of a "
             "checkout")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi("name,power.limit")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- phase 1: build every kernel of the paths, one nvcc each, at once
    t0 = time.perf_counter()
    builds = build_all({"K1 (lightgbm/csrc/hist.cu)": k1.build_kernel,
                        "K2a (dl/csrc/flash_attn.cu)": k2.build_kernel})
    print(f"phase 1: built every kernel (sm_90a) in "
          f"{time.perf_counter() - t0:.2f} s, in parallel")
    for name, (secs, log) in builds.items():
        print(f"  {name}: {secs:.2f} s")
        for line in log.splitlines():
            if "ptxas" in line or "error" in line.lower():
                print(f"    {line.strip()}")
    print(card)
    bw, bw_src = memory_bandwidth(torch)
    print(f"memory bandwidth {bw / 1e12:.3f} TB/s ({bw_src})")

    n, F, B, iters = args.rows, 28, 256, args.iterations
    feats, labels = higgs_like(n)

    # ---- phase 2: K1 against the plain version at the main path's shapes
    bounds = compute_bin_boundaries(feats, 255)
    bins = bin_features(torch.from_numpy(feats).to(dev),
                        torch.from_numpy(bounds))
    y = torch.from_numpy(labels).to(dev)
    p0 = float(labels.mean())
    g = torch.full((n,), p0, device=dev) - y      # grad at the average init
    h = torch.full((n,), p0 * (1 - p0), device=dev)
    root_vals = torch.stack([g, h, torch.ones(n, device=dev)], 1)
    sel_np = np.random.default_rng(11).random(n) < 0.3
    sel = torch.from_numpy(sel_np.astype(np.float32)).to(dev)
    masked_vals = root_vals * sel[:, None]
    count = (2 * n) // 3
    padded_vals = root_vals.clone()
    padded_vals[count:] = 0.0                     # rows past count: padding
    count_dev = torch.tensor(count, dtype=torch.int32, device=dev)
    max_err = max(
        check_hist(torch, k1, "root", bins, root_vals, B),
        check_hist(torch, k1, "masked 30%", bins, masked_vals, B),
        check_hist(torch, k1, f"count={count}", bins, padded_vals, B,
                   count=count_dev),
        check_hist(torch, k1, "root, int32 bins", bins.to(torch.int32),
                   root_vals, B))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: k1.hist_cuda(bins, root_vals, num_bins=B),
                 torch, flush=flush)
    ms_masked = time_ms(lambda: k1.hist_cuda(bins, masked_vals,
                                               num_bins=B),
                        torch, flush=flush)
    plain_ms = time_ms(lambda: k1.hist_torch(bins, root_vals, num_bins=B),
                       torch, flush=flush)
    keys = (bins.to(torch.int64)
            + torch.arange(F, device=dev, dtype=torch.int64)[None, :] * B
            ).reshape(-1)
    src = root_vals[:, None, :].expand(n, F, 3).reshape(n * F, 3)
    acc = torch.zeros(F * B, 3, device=dev)
    library_ms = time_ms(lambda: acc.index_add_(0, keys, src), torch,
                         flush=flush)
    del keys, src, acc
    bytes_moved = n * F * 1 + n * 12 + F * B * 12
    ops = 3 * n * F
    bound_bytes_ms = bytes_moved / bw * 1e3
    bound_ops_ms = ops / F32_PEAK_FLOPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    print(f"phase 2: K1 root {ms:.4f} ms, masked 30% {ms_masked:.4f} ms; "
          f"plain {plain_ms:.4f} ms; index_add_ alone {library_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB, {ops / 1e6:.1f} M adds); "
          f"median of 25 CUDA-event runs, L2 flushed")

    # ---- phase 3: fit → transform → AUC through K1
    df = DataFrame({"features": feats, "label": labels})
    kw = dict(numIterations=iters, numLeaves=31, maxBin=255,
              learningRate=0.1)
    t0 = time.perf_counter()
    compute_bin_boundaries(feats, 255)
    host_binning_s = time.perf_counter() - t0
    LightGBMClassifier(**kw).fit(df)              # warm-up fit
    torch.cuda.synchronize()
    fit_times, fit_launches = [], []
    for _ in range(FIT_RUNS):
        k1.hist_cuda.launches = 0
        t0 = time.perf_counter()
        model = LightGBMClassifier(**kw).fit(df)
        torch.cuda.synchronize()
        fit_times.append(time.perf_counter() - t0)
        fit_launches.append(k1.hist_cuda.launches)
    fit_s = float(np.median(fit_times))
    launches = fit_launches[-1]
    if launches == 0 or len(set(fit_launches)) != 1:
        fail(f"K1 launches per fit {fit_launches}: expected the same "
             "nonzero count in every fit")
    model.transform(df)                           # warm-up transform
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = model.transform(df)
    transform_s = time.perf_counter() - t0
    prob = np.asarray(scored["probability"])
    if prob.shape != (n, 2) or not np.isfinite(prob).all():
        fail(f"transform gave probabilities of shape {prob.shape} with "
             f"{(~np.isfinite(prob)).sum()} non-finite values")
    auc = float(ComputeModelStatistics(labelCol="label")
                .transform(scored)["AUC"][0])
    if not 0.75 < auc <= 1.0:
        fail(f"AUC {auc} outside (0.75, 1]")
    small = feats[:2000]
    gpu_raw = model.booster.raw_scores(small, device="cuda")
    cpu_raw = model.booster.raw_scores(small, device="cpu")
    if not np.allclose(gpu_raw, cpu_raw, rtol=0, atol=1e-5):
        fail("scoring on the card and on the CPU disagree beyond 1e-5")
    print(f"phase 3: fit {fit_s:.3f} s warm, median of {FIT_RUNS} "
          f"({', '.join(f'{t:.3f}' for t in fit_times)} s; "
          f"{n * iters / fit_s:,.0f} "
          f"rows*iterations/s; host bin boundaries {host_binning_s:.3f} s of "
          f"it), transform {transform_s:.3f} s ({n / transform_s:,.0f} "
          f"rows/s), AUC {auc:.6f}, K1 launches per fit {launches}")

    # ---- phase 4: the same fit with the plain histogram on the card
    plain_clf = LightGBMClassifier(**kw)
    plain_clf._hist_impl = "torch"
    k1.hist_cuda.launches = 0
    t0 = time.perf_counter()
    plain_model = plain_clf.fit(df)
    torch.cuda.synchronize()
    plain_fit_s = time.perf_counter() - t0
    if k1.hist_cuda.launches != 0:
        fail("the plain-histogram fit launched K1")
    plain_auc = float(ComputeModelStatistics(labelCol="label").transform(
        plain_model.transform(df))["AUC"][0])
    a, b = model.booster.arrays, plain_model.booster.arrays
    root = (int(a["feature"][0, 0]), float(a["threshold"][0, 0]))
    plain_root = (int(b["feature"][0, 0]), float(b["threshold"][0, 0]))
    internal = ~a["is_leaf"][0] & (a["left"][0] >= 0)
    agree = int((internal & (a["feature"][0] == b["feature"][0])
                 & (a["threshold"][0] == b["threshold"][0])).sum())
    print(f"phase 4: plain-histogram fit {plain_fit_s:.3f} s, AUC "
          f"{plain_auc:.6f} (|diff| {abs(plain_auc - auc):.2e}); tree 0 "
          f"root (feature, threshold) {root} vs {plain_root}; "
          f"{agree} of {int(internal.sum())} tree-0 splits agree")
    if abs(plain_auc - auc) > 1e-3:
        fail(f"kernel fit AUC {auc} and plain fit AUC {plain_auc} differ "
             "by more than 1e-3")
    if root != plain_root:
        fail(f"tree 0 root split differs: {root} vs {plain_root}")

    flash = text_phases(torch, k1, k2, dev, bw, flush, args.docs)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "hist",
        "route": "cuda",
        "source": "mmlspark_torch/lightgbm/csrc/hist.cu",
        "replaces": "mmlspark_tpu/lightgbm/pallas_hist.py:45",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }, flash]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
