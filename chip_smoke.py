#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain PyTorch versions.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from the checkout's sources, then:

1. prints the build time and the card (``nvidia-smi`` name, power limit);
2. holds K1 (``hist_cuda``) against ``hist_torch`` at the main path's
   shapes: the root histogram, a masked one (~30 % of rows) and a
   ``count < n`` one whose rows past ``count`` are padding, and times both
   beside ``index_add_`` alone and the bandwidth bound;
3. fits ``LightGBMClassifier`` (500,000 x 28, Higgs-shaped as in
   ``bench.py``'s GBDT workload; 31 leaves, 255 bins, 20 iterations) on the
   card through K1, transforms, and scores AUC with
   ``ComputeModelStatistics``, counting K1 launches in the fit;
4. fits again with the plain histogram on the card and holds the two fits
   together.

Any failed build, launch or comparison exits non-zero. The last two lines
are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
``--rows``/``--iterations`` shrink the run for a quick first check.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--iterations", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    try:
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

    # ---- phase 1: build every kernel of the path
    t0 = time.perf_counter()
    log = k1.build_kernel()
    build_s = time.perf_counter() - t0
    print(f"phase 1: built K1 (lightgbm/csrc/hist.cu, sm_90a) in "
          f"{build_s:.2f} s")
    for line in log.splitlines():
        if "ptxas" in line or "error" in line.lower():
            print(f"  {line.strip()}")
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
