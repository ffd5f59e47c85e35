#!/usr/bin/env python3
"""Where the time of the port's GBDT fit goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/profile_torch_gbdt.py [--rows 500000] [--iterations 20]
        [--classes 7]

On chip_smoke.py's Higgs-shaped workload (500,000 x 28, 31 leaves, 255
bins; with ``--classes K`` the multiclass fit of its phase 16, K classes
cut from the target's quantiles, K trees an iteration) it prints:

1. warm fit seconds with K1 and with the plain histogram, in turns
   (kernel, plain, plain, kernel), each fit ending in a synchronize;
2. the trainer's own split of one fit into binning and boosting seconds;
3. a torch.profiler trace of one warm K1 fit: device time by kernel name,
   kernel launches and total device time. The profiler slows the host
   several-fold, so the busy share of an unprofiled fit is that device time
   over the unprofiled fit seconds of step 1.

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import higgs_like, higgs_like_target  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--classes", type=int, default=2,
                    help="above 2: a multiclass fit (chip_smoke phase 16)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_gbdt: needs an NVIDIA GPU")
    import mmlspark_torch.lightgbm.hist as k1
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.lightgbm import LightGBMClassifier
    from mmlspark_torch.lightgbm.trainer import TrainConfig, train

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    n, iters = args.rows, args.iterations
    K = args.classes
    objective = "multiclass" if K > 2 else "binary"
    if K > 2:
        feats, t = higgs_like_target(n)
        labels = np.digitize(t, np.quantile(t, np.arange(1, K) / K)
                             ).astype(np.float32)
    else:
        feats, labels = higgs_like(n)
    df = DataFrame({"features": feats, "label": labels})
    kw = dict(numIterations=iters, numLeaves=31, maxBin=255,
              learningRate=0.1, objective=objective)

    def fit(impl):
        clf = LightGBMClassifier(**kw)
        clf._hist_impl = impl
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.fit(df)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    fit(None)
    fit("torch")                                  # warm both paths
    for impl in (None, "torch", "torch", None):
        s = fit(impl)
        print(f"fit hist={impl or 'cuda'}: {s:.3f} s "
              f"({n * iters / s:,.0f} rows*iterations/s)")

    cfg = TrainConfig(objective=objective, num_iterations=iters,
                      num_class=K if K > 2 else 1, num_leaves=31,
                      max_bin=255, learning_rate=0.1)
    res = train(feats, labels, None, cfg, device="cuda")
    print(f"trainer split: binning {res.seconds['binning']:.3f} s, "
          f"boosting {res.seconds['boosting']:.3f} s")

    from torch.profiler import ProfilerActivity, profile
    k1.hist_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        LightGBMClassifier(**kw).fit(df)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    device_us = sum(sum(v) for v in by_name.values())
    print(f"profiled fit: wall {wall:.3f} s (profiler on), device kernel "
          f"time {device_us / 1e6:.3f} s, {len(events)} device kernels, "
          f"K1 launches {k1.hist_cuda.launches}")
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:15]:
        print(f"  {sum(times) / 1e3:9.3f} ms  {len(times):6d} x  "
              f"{name[:90]}")


if __name__ == "__main__":
    main()
