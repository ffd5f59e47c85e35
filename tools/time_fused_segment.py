#!/usr/bin/env python3
"""Where a fused segment's time goes on one GPU: the numeric featurize
chain of ``chip_smoke.py`` phase 35 (``CleanMissingData`` Mean →
``Featurize`` over 500,000 x 30 float32 columns with ~5 % NaN), split into
the segment's upload, its traced body, the one batched fetch and the merge,
beside the two stages run eagerly, and the fetch's copy alone into pinned
and into pageable host memory.

    python3 tools/time_fused_segment.py [--rows 500000] [--runs 5]

Each time is the median of ``--runs`` calls, each between two
``torch.cuda.synchronize()`` on the host clock. Prints the card's name and
power limit beside the numbers.
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


def median_ms(torch, fn, runs: int) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times)) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_fused_segment: needs a CUDA GPU")
    import chip_smoke
    from mmlspark_torch.core import DataFrame, compile_pipeline
    from mmlspark_torch.core.compile import (_merge_traced, download,
                                             trace_columns, upload)
    from mmlspark_torch.featurize import CleanMissingData, Featurize

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cols = chip_smoke.compile_frame(args.rows)
    names = [c for c in cols if c != "label"]
    df = DataFrame(cols)
    clean = CleanMissingData(inputCols=names).fit(df)
    feat = Featurize(inputCols=names).fit(clean.transform(df))
    cp = compile_pipeline([clean, feat], df.take(list(range(4096))))
    seg = cp.plan[0]
    donated, dropped = seg._split(trace_columns(df))
    dev_cols, origin = upload(donated, seg.device)
    out = seg.call_device(dev_cols, {})
    host = download(out, origin, seg.device)
    cleaned = clean.transform(df)
    runs = args.runs
    rows = {
        "upload (one copy a column)": lambda: upload(donated, seg.device),
        "traced body": lambda: seg.call_device(dev_cols, {}),
        "fetch (one pinned copy)": lambda: download(out, origin,
                                                    seg.device),
        "merge": lambda: _merge_traced(df, host, [], seg.stages),
        "fused segment, end to end": lambda: seg.run(df),
        "eager CleanMissingDataModel": lambda: clean.transform(df),
        "eager FeaturizeModel": lambda: feat.transform(cleaned),
    }
    got = {k: median_ms(torch, fn, runs) for k, fn in rows.items()}
    nbytes = sum(v.numel() * v.element_size() for k, v in out.items()
                 if k not in donated or v is not dev_cols[k])
    packed = torch.empty(nbytes, dtype=torch.uint8, device=seg.device)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    got[f"{nbytes / 1e6:.0f} MB to pinned memory"] = median_ms(
        torch, lambda: pinned.copy_(packed, non_blocking=True), runs)
    got[f"{nbytes / 1e6:.0f} MB to pageable memory"] = median_ms(
        torch, lambda: packed.cpu(), runs)
    print(f"{args.rows:,} rows x {len(names)} float32 columns; median of "
          f"{runs}; {card}")
    for k, v in got.items():
        print(f"  {k}: {v:.3f} ms")


if __name__ == "__main__":
    main()
