#!/usr/bin/env python3
"""Where the time of one served batch goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/profile_torch_serving.py [--batch 8] [--runs 20]

``chip_smoke.py`` phase 37's executor runs batches of about eight requests
under 16 closed-loop connections. This takes its two models, with no HTTP
front, at ``--batch`` requests a batch:

1. phase 35's chain, fitted on the card and compiled as the serving DSL
   compiles it (the request parse, one fused segment, the GBDT model):
   each plan item's seconds (a synchronize after each), the replies' JSON,
   and the whole compiled transform, medians of ``--runs``;
2. BERT-base (phase 24's seeded bf16 weights, ``TextEncoderFeaturizer`` on
   K2a) on requests of 288 tokens (phase 37's loadgen payload): the
   bodies' JSON parse, the transform, the replies' JSON, medians of
   ``--runs``;
3. for each, a torch.profiler trace of ``--runs`` transforms: device time
   and kernels a transform, the largest kernels, and the busy share
   (device time over the unprofiled transform seconds).

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (CONTROL_TOKENS, chain_request,  # noqa: E402
                        control_traffic, make_documents, serving_bert,
                        serving_chain)


def requests_frame(np, HTTPRequestData, DataFrame, bodies):
    """The executor's frame: ``id`` and ``request`` object columns."""
    ids = np.empty(len(bodies), object)
    reqs = np.empty(len(bodies), object)
    ids[:] = [str(i) for i in range(len(bodies))]
    reqs[:] = [HTTPRequestData(method="POST", entity=b) for b in bodies]
    return DataFrame({"id": ids, "request": reqs})


def profiled(torch, np, fn, runs, unprofiled_s, label):
    """torch.profiler over ``runs`` calls of ``fn``: device time and
    kernels a call, the largest kernels, the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    device_us = sum(sum(v) for v in by_name.values()) / runs
    print(f"{label}: device time {device_us / 1e3:.3f} ms in "
          f"{len(events) / runs:.1f} device kernels and copies a "
          f"transform; busy share {device_us / 1e6 / unprofiled_s:.3f} of "
          f"the unprofiled {unprofiled_s * 1e3:.3f} ms")
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  {sum(times) / runs / 1e3:8.3f} ms  {len(times) / runs:6.1f}"
              f" x  {name[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: needs an NVIDIA GPU")
    import mmlspark_torch.dl.flash_attention as k2
    from mmlspark_torch.core import DataFrame, compile_pipeline
    from mmlspark_torch.io.http import HTTPRequestData, string_to_response

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)

    def median_ms(fn):
        out = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return float(np.median(out)) * 1e3

    # ---- the chain
    chain, cols, names = serving_chain(torch)
    x = np.stack([cols[c][:args.batch] for c in names], 1)
    frame = requests_frame(np, HTTPRequestData, DataFrame,
                           [json.dumps(r.tolist()).encode() for r in x])
    cp = compile_pipeline([chain_request(names),
                           *chain.getOrDefault("stages")], frame,
                          service="profile-chain")
    for _ in range(3):
        cp.transform(frame)
    parts = {}
    for _ in range(args.runs):
        cur = frame
        for item in cp.plan:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cur = item.run(cur)
            torch.cuda.synchronize()
            parts.setdefault(item.name, []).append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        [string_to_response(json.dumps(float(v[1])))
         for v in cur["probability"]]
        parts.setdefault("replies (JSON)", []).append(
            time.perf_counter() - t0)
    whole = median_ms(lambda: cp.transform(frame))
    print(f"chain, {args.batch} requests a batch: compiled transform "
          f"{whole:.3f} ms (median of {args.runs}); by plan item, each "
          f"ending in a synchronize:")
    for name, secs in parts.items():
        print(f"  {np.median(secs) * 1e3:8.3f} ms  {name}")
    profiled(torch, np, lambda: cp.transform(frame), args.runs, whole / 1e3,
             "chain")

    # ---- BERT-base
    tokens = control_traffic(make_documents(32)[0])[0]
    mid = int(np.argmin([abs(len(t) - sum(CONTROL_TOKENS) // 2)
                         for t in tokens]))
    body = json.dumps(tokens[mid].tolist()).encode()
    stage, _ = serving_bert(torch, dev, "BertBaseServingProfile")
    bframe = requests_frame(np, HTTPRequestData, DataFrame,
                            [body] * args.batch)

    def parse():
        col = np.empty(args.batch, object)
        col[:] = [np.asarray(json.loads(r.entity), np.int32)
                  for r in bframe["request"]]
        return DataFrame({"tokens": col})

    parsed = parse()
    for _ in range(3):
        pooled = np.asarray(stage.transform(parsed)["features"])
    t_parse = median_ms(parse)
    k2.flash_cuda.launches = 0
    t_stage = median_ms(lambda: stage.transform(parsed))
    launches = k2.flash_cuda.launches / args.runs
    t_reply = median_ms(lambda: [string_to_response(json.dumps(v.tolist()))
                                 for v in pooled])
    print(f"BERT-base, {args.batch} requests of {len(tokens[mid])} tokens a "
          f"batch: JSON parse {t_parse:.3f} ms, transform {t_stage:.3f} ms "
          f"({launches:g} K2a launches), replies (JSON) {t_reply:.3f} ms "
          f"(medians of {args.runs})")
    profiled(torch, np, lambda: stage.transform(parsed), args.runs,
             t_stage / 1e3, "BERT-base")


if __name__ == "__main__":
    main()
