#!/usr/bin/env python3
"""Where the time of the port's text-embedding transform goes, on one
NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/profile_torch_text.py [--docs 32]

On chip_smoke.py's text path (seeded documents of 1,024-2,048 words,
``TokenIdEncoder(maxLength=2048, vocabSize=32768)``, a seeded
``TextEncoder(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)`` in
bf16) it prints:

1. warm ``TextEncoderFeaturizer.transform`` seconds with
   ``attentionImpl="pallas"`` (K2a) and ``"dense"``, in turns (pallas,
   dense, dense, pallas), each ending in a synchronize;
2. a torch.profiler trace of one warm pallas transform: device time by
   kernel name, kernel count, total device time, K2a's share of it, and
   the busy share (device time over the unprofiled transform seconds of
   step 1; the profiler slows the host).

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import TEXT_SHAPE, TEXT_T, make_documents  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=32)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_text: needs an NVIDIA GPU")
    import mmlspark_torch.dl.flash_attention as k2
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.featurize import TokenIdEncoder
    from mmlspark_torch.models import LoadedModel, register_text_encoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    texts, _ = make_documents(args.docs)
    ids = TokenIdEncoder(maxLength=TEXT_T, vocabSize=TEXT_SHAPE["vocab"]) \
        .transform(DataFrame({"text": texts}))
    schema = register_text_encoder("TextEncoderLong", seq_len=TEXT_T,
                                   **TEXT_SHAPE)
    loaded = LoadedModel(schema, schema.builder(
        generator=torch.Generator().manual_seed(0)))
    stages = {impl: TextEncoderFeaturizer(
        attentionImpl=impl, vocabSize=TEXT_SHAPE["vocab"],
        width=TEXT_SHAPE["width"], depth=TEXT_SHAPE["depth"],
        heads=TEXT_SHAPE["heads"], model=loaded)
        for impl in ("pallas", "dense")}

    def transform(impl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stages[impl].transform(ids)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for impl in stages:
        transform(impl)                          # warm both paths
    seconds = {"pallas": [], "dense": []}
    for impl in ("pallas", "dense", "dense", "pallas"):
        s = transform(impl)
        seconds[impl].append(s)
        print(f"transform attentionImpl={impl}: {s:.4f} s "
              f"({args.docs / s:.2f} seqs/s)")

    from torch.profiler import ProfilerActivity, profile
    k2.flash_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stages["pallas"].transform(ids)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    device_us = sum(sum(v) for v in by_name.values())
    flash_us = sum(sum(v) for k, v in by_name.items() if "flash_fwd" in k)
    unprofiled = float(np.median(seconds["pallas"]))
    print(f"profiled pallas transform: wall {wall:.4f} s (profiler on), "
          f"device time {device_us / 1e3:.3f} ms in {len(events)} device "
          f"kernels and copies, K2a {flash_us / 1e3:.3f} ms "
          f"({flash_us / max(device_us, 1e-9):.3f} of device time, "
          f"{k2.flash_cuda.launches} launches); busy share "
          f"{device_us / 1e6 / unprofiled:.3f} of the unprofiled "
          f"{unprofiled:.4f} s")
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:15]:
        print(f"  {sum(times) / 1e3:9.3f} ms  {len(times):6d} x  "
              f"{name[:90]}")


if __name__ == "__main__":
    main()
