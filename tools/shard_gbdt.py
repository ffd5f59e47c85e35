#!/usr/bin/env python3
"""Sharded GBDT fits over N ranks against one rank, on NVIDIA GPUs.

Run from the root of a checkout on a machine with CUDA GPUs and nvcc:

    python3 tools/shard_gbdt.py [--ranks 4] [--backend nccl]
        [--rows 500000] [--iterations 20]

Builds K1, then runs ``chip_smoke.py``'s phase 23 with ``--ranks``
processes (rank r on card r modulo the cards there are) joined over
``--backend``: each fits the Higgs-shaped rows (28 features, seed 7; the
whole frame, each rank growing on its block of rows; 31 leaves, 255 bins)
data parallel and voting at topK=6 and prints per rank the fit's seconds,
K1 launches, all_reduce calls, bytes and the host seconds spent inside
them (with NCCL the enqueue, with gloo the wait for the card as well);
then the same rows on one rank, held as phase 23 holds them. The last
line is a JSON object of those numbers. ``--device cpu --backend gloo``
runs the same on the CPU (no K1, so 0 launches). It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import shards_phase  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the ranks may take in all")
    args = ap.parse_args()

    import torch
    import mmlspark_torch.lightgbm.hist as k1

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("shard_gbdt: needs an NVIDIA GPU (or --device cpu)")
        k1.build_kernel()          # once, before the ranks load it
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
        print(f"{torch.cuda.device_count()} cards; {args.ranks} ranks over "
              f"{args.backend}")
    out = shards_phase(torch, k1, args, world=args.ranks,
                       backend=args.backend, device=args.device,
                       timeout=args.timeout)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
