#!/usr/bin/env python3
"""Phase 39's sequence and tensor parallelism over NCCL, one card a rank.

Run from the root of a checkout on a machine with 4 NVIDIA GPUs and nvcc:

    python3 tools/parallel_nccl.py [--ranks 4] [--backend nccl]

Builds the attention kernels (K2a/K2b/K2c and K2d/K2e), then runs
``chip_smoke.py``'s phase 39 with ``--ranks`` processes (rank r on card r)
joined over NCCL: the masked LM and the causal LM through ``ring_flash``
over sp = ``--ranks`` (K2b, K2d, K2e ``ranks`` x 8 a rank a step, each
held against one rank's ``pallas`` step), BERT-base through
``ulysses_flash`` over the same axis, a tp step's gradients and
``pretrain_masked_lm`` over ``--tp-mesh`` (default dp = 2 x tp = 2), the dp
featurizer, and the planted faults, printing per rank each scenario's
seconds, launches and peak memory. The last line is a JSON object of the
kernels' launches and the phase's seconds. ``--device cpu --backend gloo``
runs the same on the CPU at a narrow shape (no kernel launches). It
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tp-mesh", default="dp=2,tp=2",
                    help="the tp scenarios' mesh, as axis=size pairs")
    ap.add_argument("--batch", type=int, default=chip_smoke.TRAIN_BATCH)
    ap.add_argument("--docs", type=int, default=32)
    args = ap.parse_args()

    import torch
    tp_mesh = {k: int(v) for k, v in (kv.split("=")
                                      for kv in args.tp_mesh.split(","))}
    cfg = dict(text_shape=chip_smoke.TEXT_SHAPE, T=chip_smoke.TEXT_T,
               B=args.batch, docs=args.docs, tp_mesh=tp_mesh)
    if args.device == "cuda":
        import mmlspark_torch.dl.flash_attention as k2
        if torch.cuda.device_count() < args.ranks:
            sys.exit(f"parallel_nccl: {args.ranks} ranks need as many "
                     f"cards, found {torch.cuda.device_count()}")
        k2.build_kernel()          # once, before the ranks load them
        k2.build_bwd_kernel()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    else:
        cfg.update(text_shape=dict(vocab=1024, width=64, depth=2, heads=4,
                                   mlp_dim=128), T=128, B=4, docs=8)
        chip_smoke.BERT_BASE = dict(chip_smoke.BERT_BASE, width=64, depth=2,
                                    heads=4, mlp_dim=128)
    print(f"{args.ranks} ranks over {args.backend} on {args.device}")
    out = chip_smoke.parallel_phase(torch, args, device=args.device,
                                    cfg=cfg, world=args.ranks,
                                    backend=args.backend)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
