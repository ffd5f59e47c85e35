#!/usr/bin/env python3
"""K3's window kernel (``paged_cuda``) of this checkout at the window shapes
of ``chip_smoke.py``'s phase 9, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/time_window_kernel.py [--label NAME]

For each shape (the phase-9 prefill window, the long prompt, the engine's
prefill shapes, a warm suffix over a 4096-position table, w = 17, short
block lengths, head dims 128 and 256, and the verify window called
directly) it prints the median of CUDA-event runs around the call and the
device time of the call's kernels (the window kernel and any combine) from
``torch.profiler``, L2 flushed before each run, every line prefixed by
``--label``. To compare two trees on one card, run this script from each
checkout in turns (parent, change, change, parent) in one command: it
imports the ``mmlspark_torch`` and ``chip_smoke`` of the directory it runs
in. It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.getcwd())

# (name, seed, slots, window rows, block length, blocks a table, head dim,
# every chain full)
SHAPES = (
    ("w=128 S=32 BL=16 (prefill window)", 63, 32, 128, 16, 256, 64, False),
    ("w=4096 S=1 BL=128 (long prompt)", 64, 1, 4096, 128, 32, 64, True),
    ("w=192 S=1 BL=16 MB=18 (engine cold prefill)", 81, 1, 192, 16, 18, 64,
     False),
    ("w=192 S=4 BL=16 MB=18 (engine prefill batch)", 82, 4, 192, 16, 18, 64,
     False),
    ("w=32 S=1 BL=16 MB=18 (engine warm suffix)", 83, 1, 32, 16, 18, 64,
     False),
    ("w=32 S=1 BL=16 MB=256 (warm suffix, long prefix)", 84, 1, 32, 16, 256,
     64, False),
    ("w=17 S=4 BL=8", 80, 4, 17, 8, 40, 64, False),
    ("w=40 S=4 BL=4 (4-row boxes)", 85, 4, 40, 4, 40, 64, False),
    ("w=40 S=4 BL=5 hd=32 (register copies)", 87, 4, 40, 5, 32, 32, False),
    ("w=64 S=8 BL=16 hd=128", 89, 8, 64, 16, 32, 128, False),
    ("w=64 S=8 BL=16 hd=256", 90, 8, 64, 16, 32, 256, False),
    ("w=5 S=32 BL=16 (verify shape)", 62, 32, 5, 16, 256, 64, False),
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_window_kernel: needs an NVIDIA GPU")
    import chip_smoke as cs
    import mmlspark_torch.dl.paged_attention as k3

    dev = torch.device("cuda", 0)
    k3.build_kernel()
    k3.build_decode_kernel()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    print(f"{args.label} {cs.nvidia_smi('name,power.limit')}")
    for name, seed, S, w, BL, MB, hd, full in SHAPES:
        c = cs.paged_case(torch, dev, seed, S, w, BL, MB, 8, hd,
                          torch.bfloat16, full)
        call = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
        ms = cs.time_ms(lambda: k3.paged_cuda(*call), torch, flush=flush)
        # the window kernel's name before and after its redesign, and the
        # combine
        names = ("paged_bf16", "paged_fwd", "paged_combine")
        dev_ms = cs.device_ms(torch, lambda: k3.paged_cuda(*call), names,
                              flush=flush)
        print(f"{args.label} {name}: {ms:.4f} ms events; device "
              f"{sum(dev_ms.values()):.4f} ms")


if __name__ == "__main__":
    main()
