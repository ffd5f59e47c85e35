#!/usr/bin/env python3
"""Where the time of K1 and of K3's window kernel goes, on one NVIDIA GPU:
each kernel beside variants built from copies of this checkout's sources
with one piece changed.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/probe_kernel_variants.py

Window kernel (``dl/csrc/paged_attn.cu`` with ``flash_fwd.cuh``), device
time (``torch.profiler``, L2 flushed) at the phase-9 prefill window
(w = 128 over 32 slots of 128-4096 positions, block length 16) and the
long prompt (w = 4096, block length 128), for:

- ``base``: the kernel as committed;
- ``plain walk``: CTA i takes items i, i + grid, ... in index order (no
  ranking of the rows by length, no snake);
- ``l2 256``: every tensor map of the kernel with the 256-byte L2
  promotion in place of 128 (a box row of a pool is one head's 128 bytes
  of a position's H heads);
- ``no math``: the consumers skip both products (wrong output; the copies'
  time alone);
- ``no copies``: the producer arrives without copying (wrong output; the
  math's time alone);

each variant timed twice, the list walked forward then backward (times
move 10-17 % between runs).

K1 (``lightgbm/csrc/hist.cu``), device time of both kernels on the root
histogram, a 3 % masked scan and an all-zero scan (500,000 x 28 u8 bins),
for ``base``, ``three atomics`` (an f32 atomicAdd for each of grad, hess
and count, in place of the paired CAS and the integer count) and ``no
partial writes`` (wrong output; the partial kernel without its writes).

Then ptxas's spills of the window kernel's D = 256 instance with the
producer warpgroup held to 24 and to 40 registers (the consumers at 240
and 232), in place of 56/224. The variants build into
``mmlspark_torch/_build/``. It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

WINDOW_FILES = ("dl/csrc/paged_attn.cu", "dl/csrc/flash_fwd.cuh",
                "dl/csrc/flash_common.cuh")
WINDOW_VARIANTS = {
    "base": (),
    "plain walk": (
        ("static constexpr int kMaxRows = 256;",
         "static constexpr int kMaxRows = 0;"),
        ("    return k * gridDim.x +\n"
         "           ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);",
         "    return blockIdx.x + k * gridDim.x;")),
    "l2 256": (("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                "CU_TENSOR_MAP_L2_PROMOTION_L2_256B"),),
    "no math": (("if (any != 0 && reach) {",
                 "if (any != 0 && reach && p.scale < 0.f) {"),),
    "no copies": (
        ("          Src::copy_tile(p, item, k0, lane, kv_s + stage * "
         "C::STAGE_BYTES,\n                         full(stage), &tk, &tv);",
         "          { if (lane == 0) mbar_arrive(full(stage)); }"),),
}
REG_VARIANTS = {
    "producer 24 registers": (
        ("static constexpr int kProducerRegs = 56, kConsumerRegs = 224;",
         "static constexpr int kProducerRegs = 24, kConsumerRegs = 240;"),),
    "producer 40 registers": (
        ("static constexpr int kProducerRegs = 56, kConsumerRegs = 224;",
         "static constexpr int kProducerRegs = 40, kConsumerRegs = 232;"),),
}
HIST_VARIANTS = {
    "base": (),
    "three atomics": (
        ("    add_pair(hs.gh + cell, g, h);\n"
         "    if (w == 1.f)\n"
         "      atomicAdd(hs.n_one + cell, 1u);\n"
         "    else if (w != 0.f)\n"
         "      atomicAdd(hs.w_other + cell, w);",
         "    atomicAdd(&hs.gh[cell].x, g);\n"
         "    atomicAdd(&hs.gh[cell].y, h);\n"
         "    atomicAdd(hs.w_other + cell, w);"),),
    "no partial writes": (
        ("  for (int i = tid; i < cells * 3; i += kThreads) {",
         "  for (int i = tid; i < 0; i += kThreads) {"),),
}


def variant_loader(name, files, subs):
    """A CudaLoader over copies of ``files`` (package paths; the first is
    the source, the rest its headers) with each (old, new) of ``subs``
    replaced where it occurs; every pair must occur somewhere."""
    from mmlspark_torch.native.loader import (BUILD_DIR, PACKAGE_DIR,
                                              CudaLoader)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    out = os.path.join(BUILD_DIR, "variants", tag)
    os.makedirs(out, exist_ok=True)
    seen = set()
    paths = []
    for f in files:
        with open(os.path.join(PACKAGE_DIR, f)) as fh:
            text = fh.read()
        for i, (old, new) in enumerate(subs):
            if old in text:
                text = text.replace(old, new)
                seen.add(i)
        path = os.path.join(out, os.path.basename(f))
        with open(path, "w") as fh:
            fh.write(text)
        paths.append(path)
    missing = set(range(len(subs))) - seen
    if missing:
        sys.exit(f"probe_kernel_variants: {name}: the sources no longer "
                 f"hold {[subs[i][0][:60] for i in sorted(missing)]}")
    return CudaLoader(f"variant_{tag}", paths[:1], headers=tuple(paths[1:]))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_kernel_variants: needs an NVIDIA GPU")
    import chip_smoke as cs
    import mmlspark_torch.dl.paged_attention as k3
    import mmlspark_torch.lightgbm.hist as k1

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    k3.build_decode_kernel()
    real_k3, real_k1 = k3._library(), k1._library()

    cases = [(name, cs.paged_case(torch, dev, seed, S, w, BL, MB, 8, 64,
                                  torch.bfloat16, full))
             for name, seed, S, w, BL, MB, full in (
                 ("prefill window", 63, 32, 128, 16, 256, False),
                 ("long prompt", 64, 1, 4096, 128, 32, True))]
    libs = {}
    for name, subs in WINDOW_VARIANTS.items():
        lib = variant_loader(name, WINDOW_FILES, subs).load()
        lib.mmlspark_paged_launch.argtypes = \
            real_k3.mmlspark_paged_launch.argtypes
        lib.mmlspark_paged_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    for name in list(libs) + list(libs)[::-1]:
        k3._library = lambda lib=libs[name]: lib
        for case, c in cases:
            call = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
            ms = cs.device_ms(torch, lambda: k3.paged_cuda(*call),
                              ("paged_fwd",), flush=flush)["paged_fwd"]
            print(f"window kernel, {name}, {case}: device {ms:.4f} ms")
    k3._library = lambda: real_k3

    n, F, B = 500_000, 28, 256
    rng = np.random.default_rng(0)
    bins = torch.from_numpy(rng.integers(0, 255, (n, F)).astype(
        np.uint8)).to(dev)
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    vals = torch.stack([g, g.abs() * 0.25, torch.ones_like(g)], 1)
    sel = torch.from_numpy((rng.random(n) < 0.03).astype(np.float32))
    scans = (("root", vals), ("3 % masked", vals * sel.to(dev)[:, None]),
             ("all zero", torch.zeros_like(vals)))
    for name, subs in HIST_VARIANTS.items():
        lib = variant_loader(f"hist {name}", ("lightgbm/csrc/hist.cu",),
                             subs).load()
        lib.mmlspark_hist_launch.argtypes = \
            real_k1.mmlspark_hist_launch.argtypes
        lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
        k1._library = lambda lib=lib: lib
        for scan, v in scans:
            d = cs.device_ms(torch, lambda: k1.hist_cuda(bins, v,
                                                         num_bins=B),
                             ("hist_partial", "hist_reduce"), flush=flush)
            print(f"K1, {name}, {scan}: device partial "
                  f"{d['hist_partial']:.4f} + sum {d['hist_reduce']:.4f} ms")
    k1._library = lambda: real_k1

    for name, subs in REG_VARIANTS.items():
        loader = variant_loader(name, WINDOW_FILES, subs)
        loader.load()
        for line in cs.ptxas_summary(loader.build_log()):
            if "paged_fwd_bf16<256>" in line:
                print(f"window kernel, {name}: {line}")


if __name__ == "__main__":
    main()
