#!/usr/bin/env python3
"""The wide-head-dim attention kernels (``csrc/attn_wide.cu``) of this
checkout on one NVIDIA GPU: every route at ``chip_smoke.py``'s timed wide
shape, and with ``--check`` each one held against its plain version first.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/time_wide_kernels.py [--label NAME] [--check] [--plain]
        [--sdpa]

It times K2a, K2b, K2c, K2c-lse, K2d, K2e and causal K2d/K2e at
``[2, 8, 1024, D]`` (the first batch row's last 100 keys masked) and K3's
window kernel at the phase-9 prefill window (w = 128 over 32 slots of up
to 4,096 positions, 8 heads), at D = 512 in bf16 and 256 in f32: the
median of 10 CUDA-event runs around the call, L2 flushed before each, one
line per route prefixed by ``--label``. ``--check`` first holds every
route at head dims 320 and 512 in both dtypes (K3 at hd 320 and 512), and
the causal training kernels at the widest clusters (bf16 2048, f32 1024)
and beyond them (the split kernels), against its plain version with
``chip_smoke.py``'s limits and checks that two backward launches are
bit-equal; the build's ptxas lines come first.
``--plain`` also times each route's plain version, and ``--sdpa``
``scaled_dot_product_attention`` on the same inputs (K3's on a cache
gathered beforehand). To compare two trees on one card, run it from each
checkout in turns (parent, change, change, parent) in one command: it imports the ``mmlspark_torch`` and ``chip_smoke`` of the
directory it runs in. It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.getcwd())


def check(torch, cs, k2, k3, dev):
    """Every wide route against its plain version (chip_smoke's holds)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    mask = torch.ones(2, 300, dtype=torch.bool, device=dev)
    mask[0, 150:] = False   # five key tiles with no valid key in a row
    mask[1, :7] = False
    for d in (320, 512):
        for dtype in (torch.bfloat16, torch.float32):
            x = [torch.randn(2, 4, 300, d, generator=gen, device=dev,
                             dtype=dtype) for _ in range(4)]
            bf16 = dtype == torch.bfloat16
            name = f"{str(dtype)[6:]} [2, 4, 300, {d}]"
            cs.check_flash(torch, k2, name, *x[:3], mask,
                           cs.FLASH_BF16_RTOL if bf16 else 0.0,
                           cs.FLASH_BF16_ATOL if bf16 else cs.FLASH_F32_ATOL)
            dlse = torch.randn(2, 4, 300, generator=gen, device=dev)
            cs.check_training_kernels(torch, k2, name, *x, mask, dlse)
            cs.check_training_kernels(torch, k2, name + " causal", *x, mask,
                                      dlse, 5, 23)
            for causal in (False, True):
                cs.deterministic(torch, k2, f"{name} causal={causal}",
                                 *x[:3], x[3], mask, causal)
    # the widest clusters (16 CTAs) and the split kernels beyond them
    for d, dtype in ((2048, torch.bfloat16), (1024, torch.float32),
                     (2176, torch.bfloat16), (1152, torch.float32)):
        x = [torch.randn(1, 2, 130, d, generator=gen, device=dev,
                         dtype=dtype) for _ in range(4)]
        name = f"{str(dtype)[6:]} [1, 2, 130, {d}]"
        cs.check_training_kernels(torch, k2, name, *x, mask[:1, :130],
                                  torch.randn(1, 2, 130, generator=gen,
                                              device=dev), 5, 23)
    for hd, w in ((320, 128), (512, 64), (512, 5)):
        for dtype in (torch.float32, torch.bfloat16):
            c = cs.paged_case(torch, dev, 76, 8, w, 16, 32, 8, hd, dtype)
            cs.check_paged(torch, k3, f"{str(dtype)[6:]} w={w} hd={hd}", c)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="also time each route's plain version")
    ap.add_argument("--sdpa", action="store_true",
                    help="also time scaled_dot_product_attention on the "
                         "same inputs (the yardstick)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("time_wide_kernels: needs an NVIDIA GPU")
    import chip_smoke as cs
    import mmlspark_torch.dl.flash_attention as k2
    import mmlspark_torch.dl.paged_attention as k3
    dev = torch.device("cuda", 0)
    for ptxas in cs.ptxas_summary(k2.build_wide_kernel()):
        print(f"ptxas {ptxas}", flush=True)
    if args.check:
        check(torch, cs, k2, k3, dev)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(71)
    label = f"{args.label}: " if args.label else ""

    def line(route, dtype, d, fn, plain=None):
        ms = cs.time_ms(fn, torch, runs=10, flush=flush)
        extra = ""
        if plain is not None and args.plain:
            plain_ms = cs.time_ms(plain, torch, runs=3, warmup=1,
                                  flush=flush)
            extra = f"; plain {plain_ms:.4f} ms"
        print(f"{label}{route} {str(dtype)[6:]} D={d}: {ms:.4f} ms{extra}",
              flush=True)

    for x, mask in cs.wide_inputs(torch, gen, dev, 4):
        d, dtype = x[0].shape[-1], x[0].dtype
        if args.sdpa:
            for causal in (False, True):
                fwd, bwd = cs.wide_sdpa(torch, x, mask, causal, x[3], flush)
                print(f"{label}SDPA{' causal' if causal else ''} "
                      f"{str(dtype)[6:]} D={d}: forward {fwd:.4f} ms, "
                      f"backward {bwd:.4f} ms", flush=True)
        line("K2a", dtype, d, lambda: k2.flash_cuda(*x[:3], mask),
             lambda: k2.flash_torch(*x[:3], mask))
        line("K2c", dtype, d, lambda: k2.flash_causal_cuda(*x[:3], mask),
             lambda: k2.flash_torch(*x[:3], mask, causal=True))
        for causal in (False, True):
            o, lse = k2.flash_lse_cuda(*x[:3], mask, causal=causal)
            a = (*x[:3], mask, x[3], lse, k2.flash_dsum(o, x[3]))
            ids = ("K2c-lse", "causal K2d", "causal K2e") if causal else \
                ("K2b", "K2d", "K2e")
            line(ids[0], dtype, d,
                 lambda: k2.flash_lse_cuda(*x[:3], mask, causal=causal),
                 lambda: k2.flash_lse_torch(*x[:3], mask, causal=causal))
            line(ids[1], dtype, d,
                 lambda: k2.flash_dq_cuda(*a, causal=causal),
                 lambda: k2.flash_dq_torch(*a, causal=causal))
            line(ids[2], dtype, d,
                 lambda: k2.flash_dkv_cuda(*a, causal=causal),
                 lambda: k2.flash_dkv_torch(*a, causal=causal))
        del x
    for hd, dtype in ((512, torch.bfloat16), (256, torch.float32)):
        c = cs.paged_case(torch, dev, 63, 32, 128, 16, 256, 8, hd, dtype)
        a = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
        line("K3 window", dtype, hd, lambda: k3.paged_cuda(*a),
             lambda: k3.paged_torch(*a))
        if args.sdpa:
            import torch.nn.functional as F
            S, w, BL, MB = 32, 128, 16, 256
            NB, L = c["k_pool"].shape[0], MB * BL
            idx = (c["rows"].long()[:, :, None] * BL
                   + torch.arange(BL, device=dev)).reshape(S, L)
            kd, vd = (t.view(NB * BL, 8, hd)[idx].transpose(1, 2)
                      .contiguous() for t in (c["k_pool"], c["v_pool"]))
            lim = c["pos"].long()[:, None] + torch.arange(w, device=dev)
            allowed = (torch.arange(L, device=dev)
                       <= lim[:, :, None])[:, None]
            line("SDPA on the gathered cache", dtype, hd,
                 lambda: F.scaled_dot_product_attention(
                     c["q"], kd, vd, attn_mask=allowed))
            del kd, vd, allowed
        del c
    print(f"{label}card: {torch.cuda.get_device_name(0)}, "
          f"{cs.nvidia_smi('power.limit')}")


if __name__ == "__main__":
    main()
