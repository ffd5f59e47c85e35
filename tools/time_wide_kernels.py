#!/usr/bin/env python3
"""The wide-head-dim attention kernels (``csrc/attn_wide.cu``) of this
checkout on one NVIDIA GPU: every route at ``chip_smoke.py``'s timed wide
shape, and with ``--check`` each one held against its plain version first.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/time_wide_kernels.py [--label NAME] [--check] [--plain]
        [--sdpa] [--split]

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
gathered beforehand) with the backend it picked (read from the kernels of
one call in ``torch.profiler``). ``--split`` times the K2 routes at the
split kernels' head dims instead (``split_fwd``/``split_dq``/``split_dkv``:
bf16 2176, f32 1152; no K3) and prints each route's bound: the larger of
its operations over the card's rate for the type (``chip_smoke.wide_peak``:
989 TFLOP/s for bf16, 495 / 3 for f32 in 3xTF32, as phase 5 bounds the
wide routes) and its bytes over the card's memory rate, and beside it the
time of its operations at 67 TFLOP/s, the CUDA cores' f32 rate on which
the split kernels run. To compare two trees on one card, run it from each
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
    ap.add_argument("--split", action="store_true",
                    help="time the split kernels' head dims (bf16 2176, "
                         "f32 1152) with each route's bound, no K3")
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

    bw = cs.memory_bandwidth(torch)[0] if args.split else None

    def line(route, dtype, d, fn, plain=None, work=None):
        ms = cs.time_ms(fn, torch, runs=10, flush=flush)
        extra = ""
        if plain is not None and args.plain:
            plain_ms = cs.time_ms(plain, torch, runs=3, warmup=1,
                                  flush=flush)
            extra = f"; plain {plain_ms:.4f} ms"
        if work is not None and bw is not None:
            peak, rate = cs.wide_peak(torch, dtype)
            bound_ms, by = cs.bound(*work, bw, peak)
            extra += (f"; bound {bound_ms:.4f} ms by {by} "
                      f"({work[0] / 1e9:.1f} GFLOP at {rate}, "
                      f"{work[1] / 1e6:.1f} MB at {bw / 1e12:.3f} TB/s); "
                      f"its operations at 67 TFLOP/s (CUDA cores) "
                      f"{work[0] / cs.F32_PEAK_FLOPS * 1e3:.4f} ms")
        print(f"{label}{route} {str(dtype)[6:]} D={d}: {ms:.4f} ms{extra}",
              flush=True)

    def sdpa_backend(x, mask):
        """The backend SDPA picks here, from its kernels' names."""
        import torch.nn.functional as F
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            F.scaled_dot_product_attention(
                *x[:3], attn_mask=mask[:, None, None, :])
            torch.cuda.synchronize()
        names = " ".join(e.key for e in prof.key_averages()).lower()
        for key, backend in (("flash", "flash"), ("cudnn", "cuDNN"),
                             ("fmha", "memory-efficient"),
                             ("efficient", "memory-efficient")):
            if key in names:
                return backend
        return "math"

    dims = ((2176, "bfloat16"), (1152, "float32")) if args.split else \
        ((512, "bfloat16"), (256, "float32"))
    for x, mask in cs.wide_inputs(torch, gen, dev, 4, dims):
        B, H, T, d = x[0].shape
        dtype = x[0].dtype
        tensor, rows = x[0].numel() * x[0].element_size(), B * H * T * 4
        if args.sdpa:
            picked = sdpa_backend(x, mask)
            for causal in (False, True):
                fwd, bwd = cs.wide_sdpa(torch, x, mask, causal, x[3], flush)
                print(f"{label}SDPA{' causal' if causal else ''} "
                      f"{str(dtype)[6:]} D={d}: forward {fwd:.4f} ms, "
                      f"backward {bwd:.4f} ms (backend: {picked})",
                      flush=True)

        def work(n_ops, n_tensors, n_rows, causal):
            return (n_ops * cs.wide_pairs(mask, H, causal) * d,
                    n_tensors * tensor + n_rows * rows + B * T)
        line("K2a", dtype, d, lambda: k2.flash_cuda(*x[:3], mask),
             lambda: k2.flash_torch(*x[:3], mask), work(4, 4, 0, False))
        line("K2c", dtype, d, lambda: k2.flash_causal_cuda(*x[:3], mask),
             lambda: k2.flash_torch(*x[:3], mask, causal=True),
             work(4, 4, 0, True))
        for causal in (False, True):
            o, lse = k2.flash_lse_cuda(*x[:3], mask, causal=causal)
            a = (*x[:3], mask, x[3], lse, k2.flash_dsum(o, x[3]))
            ids = ("K2c-lse", "causal K2d", "causal K2e") if causal else \
                ("K2b", "K2d", "K2e")
            line(ids[0], dtype, d,
                 lambda: k2.flash_lse_cuda(*x[:3], mask, causal=causal),
                 lambda: k2.flash_lse_torch(*x[:3], mask, causal=causal),
                 work(4, 4, 1, causal))
            line(ids[1], dtype, d,
                 lambda: k2.flash_dq_cuda(*a, causal=causal),
                 lambda: k2.flash_dq_torch(*a, causal=causal),
                 work(6, 5, 2, causal))
            line(ids[2], dtype, d,
                 lambda: k2.flash_dkv_cuda(*a, causal=causal),
                 lambda: k2.flash_dkv_torch(*a, causal=causal),
                 work(8, 6, 2, causal))
        del x
    for hd, dtype in (() if args.split else
                      ((512, torch.bfloat16), (256, torch.float32))):
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
