#!/usr/bin/env python3
"""Where the time of the wide-head-dim kernels (``dl/csrc/attn_wide.cu``)
goes, on one NVIDIA GPU: each kernel beside variants built from copies of
this checkout's source with one piece changed.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/probe_wide_variants.py

At ``chip_smoke.py``'s timed wide shape (``[2, 8, 1024, D]``, D = 512 in
bf16 and 256 in f32, the first row's last 100 keys masked) it times K2a in
both dtypes and K2e in both, and K3's window kernel at the phase-9 prefill
window (bf16, hd 512), for:

- ``base``: the kernels as committed;
- ``no exchange``: each CTA keeps its own partial scores (wrong output;
  the kernels without the cluster's sum);
- ``1xTF32``: f32's products as one TF32 product in place of three
  (wrong in the last digits: what the 3xTF32 products cost);

whether each variant's outputs are bit-equal to ``base``'s, then each
case's median of CUDA-event runs and the device time from
``torch.profiler`` (L2 flushed), the list walked forward then backward
(times move 10-17 % between runs), and beside them the built bf16
forward (``flash_attn.cu``) at D = 256. First ptxas's lines for the
variants' builds. The variants build into ``mmlspark_torch/_build/`` in
parallel. It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

from probe_kernel_variants import variant_loader  # noqa: E402

FILES = ("dl/csrc/attn_wide.cu", "dl/csrc/flash_common.cuh")
VARIANTS = {
    "base": (),
    "no exchange": (
        ("  const uint32_t slot = e.part + (buf * 4 + warp) * XCH + lane * 16;\n",
         "  const uint32_t slot = e.part + (buf * 4 + warp) * XCH + lane * 16;\n"
         "  if (e.nc > 0) return;\n"),),
    "1xTF32": (
        ("  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n",
         ""),),
}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_wide_variants: needs an NVIDIA GPU")
    import chip_smoke as cs
    import mmlspark_torch.dl.flash_attention as k2
    import mmlspark_torch.dl.paged_attention as k3

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    real = k2._library_wide()
    loaders = {name: variant_loader(f"wide {name}", FILES, subs)
               for name, subs in VARIANTS.items()}
    def load(ld):
        try:
            return ld.load()
        except RuntimeError as e:   # a variant ptxas refuses: say so, go on
            print(f"{ld.name}: build failed: {str(e)[-600:]}", flush=True)
            return None

    with ThreadPoolExecutor(len(loaders)) as ex:
        built = {k: v for k, v in zip(loaders, ex.map(load, loaders.values()))
                 if v is not None}
    for name, lib in built.items():
        for fn in ("mmlspark_wide_flash_launch", "mmlspark_wide_bwd_launch",
                   "mmlspark_wide_paged_launch"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        lib.mmlspark_wide_error_string.restype = \
            real.mmlspark_wide_error_string.restype
        for line in cs.ptxas_summary(loaders[name].build_log()):
            if "wide_" in line:
                print(f"{name}: {line}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(71)
    inputs = list(cs.wide_inputs(torch, gen, dev, 4))
    cases = []
    for x, mask in inputs:
        dt = str(x[0].dtype)[6:]
        o, lse = k2.flash_lse_cuda(*x[:3], mask)
        a = (*x[:3], mask, x[3], lse, k2.flash_dsum(o, x[3]))
        cases.append((f"K2a {dt}", lambda x=x, mask=mask:
                      k2.flash_cuda(*x[:3], mask)))
        cases.append((f"K2e {dt}", lambda a=a: k2.flash_dkv_cuda(*a)))
    c = cs.paged_case(torch, dev, 63, 32, 128, 16, 256, 8, 512,
                      torch.bfloat16)
    call = (c["q"], c["k_pool"], c["v_pool"], c["rows"], c["pos"])
    cases.append(("K3 window bf16", lambda: k3.paged_cuda(*call)))
    want = None
    for name in list(built) + list(built)[::-1]:
        k2._library_wide = k3._library_wide = lambda lib=built[name]: lib
        outs = [fn() for _, fn in cases]
        torch.cuda.synchronize()
        if want is None:
            want = outs
        same = all(torch.equal(torch.stack(list(a)) if isinstance(a, tuple)
                               else a, torch.stack(list(b))
                               if isinstance(b, tuple) else b)
                   for a, b in zip(outs, want))
        print(f"{name}: outputs {'bit-equal to' if same else 'differ from'} "
              "base's", flush=True)
        for case, fn in cases:
            ms = cs.time_ms(fn, torch, runs=10, flush=flush)
            dev_ms = cs.device_ms(torch, fn, ("wide_",), flush=flush)
            print(f"{name}, {case}: {ms:.4f} ms, device "
                  f"{dev_ms['wide_']:.4f} ms", flush=True)
    k2._library_wide = k3._library_wide = lambda: real
    # beside them, the built bf16 forward at D = 256 (flash_attn.cu): the
    # same rows and keys, a CTA's two units' columns in one kernel
    x = [torch.randn(2, 8, 1024, 256, generator=gen, device=dev,
                     dtype=torch.bfloat16) for _ in range(3)]
    fn = lambda: k2.flash_cuda(*x, inputs[0][1])  # noqa: E731
    print(f"flash_attn.cu K2a bf16 D=256: "
          f"{cs.time_ms(fn, torch, runs=10, flush=flush):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
