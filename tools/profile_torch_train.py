#!/usr/bin/env python3
"""Where the time of one masked-LM pretraining step goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/profile_torch_train.py [--docs 32] [--batch 8] [--steps 5]

On chip_smoke.py's training path (its seeded documents →
``TokenIdEncoder(maxLength=2048, vocabSize=32767)`` → a seeded
``MaskedLMModel`` over ``TextEncoder(vocab=32768, width=512, depth=8,
heads=8, mlp_dim=2048)`` with ``make_attention_fn("pallas")``, bf16 compute,
f32 parameters, batch 8, the default AdamW) it prints:

1. the seconds of a warm step without the profiler: ``pretrain_masked_lm``
   for one step, then ``train_epoch`` over ``--steps`` more batches on the
   same state (so the optimizer's moments exist), ending in a synchronize;
2. a torch.profiler trace of one more step: device time by group (K2b, K2d,
   K2e, K2a, the f32 LM head's GEMMs, the bf16 GEMMs, softmax and
   log-softmax, the optimizer, LayerNorm, elementwise,
   reductions, copies), the top kernels by name, the kernel count, and the
   busy share (device time over the unprofiled step of 1; the profiler
   slows the host).

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

# device kernels by name, first match wins (the flash forward is K2b when
# its template flag kLse is true, K2a otherwise)
GROUPS = (("K2d flash backward dq", ("bwd_dq_",)),
          ("K2e flash backward dk/dv", ("bwd_dkv_",)),
          ("f32 GEMMs (the LM head)", ("sgemm", "gemm_f32")),
          ("bf16 GEMMs (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass",
                                   "gemv")),
          ("softmax / log-softmax", ("softmax",)),
          ("optimizer (AdamW)", ("adam", "multi_tensor", "foreach")),
          ("LayerNorm", ("layer_norm", "LayerNorm")),
          ("reductions", ("reduce",)),
          ("copies and fills", ("memcpy", "memset", "copy", "fill")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")))


def group_of(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in low:
        return ("K2b flash forward with lse" if "true" in low
                else "K2a flash forward")
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs an NVIDIA GPU")
    import mmlspark_torch.dl.flash_attention as k2
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import (MaskedLMModel, TextEncoder,
                                   make_attention_fn, make_train_step,
                                   mask_batch, masked_xent,
                                   pretrain_masked_lm, train_epoch)
    from mmlspark_torch.featurize import TokenIdEncoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    vocab = TEXT_SHAPE["vocab"]
    texts, _ = make_documents(args.docs)
    ids = np.asarray(TokenIdEncoder(maxLength=TEXT_T, vocabSize=vocab - 1)
                     .transform(DataFrame({"text": texts}))["tokens"])
    gen = torch.Generator().manual_seed(0)
    model = MaskedLMModel(TextEncoder(
        **TEXT_SHAPE, attention_fn=make_attention_fn("pallas"),
        generator=gen), gen)
    state, _ = pretrain_masked_lm(model, ids, steps=1,
                                  batch_size=args.batch)   # warm, builds
    step = make_train_step(state.model, state.optimizer,
                           loss_fn=masked_xent)
    rng = np.random.default_rng(1)

    def batches(n):
        for _ in range(n):
            rows = ids[rng.integers(0, len(ids), size=args.batch)]
            yield mask_batch(rows, rng, mask_id=vocab - 1)

    train_epoch(step, state, batches(1))                  # warm moments
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = train_epoch(step, state, batches(args.steps))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.steps
    print(f"warm step without the profiler: {step_s:.4f} s (mean of "
          f"{args.steps}; {args.batch / step_s:.2f} seqs/s); losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}")

    from torch.profiler import ProfilerActivity, profile
    counters = (k2.flash_cuda, k2.flash_lse_cuda, k2.flash_dq_cuda,
                k2.flash_dkv_cuda)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_epoch(step, state, batches(1))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a user annotation (the optimizer's "Optimizer.step#AdamW.step") spans
    # kernels that are counted on their own, so it is left out
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("Optimizer.")]
    by_name: dict[str, list] = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.device_time)
    device_us = sum(sum(v) for v in by_name.values())
    by_group: dict[str, list] = {}
    for name, times in by_name.items():
        g = by_group.setdefault(group_of(name), [0.0, 0])
        g[0] += sum(times)
        g[1] += len(times)
    print(f"profiled step: wall {wall:.4f} s (profiler on), device time "
          f"{device_us / 1e3:.3f} ms in {len(events)} device kernels and "
          f"copies; launches K2a {k2.flash_cuda.launches}, K2b "
          f"{k2.flash_lse_cuda.launches}, K2d {k2.flash_dq_cuda.launches}, "
          f"K2e {k2.flash_dkv_cuda.launches}; busy share "
          f"{device_us / 1e6 / step_s:.3f} of the unprofiled {step_s:.4f} s")
    for group, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        share = us / max(device_us, 1e-9)
        print(f"  {us / 1e3:9.3f} ms  {n:6d} x  {share:6.3f}  {group}")
    print("top kernels:")
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:25]:
        print(f"  {sum(times) / 1e3:9.3f} ms  {len(times):6d} x  "
              f"{name[:100]}")


if __name__ == "__main__":
    main()
