#!/usr/bin/env python3
"""Where the time of one pretraining step goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/profile_torch_train.py [--causal] [--docs 32] [--batch 8] [--steps 5]

On chip_smoke.py's training paths (its seeded documents → token ids → a
seeded ``MaskedLMModel`` over ``TextEncoder(vocab=32768, width=512,
depth=8, heads=8, mlp_dim=2048)``, bf16 compute, f32 parameters, batch 8,
the default AdamW): masked-LM pretraining (``TokenIdEncoder(maxLength=2048,
vocabSize=32767)``, ``make_attention_fn("pallas")``,
``pretrain_masked_lm``), or with ``--causal`` causal-LM pretraining
(``TokenIdEncoder(maxLength=2049, vocabSize=32768)``, chip_smoke.py's
causal LM with ``make_attention_fn("pallas", causal=True)``,
``pretrain_causal_lm``), it prints:

1. the seconds of a warm step without the profiler: the pretraining entry
   point for one step, then ``train_epoch`` over ``--steps`` more batches
   on the same state (so the optimizer's moments exist), ending in a
   synchronize;
2. a torch.profiler trace of one more step: device time by group (the
   flash forward by its template flags, K2a, K2b, K2c or K2c-lse; K2d and
   K2e, causal or not; the f32 LM head's GEMMs, the bf16 GEMMs, softmax and
   log-softmax, the optimizer, LayerNorm, elementwise, reductions, copies),
   the flash kernels' share together, the top kernels by name, the kernel
   count, and the busy share (device time over the unprofiled step; the
   profiler slows the host). The trace must file under each flash group
   as many kernels as its wrapper counted launches, or the run stops.

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (TEXT_SHAPE, TEXT_T, lm_model,  # noqa: E402
                        make_documents)

# the flash kernels by name and template flags: the forward is
# flash_fwd_*<D, kLse, kCausal>, the backward bwd_dq_*/bwd_dkv_*<D, kCausal>
FLASH = {("flash_fwd_", False, False): "K2a flash forward",
         ("flash_fwd_", True, False): "K2b flash forward with lse",
         ("flash_fwd_", False, True): "K2c causal flash forward",
         ("flash_fwd_", True, True): "K2c-lse causal forward with lse",
         ("bwd_dq_", False): "K2d flash backward dq",
         ("bwd_dq_", True): "causal K2d backward dq",
         ("bwd_dkv_", False): "K2e flash backward dk/dv",
         ("bwd_dkv_", True): "causal K2e backward dk/dv"}
# the other device kernels by name, first match wins
GROUPS = (("f32 GEMMs (the LM head)", ("sgemm", "gemm_f32")),
          ("bf16 GEMMs (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass",
                                   "gemv")),
          ("softmax / log-softmax", ("softmax",)),
          ("optimizer (AdamW)", ("adam", "multi_tensor", "foreach")),
          ("LayerNorm", ("layer_norm", "LayerNorm")),
          ("reductions", ("reduce",)),
          ("copies and fills", ("memcpy", "memset", "copy", "fill")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")))


def flags(low: str) -> list[bool]:
    """A kernel's bool template arguments, demangled by the profiler
    (``<64, true, false>``) or not (``Li64ELb1ELb0E``)."""
    found = re.findall(r"\b(true|false)\b", low)
    if found:
        return [f == "true" for f in found]
    return [f == "1" for f in re.findall(r"lb([01])e", low)]


def group_of(name: str) -> str:
    low = name.lower()
    for prefix in ("flash_fwd_", "bwd_dq_", "bwd_dkv_"):
        if prefix in low:
            n = 2 if prefix == "flash_fwd_" else 1
            return FLASH[(prefix, *flags(low)[:n])]
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--causal", action="store_true",
                    help="profile pretrain_causal_lm instead of "
                    "pretrain_masked_lm")
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
                                   pretrain_causal_lm, pretrain_masked_lm,
                                   train_epoch)
    from mmlspark_torch.featurize import TokenIdEncoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    vocab = TEXT_SHAPE["vocab"]
    texts, _ = make_documents(args.docs)
    rng = np.random.default_rng(1)
    if args.causal:
        ids = np.asarray(TokenIdEncoder(maxLength=TEXT_T + 1,
                                        vocabSize=vocab)
                         .transform(DataFrame({"text": texts}))["tokens"])
        model = lm_model(torch, "pallas")
        state, _ = pretrain_causal_lm(model, ids, steps=1,
                                      batch_size=args.batch)  # warm, builds

        def batch(rows):
            return rows[:, :-1], np.where(rows[:, 1:] != 0, rows[:, 1:],
                                          -1).astype(np.int32)
    else:
        ids = np.asarray(TokenIdEncoder(maxLength=TEXT_T, vocabSize=vocab - 1)
                         .transform(DataFrame({"text": texts}))["tokens"])
        gen = torch.Generator().manual_seed(0)
        model = MaskedLMModel(TextEncoder(
            **TEXT_SHAPE, attention_fn=make_attention_fn("pallas"),
            generator=gen), gen)
        state, _ = pretrain_masked_lm(model, ids, steps=1,
                                      batch_size=args.batch)  # warm, builds

        def batch(rows):
            return mask_batch(rows, rng, mask_id=vocab - 1)
    step = make_train_step(state.model, state.optimizer,
                           loss_fn=masked_xent)

    def batches(n):
        for _ in range(n):
            yield batch(ids[rng.integers(0, len(ids), size=args.batch)])

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
    # each flash group's wrapper counter: (wrapper, attribute)
    counters = {FLASH[("flash_fwd_", False, False)]: (k2.flash_cuda,
                                                      "launches"),
                FLASH[("flash_fwd_", True, False)]: (k2.flash_lse_cuda,
                                                     "launches"),
                FLASH[("flash_fwd_", False, True)]: (k2.flash_causal_cuda,
                                                     "launches"),
                FLASH[("flash_fwd_", True, True)]: (k2.flash_lse_cuda,
                                                    "causal_launches"),
                FLASH[("bwd_dq_", False)]: (k2.flash_dq_cuda, "launches"),
                FLASH[("bwd_dq_", True)]: (k2.flash_dq_cuda,
                                           "causal_launches"),
                FLASH[("bwd_dkv_", False)]: (k2.flash_dkv_cuda, "launches"),
                FLASH[("bwd_dkv_", True)]: (k2.flash_dkv_cuda,
                                            "causal_launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
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
    launches = {g: getattr(fn, attr) for g, (fn, attr) in counters.items()}
    print(f"profiled step: wall {wall:.4f} s (profiler on), device time "
          f"{device_us / 1e3:.3f} ms in {len(events)} device kernels and "
          f"copies; busy share {device_us / 1e6 / step_s:.3f} of the "
          f"unprofiled {step_s:.4f} s; flash launches: "
          + ", ".join(f"{g} {n}" for g, n in launches.items() if n))
    for group, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        share = us / max(device_us, 1e-9)
        print(f"  {us / 1e3:9.3f} ms  {n:6d} x  {share:6.3f}  {group}")
    flash_us = sum(by_group.get(g, [0.0])[0] for g in counters)
    print(f"the flash kernels together: {flash_us / 1e3:.3f} ms, "
          f"{flash_us / max(device_us, 1e-9):.3f} of the device time")
    for group, n in launches.items():
        traced = by_group.get(group, [0.0, 0])[1]
        if traced != n:
            sys.exit(f"profile_torch_train: the trace files {traced} kernels "
                     f"under {group!r}, its wrapper launched {n}")
    print("top kernels:")
    for name, times in sorted(by_name.items(),
                              key=lambda kv: -sum(kv[1]))[:25]:
        print(f"  {sum(times) / 1e3:9.3f} ms  {len(times):6d} x  "
              f"{name[:100]}")


if __name__ == "__main__":
    main()
