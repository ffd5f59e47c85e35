#!/usr/bin/env python3
"""Where the time of causal-LM serving goes, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/profile_torch_llm.py [--steps 10]

On chip_smoke.py's LLM path (the causal LM of ``bench.py:896-930``:
``TextEncoder(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)`` with
``make_attention_fn("pallas", causal=True)`` and an f32 LM head, seeded
weights; phase 10's 32 seeded prompts of 129 tokens) it prints:

1. a torch.profiler trace of one ``generate`` prefill (a warm call with one
   new token: the batched causal prefill through K2c and one decode step):
   device time by group and the busy share over the unprofiled call;
2. ``--steps`` steady decode steps of phase 11's round 3 (``LLMEngine``
   with 16 slots, ``block_len`` 16, all 16 slots decoding): the wall time of
   an unprofiled step, then a trace of as many more: device time by group
   (K3, K2c, the bf16 GEMMs, the f32 LM head, the scatter into the pools,
   LayerNorm, elementwise, argmax), device kernels and K3 launches per
   step, and the busy share (device time over the unprofiled steps' wall
   time; the profiler slows the host);
3. the host's share of an unprofiled step: ``block_rows``,
   ``ensure_capacity``, and the token fetch (which waits for the device).

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

from chip_smoke import GEN_BATCH, GEN_T, TEXT_SHAPE, lm_model  # noqa: E402

K2C, K3 = "K2c flash causal", "K3 paged attention"
# device kernels by name, first match wins (flash_fwd_* is K2c when its
# kCausal template flag is true)
GROUPS = ((K3, ("paged_fwd", "paged_f32", "paged_decode",
               "paged_combine")),
          ("f32 GEMMs (the LM head)", ("sgemm", "gemm_f32")),
          ("bf16 GEMMs (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass",
                                   "gemv")),
          ("scatter into the pools", ("index_copy", "indexcopy",
                                      "index_put", "scatter")),
          ("argmax", ("argmax",)),
          ("softmax", ("softmax",)),
          ("LayerNorm", ("layer_norm", "layernorm")),
          ("reductions", ("reduce",)),
          ("copies and fills", ("memcpy", "memset", "copy", "fill")),
          ("elementwise", ("elementwise", "vectorized", "unrolled")))


def zero_k3(k2, k3) -> None:
    """Zero the launch counts of K2c and K3's kernels."""
    k2.flash_causal_cuda.launches = k3.paged_cuda.launches = 0
    k3.paged_cuda.combine_launches = 0
    k3.paged_decode_cuda.launches = k3.paged_decode_cuda.combine_launches = 0


def k3_launches(k3) -> int:
    """K3's kernel launches: the window kernel's, the decode kernel's and
    the combine's (a call whose plan has more than one chunk launches
    both)."""
    return (k3.paged_cuda.launches + k3.paged_cuda.combine_launches
            + k3.paged_decode_cuda.launches
            + k3.paged_decode_cuda.combine_launches)


def group_of(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in low:
        # <D, kLse, kCausal>, demangled by the profiler or not
        causal = "false, true>" in low or "lb0elb1e" in low
        return K2C if causal else "K2a/K2b flash"
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_events(prof, torch):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def report(label, events, wall_s, launches, per=1):
    """Device time by group, ``per`` calls or steps in the trace, against
    ``wall_s`` seconds of the same work unprofiled. ``launches`` maps a
    kernel's group to its wrapper's launch count over the traced work; the
    trace must file exactly that many kernels under the group, so a kernel
    name the grouping misses stops the run."""
    by_group: dict[str, list] = {}
    for e in events:
        g = by_group.setdefault(group_of(e.name), [0.0, 0])
        g[0] += e.device_time
        g[1] += 1
    device_us = sum(g[0] for g in by_group.values())
    print(f"{label}: device time {device_us / 1e3 / per:.3f} ms in "
          f"{len(events) / per:.1f} device kernels and copies per step; busy "
          f"share {device_us / 1e6 / wall_s:.3f} of the unprofiled "
          f"{wall_s / per * 1e3:.3f} ms")
    for group, (us, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3 / per:9.4f} ms  {n / per:7.1f} x  "
              f"{us / max(device_us, 1e-9):6.3f}  {group}")
    for group, n in launches.items():
        traced = by_group.get(group, [0.0, 0])[1]
        if traced != n:
            sys.exit(f"profile_torch_llm: {label}: the trace files {traced} "
                     f"kernels under {group!r}, its wrapper launched {n}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("profile_torch_llm: needs an NVIDIA GPU")
    import mmlspark_torch.dl.flash_attention as k2
    import mmlspark_torch.dl.paged_attention as k3
    from mmlspark_torch.dl import generate
    from mmlspark_torch.obs import MetricsRegistry
    from mmlspark_torch.serving import LLMEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    model = lm_model(torch, "pallas").to(dev).eval()
    prompts = np.random.default_rng(11).integers(
        2, TEXT_SHAPE["vocab"], size=(GEN_BATCH, GEN_T)).astype(np.int32)

    # ---- 1. one generate prefill (and its one decode step)
    for _ in range(2):                    # the probe, builds, warm-up
        generate(model, prompts, max_new_tokens=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, prompts, max_new_tokens=1)
    wall = time.perf_counter() - t0
    zero_k3(k2, k3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generate(model, prompts, max_new_tokens=1)
        torch.cuda.synchronize()
    report(f"generate prefill ({GEN_BATCH} x {GEN_T - 1} prefix tokens and "
           "one decode step)", device_events(prof, torch), wall,
           {K2C: k2.flash_causal_cuda.launches, K3: k3_launches(k3)})

    # ---- 2. steady decode steps of phase 11's round 3
    eng = LLMEngine(model, slots=16, block_len=16, max_seq_len=18 * 16,
                    num_blocks=1 + 2 * 16 * 18, prefill_batch=4,
                    registry=MetricsRegistry(), device=dev)
    for i, p in enumerate(prompts):
        eng.submit(i, p, 128)
    for _ in range(3):                    # admit, prefill, decode warm-up
        eng.step()
    assert eng.decoder.active.all(), "every slot should be decoding"
    host = {"block_rows": 0.0, "ensure_capacity": 0.0, "token fetch": 0.0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name] += time.perf_counter() - t0
        return wrapper

    eng.kv.block_rows = timed("block_rows", eng.kv.block_rows)
    eng.kv.ensure_capacity = timed("ensure_capacity",
                                   eng.kv.ensure_capacity)
    real_cpu = torch.Tensor.cpu
    torch.Tensor.cpu = timed("token fetch", real_cpu)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        wall = time.perf_counter() - t0
    finally:
        torch.Tensor.cpu = real_cpu
    zero_k3(k2, k3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
    report(f"decode step (16 slots, steady, {args.steps} steps)",
           device_events(prof, torch), wall,
           {K2C: k2.flash_causal_cuda.launches, K3: k3_launches(k3)},
           per=args.steps)
    print(f"  K3 launches per step {k3_launches(k3) / args.steps:.1f} "
          f"(decode kernel {k3.paged_decode_cuda.launches}, its combine "
          f"{k3.paged_decode_cuda.combine_launches}, window kernel "
          f"{k3.paged_cuda.launches})")
    step_ms = wall / args.steps * 1e3
    for name, secs in host.items():
        ms = secs / args.steps * 1e3
        print(f"host per step: {name} {ms:.4f} ms ({ms / step_ms:.3f} of "
              f"the {step_ms:.3f} ms step)")


if __name__ == "__main__":
    main()
