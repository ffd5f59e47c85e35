#!/usr/bin/env python3
"""What the single per-row window path costs ``generate``'s cached decode
steps, against a path that writes an int start's window as a slice, on one
NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/time_decode_window.py [--new 64] [--runs 3]

On chip_smoke.py's causal LM (phase 10's: ``bench.py:896-930``'s
``TextEncoder(vocab=32768, width=512, depth=8, heads=8, mlp_dim=2048)``
with ``make_attention_fn("pallas", causal=True)`` and an f32 LM head,
seeded weights; 32 seeded prompts of 129 tokens) it prints ``generate``'s
decode ms per step, (t(new + 1 tokens) - t(1 token)) / new with each t the
median of ``--runs`` calls, at B = 32 and at B = 1, for two forms of
``EncoderBlock.decode_window`` and ``TextEncoder.embed_window``:

- ``shipped``: the package's one path, where an int start becomes a [B]
  tensor of starts, k/v are written by index and the mask is [B, 1, w, L];
- ``slice``: defined here, for an int start only, k/v written into
  ``cache[:, :, pos:pos + w]`` and one [w, L] mask.

The forms run in turns (shipped, slice, slice, shipped) in one process, and
their greedy tokens must be equal. It needs one GPU and imports nothing of
JAX.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_decode_window: needs an NVIDIA GPU")
    from mmlspark_torch.dl import generate
    from mmlspark_torch.dl.text_encoder import EncoderBlock, TextEncoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    shipped = {"decode_window": EncoderBlock.decode_window,
               "embed_window": TextEncoder.embed_window}

    def slice_decode_window(self, x_win, k_cache, v_cache, pos):
        w = x_win.shape[1]
        q, k, v = self._project_qkv(x_win)
        k_cache[:, :, pos:pos + w] = k
        v_cache[:, :, pos:pos + w] = v
        L = k_cache.shape[2]
        scale = (self.width // self.heads) ** -0.5
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         k_cache.float()) * scale
        keys = torch.arange(L, device=x_win.device)
        rows = pos + torch.arange(w, device=x_win.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache)
        return self.ffn(x_win + self._merge_out(o))

    def slice_embed_window(self, toks, pos):
        at = pos + torch.arange(toks.shape[1], device=toks.device)
        return self.embed(toks).to(self.dtype) + self.positions(at)[None]

    forms = {"shipped": shipped,
             "slice": {"decode_window": slice_decode_window,
                       "embed_window": slice_embed_window}}

    def use(form):
        EncoderBlock.decode_window = forms[form]["decode_window"]
        TextEncoder.embed_window = forms[form]["embed_window"]

    dev = torch.device("cuda")
    model = lm_model(torch, "pallas").to(dev).eval()
    prompts = np.random.default_rng(11).integers(
        2, TEXT_SHAPE["vocab"], size=(GEN_BATCH, GEN_T)).astype(np.int32)
    max_len = GEN_T + args.new + 1

    def timed(rows, n_new):
        generate(model, rows, max_new_tokens=n_new, max_len=max_len)
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            out = generate(model, rows, max_new_tokens=n_new,
                           max_len=max_len)
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), out

    tokens = {}
    for form in ("shipped", "slice", "slice", "shipped"):
        use(form)
        for B in (GEN_BATCH, 1):
            t_one, _ = timed(prompts[:B], 1)
            t_full, out = timed(prompts[:B], args.new + 1)
            tokens.setdefault((form, B), out)
            step = (t_full - t_one) / args.new
            print(f"{form}: B={B}, decode {step * 1e3:.3f} ms per step "
                  f"(prefill + one step {t_one:.4f} s; {args.new + 1} new "
                  f"{t_full:.4f} s; medians of {args.runs})", flush=True)
    use("shipped")
    for B in (GEN_BATCH, 1):
        same = np.array_equal(tokens[("shipped", B)], tokens[("slice", B)])
        print(f"B={B}: greedy tokens of the two forms "
              f"{'equal' if same else 'DIFFER'}")
        if not same:
            sys.exit(1)


if __name__ == "__main__":
    main()
