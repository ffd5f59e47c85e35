#!/usr/bin/env python3
"""How closely BERT-base's bf16 embeddings through K2a agree with the dense
attention's on chip_smoke.py phase 34's traffic, over several weight and
request seeds, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/control_bf16_agreement.py [--weight-seeds 0 1 2 3]
        [--request-seeds 34 35 36 37]

Phase 34's requests (``chip_smoke.control_traffic``: single documents of
64-512 WordPiece tokens cut from seeded windows of the phase's texts) go
through ``TextEncoderFeaturizer`` in batches of 32 in arrival order, once
with ``attentionImpl="pallas"`` (K2a) and once ``"dense"``, in bf16, and
once dense in float32 (TF32 off). For each weight seed (on request seed
34) and each request seed (on weight seed 0) it prints the K2a rows'
agreement with the dense bf16 rows (the smallest per-row cosine, raw and
centred on the dense rows' mean, and max |diff|; also max |diff| over the
rows of at most 128 tokens and over the longer ones), each bf16 route's
max |diff| from the f32 rows, and the planted fault's agreement (K2a with
the key mask dropped), then the worst reading of each over all runs.

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (BERT_BASE, CONTROL_BATCH, agreement,  # noqa: E402
                        bert_state_dict, control_traffic, make_documents,
                        padded_rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weight-seeds", type=int, nargs="+",
                    default=[0, 1, 2, 3])
    ap.add_argument("--request-seeds", type=int, nargs="+",
                    default=[34, 35, 36, 37])
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("control_bf16_agreement: needs an NVIDIA GPU")
    import mmlspark_torch.dl.flash_attention as k2
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    schema = register_bert_encoder("BertBaseControl",
                                   seq_len=BERT_BASE["max_len"], **BERT_BASE)
    texts, _ = make_documents(32)

    def frame(rows):
        col = np.empty(len(rows), object)
        col[:] = rows
        return DataFrame({"tokens": col})

    def reading(weight_seed, request_seed):
        tokens = control_traffic(texts, seed=request_seed)[0]
        batches = [tokens[i:i + CONTROL_BATCH]
                   for i in range(0, len(tokens), CONTROL_BATCH)]
        sd = bert_state_dict(torch, weight_seed)
        out = {}
        for name, impl, dtype in (("pallas", "pallas", torch.bfloat16),
                                  ("dense", "dense", torch.bfloat16),
                                  ("f32", "dense", torch.float32)):
            module = bert_encoder_from_torch(
                sd, config={"num_attention_heads": BERT_BASE["heads"]},
                dtype=dtype)
            stage = TextEncoderFeaturizer(
                attentionImpl=impl, model=LoadedModel(schema, module),
                inputCol="tokens", seqChunk=128)
            out[name] = np.concatenate([stage.transform(frame(b))["features"]
                                        for b in batches])
            if name == "pallas":
                no_mask = module.with_attention(
                    lambda q, k, v, key_mask=None: k2.flash_cuda(q, k, v,
                                                                 None))
                with torch.inference_mode():
                    out["fault"] = np.concatenate([
                        no_mask.to(dev).eval()(torch.from_numpy(
                            padded_rows(b)).to(dev))["pooled"].float()
                        .cpu().numpy() for b in batches])
                del no_mask
            del module, stage
            torch.cuda.empty_cache()
        short = np.asarray([len(t) for t in tokens]) <= 128
        got = agreement(out["pallas"], out["dense"])
        fault = agreement(out["fault"], out["dense"])
        diff = np.abs(out["pallas"] - out["dense"])
        vs32 = [float(np.abs(out[r] - out["f32"]).max())
                for r in ("pallas", "dense")]
        print(f"weights {weight_seed}, requests {request_seed}: pallas vs "
              f"dense raw {got[0]:.7f}, centred {got[1]:.7f}, max |diff| "
              f"{got[2]:.4g} (rows <= 128 tokens {diff[short].max():.4g}, "
              f"longer {diff[~short].max():.4g}); from f32: pallas "
              f"{vs32[0]:.4g}, dense {vs32[1]:.4g}; key mask dropped raw "
              f"{fault[0]:.7f}, centred {fault[1]:.7f}, max |diff| "
              f"{fault[2]:.4g}", flush=True)
        return got, fault

    runs = [(w, 34) for w in args.weight_seeds] + \
        [(0, r) for r in args.request_seeds if r != 34]
    got, fault = zip(*(reading(w, r) for w, r in runs))
    print(f"over {len(runs)} runs: pallas vs dense raw min "
          f"{min(g[0] for g in got):.7f}, centred min "
          f"{min(g[1] for g in got):.7f}, max |diff| max "
          f"{max(g[2] for g in got):.4g}; key mask dropped raw max "
          f"{max(f[0] for f in fault):.7f}, centred max "
          f"{max(f[1] for f in fault):.7f}, max |diff| min "
          f"{min(f[2] for f in fault):.4g}")


if __name__ == "__main__":
    main()
