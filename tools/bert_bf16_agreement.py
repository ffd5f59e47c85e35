#!/usr/bin/env python3
"""How closely BERT-base's bf16 embeddings through K2a agree with the dense
attention's, over several weight and document seeds, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 tools/bert_bf16_agreement.py [--weight-seeds 0 1 2 3 4 5 6 7]
        [--doc-seeds 5 6 7 8 9]

chip_smoke.py's phase 24 (bert-base-uncased's published config, a seeded
state dict in the HuggingFace layout through ``bert_encoder_from_torch``,
32 of ``make_documents``' texts cut to their first fifth, WordPiece over a
30,522-entry vocabulary, ``TextEncoderFeaturizer`` in bf16) runs once per
weight seed on document seed 5, then once per document seed on weight seed
0. For each it prints the pallas transform's agreement with the dense one
(the smallest per-row cosine, raw and centred on the dense rows' mean, and
max |diff|) and the same three for the planted fault (K2a with the key
mask dropped), then the worst reading of each over all runs.

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (BERT_BASE, agreement, bert_state_dict,  # noqa: E402
                        make_documents, wordpiece_vocab)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weight-seeds", type=int, nargs="+",
                    default=list(range(8)))
    ap.add_argument("--doc-seeds", type=int, nargs="+",
                    default=[5, 6, 7, 8, 9])
    ap.add_argument("--docs", type=int, default=32)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("bert_bf16_agreement: needs an NVIDIA GPU")
    import mmlspark_torch.dl.flash_attention as k2
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.dl import TextEncoderFeaturizer
    from mmlspark_torch.featurize import WordPieceTokenizerModel
    from mmlspark_torch.models import (LoadedModel, bert_encoder_from_torch,
                                       register_bert_encoder)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    T = BERT_BASE["max_len"]
    schema = register_bert_encoder("BertBase", seq_len=T, **BERT_BASE)

    def tokens(doc_seed):
        texts, lengths = make_documents(args.docs, seed=doc_seed)
        docs = np.asarray([" ".join(t.split()[:n // 5])
                           for t, n in zip(texts, lengths)], object)
        tok = WordPieceTokenizerModel.from_vocab(
            wordpiece_vocab(texts), maxLength=T, inputCol="text")
        return tok.transform(DataFrame({"text": docs}))

    def reading(weight_seed, doc_seed):
        ids = tokens(doc_seed)
        module = bert_encoder_from_torch(
            bert_state_dict(torch, weight_seed),
            config={"num_attention_heads": BERT_BASE["heads"]},
            dtype=torch.bfloat16)
        kw = dict(model=LoadedModel(schema, module), inputCol="tokens",
                  seqChunk=128)
        pooled, dense = (TextEncoderFeaturizer(attentionImpl=impl, **kw)
                         .transform(ids)["features"]
                         for impl in ("pallas", "dense"))
        rows = torch.from_numpy(np.asarray(ids["tokens"], np.int32)).to(dev)
        no_mask = module.with_attention(
            lambda q, k, v, key_mask=None: k2.flash_cuda(q, k, v, None))
        with torch.inference_mode():
            faulty = no_mask.to(dev).eval()(rows)["pooled"].float() \
                .cpu().numpy()
        got, fault = agreement(pooled, dense), agreement(faulty, dense)
        print(f"weights {weight_seed}, documents {doc_seed}: pallas vs "
              f"dense raw {got[0]:.7f}, centred {got[1]:.7f}, max |diff| "
              f"{got[2]:.4g}; key mask dropped raw {fault[0]:.7f}, centred "
              f"{fault[1]:.7f}, max |diff| {fault[2]:.4g}", flush=True)
        del module, no_mask
        torch.cuda.empty_cache()
        return got, fault

    runs = [(w, 5) for w in args.weight_seeds] + \
        [(0, d) for d in args.doc_seeds if d != 5]
    got, fault = zip(*(reading(w, d) for w, d in runs))
    print(f"over {len(runs)} runs: pallas vs dense raw min "
          f"{min(g[0] for g in got):.7f}, centred min "
          f"{min(g[1] for g in got):.7f}, max |diff| max "
          f"{max(g[2] for g in got):.4g}; key mask dropped centred max "
          f"{max(f[1] for f in fault):.7f}, max |diff| min "
          f"{min(f[2] for f in fault):.4g}")


if __name__ == "__main__":
    main()
