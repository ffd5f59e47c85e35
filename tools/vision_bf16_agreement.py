#!/usr/bin/env python3
"""How closely ResNet-50's and ViT-B/16's bf16 features agree with their f32
features through ImageFeaturizer, over several weight and image seeds, on
one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 tools/vision_bf16_agreement.py [--weight-seeds 0 1 2 3]
        [--image-seeds 29 30] [--images 512]

chip_smoke.py's phases 29-30 set up each run: a seeded torchvision-layout
state dict through ``module_from_torch`` in bf16 and in f32 (TF32 off),
``vision_images`` of 256 x 256 resized to 224 by ``autoResize``,
minibatches of 64. Each model runs once per weight seed on the first image
seed, then once per further image seed on weight seed 0. Each run prints
the smallest per-row cosine of the bf16 features against the f32 ones and
their max |diff| over the largest f32 value; the last lines give the worst
of each per model, which ``chip_smoke.VISION_BF16_LIMITS`` rests on.

It needs one GPU and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (VISION_BATCH, resnet50_state_dict,  # noqa: E402
                        row_agreement, vision_images, vit_b16_state_dict)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weight-seeds", type=int, nargs="+",
                    default=[0, 1, 2, 3])
    ap.add_argument("--image-seeds", type=int, nargs="+", default=[29, 30])
    ap.add_argument("--images", type=int, default=512)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("vision_bf16_agreement: needs an NVIDIA GPU")
    from mmlspark_torch.core import DataFrame
    from mmlspark_torch.image import ImageFeaturizer
    from mmlspark_torch.models import LoadedModel, get_model, module_from_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    runs = [(w, args.image_seeds[0]) for w in args.weight_seeds] + \
        [(args.weight_seeds[0], s) for s in args.image_seeds[1:]]
    images = {s: DataFrame({"image": vision_images(args.images, s)})
              for s in args.image_seeds}
    for name, make in (("ResNet50", resnet50_state_dict),
                       ("ViT_B_16", vit_b16_state_dict)):
        schema = get_model(name)
        worst_cos, worst_rel = 1.0, 0.0
        for weight_seed, image_seed in runs:
            sd = make(torch, weight_seed)
            feats = {}
            for dtype in (torch.bfloat16, torch.float32):
                stage = ImageFeaturizer(
                    model=LoadedModel(schema, module_from_torch(
                        sd, name, dtype=dtype)), miniBatchSize=VISION_BATCH)
                feats[dtype] = stage.transform(images[image_seed])[
                    "features"]
            cos, rel = row_agreement(feats[torch.bfloat16],
                                     feats[torch.float32])
            worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
            print(f"{name} weight seed {weight_seed} image seed "
                  f"{image_seed}: min per-row cosine {cos:.7f}, max |diff| "
                  f"{rel:.3e} of the largest", flush=True)
            del stage, feats
            torch.cuda.empty_cache()
        print(f"{name}: worst over {len(runs)} runs: min per-row cosine "
              f"{worst_cos:.7f}, max |diff| {worst_rel:.3e} of the largest")
    print(card)


if __name__ == "__main__":
    main()
