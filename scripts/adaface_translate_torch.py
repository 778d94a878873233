"""Identity-transfer img2img CLI of the PyTorch port (the counterpart of
`scripts/adaface_translate.py`):

    python scripts/adaface_translate_torch.py --subject subj_pngs/ --in_images src/ \
        --out_dir out/ [--strength 0.8] [--randface] [--device cpu]

In-place translation of a folder (`--in_place`) and a random identity
(`--randface`) as in the JAX CLI. Images are PNGs.
"""

from __future__ import annotations

import argparse
import os

import torch

from _common_torch import add_model_args, build_wrapper, load_subject_images, save_images


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--subject", default=None)
    ap.add_argument("--randface", action="store_true")
    ap.add_argument("--in_images", required=True, help="PNG or folder of PNGs to translate")
    ap.add_argument("--prompt", default="portrait photo, high quality")
    ap.add_argument("--strength", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="out_translate")
    ap.add_argument("--in_place", action="store_true", help="overwrite inputs with translations")
    args = ap.parse_args(argv)
    if not (args.subject or args.randface):
        raise SystemExit("--subject or --randface required")

    wrapper = build_wrapper(args, "img2img")
    if args.randface:
        gen = torch.Generator(args.device).manual_seed(args.seed)
        face_id = torch.randn((1, 512), generator=gen, device=args.device)
        ada = wrapper.prepare_adaface_embeddings(face_id_embs=face_id)
    else:
        ada = wrapper.prepare_adaface_embeddings(images=load_subject_images(args.subject))
    if ada is None:
        raise SystemExit("no identity could be prepared")

    sources = load_subject_images(args.in_images)
    out_dir = (args.in_images if args.in_place and os.path.isdir(args.in_images)
               else args.out_dir)
    paths = []
    for i, src in enumerate(sources):
        out = wrapper.forward(args.prompt, init_image=src, strength=args.strength, num_images=1,
                              generator=torch.Generator(args.device).manual_seed(args.seed + i),
                              height=src.shape[0], width=src.shape[1])
        paths += save_images(out, out_dir, prefix=f"translate_{i:03d}")
    print(f"translated {len(sources)} images -> {out_dir}")
    return paths


if __name__ == "__main__":
    main()
