"""Text→image inference CLI of the PyTorch port (the counterpart of
`scripts/adaface_infer.py`):

    python scripts/adaface_infer_torch.py --subject path/to/subject_pngs \
        --prompt "portrait at the beach" --out_dir out/ [--num_images 4] \
        [--base_model v1-5-pruned.safetensors] [--adaface_ckpt ckpt_dir] [--device cpu]

Subject images and outputs are PNGs.
"""

from __future__ import annotations

import argparse

import torch

from _common_torch import (add_model_args, build_wrapper, load_subject_images, save_image_grid,
                           save_images)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--subject", required=True, help="folder (or single PNG) of the subject")
    ap.add_argument("--prompt", default="portrait photo, high quality")
    ap.add_argument("--negative_prompt",
                    default="flaws in the eyes, flaws in the face, lowres, non-HDRi, low quality")
    ap.add_argument("--num_images", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="out")
    ap.add_argument("--grid", action="store_true", default=True)
    args = ap.parse_args(argv)

    wrapper = build_wrapper(args, "text2img")
    images = load_subject_images(args.subject)
    print(f"{len(images)} subject images")
    ada = wrapper.prepare_adaface_embeddings(images=images)
    if ada is None:
        raise SystemExit("no face detected in the subject images")
    out = wrapper.forward(args.prompt, negative_prompt=args.negative_prompt,
                          num_images=args.num_images,
                          generator=torch.Generator(args.device).manual_seed(args.seed),
                          height=args.size, width=args.size)
    paths = save_images(out, args.out_dir)
    if args.grid:
        print(f"wrote {save_image_grid(out, f'{args.out_dir}/grid.png')}")
    print(f"wrote {len(paths)} images to {args.out_dir}")
    return paths


if __name__ == "__main__":
    main()
