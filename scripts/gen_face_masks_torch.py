"""Generate the `*_mask.png` face masks of training data on the PyTorch
port (the twin of `scripts/gen_face_masks.py`).

    python scripts/gen_face_masks_torch.py --in_dir subjects/alice \
        [--bisenet_ckpt 79999_iter.pth] [--min_face_frac 0.01] [--trash_dir t/]

Each photo is resized to `--size`² with Pillow's BICUBIC (the host
library's, bit for bit), parsed by BiSeNet, its face classes (1-13) made a
0/255 mask, and the mask resized back to the photo's size with NEAREST. A
photo whose parsed face covers less than `--min_face_frac` is moved to
`--trash_dir` (or skipped) and gets no mask. BiSeNet runs on the card
unless `--device cpu`; `--bisenet_ckpt` takes the reference's checkpoint or
one of `train_face_parsing_torch.py`, else the weights are random.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from _common_torch import image_files

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def add_bisenet_args(ap) -> None:
    ap.add_argument("--bisenet_ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build_parser(args):
    """The eval-mode BiSeNet of `--bisenet_ckpt` (random, seed 0, without)."""
    from adaface_tpu_torch.models.bisenet import load_bisenet

    device = torch.device(args.device)
    model = load_bisenet(args.bisenet_ckpt, device, torch.Generator(device).manual_seed(0))
    print(f"loaded BiSeNet weights from {args.bisenet_ckpt}" if args.bisenet_ckpt else
          "WARNING: random BiSeNet weights: the parsing is only for pipeline smoke tests")
    return model


@torch.inference_mode()
def parse_image(model, image: np.ndarray) -> np.ndarray:
    """An RGB uint8 [S, S, 3] image → its [S, S] class map."""
    x = (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    x = torch.from_numpy(x.transpose(2, 0, 1)[None].copy())
    device = next(model.parameters()).device
    return model(x.to(device)).argmax(1)[0].cpu().numpy()


def main(argv=None) -> dict:
    from adaface_tpu_torch import native
    from adaface_tpu_torch.models.bisenet import parsing_to_face_mask
    from adaface_tpu_torch.utils.image import read_image, resize_nearest_pil, to_rgb, write_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--min_face_frac", type=float, default=0.01)
    ap.add_argument("--trash_dir", default=None)
    ap.add_argument("--overwrite", action="store_true")
    add_bisenet_args(ap)
    args = ap.parse_args(argv)

    model = build_parser(args)
    kept, trashed, fracs = [], [], {}
    for fn in image_files(args.in_dir, (".jpg", ".jpeg", ".png", ".webp")):
        out_path = os.path.join(args.in_dir, os.path.splitext(fn)[0] + "_mask.png")
        if os.path.exists(out_path) and not args.overwrite:
            continue
        img = to_rgb(read_image(os.path.join(args.in_dir, fn)))
        small = native.resize_pil(img, (args.size, args.size), "bicubic")
        mask = parsing_to_face_mask(parse_image(model, small))
        face_frac = fracs[fn] = float((mask > 0).mean())
        if face_frac < args.min_face_frac:
            trashed.append(fn)
            if args.trash_dir:
                os.makedirs(args.trash_dir, exist_ok=True)
                shutil.move(os.path.join(args.in_dir, fn), os.path.join(args.trash_dir, fn))
                print(f"{fn}: face area {face_frac:.3f} < {args.min_face_frac} → trashed")
            else:
                print(f"{fn}: face area {face_frac:.3f} too small — skipped")
            continue
        write_png(out_path, resize_nearest_pil(mask, (img.shape[1], img.shape[0])))
        kept.append(out_path)
    print(f"masks written: {len(kept)}; filtered: {len(trashed)}")
    return {"masks": kept, "filtered": trashed, "face_frac": fracs}


if __name__ == "__main__":
    main()
