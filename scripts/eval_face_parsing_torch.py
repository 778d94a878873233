"""Face-parsing evaluation on the PyTorch port (the twin of
`scripts/eval_face_parsing.py`, the reference's `face_parsing/evaluate.py`).

Runs BiSeNet over a folder of face images and writes colour-coded parsing
overlays (0.4 image + 0.6 annotation, `train.face_parsing_train.
overlay_parsing`), and with a CelebAMask-HQ-style root (`images/` +
`labels/`) reports mIoU and pixel accuracy:

    python scripts/eval_face_parsing_torch.py --in_dir faces/ --out_dir vis/ \
        [--bisenet_ckpt 79999_iter.pth | face_parsing_ckpt.pt]
    python scripts/eval_face_parsing_torch.py --dataset_root celebamask/ \
        [--batches 50] [--batch_size 8]

Images are resized with Pillow's BILINEAR (the host library's); overlays
are written as PNGs named after their image. The checkpoint is the
reference's or one that `train_face_parsing_torch.py` saved. Runs on the
card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

from _common_torch import image_files
from gen_face_masks_torch import add_bisenet_args, build_parser, parse_image


def main(argv=None) -> dict:
    from adaface_tpu_torch import native
    from adaface_tpu_torch.train.face_parsing_train import (FaceMaskDataset,
                                                            evaluate_face_parsing,
                                                            overlay_parsing)
    from adaface_tpu_torch.utils.image import read_image, to_rgb, write_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in_dir", default=None, help="folder of face images")
    ap.add_argument("--out_dir", default="parsing_vis")
    ap.add_argument("--dataset_root", default=None,
                    help="images/ + labels/ root for mIoU scoring")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batches", type=int, default=None,
                    help="truncate the eval pass (default: the whole dataset)")
    ap.add_argument("--batch_size", type=int, default=8)
    add_bisenet_args(ap)
    args = ap.parse_args(argv)

    model = build_parser(args)
    result: dict = {"overlays": []}
    if args.dataset_root:
        ds = FaceMaskDataset(args.dataset_root, crop_size=args.size)
        metrics = evaluate_face_parsing(model, ds, batch_size=args.batch_size,
                                        max_batches=args.batches)
        ious = ", ".join(f"{v:.3f}" for v in metrics["per_class_iou"])
        print(f"mIoU {metrics['miou']:.4f}  pixel_acc {metrics['pixel_acc']:.4f}\n"
              f"per-class IoU: [{ious}]")
        result["metrics"] = metrics
    if args.in_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        for fn in image_files(args.in_dir, (".jpg", ".jpeg", ".png", ".webp")):
            img = to_rgb(read_image(os.path.join(args.in_dir, fn)))
            img = native.resize_pil(img, (args.size, args.size), "bilinear")
            vis = overlay_parsing(img, parse_image(model, img))
            out_path = os.path.join(args.out_dir, os.path.splitext(fn)[0] + ".png")
            write_png(out_path, vis)
            result["overlays"].append(out_path)
            print(f"wrote {out_path}")
    return result


if __name__ == "__main__":
    main()
