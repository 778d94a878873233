"""Generate a tiny synthetic training dataset for integration runs, without
PIL: the PyTorch port's counterpart of `scripts/make_toy_dataset.py`.

Two subjects x N images with fg masks, captions and metainfo.json, the
layout `PersonalizedBase` scans. Images are smooth random blobs with a
bright centred disc, so a brightness detector finds a stable "face" region.
The numpy streams are the JAX script's (`RandomState(1000 + subject)`) and
the upsampling is Pillow's BILINEAR in the host library
(`native.resize_pil`), so the decoded pixels equal that script's; the PNGs
are written by `utils.image.encode_png` (the bytes may differ by compressor).

    python scripts/make_toy_dataset_torch.py /tmp/toy_faces --n 4 --size 512
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from adaface_tpu_torch.native import resize_pil
from adaface_tpu_torch.utils.image import write_png

SUBJECTS = (("alice", "woman"), ("bob", "man"))


def make_image(rs: np.random.RandomState, size: int):
    base = rs.randint(30, 90, (size // 8, size // 8, 3), np.uint8)
    img = resize_pil(base, (size, size), "bilinear")
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = size / 2 + rs.uniform(-size / 8, size / 8)
    cx = size / 2 + rs.uniform(-size / 8, size / 8)
    r = size * rs.uniform(0.18, 0.25)
    disc = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)))
    img = np.clip(img.astype(np.float32) + disc[..., None] * 140, 0, 255).astype(np.uint8)
    return img, (cx, cy, r)


def make_mask(size: int, cx: float, cy: float, r: float) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    return (((yy - cy) ** 2 + (xx - cx) ** 2) <= (1.6 * r) ** 2).astype(np.uint8) * 255


def write_dataset(out: str, n: int = 4, size: int = 512) -> None:
    meta = {}
    for si, (name, cls) in enumerate(SUBJECTS):
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        rs = np.random.RandomState(1000 + si)
        for i in range(n):
            img, (cx, cy, r) = make_image(rs, size)
            write_png(os.path.join(d, f"{i}.png"), img)
            write_png(os.path.join(d, f"{i}_mask.png"), make_mask(size, cx, cy, r))
            with open(os.path.join(d, f"{i}.txt"), "w") as f:
                f.write(f"a photo of {name}")
        meta[name] = {"cls_delta_string": cls}
    with open(os.path.join(out, "metainfo.json"), "w") as f:
        json.dump(meta, f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args(argv)
    write_dataset(args.out, args.n, args.size)
    print(f"wrote 2 subjects x {args.n} images at {args.size}px -> {args.out}")


if __name__ == "__main__":
    main()
