"""Parsing-based virtual makeup on the PyTorch port (the twin of
`scripts/makeup_demo.py`, the reference's `face_parsing/makeup.py`).

    python scripts/makeup_demo_torch.py --image face.jpg --out makeup.png \
        [--parsing parsing.png | --bisenet_ckpt 79999_iter.pth] \
        [--hair 100,200,100] [--upper_lip 230,50,20] [--lower_lip 230,50,20]

The photo is resized to `--size`² with Pillow's LANCZOS (the host
library's, bit for bit). The part labels come from a grey label PNG
(`--parsing`, NEAREST-resized) or from BiSeNet on the card (`--device cpu`
for the CPU; random weights without `--bisenet_ckpt`). Without a colour,
the hair goes (100, 200, 100), the reference's demo colour.
"""

from __future__ import annotations

import argparse

import numpy as np

from gen_face_masks_torch import add_bisenet_args, build_parser, parse_image


def _color(s):
    r, g, b = (int(v) for v in s.split(","))
    return (r, g, b)


def main(argv=None) -> np.ndarray:
    from adaface_tpu_torch import native
    from adaface_tpu_torch.utils.image import read_image, resize_nearest_pil, to_rgb, write_png
    from adaface_tpu_torch.utils.makeup import apply_makeup

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--parsing", default=None, help="part-label PNG; else BiSeNet")
    ap.add_argument("--size", type=int, default=512)
    for part in ("hair", "upper_lip", "lower_lip"):
        ap.add_argument(f"--{part}", type=_color, default=None,
                        help=f"target RGB for {part}, e.g. 230,50,20")
    add_bisenet_args(ap)
    args = ap.parse_args(argv)

    image = native.resize_pil(to_rgb(read_image(args.image)), (args.size, args.size), "lanczos")
    if args.parsing:
        parsing = resize_nearest_pil(read_image(args.parsing), (args.size, args.size))
    else:
        parsing = parse_image(build_parser(args), image)
    spec = {p: getattr(args, p) for p in ("hair", "upper_lip", "lower_lip")
            if getattr(args, p) is not None} or {"hair": (100, 200, 100)}
    out = apply_makeup(image, parsing, spec)
    write_png(args.out, out)
    print(f"wrote {args.out} (parts: {list(spec)})")
    return out


if __name__ == "__main__":
    main()
