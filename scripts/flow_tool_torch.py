"""Optical-flow sanity CLI of the PyTorch port, the counterpart of
`scripts/flow_tool.py` (`gma/test.py` + `gma/utils/flow_viz.py`): the GMA
flow between two images (`adaface_tpu_torch/models/gma.py`, fp32 without
TF32), saved as a Middlebury colour-wheel PNG. The network is a torch GMA
checkpoint in the reference's layout (`gma-sintel.pth`, converted by
`models.gma.convert_gma_state_dict`) given by `--weights`, else random at
the JAX initialiser's scales from seed 0.

    python scripts/flow_tool_torch.py img1.png img2.png --out flow.png \
        [--weights gma-sintel.pth] [--device cpu]

The images (PNG, JPEG or BMP) are read by `utils.image.read_image` and resized to
`--size`² by `utils.image.resize_linear`, which is OpenCV's bilinear resize
(the JAX tool resizes with PIL's, whose antialiasing filter differs when it
shrinks). They go to `gma_flow` as [0, 255] pixels, the RAFT protocol
`gma_flow` is written for; the JAX tool hands it [-1, 1] values.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(argv=None) -> np.ndarray:
    """→ the flow [H, W, 2] (also written as a PNG to `--out`)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("img1")
    ap.add_argument("img2")
    ap.add_argument("--out", default="flow.png")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--size", type=int, default=256, help="resize inputs to this square size")
    ap.add_argument("--weights", default=None,
                    help="a torch GMA checkpoint (gma-sintel.pth layout); random when absent")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.core.device import fp32_convolutions
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.gma import (GMA, convert_gma_state_dict, flow_to_image,
                                              gma_flow, init_gma_weights_)
    from adaface_tpu_torch.tools.ckpt_lib import load_state_dict
    from adaface_tpu_torch.utils.image import read_image, resize_linear, to_rgb, write_png

    device = torch.device(args.device)

    def load(path):
        im = resize_linear(to_rgb(read_image(path)), (args.size, args.size))
        return torch.from_numpy(im.astype(np.float32).transpose(2, 0, 1)[None]).to(device)

    i1, i2 = load(args.img1), load(args.img2)
    gma = build(GMA, device, torch.float32, init_gma_weights_,
                torch.Generator(device).manual_seed(0))
    if args.weights:
        bridge.load(gma, convert_gma_state_dict(load_state_dict(args.weights)))
    with torch.inference_mode(), fp32_convolutions(matmuls=True):
        flow = gma_flow(gma, i1, i2, num_iters=args.iters)
    flow = flow[0].permute(1, 2, 0).cpu().numpy()  # [H, W, 2]
    write_png(args.out, flow_to_image(flow))
    mag = np.sqrt((flow ** 2).sum(-1))
    print(f"flow: mean |f| = {mag.mean():.3f}, max |f| = {mag.max():.3f} -> {args.out}")
    return flow


if __name__ == "__main__":
    main()
