"""Time the flash kernels, a UNet call and requests of two checkouts on one
card, in turns.

    python3 chip_compare.py PARENT_DIR [CHANGE_DIR]

Each directory holds a checkout of this repository (CHANGE_DIR defaults to
the current one). The trees run in the order parent, change, change, parent,
each turn in a process of its own started in that tree, so each builds and
loads its own kernels. A turn prints, for every attention shape of the
serving path (q, k, v laid out as the UNet and the VAE lay them out), the
tree's kernel and the stock `F.scaled_dot_product_attention` as device time
per launch (20 launches in a CUDA graph) and as single launches (median of
10, CUDA events, the wrapper's host work included); then one full-width UNet
call at CFG batch 2 (median of 5) and three 512x512, 25-step requests.
Compare numbers of one call of this script only: two calls may land on two
cards. A turn uses its own tree's `chip_smoke` for what every tree has
(the shapes, `median_ms`, `serve`) and this file's own input layout and
CUDA-graph timing, which an older tree's `chip_smoke` may lack.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys


def turn() -> None:
    """One tree's measurements; runs with the tree as working directory."""
    sys.path.insert(0, os.getcwd())
    import dataclasses

    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.ops import attention as A

    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)

    def inputs(label, b, h, sq, sk, d):
        mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        split = lambda t: t.reshape(b, -1, h, d).transpose(1, 2)
        q = split(mk(b, sq, h * d))
        if "cross" in label:
            k, v = (split(t) for t in mk(b, sk, 2 * h * d).split(h * d, dim=-1))
        else:
            k, v = split(mk(b, sk, h * d)), split(mk(b, sk, h * d))
        return q, k, v

    def graph_ms(fn, launches=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
        return c.median_ms(graph.replay, reps=5, warmup=2) / launches

    with torch.inference_mode():
        for label, b, h, sq, sk, d in c.FLASH_CASES:
            q, k, v = inputs(label, b, h, sq, sk, d)
            kernel = lambda: A._flash_cuda(q, k, v, None, False, 1.0 / math.sqrt(d))
            stock = lambda: F.scaled_dot_product_attention(q, k, v)
            print(f"flash {label:18s}: device alone kernel {graph_ms(kernel):.4f} ms stock "
                  f"{graph_ms(stock):.4f} ms | single launches kernel {c.median_ms(kernel):.4f} "
                  f"ms stock {c.median_ms(stock):.4f} ms", flush=True)
        unet = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=False)),
                     "cuda", torch.bfloat16, init_unet_weights_, gen)
        x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        t = torch.full((2,), 501, dtype=torch.long, device="cuda")
        ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        print(f"unet call CFG batch 2: {c.median_ms(lambda: unet(x, t, ctx), reps=5):.2f} ms",
              flush=True)
        del unet
        torch.cuda.empty_cache()
    served = c.serve(gen)
    print("requests: " + ", ".join(f"{x * 1e3:.1f}" for x in served["latencies"]) + " ms",
          flush=True)


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--turn":
        turn()
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__)
        return 2
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else ".")
    for name, tree in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        print(f"== {name}: {tree}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn"], cwd=tree,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
