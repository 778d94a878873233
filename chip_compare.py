"""Time the kernels, a UNet call and requests of two checkouts on one card,
in turns.

    python3 chip_compare.py PARENT_DIR [CHANGE_DIR]

Each directory holds a checkout of this repository (CHANGE_DIR defaults to
the current one). The trees run in the order parent, change, change, parent,
each turn in a process of its own started in that tree, so each builds and
loads its own kernels. A turn prints, for every attention shape of the
serving path (q, k, v laid out as the UNet and the VAE lay them out), the
tree's kernel and the stock `F.scaled_dot_product_attention` as device time
per launch (20 launches in a CUDA graph) and as single launches (median of
10, CUDA events, the wrapper's host work included); the same two times for
every GroupNorm of the path through the tree's `group_norm_silu`, in the
memory format the tree's kernels take (channels-last, or NCHW for a tree from
before the redesign), beside `F.group_norm` (+ `F.silu`) in that format and
the function's bound, and their sums over a request; then one full-width
UNet call at CFG batch 2 (median of 5) and three 512x512, 25-step requests.
Compare numbers of one call of this script only: two calls may land on two
cards. A turn uses its own tree's `chip_smoke` for what every tree has
(`require_cuda`, `build_kernels`, `serve`) and the `chip_smoke` beside this
file for the cases, the inputs and the timing, which an older tree's may
lack.

    python3 chip_compare.py --profile-turn

profiles one UNet call and one VAE decode of the tree in the working
directory by kind of kernel (layout transposes, convolutions, copies, ...).
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
    from adaface_tpu_torch.ops import fused_gn as G

    new = beside()
    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)

    with torch.inference_mode():
        for label, b, h, sq, sk, d in new.FLASH_CASES:
            q, k, v = new.flash_inputs(gen, label, b, h, sq, sk, d)
            kernel = lambda: A._flash_cuda(q, k, v, None, False, 1.0 / math.sqrt(d))
            stock = lambda: F.scaled_dot_product_attention(q, k, v)
            print(f"flash {label:18s}: device alone kernel {new.graph_ms(kernel):.4f} ms stock "
                  f"{new.graph_ms(stock):.4f} ms | single launches kernel "
                  f"{new.median_ms(kernel):.4f} ms stock {new.median_ms(stock):.4f} ms",
                  flush=True)

        channels_last = hasattr(G, "GN_FUSED")  # else the tree's kernels take NCHW
        sums = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
        for label, shape, groups, eps, silu, per_call, per_decode in new.GN_CASES:
            x, scale, bias = new.gn_inputs(gen, shape)
            if not channels_last:
                x = x.contiguous()
            kernel = lambda: G.group_norm_silu(x, scale, bias, groups, eps, silu)
            act = F.silu if silu else (lambda t: t)
            stock = lambda: act(F.group_norm(x, groups, scale, bias, eps))
            dev, stock_dev = new.graph_ms(kernel), new.graph_ms(stock)
            least, _ = new.bound((2 * x.numel() + 2 * shape[1]) * x.element_size())
            n = new.gn_launches(per_call, per_decode)
            sums["kernel"] += n * dev
            sums["library"] += n * stock_dev
            sums["bound"] += n * least
            print(f"gn {label:28s} {shape} {'channels-last' if channels_last else 'NCHW'}: "
                  f"device alone kernel {dev:.4f} ms library {stock_dev:.4f} ms | single launches "
                  f"kernel {new.median_ms(kernel):.4f} ms library {new.median_ms(stock):.4f} ms | "
                  f"least {least:.4f} ms | x{n} a request", flush=True)
        print(f"gn per request: device alone kernel {sums['kernel']:.3f} ms library "
              f"{sums['library']:.3f} ms least {sums['bound']:.3f} ms", flush=True)

        unet = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=False)),
                     "cuda", torch.bfloat16, init_unet_weights_, gen)
        x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        t = torch.full((2,), 501, dtype=torch.long, device="cuda")
        ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        print(f"unet call CFG batch 2: {new.median_ms(lambda: unet(x, t, ctx), reps=5):.2f} ms",
              flush=True)
        del unet
        torch.cuda.empty_cache()
    served = c.serve(gen)
    print("requests: " + ", ".join(f"{x * 1e3:.1f}" for x in served["latencies"]) + " ms",
          flush=True)


def beside():
    """The `chip_smoke` beside this file, whatever tree a turn runs in: the
    newest cases, inputs and timing helpers, which an older tree's
    `chip_smoke` may lack."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_beside", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def profile_turn(top: int = 12) -> None:
    """Device time by kind of kernel for one full-width UNet call (CFG batch
    2, 64x64, bf16) and one VAE decode (1x4x64x64) of the tree in the working
    directory, with the GroupNorms routed to their plain version and then
    with the tree's own kernels: what the layout of the activations costs
    around the convolutions, with and without a kernel of ours in the way."""
    sys.path.insert(0, os.getcwd())
    import dataclasses
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from adaface_tpu_torch.core.params import build, init_fan_in_
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.models.vae import SD_VAE, VAEDecoder
    from adaface_tpu_torch.ops import fused_gn as G

    new = beside()
    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    unet = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=False)),
                 "cuda", torch.bfloat16, init_unet_weights_, gen)
    vae = build(lambda: VAEDecoder(SD_VAE), "cuda", torch.bfloat16, init_fan_in_, gen)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((2,), 501, dtype=torch.long, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    z = torch.randn((1, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)

    def report(label, fn):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        new.profile_report(prof, label, top)

    with torch.inference_mode():
        with mock.patch.object(G, "group_norm_silu", G.gn_silu_plain):
            report("unet call, plain GroupNorm", lambda: unet(x, t, ctx))
            report("vae decode, plain GroupNorm", lambda: vae(z))
        report("unet call, GroupNorm kernels", lambda: unet(x, t, ctx))
        report("vae decode, GroupNorm kernels", lambda: vae(z))


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--turn":
        turn()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--profile-turn":
        profile_turn()
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
