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
the function's bound, and their sums over a request; `bn_stats` at every
batch norm shape of the face parser beside `torch.batch_norm_stats`, and
`layer_norm` at every LayerNorm shape of the UNet beside `F.layer_norm`, with
their sums over a train step and a fused-LN request; then one full-width
UNet call at CFG batch 2 in the default and in the fused-LN configuration
(median of 5), three 512x512, 25-step requests and the face-parser train
steps of the tree's `chip_smoke.py`.
Compare numbers of one call of this script only: two calls may land on two
cards. A turn uses its own tree's `chip_smoke` for what every tree has
(`require_cuda`, `build_kernels`, `serve`) and the `chip_smoke` beside this
file for the cases, the inputs and the timing, which an older tree's may
lack.

    python3 chip_compare.py --sweep

times `bn_stats` and `layer_norm` of the tree in the working directory over
launch geometries at every path shape (how `bn_plan` and `ln_plan` were set).

    python3 chip_compare.py --flash-rows

times the wgmma flash kernel with 64 and with 128 query rows a block at every
UNet shape, at CFG batch 2 and at batch 16, beside the stock op (how
`flash_plan`'s rule for the rows was checked).

    python3 chip_compare.py --flash-bwd-plans

times the wgmma backward's dk/dv and dq kernels at both geometries (64 or
128 keys / queries a block) at every attention shape of the training path at UNet batches 2, 4, 8, 12 and
16, beside `flash_bwd_plan`'s choice, each held to the plan's bits (how the
plan's rule was set).

    python3 chip_compare.py --flash-bwd PARENT_DIR [CHANGE_DIR]

times the flash backward of two trees in turns (parent, change, change,
parent): `torch.autograd.grad` through each tree's own `flash_attention` at
every attention shape of the training path (Stage 1 at batch 16, Stage 2 at
12, the recon's face-masked self-attention at 4, the VAE decoder's D 512 at
2 and 3), as the device time of one call (torch.profiler, kernels only; at
D 512 also by kernel) and as 20 calls back to back (CUDA events), beside
the library's backward; then one Stage-1 micro-step at 4 teacher steps
(device time under the profiler, host time) and seconds per optimizer step
(a 6-micro-step fit through each tree's `chip_smoke.train_step_split` and
`Trainer.fit`). `--flash-bwd-kernels` runs the same turns without the
Stage-1 micro-step and fit.

    python3 chip_compare.py --gn-bwd-plans

times the GroupNorm backward over geometries (the fused kernel's cluster
and stages, the split pair's threads and blocks an SM) at every
training shape, UNet batches 2-16 and decoder batches 1-3, beside
`gn_bwd_plan`'s choice (how the plan's rule was set).

    python3 chip_compare.py --gn-bwd PARENT_DIR [CHANGE_DIR]

times the GroupNorm backward of two trees in turns (parent, change, change,
parent): `torch.autograd.grad` through each tree's own `group_norm_silu` at
every UNet map at batch 16 and every decoder map at batches 2 and 3 (device
time of one call under torch.profiler, and 20 calls back to back), then the
backward of a Stage-1 micro-step at 4 teacher steps and of a recon
micro-step, each with its GroupNorm backward's device time by kernel.

    python3 chip_compare.py --profile-turn

profiles one UNet call and one VAE decode of the tree in the working
directory by kind of kernel (layout transposes, convolutions, copies, ...).

    python3 chip_compare.py --d64

times the wgmma kernel's D 64 instance at every D 64 shape of the SDXL and
SD3 paths (`chip_smoke.FLASH_XL_CASES`), in turns with the wide kernel (the
route D 64 took before it had an instance: the same call with D 64 left out
of `WG_KSTEPS`) and `F.scaled_dot_product_attention` (wgmma, wide, sdpa,
sdpa, wide, wgmma), each as device time (20 launches in a CUDA graph) and
held to the plain version, beside the bound.

    python3 chip_compare.py --d64-caps

builds copies of `csrc/flash_attn_wgmma.cu` alone, three times, with the
D 64 instance's register cap changed (blocks an SM for 64- and 128-row
blocks: (2, 1), (3, 2), (4, 1); the source's `wg_min_blocks` rule gives it
(3, 1)), prints each build's registers and spills for that instance, and
times each at the D 64 shapes with 64 and with 128 query rows a block, in
turns (how the instance's cap was set).

    python3 chip_compare.py --sd15-bits PARENT_DIR [CHANGE_DIR]

one SD1.5 512x512, 25-step request of each tree's `chip_smoke.build_server`
modules (seed 0, generator seed 100), each tree in its own process; the two
images compared bit for bit.

    python3 chip_compare.py --face-parser-folder PARENT_DIR [CHANGE_DIR]

the face parser's published configuration trained from the JPEG folder of
`tests/data/images/face_parser` through each tree's
`chip_smoke.train_face_parser_folder` (steps/sec with the batch's host
preparation, which it prints), in turns parent, change, change, parent.

    python3 chip_compare.py --dp-faults

the Stage-1 fit of `chip_smoke.train_dp` once more beside two gloo pairs
with a fault planted in the gradients' all-reduce: the ranks' gradients
averaged where they are summed ("mean"), and not reduced at all, each rank
on its own half ("none"); each pair's rank 0 against the single process in
the distances `train_dp` bounds (the losses, the gradient norms, the
update's relative L2), so that the bounds sit between the sound fit's
readings and these.

    python3 chip_compare.py --tp-faults

`chip_smoke.train_tp`'s unet-distill micro-step at tp 2 (two gloo ranks on
the card, full SD1.5 width) against one process, sound and with each of two
faults planted (`tp_fault`: `o`'s bias added on every rank; the GEGLU cut as
JAX's contiguous column split lays it out), in bf16 through the kernels and
in fp32 plain with TF32 off: where `chip_smoke.py`'s bf16 bounds sit
between the sound readings and the faults'.

    python3 chip_compare.py --dp-adv-faults

the adversarial branch's attacked noise (`_adv_attacked_noise`,
`chip_smoke.ADV_BS` attacked rows of a global batch of 4 at 512x512, a
random VAE decoder and ArcFace) in one process and on two gloo ranks on
the card, the ranks sound and with a fault planted in each of the branch's
reductions ("max": the magnitude's max of each rank's own rows; "mean": the
fg-masked mean of each rank's own rows), each against the single process's
attack on the whole batch and on the ranks' row groups (`train_dp`'s two
readings), with the decoder in bf16 through the kernels, in bf16 with its
attention and GroupNorms plain, and in fp32 plain with TF32 off (no fp32
flash backward): how far the row groups' attack lies from the whole
batch's at each precision, and where `chip_smoke.py`'s fixed bounds sit
between the sound readings and the faults'.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import subprocess
import sys


def turn() -> None:
    """One tree's measurements; runs with the tree as working directory."""
    sys.path.insert(0, os.getcwd())
    import dataclasses
    import inspect

    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.ops import fused_ln as L
    from adaface_tpu_torch.ops import fused_norm as N

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
        for label, shape, groups, eps, silu, by_path in new.GN_CASES:
            n = new.gn_launches(by_path, unet=new.UNET_CALLS, decode=1)
            if not n:  # not on a text-to-image request's path
                continue
            x, scale, bias = new.gn_inputs(gen, shape)
            if not channels_last:
                x = x.contiguous()
            kernel = lambda: G.group_norm_silu(x, scale, bias, groups, eps, silu)
            act = F.silu if silu else (lambda t: t)
            stock = lambda: act(F.group_norm(x, groups, scale, bias, eps))
            dev, stock_dev = new.graph_ms(kernel), new.graph_ms(stock)
            least, _ = new.bound((2 * x.numel() + 2 * shape[1]) * x.element_size())
            sums["kernel"] += n * dev
            sums["library"] += n * stock_dev
            sums["bound"] += n * least
            print(f"gn {label:28s} {shape} {'channels-last' if channels_last else 'NCHW'}: "
                  f"device alone kernel {dev:.4f} ms library {stock_dev:.4f} ms | single launches "
                  f"kernel {new.median_ms(kernel):.4f} ms library {new.median_ms(stock):.4f} ms | "
                  f"least {least:.4f} ms | x{n} a request", flush=True)
        print(f"gn per request: device alone kernel {sums['kernel']:.3f} ms library "
              f"{sums['library']:.3f} ms least {sums['bound']:.3f} ms", flush=True)

        sums = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
        for label, r, ch, _, dtype, per_step in new.BN_CASES:
            x = (torch.randn((r, ch), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            kernel = lambda: N.bn_stats(x, new.BN_EPS)
            stock = lambda: torch.batch_norm_stats(x, new.BN_EPS)
            dev, stock_dev = new.graph_ms(kernel), new.graph_ms(stock)
            least, _ = new.bound(x.numel() * x.element_size() + 8 * ch)
            sums["kernel"] += per_step * dev
            sums["library"] += per_step * stock_dev
            sums["bound"] += per_step * least
            print(f"bn_stats {label:20s} R{r} C{ch} {dtype}: device alone kernel {dev:.4f} ms "
                  f"library {stock_dev:.4f} ms | single launches kernel "
                  f"{new.median_ms(kernel):.4f} ms library {new.median_ms(stock):.4f} ms | "
                  f"least {least:.4f} ms | x{per_step} a train step", flush=True)
        print(f"bn_stats per train step: device alone kernel {sums['kernel']:.4f} ms library "
              f"{sums['library']:.4f} ms least {sums['bound']:.4f} ms", flush=True)

        sums = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
        for label, rows, ch, dtype, per_call in new.LN_CASES:
            x = (torch.randn((rows, ch), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            w = (torch.randn((ch,), generator=gen, device="cuda") + 1.0).to(dtype)
            b = (torch.randn((ch,), generator=gen, device="cuda") * 0.1).to(dtype)
            kernel = lambda: L.layer_norm(x, w, b, 1e-5)
            stock = lambda: F.layer_norm(x, (ch,), w, b, 1e-5)
            dev, stock_dev = new.graph_ms(kernel), new.graph_ms(stock)
            least, _ = new.bound((2 * x.numel() + 2 * ch) * x.element_size())
            n = new.UNET_CALLS * per_call
            sums["kernel"] += n * dev
            sums["library"] += n * stock_dev
            sums["bound"] += n * least
            print(f"layer_norm {label:16s} [{rows}, {ch}] {dtype}: device alone kernel {dev:.4f} "
                  f"ms library {stock_dev:.4f} ms | single launches kernel "
                  f"{new.median_ms(kernel):.4f} ms library {new.median_ms(stock):.4f} ms | host "
                  f"per call kernel {new.host_us(kernel):.1f} us library "
                  f"{new.host_us(stock):.1f} us | least {least:.4f} ms | x{n} a fused-LN request",
                  flush=True)
        print(f"layer_norm per fused-LN request: device alone kernel {sums['kernel']:.3f} ms "
              f"library {sums['library']:.3f} ms least {sums['bound']:.3f} ms", flush=True)

        x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
        t = torch.full((2,), 501, dtype=torch.long, device="cuda")
        ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
        for fused_ln in (False, True):
            unet = build(lambda: UNet2DConditionModel(
                dataclasses.replace(SD15_UNET, fused_ln=fused_ln)),
                "cuda", torch.bfloat16, init_unet_weights_, gen)
            print(f"unet call CFG batch 2{', fused-LN configuration' if fused_ln else ''}: "
                  f"{new.median_ms(lambda: unet(x, t, ctx), reps=5):.2f} ms", flush=True)
            del unet
            torch.cuda.empty_cache()
    # a tree from before the batcher builds its server inside `serve`
    served = (c.serve(gen) if "gen" in inspect.signature(c.serve).parameters
              else c.serve(*c.build_server(gen)))
    print("requests: " + ", ".join(f"{x * 1e3:.1f}" for x in served["latencies"]) + " ms; "
          f"{len(served['latencies']) / served['total']:.3f} imgs/sec", flush=True)
    trained = c.train_face_parser(gen)
    print(f"face-parser training: {trained['steps_per_sec']:.3f} steps/sec; step times "
          + ", ".join(f"{x * 1e3:.1f}" for x in trained["secs"]) + " ms", flush=True)


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


def sweep_norm_plans() -> None:
    """Device time (20 launches in a CUDA graph) of `bn_stats` over launch
    geometries (threads a block, blocks an SM, bytes of a row a block spans,
    least rows a thread) at every batch norm shape of the face parser, and of
    `layer_norm` over threads a block at every LayerNorm shape of the UNet,
    in the tree in the working directory; the geometry `bn_plan` / `ln_plan`
    picks is marked. Run as `python3 chip_compare.py --sweep`."""
    sys.path.insert(0, os.getcwd())
    import itertools

    import torch

    import chip_smoke as c
    from adaface_tpu_torch.ops import fused_ln as L
    from adaface_tpu_torch.ops import fused_norm as N

    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with torch.inference_mode():
        print(f"launch floor {c.launch_floor_ms() * 1e3:.2f} us", flush=True)
        for label, r, ch, _, dtype, _ in c.BN_CASES:
            x = (torch.randn((r, ch), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            chosen = N.bn_plan(r, ch, dtype, sms)
            seen = {}
            for threads, waves, tile, least in itertools.product(
                    (128, 256, 512), (1, 2, 4), (128, 256, 512), (2, 4, 8)):
                plan = N.bn_plan(r, ch, dtype, sms, True, threads, waves, tile, least)
                if plan not in seen:
                    seen[plan] = c.graph_ms(lambda: N.bn_stats(x, c.BN_EPS, plan)) * 1e3
            lib = c.graph_ms(lambda: torch.batch_norm_stats(x, c.BN_EPS)) * 1e3
            best = sorted(seen.items(), key=lambda kv: kv[1])
            print(f"bn_stats {label} R{r} C{ch} {dtype}: library {lib:.2f} us; the plan's "
                  f"{seen[chosen]:.2f} us {chosen}; {len(seen)} geometries, best first: "
                  + "; ".join(f"{us:.2f} t{p.threads} l{p.lanes} k{p.chunks}x{p.grid(ch)[1]}"
                              for p, us in best[:6])
                  + f"; worst {best[-1][1]:.2f} us", flush=True)
        # the UNet's shapes, then more rows of its widest row: where the split stops winning
        extra = [(f"{rows} rows of 1280", rows, 1280, torch.bfloat16, 0)
                 for rows in (1024, 2048, 8192)]
        for label, rows, ch, dtype, _ in c.LN_CASES + extra:
            x = (torch.randn((rows, ch), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            w = torch.ones(ch, device="cuda", dtype=dtype)
            b = torch.zeros(ch, device="cuda", dtype=dtype)
            chosen = L.ln_plan(rows, ch, dtype, sms)
            rows_plan = L.ln_plan(L.SPLIT_MAX_ROWS + 1, ch, dtype, sms)  # never split
            times = {}
            for threads in (32, 64, 128, 256):
                plan = L.LnPlan(rows_plan.packs, rows_plan.lanes, threads)
                times[threads] = c.graph_ms(lambda: L.layer_norm(x, w, b, 1e-5, plan)) * 1e3
            split = ""
            warps, rest = divmod(ch * x.element_size() // 16, 32)
            if rest == 0 and 2 <= warps <= L.MAX_SPLIT:
                plan = L.LnPlan(1, 32, 32 * warps, warps)
                us = c.graph_ms(lambda: L.layer_norm(x, w, b, 1e-5, plan)) * 1e3
                split = f"; a row over {warps} warps {us:.2f} us"
            loop = c.graph_ms(lambda: L.layer_norm(x, w, b, 1e-5, L.LnPlan(0, 32, 256))) * 1e3
            lib = c.graph_ms(lambda: torch.nn.functional.layer_norm(x, (ch,), w, b, 1e-5)) * 1e3
            print(f"layer_norm {label} [{rows}, {ch}] {dtype}: library {lib:.2f} us; the looped "
                  f"kernel {loop:.2f} us{split}; in registers, {rows_plan.lanes} lanes x "
                  f"{rows_plan.packs} packs, by threads a block: "
                  + ", ".join(f"{t}: {us:.2f}" for t, us in times.items())
                  + f" us; the plan's: {chosen}", flush=True)


def flash_rows() -> None:
    """Device time of the wgmma kernel at both block sizes, in turns 64, 128,
    128, 64, at every UNet attention shape of `chip_smoke.py` (q, k, v laid
    out as the UNet lays them out), beside `flash_plan`'s choice and the
    stock op."""
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A

    c.require_cuda()
    c.build_kernels()
    lib = _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    with torch.inference_mode():
        for label, b, h, sq, sk, d in c.FLASH_CASES[:-1] + c.FLASH_CASES_B16:
            q, k, v = c.flash_inputs(gen, label, b, h, sq, sk, d)
            plan, _, _, strides = A._prepare(q, k, v, True)
            out = torch.empty_strided((b, h, sq, d), (sq * h * d, d, h * d, 1), dtype=q.dtype,
                                      device="cuda")

            def launch(rows):
                _build.check(lib.flash_fwd_bf16_wg(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), strides,
                    b, h, sq, sk, d, 0, 1.0 / math.sqrt(d), rows, None,
                    torch.cuda.current_stream().cuda_stream), "flash_fwd_bf16_wg")

            ms = {rows: [] for rows in (64, 128)}
            for rows in (64, 128, 128, 64):
                ms[rows].append(c.graph_ms(lambda: launch(rows)))
            stock = c.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            print(f"flash {label:28s} the plan takes {plan.block_rows} rows: 64 rows "
                  f"{ms[64][0]:.4f}, {ms[64][1]:.4f} ms | 128 rows {ms[128][0]:.4f}, "
                  f"{ms[128][1]:.4f} ms | stock {stock:.4f} ms", flush=True)


def flash_bwd_plans() -> None:
    """Device time of each geometry of the wgmma backward kernels (20 launches
    in a CUDA graph) at every training-path shape and batch, beside the plan's
    choice; every geometry's gradients equal to the plan's, bit for bit."""
    sys.path.insert(0, os.getcwd())
    import dataclasses

    import torch

    import chip_smoke as c
    from adaface_tpu_torch.ops import attention as A

    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(label, *dims) for label, _, *dims in c.FLASH_CASES[:-1]]
    with torch.inference_mode():
        for b in (2, 4, 8, 12, 16):
            for label, h, sq, sk, d in shapes:
                q, k, v = c.flash_inputs(gen, label, b, h, sq, sk, d)
                scale = 1.0 / math.sqrt(d)
                out, stats = A._flash_cuda(q, k, v, None, False, scale, with_stats=True)
                g = torch.randn((b, sq, h * d), generator=gen, device="cuda").to(q.dtype)
                g = g.reshape(b, sq, h, d).transpose(1, 2)
                plan = A.flash_bwd_plan(q.dtype, b, h, sq, sk, d, sms)
                want = A._flash_bwd_kernels(plan, q, k, v, None, out, g, False, scale, True,
                                            True, stats)

                def run(p, dq, dkdv):
                    return A._flash_bwd_kernels(p, q, k, v, None, out, g, False, scale, dq, dkdv,
                                                stats)

                delta = c.graph_ms(lambda: run(plan, False, False))
                rows = []
                for kb in (64, 128):
                    p = dataclasses.replace(plan, key_block=kb)
                    same = all(torch.equal(x, y)
                               for x, y in zip(run(p, False, True)[1:], want[1:]))
                    ms = c.graph_ms(lambda: run(p, False, True)) - delta
                    rows.append(f"dkdv {kb} keys {ms:.4f}{'' if same else ' DIFFERENT BITS'}")
                for qb in (64, 128):
                    p = dataclasses.replace(plan, query_block=qb)
                    same = torch.equal(run(p, True, False)[0], want[0])
                    ms = c.graph_ms(lambda: run(p, True, False)) - delta
                    rows.append(f"dq {qb} queries {ms:.4f}{'' if same else ' DIFFERENT BITS'}")
                print(f"flash bwd B{b:2d} {label:18s}: delta {delta:.4f} | " + " | ".join(rows)
                      + f" | plan {plan.key_block} keys, {plan.query_block} queries", flush=True)
                del q, k, v, out, stats, g, want
                torch.cuda.empty_cache()


def flash_bwd_turn(fit: bool = True) -> None:
    """One tree's flash backward and (`fit`) Stage-1 micro-step; runs with
    the tree as working directory."""
    sys.path.insert(0, os.getcwd())
    import collections
    import dataclasses
    import statistics
    import tempfile
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    import train_torch
    from adaface_tpu_torch.ops import attention as A

    new = beside()
    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)

    def device_events(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] += e.device_time / 1e3
        return by_name

    def device_ms(fn):
        return sum(device_events(fn).values())

    for label, b, h, sq, sk, d in (new.FLASH_BWD_CASES + new.FLASH_BWD_STAGE2 + new.FLASH_BWD_RECON
                                   + new.FLASH_BWD_VAE + new.FLASH_BWD_STAGE2_VAE):
        q, k, v = (t.detach().requires_grad_() for t in new.flash_inputs(gen, label, b, h, sq,
                                                                           sk, d))
        mask = new.face_mask(b, 64) if label.startswith("recon masked") else None
        with torch.enable_grad():
            out = A.flash_attention(q, k, v, mask)
        g = torch.randn((b, sq, h * d), generator=gen, device="cuda").to(q.dtype)
        g = g.reshape(b, sq, h, d).transpose(1, 2)
        kernel = lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)  # noqa: E731
        library, backend = new.flash_library_backward(
            q, k, v, g, ("FLASH_ATTENTION",) if mask is None and d <= 256 else
            ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"), mask)
        split = ""
        if d > 256:  # the D 512 backward by kernel (the recompute of out is not in it)
            split = " (" + ", ".join(f"{name[:60]} {ms:.4f}" for name, ms in
                                     sorted(device_events(kernel).items())) + ")"
        print(f"flash bwd {label:32s}: device kernel {device_ms(kernel):.4f} ms{split} library "
              f"{device_ms(library):.4f} ms ({backend}) | 20 back to back kernel "
              f"{new.run_ms(kernel):.4f} ms library {new.run_ms(library):.4f} ms", flush=True)
        del q, k, v, out, g, kernel, library
        torch.cuda.empty_cache()
    if not fit:
        return

    repo = os.getcwd()
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = c.write_train_photos(os.path.join(tmp, "photos"))
        cfg, args = train_torch.parse_args([
            "--base", os.path.join(repo, c.TRAIN_CONFIG), "--data_roots", data, "--log_dir",
            os.path.join(tmp, "logs"), "--max_steps", str(new.TRAIN_MICRO_STEPS)])
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
        post, stamps = trainer._post_step, []

        def watch(step, f, metrics):
            stamps.append(time.perf_counter())
            post(step, f, metrics)

        trainer._post_step = watch
        trainer.fit(dataset, num_steps=args.max_steps, start_step=start)
        torch.cuda.synchronize()
        gaps = [b_ - a for a, b_ in zip(stamps, stamps[1:])]
        per_update = trainer.cfg.accum_steps * statistics.mean(gaps)
        splits = [c.train_step_split(trainer, dataset, new.TRAIN_MICRO_STEPS + i) for i in range(3)]
        fl = dataclasses.replace(trainer.planner.plan(new.TRAIN_MICRO_STEPS + 3),
                                 num_denoising_steps=4)
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], fl,
                                       trainer.draws_for(fl))
        step_fn = trainer._get_step(fl)
        step = lambda: step_fn(trainer.state, batch)  # noqa: E731
        step()
        _, wall_ms = new.sync_ms(step)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            new.sync_ms(step)
        by_kind = collections.Counter()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kind = "flash backward" if "flash_bwd" in e.name else (
                    "flash forward" if "flash_fwd" in e.name else "other")
                by_kind[kind] += e.device_time / 1e3
        print(f"stage-1: seconds per optimizer step {per_update:.3f} (accumulation "
              f"{trainer.cfg.accum_steps} x the mean gap between micro-steps, gaps "
              f"{', '.join(f'{x:.3f}' for x in gaps)} s); a micro-step at 4 teacher steps: "
              f"{wall_ms:.1f} ms on the host clock, device {sum(by_kind.values()):.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by_kind.items())) + ")", flush=True)
        for sp in splits:
            print(f"stage-1: split at {sp['steps']} teacher steps: student forward + backward "
                  f"{sp['student_ms']:.1f} ms, total {sp['total_ms']:.1f} ms", flush=True)


# the GroupNorm backward's training shapes for the sweep: (C, H = W) of every
# UNet map at UNet batches 2-16 and every VAE decoder map at batches 1-3
GN_BWD_SWEEP_UNET_BATCHES = (2, 3, 4, 8, 12, 16)
GN_BWD_SWEEP_DECODER_BATCHES = (1, 2, 3)


def gn_bwd_plans() -> None:
    """Device time of the GroupNorm backward (20 calls of `gn_silu_bwd` as a
    CUDA graph: one launch fused, two split) over geometries at every
    training shape and batch, beside `gn_bwd_plan`'s choice (marked *): the
    fused kernel at clusters of 1 to 16 blocks (where the tiles fit) and at 1
    stage against the plan's stages, the split pair at (threads, blocks an
    SM) of (256, 4), (256, 2), (512, 2), (512, 1), (128, 8); every
    variant's dx within bf16's
    rounding of the plan's (how the plan's rule was set). Run as
    `python3 chip_compare.py --gn-bwd-plans`."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from adaface_tpu_torch.ops import fused_gn as G

    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    unet_maps = sorted({(ch, hw) for _, ch, hw, *_ in c.UNET_GN}, key=lambda m: (-m[1], m[0]))
    decoder_maps = [(ch, hw) for _, ch, hw, _, dec, _ in c.VAE_GN if dec]
    shapes = ([(b, ch, hw) for b in GN_BWD_SWEEP_UNET_BATCHES for ch, hw in unet_maps]
              + [(b, ch, hw) for b in GN_BWD_SWEEP_DECODER_BATCHES for ch, hw in decoder_maps])
    for b, ch, hw in shapes:
        rows = hw * hw
        x, scale, bias = c.gn_inputs(gen, (b, ch, hw, hw))
        g = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        g = g.contiguous(memory_format=torch.channels_last)
        _, stats = G._gn_forward(x, scale, bias, 32, 1e-5, True, with_stats=True)
        plan = G.gn_bwd_plan(x.dtype, b, ch, rows, 32, sms)
        want = G.gn_silu_bwd(x, scale, bias, g, 32, stats, True, need=(False, False),
                             plan=plan)[0].float()
        scale_of = max(1.0, want.abs().max().item())
        variants = []
        for cluster in (1, 2, 4, 8, 16):
            for stages in (None, 1):
                p = G.fused_bwd_geometry(x.dtype, ch, rows, 32, cluster, stages=stages)
                if p.smem <= G.SMEM_BYTES and (stages is None or p.stage_rows < rows / cluster):
                    variants.append((f"fused {cluster}" + (" 1 stage" if stages else ""), p))
        for threads, waves in ((256, 4), (256, 2), (512, 2), (512, 1), (128, 8)):
            variants.append((f"split {threads}x{waves}",
                             G.split_bwd_geometry(x.dtype, b, ch, rows, 32, sms, threads, waves)))
        cells = []
        for name, p in variants:
            run = lambda: G.gn_silu_bwd(x, scale, bias, g, 32, stats, True,  # noqa: E731
                                        need=(False, False), plan=p)
            try:
                err = (run()[0].float() - want).abs().max().item() / scale_of
                ms = c.graph_ms(run)
            except RuntimeError as e:  # a cluster the card cannot co-schedule
                cells.append(f"{name} refused ({str(e).splitlines()[0][:60]})")
                continue
            mark = " *" if p == plan else ""
            cells.append(f"{name} {ms:.4f}{mark}" + ("" if err <= c.BF16_TOL else f" ERR {err:.2e}"))
        bound_ms = c.bound(3 * x.numel() * x.element_size())[0]
        print(f"gn bwd B{b:2d} {ch:4d}x{hw}^2: bound {bound_ms:.4f} | " + " | ".join(cells)
              + f" | plan {plan.kernel} {plan.chunks}", flush=True)
        del x, g, stats, want
        torch.cuda.empty_cache()


def gn_bwd_turn() -> None:
    """One tree's GroupNorm backward and training micro-steps; runs with the
    tree as working directory. At every UNet map at batch 16 and every VAE
    decoder map at batches 2 and 3 (x requiring grad, as in the frozen
    UNets and the decoder): `torch.autograd.grad` through the tree's own
    `group_norm_silu`, as the device time of one call (torch.profiler,
    kernels only) and as 20 calls back to back (CUDA events). Then one
    Stage-1 micro-step at 4 teacher steps and one recon micro-step on images
    (finetuning, batch 2): the backward alone under the profiler, its
    device time, and the GroupNorm backward's share by kernel (a `gn_stats`
    launch that a `gn_bwd_reduce` follows is the backward's; `gn_fused`,
    `gn_norm` and the other `gn_stats` inside a backward are the decoder's
    recomputed forward)."""
    sys.path.insert(0, os.getcwd())
    import collections
    import dataclasses
    import gc
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    import train_torch
    from adaface_tpu_torch.core.device import fp32_convolutions
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.train.face_detect import HostFaceDetector
    from adaface_tpu_torch.train.train_step import unet_distill_loss_fn

    new = beside()
    c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)

    def device_events(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)

    def gn_backward(events):
        """(GroupNorm backward ms, its launches by kernel, the backward's
        recomputed GroupNorm forward ms) of a backward's device events."""
        kinds = [(e, re.search(r"gn_(stats|norm|fused|bwd_fused|bwd_reduce|bwd_dx)_kernel",
                               e.name)) for e in events]
        gn = [(e, m.group(1)) for e, m in kinds if m]
        by, ms, fwd = collections.Counter(), 0.0, 0.0
        for (e, kind), after in zip(gn, [e for e, _ in gn[1:]] + [None]):
            backward = kind.startswith("bwd") or (
                kind == "stats" and after is not None and "gn_bwd_reduce" in after.name)
            if backward:
                by[kind] += 1
                ms += e.device_time / 1e3
            else:
                fwd += e.device_time / 1e3
        return ms, dict(by), fwd

    shapes = ([(f"{label} batch 16", (16, ch, hw, hw), eps, silu)
               for label, ch, hw, eps, silu, _ in new.UNET_GN]
              + [(f"vae {label} batch {b}", (b, ch, hw, hw), 1e-6, silu)
                 for b in (2, 3) for label, ch, hw, silu, dec, _ in new.VAE_GN if dec])
    for label, shape, eps, silu in shapes:
        x0, scale, bias = new.gn_inputs(gen, shape)
        x = x0.detach().requires_grad_()
        with torch.enable_grad():
            y = G.group_norm_silu(x, scale, bias, 32, eps, silu)
        g = torch.randn(shape, generator=gen, device="cuda").to(x.dtype)
        g = g.contiguous(memory_format=torch.channels_last)
        call = lambda: torch.autograd.grad(y, (x,), g, retain_graph=True)  # noqa: E731
        events = device_events(call)
        print(f"gn bwd {label:34s}: device {sum(e.device_time for e in events) / 1e3:.4f} ms in "
              f"{len(events)} launches | 20 back to back {new.run_ms(call):.4f} ms", flush=True)
        del x0, x, y, g
        torch.cuda.empty_cache()

    repo = os.getcwd()
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=repo) as tmp:
        data = c.write_train_photos(os.path.join(tmp, "photos"))
        cfg, args = train_torch.parse_args([
            "--base", os.path.join(repo, c.TRAIN_CONFIG), "--data_roots", data, "--log_dir",
            os.path.join(tmp, "logs"), "--max_steps", "1"])
        trainer, dataset, _ = train_torch.build_trainer(cfg, args)
        fl = dataclasses.replace(trainer.planner.plan(0), num_denoising_steps=4)
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], fl,
                                       trainer.draws_for(fl))

        def stage1_backward():
            loss, _ = unet_distill_loss_fn(trainer.state.params, trainer.frozen, batch,
                                           trainer.schedule, trainer.tcfg)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                loss.backward()
                torch.cuda.synchronize()
            return prof

        stage1_backward()
        events = sorted((e for e in stage1_backward().events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        gn_ms, by, _ = gn_backward(events)
        print(f"stage-1: a student backward at 4 teacher steps (UNet batch "
              f"{4 * trainer.cfg.batch_size}): device {sum(e.device_time for e in events) / 1e3:.2f}"
              f" ms in {len(events)} launches; GroupNorm backward {gn_ms:.3f} ms ({by})",
              flush=True)
        del trainer, dataset, batch
        gc.collect()
        torch.cuda.empty_cache()

        cfg, args = train_torch.parse_args([
            "--base", os.path.join(repo, c.FINETUNE_CONFIG), "--data_roots", data, "--log_dir",
            os.path.join(tmp, "logs2"), "--max_steps", "1"])
        trainer, dataset, _ = train_torch.build_trainer(cfg, args)
        trainer.host_detector = HostFaceDetector(detector_fn=new.central_face)
        fl = trainer.planner.plan(0)
        batch = trainer._prepare_batch([dataset[i] for i in range(trainer.cfg.batch_size)], fl,
                                       trainer.draws_for(fl))

        def recon_backward():
            for p in trainer.state.optimizer.params:
                p.grad = None
            loss, _ = new.recon_loss_for(trainer, fl)(trainer.state.params, trainer.frozen,
                                                      batch, trainer.schedule, trainer.tcfg,
                                                      trainer.draws_for(fl, loss=True))
            torch.cuda.synchronize()
            with fp32_convolutions(), profile(activities=[ProfilerActivity.CUDA]) as prof:
                loss.backward()
                torch.cuda.synchronize()
            return prof

        recon_backward()
        events = sorted((e for e in recon_backward().events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        gn_ms, by, fwd_ms = gn_backward(events)
        print(f"recon: a micro-step's backward on images (UNet batch {trainer.cfg.batch_size}, "
              f"the decoder recomputed): device {sum(e.device_time for e in events) / 1e3:.2f} ms"
              f" in {len(events)} launches; GroupNorm backward {gn_ms:.3f} ms ({by}); the "
              f"recomputed GroupNorm forward {fwd_ms:.3f} ms", flush=True)


def d64_turns() -> None:
    """The D 64 instance against the wide kernel and the library, in turns."""
    sys.path.insert(0, os.getcwd())
    from unittest import mock

    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from adaface_tpu_torch.ops import attention as A

    card = c.require_cuda()
    c.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    cases = [case for case in c.FLASH_XL_CASES if case[-1] == 64]
    with torch.inference_mode():
        for label, b, h, sq, sk, d in cases:
            q, k, v = c.flash_inputs(gen, label, b, h, sq, sk, d)
            scale = 1.0 / math.sqrt(d)
            ref = A.scaled_dot_product_attention(q, k, v)

            def wide():
                with mock.patch.object(A, "WG_KSTEPS", tuple(x for x in A.WG_KSTEPS if x != 4)):
                    A._PREPARED.clear()
                    out = A._flash_cuda(q, k, v, None, False, scale)
                A._PREPARED.clear()
                return out

            def wg():
                return A._flash_cuda(q, k, v, None, False, scale)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v)

            errs = {}
            for name, fn in (("wgmma", wg), ("wide", wide), ("sdpa", sdpa)):
                errs[name], _ = c.max_err(fn(), ref)
            # the wide route's plan is taken outside the graph: capture its launches
            with mock.patch.object(A, "WG_KSTEPS", tuple(x for x in A.WG_KSTEPS if x != 4)):
                A._PREPARED.clear()
                wide_plan = A.plan_for(q, k, v)
                wide_ms = [c.graph_ms(lambda: A._flash_cuda(q, k, v, None, False, scale))]
            A._PREPARED.clear()
            times = {"wgmma": [c.graph_ms(wg)], "wide": wide_ms, "sdpa": [c.graph_ms(sdpa)]}
            times["sdpa"].append(c.graph_ms(sdpa))
            with mock.patch.object(A, "WG_KSTEPS", tuple(x for x in A.WG_KSTEPS if x != 4)):
                A._PREPARED.clear()
                times["wide"].append(c.graph_ms(lambda: A._flash_cuda(q, k, v, None, False,
                                                                      scale)))
            A._PREPARED.clear()
            times["wgmma"].append(c.graph_ms(wg))
            bound_ms, bound_by = c.bound(2 * (2 * q.numel() + 2 * k.numel()),
                                         4.0 * b * h * sq * sk * d)
            plan = A.plan_for(q, k, v)
            print(f"d64 {label:18s} B{b} H{h} Sq{sq} Sk{sk}: wgmma ({plan.block_rows} rows) "
                  f"{times['wgmma'][0]:.4f}, {times['wgmma'][1]:.4f} ms | wide (splits "
                  f"{wide_plan.nsplit}) {times['wide'][0]:.4f}, {times['wide'][1]:.4f} ms | sdpa "
                  f"{times['sdpa'][0]:.4f}, {times['sdpa'][1]:.4f} ms | least {bound_ms:.4f} ms "
                  f"by {bound_by} | max_abs_err against plain: " +
                  ", ".join(f"{n} {e:.3e}" for n, e in errs.items()), flush=True)
            del q, k, v, ref
            torch.cuda.empty_cache()
    print(f"card: {card}", flush=True)


D64_CAPS = ((2, 1), (3, 2), (4, 1))  # (blocks an SM at 64 rows, at 128 rows) of each build


def d64_caps() -> None:
    """Three builds of the wgmma source with the D 64 instance's register cap
    set by -D, timed in turns at the D 64 shapes with both block sizes."""
    sys.path.insert(0, os.getcwd())
    import ctypes

    import torch

    import chip_smoke as c
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A

    card = c.require_cuda()
    c.build_kernels()
    out_dir = os.path.join(os.getcwd(), "chiprun_out", "d64_caps")
    os.makedirs(out_dir, exist_ok=True)
    source = (_build.CSRC / "flash_attn_wgmma.cu").read_text()
    rule = "  return KS <= 3 ? 4 / NWG : (KS <= 5 && NWG == 1 ? 3 : 1);"
    if rule not in source:
        raise RuntimeError("wg_min_blocks' rule not found in flash_attn_wgmma.cu")
    procs = {}
    for caps in D64_CAPS:
        # a copy beside the source (its headers resolve) with the D 64 cap changed
        copy = _build.CSRC / f"d64_caps_{caps[0]}_{caps[1]}.cu"
        copy.write_text(source.replace(rule, f"  if (KS == 4) return NWG == 1 ? {caps[0]} : "
                                             f"{caps[1]};\n" + rule))
        lib = os.path.join(out_dir, f"wgmma_{caps[0]}_{caps[1]}.so")
        procs[caps] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, str(copy)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for caps, (path, proc) in procs.items():
        log = proc.communicate()[0]
        (_build.CSRC / f"d64_caps_{caps[0]}_{caps[1]}.cu").unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for caps {caps}:\n{log}")
        # ptxas's report of each D 64 instance (KS 4): its entry, spills, registers
        for chunk in log.split("Compiling entry function")[1:]:
            m = re.search(r"flash_fwd_wg_kernelILi4ELi(\d)ELb(\d)", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            if m and spill and regs:
                print(f"caps {caps}: KS 4 NWG {m.group(1)} TMA {m.group(2)}: {regs.group(1)} "
                      f"registers, {spill.group(1)} bytes spill stores", flush=True)
        lib = ctypes.CDLL(path)
        lib.flash_fwd_bf16_wg.argtypes = _build.load_library().flash_fwd_bf16_wg.argtypes
        lib.flash_fwd_bf16_wg.restype = ctypes.c_int
        libs[caps] = lib
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    cases = [case for case in c.FLASH_XL_CASES if case[-1] == 64]
    with torch.inference_mode():
        for label, b, h, sq, sk, d in cases:
            q, k, v = c.flash_inputs(gen, label, b, h, sq, sk, d)
            _, _, _, strides = A._prepare(q, k, v, True)
            ref = A.scaled_dot_product_attention(q, k, v)
            out = torch.empty_strided((b, h, sq, d), (sq * h * d, d, h * d, 1), dtype=q.dtype,
                                      device="cuda")

            def launch(lib, rows):
                _build.check(lib.flash_fwd_bf16_wg(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), strides,
                    b, h, sq, sk, d, 0, 1.0 / math.sqrt(d), rows, None,
                    torch.cuda.current_stream().cuda_stream), "flash_fwd_bf16_wg")

            rows_plan = A.plan_for(q, k, v).block_rows
            for rows in (64, 128):
                ms = {caps: [] for caps in D64_CAPS}
                for caps in D64_CAPS + D64_CAPS[::-1]:
                    ms[caps].append(c.graph_ms(lambda: launch(libs[caps], rows)))
                errs = {}
                for caps in D64_CAPS:
                    launch(libs[caps], rows)
                    errs[caps], _ = c.max_err(out, ref)
                print(f"d64 caps {label:18s} {rows} rows (the plan takes {rows_plan}): " +
                      " | ".join(f"blocks {caps[0] if rows == 64 else caps[1]}: "
                                 f"{ms[caps][0]:.4f}, {ms[caps][1]:.4f} ms (err {errs[caps]:.2e})"
                                 for caps in D64_CAPS), flush=True)
            del q, k, v, ref, out
            torch.cuda.empty_cache()
    print(f"card: {card}", flush=True)


def sd15_bits_turn(path: str) -> None:
    """One SD1.5 512x512, 25-step request of this tree's modules → `path`."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as c

    c.require_cuda()
    c.build_kernels()
    wrapper, faces = c.build_server(torch.Generator(device="cuda").manual_seed(c.SEED))
    wrapper.prepare_adaface_embeddings(images=faces["a"])
    img = wrapper(c.REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(100))
    np.save(path, img.float().cpu().numpy())


def face_parser_folder_turn() -> None:
    """One tree's face-parser folder fit; runs with the tree as working
    directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c

    c.require_cuda()
    c.build_kernels()
    res = c.train_face_parser_folder(torch.Generator(device="cuda").manual_seed(c.SEED))
    print(f"face parser folder: {res['steps_per_sec']:.3f} steps/sec, host preparation "
          f"{', '.join(f'{v * 1e3:.1f}' for v in res['data_secs'])} ms a batch", flush=True)


def faulty_fit(fault: str, *args) -> None:
    """`chip_smoke.dp_fit` with the gradients' all-reduce replaced: "mean"
    divides the ranks' sum by their number, "none" leaves each rank's own."""
    import torch

    from adaface_tpu_torch.parallel import mesh as M
    from adaface_tpu_torch.train import train_step

    import chip_smoke as c

    def reduce(params, mesh):
        if fault == "mean":
            M.all_reduce_grads(params, mesh)
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(mesh.dp)

    train_step.all_reduce_grads = reduce
    c.dp_fit(*args)


def dp_faults() -> None:
    import tempfile

    import torch

    import chip_smoke as c

    card = c.require_cuda()
    c.build_kernels()
    c.train_dp(card)  # the sound fit, its readings and bounds
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(c.REPO)) as tmp:
        data = c.dp_photos(os.path.join(tmp, "photos"))
        plain = os.path.join(tmp, "plain.pt")
        syncs = {f: os.path.join(tmp, f"sync_{f}") for f in ("mean", "none")}
        procs = [(c.dp_fit, (0, 1, None, 0, data, plain, syncs["mean"]))]
        for fault in ("mean", "none"):
            port = c.free_port()
            procs += [(faulty_fit, (fault, r, c.DP_RANKS, "gloo", port, data,
                                    os.path.join(tmp, f"{fault}{r}.pt"), syncs[fault]))
                      for r in range(c.DP_RANKS)]
        ctx = torch.multiprocessing.get_context("spawn")
        started = [ctx.Process(target=t, args=a) for t, a in procs]
        for p in started:
            p.start()
        for p in started:
            p.join(c.DP_TIMEOUT_S)
        if any(p.exitcode != 0 for p in started):
            for p in started:
                if p.is_alive():
                    p.kill()
            raise AssertionError(f"exit codes {[p.exitcode for p in started]}")
        ref = torch.load(plain, weights_only=False)
        for fault in ("mean", "none"):
            r0, r1 = (torch.load(os.path.join(tmp, f"{fault}{r}.pt"), weights_only=False)
                      for r in range(c.DP_RANKS))
            loss, gnorm, upd = c.dp_distance(r0, ref)
            equal = all(torch.equal(a, b) for a, b in zip(r0["after"], r1["after"]))
            print(f"dp fault {fault!r} ({card}): rank 0 against one process: losses {loss:.3e} "
                  f"relative at most (bound {c.DP_LOSS_REL:g}), gradient norms {gnorm:.3e} "
                  f"(bound {c.DP_GRAD_NORM_REL:g}), update {upd:.3e} relative L2 (bound "
                  f"{c.DP_UPDATE_REL_L2:g}); the ranks' parameters equal: {equal}; gradient "
                  f"norms {r0['grad_norms']} against {ref['grad_norms']}", flush=True)


ADV_VARIANTS = ("bf16", "bf16 plain", "fp32 plain")
ADV_FAULTS = ("sound", "max", "mean")


def adv_fault(fault: str):
    """The branch's reductions with `fault` planted (none for "sound")."""
    from unittest import mock

    import torch

    from adaface_tpu_torch.train import recon_step as R

    if fault == "max":
        return mock.patch.object(R, "gmax", lambda x: x.max() if x.numel() else
                                 torch.tensor(float("-inf"), device=x.device))
    if fault == "mean":
        return mock.patch.object(R, "gsum", lambda x: x)
    return contextlib.nullcontext()


def adv_variant(decoder, variant: str):
    """(the decoder in the variant's dtype, a context in which its attention
    and GroupNorms take their plain versions where the variant says so,
    TF32 off for fp32)."""
    import copy
    from unittest import mock

    import torch

    from adaface_tpu_torch.models import vae
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G

    dtype = torch.float32 if variant.startswith("fp32") else torch.bfloat16
    dec = copy.deepcopy(decoder).to(dtype)
    if not variant.endswith("plain"):
        return dec, contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(vae, "multi_head_attention",
                                          A.scaled_dot_product_attention))
    stack.enter_context(mock.patch.object(
        G, "group_norm_silu", lambda x, w, b, groups, eps, silu=False:
        G.gn_silu_plain(x, w, b, groups, eps, silu)))
    if dtype == torch.float32:
        stack.enter_context(tf32_off())
    return dec, stack


@contextlib.contextmanager
def tf32_off():
    import torch

    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def adv_noise_process(rank: int, world: int, port: int, out: str) -> None:
    """One process of `dp_adv_faults`: the same seeded inputs in each, then
    this process's rows of the attacked noise for every variant (and fault,
    on a rank; on the single process also the attack with the gradient taken
    on the ranks' row groups and on the whole batch), saved to `out`."""
    import datetime

    import torch
    import torch.distributed as dist

    import chip_smoke as c
    from adaface_tpu_torch.core.params import build, init_fan_in_
    from adaface_tpu_torch.models.arcface import ArcFace, init_arcface_weights_
    from adaface_tpu_torch.models.vae import SD_VAE, VAEDecoder
    from adaface_tpu_torch.parallel.collectives import data_parallel
    from adaface_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from adaface_tpu_torch.train import recon_step as R
    from adaface_tpu_torch.train.face_detect import map_bboxes_to_latent
    from adaface_tpu_torch.train.recon_multistep import calc_arcface_adv_grad

    torch.cuda.set_device(0)
    mesh = None
    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        dist.init_process_group("gloo", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=c.DP_TIMEOUT_S))
        mesh = make_mesh(world)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(c.SEED + 26)
    decoder = build(lambda: VAEDecoder(SD_VAE), dev, torch.float32, init_fan_in_, gen)
    arcface = build(lambda: ArcFace(), dev, torch.float32, init_arcface_weights_, gen)
    batch = c.adv_image_fields(gen)
    noise = torch.randn(batch["x_start"].shape, generator=gen, device=dev)
    rand = {"adv_dropout_u": torch.rand((c.ADV_BS, 512), generator=gen, device=dev),
            "adv_uniform": 0.37}
    rcfg = R.ReconStepConfig(do_adv_attack=True, adv_bs=c.ADV_BS)
    rows, nz = batch, noise
    if mesh is not None:
        rows = shard_batch(batch, mesh.dp_rank, mesh.dp)
        nz = shard_batch(noise, mesh.dp_rank, mesh.dp)
    res = {"noise_in": nz.cpu()}
    for variant in ADV_VARIANTS:
        dec, ctx = adv_variant(decoder, variant)
        frozen = {"vae": dec, "arcface": arcface}
        with ctx:
            for fault in ADV_FAULTS if mesh is not None else ("sound",):
                with adv_fault(fault), data_parallel(mesh):
                    res[variant, fault] = R._adv_attacked_noise(frozen, rows, rand, nz, rcfg,
                                                                64).float().cpu()
            if mesh is None:
                half = batch["x_start"].shape[0] // c.DP_RANKS
                bb_px = batch["ref_face_bboxes"][:c.ADV_BS]
                bb_lat = map_bboxes_to_latent(bb_px, batch["ref_images"].shape[-1], 64)

                def grad(a, b):
                    return calc_arcface_adv_grad(
                        arcface, dec, batch["x_start"][a:b], bb_lat[a:b], bb_px[a:b],
                        rand["adv_dropout_u"][a:b], dropout_p=0.3,
                        count=c.ADV_BS * 512).detach()

                groups = [(a, min(a + half, c.ADV_BS)) for a in range(0, c.ADV_BS, half)]
                res[variant, "whole"] = c.adv_noise_of(grad(0, c.ADV_BS), batch, rand, noise,
                                                       rcfg).float().cpu()
                res[variant, "split"] = c.adv_noise_of(
                    torch.cat([grad(a, b) for a, b in groups]), batch, rand, noise,
                    rcfg).float().cpu()
        del dec
        torch.cuda.empty_cache()
    torch.save(res, out)
    if mesh is not None:
        dist.destroy_process_group()


def dp_adv_faults() -> None:
    import tempfile

    import torch

    import chip_smoke as c

    card = c.require_cuda()
    c.build_kernels()
    with tempfile.TemporaryDirectory(prefix=".adv_faults_", dir=str(c.REPO)) as tmp:
        outs = [os.path.join(tmp, f"{name}.pt") for name in ("plain", "rank0", "rank1")]
        port = c.free_port()
        c.run_processes(adv_noise_process, [(0, 1, 0, outs[0]),
                                            (0, c.DP_RANKS, port, outs[1]),
                                            (1, c.DP_RANKS, port, outs[2])], c.DP_TIMEOUT_S)
        plain, r0, r1 = (torch.load(p, weights_only=False) for p in outs)
    for variant in ADV_VARIANTS:
        attack = (plain[variant, "sound"] - plain["noise_in"]).abs().max()

        def rel(a, b):
            return ((a - b).abs().max() / attack).item()

        print(f"dp adversarial noise, decoder {variant} ({card}), over the attack's largest "
              f"value {attack.item():.4e}: the row groups' attack from the whole batch's "
              f"{rel(plain[variant, 'split'], plain[variant, 'whole']):.3e}; the whole batch's "
              f"recomputed from the branch's {rel(plain[variant, 'whole'], plain[variant, 'sound']):.3e}",
              flush=True)
        for fault in ADV_FAULTS:
            ranks = torch.cat([r0[variant, fault], r1[variant, fault]])
            print(f"  ranks {fault:5s}: against the row groups' attack "
                  f"{rel(ranks, plain[variant, 'split']):.3e} (bound {c.DP_ADV_NOISE_REL:g}), "
                  f"against the whole batch's {rel(ranks, plain[variant, 'sound']):.3e} (bound "
                  f"{c.DP_ADV_WHOLE_REL:g})", flush=True)


TP_FAULTS = ("o_bias_every_rank", "geglu_contiguous")


def tp_faults() -> None:
    """`chip_smoke.train_tp`'s unet-distill micro-step at tp 2 (two gloo
    ranks on the card, against one process) sound and with each of
    TP_FAULTS planted, in bf16 through the kernels and in fp32 plain with
    TF32 off: the readings the bf16 bounds sit between."""
    import tempfile

    import torch

    import chip_smoke as c

    card = c.require_cuda()
    c.build_kernels()
    with tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(c.REPO)) as tmp:
        data = c.write_train_photos(os.path.join(tmp, "photos"))
        for fault in ("sound",) + TP_FAULTS:
            outs = [os.path.join(tmp, f"{fault}{r}.pt") for r in range(2)]
            port = c.free_port()
            c.run_processes(c.tp_process, [(r, 2, port, data, outs[r], fault) for r in range(2)],
                            c.TP_TIMEOUT_S)
            ranks = [torch.load(o, weights_only=False) for o in outs]
            r = c.tp_readings(ranks, card, f"tp {fault}")["distill tp 2"]
            over = r["bf16"][0] > c.TP_BF16_LOSS_REL or r["bf16"][1] > c.TP_BF16_GRAD_REL_L2
            print(f"tp {fault} ({card}): bf16 loss {r['bf16'][0]:.3e} (bound "
                  f"{c.TP_BF16_LOSS_REL:g}), gradients {r['bf16'][1]:.3e} relative L2 (bound "
                  f"{c.TP_BF16_GRAD_REL_L2:g}); fp32 plain loss {r['fp32'][0]:.3e}, gradients "
                  f"{r['fp32'][1]:.3e} (bound {c.TP_FP32_REL:g}); "
                  f"beyond the bf16 bounds: {over}",
                  flush=True)


@contextlib.contextmanager
def tp_fault(fault: str | None):
    """The UNet's tensor-parallel layers with `fault` planted (none for
    None or "sound"): "o_bias_every_rank" adds `o`'s bias to each tp rank's partial
    product before their sum (tp times in all); "geglu_contiguous" cuts the
    GEGLU's `proj_in` as JAX's contiguous column split lays it out (at tp 2
    rank 0 all of `val`, rank 1 all of `gate`), in `shard_params` and in the
    forward. Restored on exit."""
    from adaface_tpu_torch.models import unet
    from adaface_tpu_torch.parallel.collectives import reduce_from_tp

    saved = unet.Attention._out, unet.TransformerBlock.GEGLU_PARTS
    if fault == "o_bias_every_rank":
        unet.Attention._out = lambda self, part, tp: reduce_from_tp(
            part + self.o.bias.to(part.dtype), tp)
    elif fault == "geglu_contiguous":
        unet.TransformerBlock.GEGLU_PARTS = 1
    elif fault not in (None, "sound"):
        raise ValueError(f"no tp fault {fault!r}: {TP_FAULTS}")
    try:
        yield
    finally:
        unet.Attention._out, unet.TransformerBlock.GEGLU_PARTS = saved


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--tp-faults":
        tp_faults()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--dp-adv-faults":
        dp_adv_faults()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--dp-faults":
        dp_faults()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--face-parser-folder-turn":
        face_parser_folder_turn()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--d64":
        d64_turns()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--d64-caps":
        d64_caps()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--sd15-bits-turn":
        sd15_bits_turn(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--sd15-bits"] and len(sys.argv) in (3, 4):
        import numpy as np

        trees = [os.path.abspath(x) for x in (sys.argv[2:] + ["."])[:2]]
        out = os.path.abspath(os.path.join("chiprun_out", "sd15_bits"))
        os.makedirs(out, exist_ok=True)
        paths = []
        for name, tree in zip(("parent", "change"), trees):
            paths.append(os.path.join(out, f"{name}.npy"))
            subprocess.run([sys.executable, os.path.abspath(__file__), "--sd15-bits-turn",
                            paths[-1]], cwd=tree, check=True)
        a, b = (np.load(p) for p in paths)
        print(f"sd15 request parent against change: equal bits {np.array_equal(a, b)}, max abs "
              f"difference {np.abs(a - b).max():.3e}", flush=True)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--sweep":
        sweep_norm_plans()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--flash-rows":
        flash_rows()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--turn":
        turn()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--profile-turn":
        profile_turn()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--flash-bwd-plans":
        flash_bwd_plans()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--flash-bwd-turn":
        flash_bwd_turn()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--flash-bwd-kernels-turn":
        flash_bwd_turn(fit=False)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--gn-bwd-plans":
        gn_bwd_plans()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--gn-bwd-turn":
        gn_bwd_turn()
        return 0
    turn_flag = "--turn"
    if sys.argv[1:2] in (["--flash-bwd"], ["--flash-bwd-kernels"], ["--gn-bwd"],
                         ["--face-parser-folder"]):
        turn_flag = sys.argv[1] + "-turn"
        del sys.argv[1]
    if len(sys.argv) not in (2, 3):
        print(__doc__)
        return 2
    parent = os.path.abspath(sys.argv[1])
    change = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else ".")
    for name, tree in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        print(f"== {name}: {tree}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), turn_flag], cwd=tree,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
