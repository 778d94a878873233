"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from `adaface_tpu_torch/csrc/`;
  3. hold every kernel against its plain PyTorch version at the shapes its
     path gives it: the SD1.5 serving path's (bf16), the fused-LN UNet's
     (LayerNorm, bf16) and the face parser's (train-mode BN + activation at
     batch 16, 448x448, fp32, with the BN Function's gradients); the flash
     kernels at the path's strides (views of [B,S,H*D] storage), at a
     contiguous and at a misaligned layout, and the split-keys combine
     kernel on the partial results of the VAE's attention; the GroupNorm
     kernels on channels-last maps at every shape of the path, each with
     the kernel `gn_plan` gives it, the one-launch kernel and the split pair
     each forced at a shape of the other's regime, an fp32 case, a case with
     mean 100 and deviation 1, and two runs held to the same bits; print
     errors, median times (single launches, and for GroupNorm, LayerNorm and
     BatchNorm also 20 launches as a CUDA graph: the device alone), each
     kernel's bound (the larger of bytes / 3.35 TB/s and operations / 989
     TFLOP/s) and the stock PyTorch op's time (a yardstick only: the port
     never calls it);
  4. one full-width SD1.5 UNet call at CFG batch 2, kernels against plain;
     then the same call in the fused-LN configuration (`fused_ln=True`),
     kernels against plain, with its 48 LayerNorm launches;
  5. the personalized text-to-image path through the port's AdaFaceWrapper:
     a small request, kernels against plain; then 3 requests for 2
     subjects at 512x512, 25 DDIM steps, guidance 6.0, random full-size
     weights from a seeded torch.Generator, with the kernels' launch counts
     and the hits and misses of the flash wrapper's two caches;
  6. face-parser training at its published configuration (BiSeNet-ResNet18,
     batch 16, crop 448, fp32, OHEM, SGD): one train step's loss and
     gradients, kernels against plain, under deterministic cuDNN without
     TF32, beside the envelope of plain with fp64 BN statistics; then 10 steps of the port's train step and optimizer with the BN
     launch counts, steps/sec and the memory peak; then one eval-mode
     forward at 512x512 to a face mask.
Each path runs with the launch counts set to 0 just before it and checked
just after. The line before the last holds the per-kernel JSON record; the
last line is {"ok": true, "device": {...}}.

The script imports only torch, numpy and the port (`adaface_tpu_torch`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BF16_TOL = 1e-2  # bf16 keeps 8 significant bits: ~0.4% per rounding
FP32_TOL = 1e-4
FP32_SUM_TOL = 1e-5  # a few fp32 roundings of a short sum, and ex2.approx (2^-22)
UNET_REL_TOL = 5e-2  # bf16 through ~70 layers of random weights
IMAGE_TOL = 5e-2  # [0, 1] pixels after a short bf16 sampling loop

# (label, B, H, Sq, Sk, D): every attention the serving path sends to the
# flash kernel (UNet at CFG batch 2, 8 heads; VAE mid-block, one head)
FLASH_CASES = [
    ("unet 64x64 self", 2, 8, 4096, 4096, 40),
    ("unet 64x64 cross", 2, 8, 4096, 77, 40),
    ("unet 32x32 self", 2, 8, 1024, 1024, 80),
    ("unet 32x32 cross", 2, 8, 1024, 77, 80),
    ("unet 16x16 self", 2, 8, 256, 256, 160),
    ("unet 16x16 cross", 2, 8, 256, 77, 160),
    ("vae mid self", 1, 1, 4096, 4096, 512),
]
# layouts off the path, at the 32x32 self-attention shape: one contiguous
# [B,H,S,D], and one whose head offset (D = 36: 72 bytes) is not a multiple
# of 16 bytes, which takes the wide kernel and its element-copy staging
FLASH_EXTRA_CASES = [
    ("contiguous 32x32 self", 2, 8, 1024, 1024, 80),
    ("misaligned D36 self", 2, 8, 1024, 1024, 36),
]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12
RUN_LAUNCHES = 20  # launches between one pair of events, for launch-bound shapes
# (label, shape, groups, eps, silu, launches per UNet call, per decode): every
# GroupNorm of the UNet (CFG batch 2; resnet norms with SiLU, transformer
# norms without) and of the VAE decoder (batch 1) at 512x512; `check_unet` and
# `serve` count the shapes the modules really see against this table
GN_CASES = [
    ("unet resnet 64x64 320", (2, 320, 64, 64), 32, 1e-5, True, 8, 0),
    ("unet transformer 64x64 320", (2, 320, 64, 64), 32, 1e-6, False, 5, 0),
    ("unet resnet 64x64 640", (2, 640, 64, 64), 32, 1e-5, True, 2, 0),
    ("unet resnet 64x64 960", (2, 960, 64, 64), 32, 1e-5, True, 1, 0),
    ("unet resnet 32x32 320", (2, 320, 32, 32), 32, 1e-5, True, 1, 0),
    ("unet resnet 32x32 640", (2, 640, 32, 32), 32, 1e-5, True, 6, 0),
    ("unet transformer 32x32 640", (2, 640, 32, 32), 32, 1e-6, False, 5, 0),
    ("unet resnet 32x32 960", (2, 960, 32, 32), 32, 1e-5, True, 1, 0),
    ("unet resnet 32x32 1280", (2, 1280, 32, 32), 32, 1e-5, True, 1, 0),
    ("unet resnet 32x32 1920", (2, 1920, 32, 32), 32, 1e-5, True, 1, 0),
    ("unet resnet 16x16 640", (2, 640, 16, 16), 32, 1e-5, True, 1, 0),
    ("unet resnet 16x16 1280", (2, 1280, 16, 16), 32, 1e-5, True, 6, 0),
    ("unet transformer 16x16 1280", (2, 1280, 16, 16), 32, 1e-6, False, 5, 0),
    ("unet resnet 16x16 1920", (2, 1920, 16, 16), 32, 1e-5, True, 1, 0),
    ("unet resnet 16x16 2560", (2, 2560, 16, 16), 32, 1e-5, True, 2, 0),
    ("unet resnet 8x8 1280", (2, 1280, 8, 8), 32, 1e-5, True, 11, 0),
    ("unet transformer 8x8 1280", (2, 1280, 8, 8), 32, 1e-6, False, 1, 0),
    ("unet resnet 8x8 2560", (2, 2560, 8, 8), 32, 1e-5, True, 3, 0),
    ("vae resnet 64x64 512", (1, 512, 64, 64), 32, 1e-6, True, 0, 10),
    ("vae attention 64x64 512", (1, 512, 64, 64), 32, 1e-6, False, 0, 1),
    ("vae resnet 128x128 512", (1, 512, 128, 128), 32, 1e-6, True, 0, 6),
    ("vae resnet 256x256 512", (1, 512, 256, 256), 32, 1e-6, True, 0, 1),
    ("vae resnet 256x256 256", (1, 256, 256, 256), 32, 1e-6, True, 0, 5),
    ("vae resnet 512x512 256", (1, 256, 512, 512), 32, 1e-6, True, 0, 1),
    ("vae resnet 512x512 128", (1, 128, 512, 512), 32, 1e-6, True, 0, 6),
]
UNET_CALLS = 25  # per request: DDIM steps, one CFG batch-2 call each
# each kernel forced at a shape of the other's regime, where it can run
GN_FORCED = [("vae resnet 128x128 512", "fused"), ("unet resnet 64x64 320", "split"),
             ("unet resnet 8x8 1280", "split")]
RSTD_REL_TOL = 1e-3  # statistics of a map with mean 100 and deviation 1, against fp64
# (label, R, C, slope, dtype): the train-mode BNs of BiSeNet at batch 16,
# 448x448 as [R = N*H*W, C] (`adaface_tpu/models/bisenet.py:148-198`);
# slope 0 is ReLU, 1 no activation
BN_CASES = [
    ("stem 224x224", 802816, 64, 0.0, torch.float32),
    ("layer1 112x112", 200704, 64, 1.0, torch.float32),
    ("layer2 56x56", 50176, 128, 0.0, torch.float32),
    ("layer3 28x28", 12544, 256, 0.0, torch.float32),
    ("layer4 14x14", 3136, 512, 1.0, torch.float32),
    ("ffm 56x56", 50176, 256, 0.0, torch.float32),
    ("arm attention 1x1", 16, 128, 1.0, torch.float32),
    ("layer1 112x112 bf16", 200704, 64, 0.0, torch.bfloat16),
]
BN_EPS = 1e-5
# (label, rows, C, dtype): the UNet's LayerNorms at CFG batch 2
LN_CASES = [
    ("unet 64x64", 8192, 320, torch.bfloat16),
    ("unet 32x32", 2048, 640, torch.bfloat16),
    ("unet 16x16", 512, 1280, torch.bfloat16),
    ("unet 8x8", 128, 1280, torch.bfloat16),
    ("unet 64x64 fp32", 8192, 320, torch.float32),
]
LOSS_REL_TOL = 1e-4  # one fp32 train step, kernels against plain
GRAD_REL_TOL = 1e-3  # the BN Function's gradients, kernel residuals against plain
# A whole train step's gradients move by ~2.5e-3 (relative L2) when only the
# BN statistics' last bit changes (fp32 E[x^2] - mean^2 against the same in
# fp64): a ReLU or max-pool input that lands on the other side of its kink
# moves one unit's gradient, and the BN parameters' gradients are sums over
# 10^5-10^6 units that mostly cancel. Kernels against plain are held to twice
# that envelope, measured in the same run, and never to less than GRAD_REL_TOL.
ENVELOPE = 2.0
TRAIN_STEPS = 10
BISENET_BNS = 31  # train-mode BNs per BiSeNet forward
# shapes whose times go into the JSON record: the heaviest of each kernel
# that the UNet, which runs 25 times per image, gives it, and the face
# parser's stem
JSON_FLASH_T = "unet 64x64 self"
JSON_FLASH_STD = "unet 16x16 self"
JSON_FLASH_WIDE = "vae mid self"
JSON_GN = "unet resnet 64x64 320"  # the one-launch kernel
JSON_GN_SPLIT = "vae resnet 512x512 128"  # the split pair
JSON_BN = "stem 224x224"
JSON_LN = "unet 64x64"


def log(*a):
    print(*a, flush=True)


def require_cuda() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def build_kernels() -> float:
    from adaface_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s -> {_build.library_path()}")
    log_path = _build.library_path().with_suffix(".log")
    if log_path.exists():
        text = log_path.read_text()
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", text))
        log(f"ptxas: {len(regs)} kernel instances, registers {min(regs)}..{max(regs)}, "
            f"spill stores {spills} bytes")
    return secs


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, launches: int = RUN_LAUNCHES, reps: int = 5) -> float:
    """Per-launch time of `launches` back-to-back launches between one pair of
    events (median of `reps` such runs): the host's enqueue of one launch
    hides behind the device's work on the one before."""
    def run():
        for _ in range(launches):
            fn()
    return median_ms(run, reps=reps, warmup=1) / launches


def graph_ms(fn, launches: int = RUN_LAUNCHES, reps: int = 5) -> float:
    """Per-launch device time: `launches` launches captured in a CUDA graph
    and replayed, so that the host's work per launch (the wrapper's checks,
    the allocator, the enqueue) is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return median_ms(graph.replay, reps=reps, warmup=2) / launches


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call, in microseconds: `calls` calls on the host's
    clock with no synchronisation between them (the device drains after)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def bound(n_bytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(the least ms the card could take, what bounds it): every input read
    once and every output written once at the card's memory rate, or the
    operations at its bf16 tensor-core peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max(1, max |ref|)) in fp32."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out - ref).abs().max().item(), max(1.0, ref.abs().max().item())


def flash_inputs(gen, label, b, h, sq, sk, d, dtype=torch.bfloat16):
    """q, k, v [B,H,S,D] laid out as the path lays them out: the UNet's are
    views of [B,S,H*D] projections (cross-attention's k and v the two halves
    of one [B,77,2*H*D] projection), the VAE's [B,1,S,D] is contiguous."""
    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if label.startswith("contiguous"):
        return mk(b, h, sq, d), mk(b, h, sk, d), mk(b, h, sk, d)
    split = lambda t: t.reshape(b, -1, h, d).transpose(1, 2)
    q = split(mk(b, sq, h * d))
    if "cross" in label:
        k, v = (split(t) for t in mk(b, sk, 2 * h * d).split(h * d, dim=-1))
    else:
        k, v = split(mk(b, sk, h * d)), split(mk(b, sk, h * d))
    return q, k, v


def check_flash(gen) -> dict:
    from adaface_tpu_torch.ops import attention as A

    results = {}
    for label, b, h, sq, sk, d in FLASH_CASES + FLASH_EXTRA_CASES:
        q, k, v = flash_inputs(gen, label, b, h, sq, sk, d)
        scale = 1.0 / math.sqrt(d)
        out = A._flash_cuda(q, k, v, None, False, scale)
        ref = A.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        err, mag = max_err(out, ref)
        kernel = lambda: A._flash_cuda(q, k, v, None, False, scale)
        plain = lambda: A.scaled_dot_product_attention(q, k, v)
        stock = lambda: F.scaled_dot_product_attention(q, k, v)
        # in turns: kernel, plain, stock, stock, plain, kernel
        turns = [median_ms(f) for f in (kernel, plain, stock, stock, plain, kernel)]
        ms, plain_ms, stock_ms = (min(turns[0], turns[5]), min(turns[1], turns[4]),
                                  min(turns[2], turns[3]))
        run, stock_run = run_ms(kernel), run_ms(stock)
        dev, stock_dev = graph_ms(kernel), graph_ms(stock)
        host, stock_host = host_us(kernel), host_us(stock)
        bound_ms, bound_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                                   4.0 * b * h * sq * sk * d)
        plan = A.plan_for(q, k, v)
        log(f"flash {label:22s} B{b} H{h} Sq{sq} Sk{sk} D{d} strides q{tuple(q.stride())} "
            f"k{tuple(k.stride())} {plan.variant} rows {plan.block_rows} splits {plan.nsplit}: "
            f"max_abs_err {err:.3e} (bound {BF16_TOL * mag:.3e}) | single launches: kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms stock sdpa {stock_ms:.4f} ms | run of "
            f"{RUN_LAUNCHES}: kernel {run:.4f} ms stock {stock_run:.4f} ms | the same run as a "
            f"CUDA graph (device alone): kernel {dev:.4f} ms stock {stock_dev:.4f} ms | host per "
            f"call: kernel {host:.1f} us stock {stock_host:.1f} us | least "
            f"{bound_ms:.4f} ms by {bound_by}, reached {bound_ms / dev:.1%}")
        if err > BF16_TOL * mag:
            raise AssertionError(f"flash {label}: error {err} above bound")
        results[label] = dict(variant=plan.variant, err=err, ms=ms, plain_ms=plain_ms,
                              stock_ms=stock_ms, run_ms=run,
                              stock_run_ms=stock_run, graph_ms=dev, stock_graph_ms=stock_dev,
                              host_us=host, stock_host_us=stock_host,
                              bound_ms=bound_ms, bound_by=bound_by)

    # masked + causal at ragged lengths (Sq 200, Sk 177: the causal offset
    # Sk - Sq = -23 leaves rows 0..22 only masked keys; batch 1 also masks
    # keys 0..15), on every kernel: bf16 D 40 (wgmma, three tiles by TMA; at
    # Sk 100 two tiles by cp.async), bf16 D 64 and D 200 (the wide kernel,
    # 32-key tiles, 6 key splits and the combine kernel) and fp32 D 64 (CUDA
    # cores)
    for dtype, d, sk, tol in ((torch.bfloat16, 64, 177, BF16_TOL),
                              (torch.bfloat16, 40, 177, BF16_TOL),
                              (torch.bfloat16, 40, 100, BF16_TOL),
                              (torch.bfloat16, 200, 177, BF16_TOL),
                              (torch.float32, 64, 177, FP32_TOL)):
        q, k, v = flash_inputs(gen, "self", 2, 2, 200, sk, d, dtype)
        mask = torch.ones((2, sk), device="cuda")
        mask[1, :16] = 0.0
        mask[0, sk - 27:] = 0.0
        out = A._flash_cuda(q, k, v, mask, True, 1.0 / math.sqrt(d))
        ref = A.scaled_dot_product_attention(q, k, v, kv_mask=mask, causal=True)
        err, mag = max_err(out, ref)
        plan = A.plan_for(q, k, v)
        log(f"flash masked+causal Sq200 Sk{sk} D{d} {dtype} {plan.variant} splits "
            f"{plan.nsplit}: max_abs_err {err:.3e} (bound {tol * mag:.3e})")
        if err > tol * mag:
            raise AssertionError(f"flash masked+causal Sk{sk} D{d} {dtype}: error {err} "
                                 "above bound")
        results[f"masked causal Sk{sk} D{d} {dtype}"] = dict(variant=plan.variant, err=err)
    return results


def check_flash_combine(gen) -> dict:
    """The combine kernel against its plain version, on the partial results
    of the VAE's attention in two shares of its keys (unnormalized O, row
    maxima in log2 units, row sums: `flash_partials_tiled`, the wide
    kernel's arithmetic in plain PyTorch). The kernel adds the shares in the
    plain version's order in fp32, so its fp32 output is held to FP32_SUM_TOL
    of each element and its bf16 output to one bf16 rounding of each
    element (2^-8 relative covers a reference that sits on a rounding
    boundary); both with an absolute floor of FP32_SUM_TOL of the largest
    element, for elements that cancel to nearly nothing."""
    from adaface_tpu_torch.ops import attention as A

    label, b, h, sq, sk, d = FLASH_CASES[-1]
    nsplit = 2
    q, k, v = flash_inputs(gen, label, b, h, sq, sk, d)
    o_part, m_part, l_part = A.flash_partials_tiled(q, k, v, key_tile=32, d_slices=4,
                                                    nsplit=nsplit)
    ref = A.combine_partials(o_part, m_part, l_part)
    out32 = A.flash_combine(o_part, m_part, l_part, torch.float32)
    out = A.flash_combine(o_part, m_part, l_part, torch.bfloat16)
    torch.cuda.synchronize()
    err, _ = max_err(out, ref)
    floor = FP32_SUM_TOL * ref.abs().max().item()
    over32 = ((out32 - ref).abs() - FP32_SUM_TOL * ref.abs()).max().item()
    over = ((out.float() - ref).abs() - 2.0 ** -8 * ref.abs()).max().item()
    rel_l2 = ((out.float() - ref).norm() / ref.norm()).item()
    ms = median_ms(lambda: A.flash_combine(o_part, m_part, l_part, torch.bfloat16))
    plain_ms = median_ms(lambda: A.combine_partials(o_part, m_part, l_part).to(torch.bfloat16))
    bound_ms, bound_by = bound(4 * (o_part.numel() + 2 * m_part.numel()) + 2 * b * h * sq * d)
    log(f"flash combine {nsplit} shares [{b},{h},{sq},{d}]: l_part {l_part.min().item():.2f}.."
        f"{l_part.max().item():.2f}, |ref| max {ref.abs().max().item():.3e} median "
        f"{ref.abs().median().item():.3e}; max_abs_err {err:.3e}, relative L2 {rel_l2:.3e}; "
        f"largest per-element excess, fp32 output: |out - ref| - {FP32_SUM_TOL:g} |ref| = "
        f"{over32:.3e}, bf16 output: |out - ref| - 2^-8 |ref| = {over:.3e} (bound for both "
        f"{floor:.3e}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms | least {bound_ms:.4f} ms "
        f"by {bound_by}")
    if not (torch.isfinite(out32).all() and over32 <= floor and over <= floor):
        raise AssertionError("flash combine: an element is off by more than its rounding")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def gn_inputs(gen, shape, dtype=torch.bfloat16, mean=0.5, std=2.0):
    """x [B, C, H, W] in channels-last memory, as the UNet and the VAE keep
    their maps, with scale and bias [C]."""
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)
    scale = (torch.randn((c,), generator=gen, device="cuda") + 1.0).to(dtype)
    bias = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), scale, bias


def gn_launches(per_call: int, per_decode: int) -> int:
    """Launches of a GroupNorm case in one 512x512, 25-step request."""
    return UNET_CALLS * per_call + per_decode


def check_gn_case(G, x, scale, bias, groups, eps, silu, plan, tol) -> dict:
    """One GroupNorm on the kernel(s) of `plan` against the plain version:
    the output, two runs to the same bits, and for the split pair its
    statistics (the partials folded by `gn_finalize_plain`) and its
    normalize pass on them."""
    def run():
        if plan.kernel == "fused":
            return G.gn_fused(x, scale, bias, groups, eps, silu, plan)
        return G.gn_norm(x, G.gn_stats(x, groups, plan), scale, bias, groups, eps, silu, plan)

    out = run()
    err, mag = max_err(out, G.gn_silu_plain(x, scale, bias, groups, eps, silu))
    same_bits = torch.equal(out, run())
    res = dict(err=err, mag=mag, run=run, stats_err=0.0, norm_err=0.0)
    if plan.kernel == "split":
        rows, cpg = x[0, 0].numel(), x.shape[1] // groups
        part = G.gn_stats(x, groups, plan)
        stats = G.gn_finalize_plain(part, rows, cpg, -(-rows // plan.chunks), eps)
        res["stats_err"] = (stats - G.gn_stats_plain(x, groups, eps)).abs().max().item()
        res["norm_err"], _ = max_err(G.gn_norm(x, part, scale, bias, groups, eps, silu, plan),
                                     G.gn_norm_plain(x, stats, scale, bias, groups, silu))
        res["part"] = part
    if not same_bits:
        raise AssertionError(f"gn {tuple(x.shape)} {plan}: two runs differ")
    if err > tol * mag or res["stats_err"] > FP32_TOL or res["norm_err"] > tol * mag:
        raise AssertionError(f"gn {tuple(x.shape)} {plan}: error above bound: {res}")
    return res


def rstd_from_output(y, x, groups: int, eps: float):
    """rstd per (sample, group) that a GroupNorm output y (scale 1, bias 0, no
    SiLU) implies, and the fp64 value: the least-squares slope of y on
    x - mean in fp64, divided by the same slope of the exact output rounded
    to y's dtype. A bf16 map around 100 holds a dozen distinct values, so
    the output's rounding does not average out of one slope; it cancels
    between the two."""
    b = x.shape[0]
    xd = x.double().reshape(b, groups, x.shape[1] // groups, -1)
    dx = xd - xd.mean(dim=(2, 3), keepdim=True)
    want = torch.rsqrt((dx * dx).mean(dim=(2, 3), keepdim=True) + eps)
    slope = lambda out: (out.double().reshape(xd.shape) * dx).sum(dim=(2, 3)) / (
        dx * dx).sum(dim=(2, 3))
    exact = (dx * want).to(y.dtype)
    want = want.reshape(-1)
    return want * (slope(y) / slope(exact)).reshape(-1), want


def check_gn_adversarial(G, gen) -> float:
    """Mean 100, deviation 1 (mean^2 / variance = 1e4): rstd of each kernel
    within RSTD_REL_TOL of the fp64 value, bf16 and fp32, both regimes."""
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape, kernel in (((2, 320, 64, 64), "fused"), ((2, 320, 64, 64), "split"),
                              ((1, 128, 256, 256), "split")):
            x, _, _ = gn_inputs(gen, shape, dtype, mean=100.0, std=1.0)
            one, zero = torch.ones_like(x[0, :, 0, 0]), torch.zeros_like(x[0, :, 0, 0])
            plan = G.plan_for(x, 32, kernel)
            if kernel == "fused":
                got, want = rstd_from_output(
                    G.gn_fused(x, one, zero, 32, 1e-5, False, plan), x, 32, 1e-5)
            else:
                rows = shape[2] * shape[3]
                part = G.gn_stats(x, 32, plan)
                # what gn_norm's own fold of the partials makes of them, and
                # the partials folded in plain PyTorch
                folded, want = rstd_from_output(
                    G.gn_norm(x, part, one, zero, 32, 1e-5, False, plan), x, 32, 1e-5)
                got = torch.stack([folded, G.gn_finalize_plain(
                    part, rows, shape[1] // 32, -(-rows // plan.chunks), 1e-5)[:, 1].double()])
            rel = ((got - want).abs() / want).max().item()
            log(f"gn mean 100 deviation 1 {shape} {dtype} {kernel}: rstd rel_err {rel:.3e} "
                f"(bound {RSTD_REL_TOL:g})")
            if not rel <= RSTD_REL_TOL:
                raise AssertionError(f"gn adversarial {shape} {dtype} {kernel}: rstd off by {rel}")
            worst = max(worst, rel)
    return worst


def check_gn(gen) -> dict:
    from adaface_tpu_torch.ops import fused_gn as G

    results = {}
    for label, shape, groups, eps, silu, per_call, per_decode in GN_CASES:
        c = shape[1]
        x, scale, bias = gn_inputs(gen, shape)
        plan = G.plan_for(x, groups)
        r = check_gn_case(G, x, scale, bias, groups, eps, silu, plan, BF16_TOL)
        full_err, _ = max_err(G.group_norm_silu(x, scale, bias, groups, eps, silu),
                              G.gn_silu_plain(x, scale, bias, groups, eps, silu))
        torch.cuda.synchronize()
        kernel = lambda: G.group_norm_silu(x, scale, bias, groups, eps, silu)
        plain = lambda: G.gn_silu_plain(x, scale, bias, groups, eps, silu)
        act = F.silu if silu else (lambda t: t)
        stock = lambda: act(F.group_norm(x, groups, scale, bias, eps))  # same memory format
        # one library call for the statistics' function, on the same memory
        grouped = x.permute(0, 2, 3, 1).reshape(shape[0], -1, groups, c // groups)
        stock_stats_fn = lambda: torch.var_mean(grouped, dim=(1, 3), correction=0)
        ms, plain_ms, stock_ms = median_ms(kernel), median_ms(plain), median_ms(stock)
        dev, stock_dev = graph_ms(kernel), graph_ms(stock)
        host, stock_host = host_us(kernel), host_us(stock)
        x_bytes = x.numel() * x.element_size()
        bound_fn, _ = bound(2 * x_bytes + 2 * c * x.element_size())
        res = dict(kernel=plan.kernel, plan=dataclasses.asdict(plan), err=max(r["err"], full_err),
                   stats_err=r["stats_err"], norm_err=r["norm_err"], ms=ms, plain_ms=plain_ms,
                   stock_ms=stock_ms, graph_ms=dev, stock_graph_ms=stock_dev, host_us=host,
                   stock_host_us=stock_host, bound_fn=bound_fn, bound_moved=bound_fn,
                   launches=gn_launches(per_call, per_decode))
        detail = ""
        if plan.kernel == "split":
            part = r["part"]
            stats = G.gn_stats_plain(x, groups, eps)
            stats_fn = lambda: G.gn_stats(x, groups, plan)
            norm_fn = lambda: G.gn_norm(x, part, scale, bias, groups, eps, silu, plan)
            part_bytes = part.numel() * 4
            res.update(
                ms_stats=median_ms(stats_fn), graph_stats=graph_ms(stats_fn),
                plain_stats=median_ms(lambda: G.gn_stats_plain(x, groups, eps)),
                stock_stats=median_ms(stock_stats_fn), stock_graph_stats=graph_ms(stock_stats_fn),
                ms_norm=median_ms(norm_fn), graph_norm=graph_ms(norm_fn),
                plain_norm=median_ms(lambda: G.gn_norm_plain(x, stats, scale, bias, groups, silu)),
                bound_stats=bound(x_bytes + part_bytes)[0],
                bound_norm=bound(2 * x_bytes + part_bytes + 2 * c * x.element_size())[0])
            res["bound_moved"] = res["bound_stats"] + res["bound_norm"]
            detail = (f" | stats max_abs_err {r['stats_err']:.3e} norm max_abs_err "
                      f"{r['norm_err']:.3e}; gn_stats {res['ms_stats']:.4f} ms single "
                      f"{res['graph_stats']:.4f} device (plain {res['plain_stats']:.4f}, "
                      f"torch.var_mean {res['stock_stats']:.4f} single "
                      f"{res['stock_graph_stats']:.4f} device), gn_norm {res['ms_norm']:.4f} ms "
                      f"single {res['graph_norm']:.4f} device (plain {res['plain_norm']:.4f})")
        log(f"gn {label:28s} {shape} eps {eps:g} silu {silu} {plan.kernel} slab {plan.slab} "
            f"chunks {plan.chunks} threads {plan.threads}: max_abs_err {res['err']:.3e} (bound "
            f"{BF16_TOL * r['mag']:.3e}) | single launches: kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms F.group_norm{'+silu' if silu else ''} {stock_ms:.4f} ms | "
            f"20 launches as a CUDA graph (device alone): kernel {dev:.4f} ms library "
            f"{stock_dev:.4f} ms | host per call: kernel {host:.1f} us library "
            f"{stock_host:.1f} us | least by bytes: the function {bound_fn:.4f} ms, what the "
            f"kernels move {res['bound_moved']:.4f} ms | {res['launches']} launches a request"
            f"{detail}")
        results[label] = res

    # each kernel at a shape of the other's regime
    cases = {case[0]: case for case in GN_CASES}
    for label, forced in GN_FORCED:
        _, shape, groups, eps, silu, _, _ = cases[label]
        x, scale, bias = gn_inputs(gen, shape)
        plan = G.plan_for(x, groups, forced)
        r = check_gn_case(G, x, scale, bias, groups, eps, silu, plan, BF16_TOL)
        dev = graph_ms(r["run"])
        log(f"gn forced {forced} at {label} {shape} slab {plan.slab} chunks {plan.chunks} threads "
            f"{plan.threads}: max_abs_err {r['err']:.3e} stats max_abs_err {r['stats_err']:.3e} "
            f"| device {dev:.4f} ms against {results[label]['graph_ms']:.4f} ms of the "
            f"{results[label]['kernel']} kernel the plan takes")
        results[f"forced {forced} {label}"] = dict(kernel=forced, err=r["err"],
                                                   stats_err=r["stats_err"],
                                                   norm_err=r["norm_err"], graph_ms=dev)

    # fp32, both kernels
    for kernel_name in ("fused", "split"):
        x, scale, bias = gn_inputs(gen, (2, 320, 64, 64), torch.float32)
        plan = G.plan_for(x, 32, kernel_name)
        r = check_gn_case(G, x, scale, bias, 32, 1e-5, True, plan, FP32_TOL)
        log(f"gn fp32 (2, 320, 64, 64) {kernel_name} slab {plan.slab} chunks {plan.chunks}: "
            f"max_abs_err {r['err']:.3e} (bound {FP32_TOL * r['mag']:.3e}) stats max_abs_err "
            f"{r['stats_err']:.3e}")
        results[f"fp32 {kernel_name}"] = dict(kernel=kernel_name, err=r["err"],
                                              stats_err=r["stats_err"], norm_err=r["norm_err"])
    results["adversarial rstd rel_err"] = check_gn_adversarial(G, gen)

    path = [results[case[0]] for case in GN_CASES]
    sums = {k: sum(r["launches"] * r[k] for r in path)
            for k in ("graph_ms", "stock_graph_ms", "bound_fn", "bound_moved")}
    launches = sum(r["launches"] * (1 if r["kernel"] == "fused" else 2) for r in path)
    log(f"gn per 512x512 25-step request ({sum(r['launches'] for r in path)} GroupNorms, "
        f"{launches} launches): kernels {sums['graph_ms']:.3f} ms of device time, "
        f"F.group_norm(+silu) in the same memory format {sums['stock_graph_ms']:.3f} ms; least "
        f"by bytes: the function {sums['bound_fn']:.3f} ms, what the kernels move "
        f"{sums['bound_moved']:.3f} ms")
    results["per request"] = dict(launches=launches, **sums)
    return results


def rel_max_err(out, ref) -> float:
    """max |out - ref| / max |ref| in fp32."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return ((out - ref).abs().max() / ref.abs().max()).item()


def check_bn(gen) -> dict:
    from adaface_tpu_torch.ops import fused_norm as N

    results = {}
    for label, r, c, slope, dtype in BN_CASES:
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        x = (torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        scale = torch.randn((c,), generator=gen, device="cuda") + 1.0
        bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
        mean, rstd = N.bn_stats(x, BN_EPS)
        mean_p, rstd_p = N.bn_stats_plain(x, BN_EPS)
        stats_err = max(rel_max_err(mean, mean_p), rel_max_err(rstd, rstd_p))
        stats_abs = max(max_err(mean, mean_p)[0], max_err(rstd, rstd_p)[0])
        # the normalize pass on the same statistics, then the pair
        norm_err, mag = max_err(N.bn_norm_act(x, mean_p, rstd_p, scale, bias, slope),
                                N.bn_norm_act_plain(x, mean_p, rstd_p, scale, bias, slope))
        err, mag_full = max_err(N.fused_bn_act(x, scale, bias, slope, BN_EPS),
                                N.fused_bn_act_plain(x, scale, bias, slope, BN_EPS))
        torch.cuda.synchronize()
        ms_stats = median_ms(lambda: N.bn_stats(x, BN_EPS))
        plain_stats = median_ms(lambda: N.bn_stats_plain(x, BN_EPS))
        ms_norm = median_ms(lambda: N.bn_norm_act(x, mean, rstd, scale, bias, slope))
        plain_norm = median_ms(lambda: N.bn_norm_act_plain(x, mean, rstd, scale, bias, slope))
        ms = median_ms(lambda: N.fused_bn_act(x, scale, bias, slope, BN_EPS))
        plain_ms = median_ms(lambda: N.fused_bn_act_plain(x, scale, bias, slope, BN_EPS))
        x4 = x.t()[None, :, :, None]  # [1, C, R, 1], channels-last strides
        stock_ms = median_ms(lambda: F.leaky_relu(
            F.batch_norm(x4, None, None, scale, bias, training=True, eps=BN_EPS), slope))
        # one library call that computes bn_stats' function (mean, 1/std)
        stock_stats = median_ms(lambda: torch.batch_norm_stats(x, BN_EPS))
        # the same as 20 launches in a CUDA graph: the device alone
        dev_stats = graph_ms(lambda: N.bn_stats(x, BN_EPS))
        dev_norm = graph_ms(lambda: N.bn_norm_act(x, mean, rstd, scale, bias, slope))
        dev = graph_ms(lambda: N.fused_bn_act(x, scale, bias, slope, BN_EPS))
        stock_dev_stats = graph_ms(lambda: torch.batch_norm_stats(x, BN_EPS))
        stock_dev = graph_ms(lambda: F.leaky_relu(
            F.batch_norm(x4, None, None, scale, bias, training=True, eps=BN_EPS), slope))
        x_bytes = x.numel() * x.element_size()
        bound_stats, _ = bound(x_bytes + 2 * c * 4)
        bound_norm, _ = bound(2 * x_bytes + 4 * c * 4)
        log(f"bn {label:20s} R{r} C{c} slope {slope:g} {dtype}: stats rel_err {stats_err:.3e} "
            f"(bound {FP32_TOL:g}) norm max_abs_err {norm_err:.3e} (bound {tol * mag:.3e}) "
            f"full max_abs_err {err:.3e} | stats {ms_stats:.3f} ms (plain {plain_stats:.3f}, "
            f"torch.batch_norm_stats {stock_stats:.3f}) "
            f"norm {ms_norm:.3f} ms (plain {plain_norm:.3f}) full {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms stock {stock_ms:.3f} ms | device alone (CUDA graph): stats "
            f"{dev_stats:.4f} ms (torch.batch_norm_stats {stock_dev_stats:.4f}) norm "
            f"{dev_norm:.4f} ms full {dev:.4f} ms (stock {stock_dev:.4f}) | least, by bytes: "
            f"stats {bound_stats:.4f} ms norm {bound_norm:.4f} ms")
        if stats_err > FP32_TOL or norm_err > tol * mag or err > tol * mag_full:
            raise AssertionError(f"bn {label}: error above bound")
        results[label] = dict(stats_err=stats_err, stats_abs=stats_abs, norm_err=norm_err,
                              err=err, ms_stats=ms_stats, plain_stats=plain_stats,
                              ms_norm=ms_norm, plain_norm=plain_norm, ms=ms, plain_ms=plain_ms,
                              stock_ms=stock_ms, stock_stats=stock_stats,
                              graph_stats=dev_stats, graph_norm=dev_norm, graph_ms=dev,
                              stock_graph_stats=stock_dev_stats, stock_graph_ms=stock_dev,
                              bound_stats=bound_stats, bound_norm=bound_norm)
    return results


def check_ln(gen) -> dict:
    from adaface_tpu_torch.ops import fused_ln as L

    results = {}
    for label, rows, c, dtype in LN_CASES:
        tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
        x = (torch.randn((rows, c), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        w = (torch.randn((c,), generator=gen, device="cuda") + 1.0).to(dtype)
        b = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
        err, mag = max_err(L.layer_norm(x, w, b, 1e-5), L.layer_norm_plain(x, w, b, 1e-5))
        torch.cuda.synchronize()
        ms = median_ms(lambda: L.layer_norm(x, w, b, 1e-5))
        plain_ms = median_ms(lambda: L.layer_norm_plain(x, w, b, 1e-5))
        stock_ms = median_ms(lambda: F.layer_norm(x, (c,), w, b, 1e-5))
        dev = graph_ms(lambda: L.layer_norm(x, w, b, 1e-5))
        stock_dev = graph_ms(lambda: F.layer_norm(x, (c,), w, b, 1e-5))
        bound_ms, _ = bound((2 * x.numel() + 2 * c) * x.element_size())
        log(f"ln {label:16s} [{rows}, {c}] {dtype}: max_abs_err {err:.3e} "
            f"(bound {tol * mag:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"stock {stock_ms:.3f} ms | device alone (CUDA graph): kernel {dev:.4f} ms stock "
            f"{stock_dev:.4f} ms | least, by bytes: {bound_ms:.4f} ms")
        if err > tol * mag:
            raise AssertionError(f"ln {label}: error {err} above bound")
        results[label] = dict(err=err, ms=ms, plain_ms=plain_ms, stock_ms=stock_ms,
                              graph_ms=dev, stock_graph_ms=stock_dev, bound_ms=bound_ms)
    return results


def check_bn_backward(gen) -> dict:
    """The BN Function's gradients (x, scale, bias) on the kernels' residuals
    against the plain versions', for one upstream gradient, at the fp32 path
    shapes."""
    from adaface_tpu_torch.ops import fused_norm as N

    results = {}
    for label, r, c, slope, dtype in BN_CASES:
        if dtype != torch.float32:
            continue
        x = torch.randn((r, c), generator=gen, device="cuda") * 2.0 + 0.5
        scale = torch.randn((c,), generator=gen, device="cuda") + 1.0
        bias = torch.randn((c,), generator=gen, device="cuda") * 0.1
        g = torch.randn((r, c), generator=gen, device="cuda")

        def grads():
            leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
            N.fused_bn_act(*leaves, slope, BN_EPS).backward(g)
            return [t.grad for t in leaves]

        kernel = grads()
        with plain_versions():
            plain = grads()
        rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(kernel, plain))
        log(f"bn backward {label:20s} R{r} C{c} slope {slope:g}: gradients rel L2 max "
            f"{rel:.3e} (bound {GRAD_REL_TOL:g})")
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"bn backward {label}: rel L2 {rel} above bound")
        results[label] = rel
    return results


def check_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        flash = check_flash(gen)
        flash["combine"] = check_flash_combine(gen)
        gn, bn, ln = check_gn(gen), check_bn(gen), check_ln(gen)
    check_bn_backward(gen)
    return flash, gn, bn, ln


@contextmanager
def plain_versions():
    """Route the port's kernel wrappers to their plain versions on CUDA
    tensors, for the kernel-against-plain comparisons of whole modules."""
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G
    from adaface_tpu_torch.ops import fused_ln as L
    from adaface_tpu_torch.ops import fused_norm as N

    def flash_plain(q, k, v, kv_mask=None, causal=False, scale=None):
        return A.scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                              scale=scale)

    with mock.patch.object(A, "flash_attention", flash_plain), \
            mock.patch.object(G, "group_norm_silu", G.gn_silu_plain), \
            mock.patch.object(L, "layer_norm", L.layer_norm_plain), \
            mock.patch.object(N, "bn_stats", N.bn_stats_plain), \
            mock.patch.object(N, "bn_norm_act", N.bn_norm_act_plain):
        yield


def launch_counts() -> dict:
    from adaface_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def gn_expected(unet_calls: int, decodes: int) -> dict:
    """Launches of each GroupNorm kernel that `gn_plan` predicts on this card
    for `unet_calls` UNet calls and `decodes` VAE decodes: one `gn_fused`
    launch for a map the plan gives the one-launch kernel, one `gn_stats` and
    one `gn_norm` for each of the rest."""
    from adaface_tpu_torch.ops.fused_gn import GN_FUSED, GN_NORM, GN_STATS, gn_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = {GN_FUSED: 0, GN_STATS: 0, GN_NORM: 0}
    for _, (b, c, h, w), groups, _, _, per_call, per_decode in GN_CASES:
        n = per_call * unet_calls + per_decode * decodes
        if gn_plan(torch.bfloat16, b, c, h * w, groups, sms).kernel == "fused":
            want[GN_FUSED] += n
        else:
            want[GN_STATS] += n
            want[GN_NORM] += n
    return want


def expect_counts(counts: dict, unet_calls: int = 0, decodes: int = 0,
                  fused_ln_calls: int = 0, bisenet_forwards: int = 0):
    """30 launches of the wgmma flash kernel per UNet call (20 at head dim
    40/80, 10 at 160) and 1 of the wide-head kernel per VAE decode (D 512),
    the latter followed by one launch of the combine kernel where this
    card's SM count makes the wrapper split the keys (132 SMs: 2 splits); no
    launch of a flash kernel under another key (the wide kernel in the
    UNet, the fp32 kernel anywhere); 61 GroupNorms per UNet call, 30 per
    decode, each under the key of the kernel `gn_plan` gives its shape (132
    SMs: every one of the UNet's and 11 of a decode's in one `gn_fused`
    launch, 19 of a decode's as `gn_stats` + `gn_norm`); 48 LayerNorm launches
    per UNet call in the fused-LN configuration (16 transformer blocks x 3),
    0 in the default one; one bn_stats and one bn_norm_act launch for each
    of the 31 train-mode BNs of a BiSeNet forward. No other launch."""
    from adaface_tpu_torch.ops.attention import (FLASH_COMBINE, FLASH_STD, FLASH_T, FLASH_WIDE,
                                                 flash_plan)
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS

    vae_plan = flash_plan(torch.bfloat16, *FLASH_CASES[-1][1:],
                          torch.cuda.get_device_properties(0).multi_processor_count)
    want = {FLASH_T: 20 * unet_calls, FLASH_STD: 10 * unet_calls, FLASH_WIDE: decodes,
            FLASH_COMBINE: decodes * (vae_plan.nsplit > 1),
            **gn_expected(unet_calls, decodes),
            LAYER_NORM: 48 * fused_ln_calls,
            BN_STATS: BISENET_BNS * bisenet_forwards,
            BN_NORM_ACT: BISENET_BNS * bisenet_forwards}
    want = {k: v for k, v in want.items() if v}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")


@contextmanager
def gn_census(module):
    """Count the (shape, eps, SiLU) of every GroupNorm call inside `module`
    while the block runs; yields the counter."""
    import collections

    from adaface_tpu_torch.ops.fused_gn import GroupNorm

    seen: collections.Counter = collections.Counter()

    def hook(mod, args, kwargs):
        seen[(tuple(args[0].shape), mod.eps, bool(kwargs.get("silu", False)))] += 1

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in module.modules() if isinstance(m, GroupNorm)]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def expect_census(seen: dict, unet_calls: int = 0, decodes: int = 0):
    """The GroupNorms a module really ran against GN_CASES, the table the
    per-request sums are taken over."""
    want = {(shape, eps, silu): per_call * unet_calls + per_decode * decodes
            for _, shape, _, eps, silu, per_call, per_decode in GN_CASES}
    want = {k: v for k, v in want.items() if v}
    if dict(seen) != want:
        raise AssertionError(f"GroupNorm calls {dict(seen)}, expected {want}")


def check_unet(gen) -> dict:
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.ops import _build

    unet = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=False)),
                 "cuda", torch.bfloat16, init_unet_weights_, gen)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((2,), 501, dtype=torch.long, device="cuda")
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        _build.reset_launch_counts()
        with gn_census(unet) as seen:
            eps = unet(x, t, ctx).float()
        torch.cuda.synchronize()
        expect_counts(launch_counts(), unet_calls=1, decodes=0)
        expect_census(seen, unet_calls=1)
        with plain_versions():
            ref = unet(x, t, ctx).float()
            plain_ms = median_ms(lambda: unet(x, t, ctx), reps=5)
        ms = median_ms(lambda: unet(x, t, ctx), reps=5)
    if not torch.isfinite(eps).all():
        raise AssertionError("UNet output is not finite")
    rel = ((eps - ref).norm() / ref.norm()).item()
    log(f"unet SD1.5 CFG batch 2 64x64: rel_err {rel:.3e} (bound {UNET_REL_TOL:g}) "
        f"kernels {ms:.1f} ms plain {plain_ms:.1f} ms")
    if rel > UNET_REL_TOL:
        raise AssertionError(f"UNet kernels against plain: rel_err {rel} above bound")

    # the fused-LN configuration, same weights
    state = unet.state_dict()
    unet_ln = build(lambda: UNet2DConditionModel(dataclasses.replace(SD15_UNET, fused_ln=True)),
                    "cuda", torch.bfloat16, lambda m, _: m.load_state_dict(state), gen)
    with torch.inference_mode():
        _build.reset_launch_counts()
        eps_ln = unet_ln(x, t, ctx).float()
        torch.cuda.synchronize()
        ln_counts = launch_counts()
        expect_counts(ln_counts, unet_calls=1, fused_ln_calls=1)
        with plain_versions():
            ref_ln = unet_ln(x, t, ctx).float()
        # in turns: default, fused LN, fused LN, default
        ms_turns = [median_ms(lambda: m(x, t, ctx), reps=5)
                    for m in (unet, unet_ln, unet_ln, unet)]
    if not torch.isfinite(eps_ln).all():
        raise AssertionError("fused-LN UNet output is not finite")
    rel_ln = ((eps_ln - ref_ln).norm() / ref_ln.norm()).item()
    log(f"unet SD1.5 fused-LN CFG batch 2 64x64: rel_err {rel_ln:.3e} (bound {UNET_REL_TOL:g}); "
        f"call with the LN kernel {ms_turns[1]:.1f}, {ms_turns[2]:.1f} ms, without it "
        f"{ms_turns[0]:.1f}, {ms_turns[3]:.1f} ms; launches {ln_counts}")
    if rel_ln > UNET_REL_TOL:
        raise AssertionError(f"fused-LN UNet kernels against plain: rel_err {rel_ln} above bound")
    del unet, unet_ln, state
    torch.cuda.empty_cache()
    return dict(rel=rel, ms=ms, plain_ms=plain_ms, rel_ln=rel_ln, ms_turns=ms_turns,
                ln_counts=ln_counts)


REQUESTS = [  # (subject, prompt)
    ("a", "a photo of a person walking on the beach"),
    ("b", "a portrait of a person in a garden, oil painting"),
    ("a", "a person reading a book in a cafe"),
]


def build_server(gen):
    """→ (AdaFaceWrapper with random full-size bf16 weights on the card,
    {subject: face images})."""
    from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
    from adaface_tpu_torch.inference.pipeline import PipelineModules
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    t0 = time.perf_counter()
    tok = default_tokenizer()
    modules = PipelineModules.random_init(gen, "cuda", torch.bfloat16, tokenizer=tok)
    enc = Arc2FaceID2AdaPrompt.random_init(gen, tok, "cuda",
                                           face_backend=DeterministicBackend())
    wrapper = AdaFaceWrapper("text2img", modules, enc, guidance_scale=6.0,
                             num_inference_steps=25)
    torch.cuda.synchronize()
    log(f"serve: random full-size weights on the card in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(SEED)
    faces = {"a": [rs.randint(0, 256, (512, 512, 3), np.uint8) for _ in range(2)],
             "b": [rs.randint(0, 256, (512, 512, 3), np.uint8)]}
    return wrapper, faces


def serve(gen) -> dict:
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import attention as A

    wrapper, faces = build_server(gen)

    # a small request, kernels against plain versions on the same inputs
    wrapper.prepare_adaface_embeddings(images=faces["a"])
    small = dict(num_inference_steps=3, height=256, width=256)
    img_k = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(1), **small)
    with plain_versions():
        img_p = wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(1),
                        **small)
    err = (img_k - img_p).abs().max().item()
    log(f"serve: 256x256 3-step request, kernels against plain: image max_abs_err "
        f"{err:.3e} (bound {IMAGE_TOL:g})")
    if err > IMAGE_TOL:
        raise AssertionError(f"request kernels against plain: error {err} above bound")

    _build.reset_launch_counts()
    A.cache_lookups(reset=True)
    latencies, images = [], []
    t_all = time.perf_counter()
    for i, (subject, prompt) in enumerate(REQUESTS):
        t0 = time.perf_counter()
        ada = wrapper.prepare_adaface_embeddings(images=faces[subject])
        with gn_census(wrapper.pipeline.m.vae) as seen:
            img = wrapper(prompt, generator=torch.Generator("cuda").manual_seed(100 + i))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        expect_census(seen, decodes=1)
        if ada is None or tuple(ada.shape) != (16, 768):
            raise AssertionError(f"request {i}: ada embeddings {None if ada is None else ada.shape}")
        if tuple(img.shape) != (1, 3, 512, 512) or not torch.isfinite(img).all():
            raise AssertionError(f"request {i}: image {tuple(img.shape)} not finite or misshaped")
        if img.min() < 0.0 or img.max() > 1.0 or img.std() == 0.0:
            raise AssertionError(f"request {i}: image outside [0, 1] or constant")
        images.append(img)
        log(f"serve: request {i} subject {subject} 512x512 25 steps: "
            f"{latencies[-1] * 1e3:.1f} ms")
    total = time.perf_counter() - t_all
    counts = launch_counts()
    lookups = A.cache_lookups()
    expect_counts(counts, unet_calls=25 * len(REQUESTS), decodes=len(REQUESTS))
    if torch.equal(images[0], images[1]):
        raise AssertionError("two subjects gave the same image")
    log(f"serve: {len(REQUESTS)} requests in {total:.2f} s: {len(REQUESTS) / total:.3f} imgs/sec, "
        f"latency per request {', '.join(f'{x * 1e3:.1f}' for x in latencies)} ms "
        f"(first includes warm-up); launches {counts}; flash cache lookups {lookups}")
    return dict(counts=counts, latencies=latencies, total=total, small_err=err,
                lookups=lookups)


# device operations of a profile by kind, matched on the kernel's name in
# this order; "layout transpose" is cuDNN's layout change around a convolution
PROFILE_KINDS = (("layout transpose", r"nchwToNhwc|nhwcToNchw"),
                 ("convolution", r"fprop|conv|wgrad|dgrad"),
                 ("group norm kernel", r"gn_(stats|norm|fused)"),
                 ("flash kernel", r"flash_"),
                 ("copy", r"copy|Memcpy"),
                 ("concatenation", r"CatArray"),
                 ("matrix product", r"gemm|nvjet|cublas|cutlass"))


def profile_report(prof, label: str, top: int) -> None:
    """Print a torch.profiler run's device time in all, by kind of kernel
    (PROFILE_KINDS) and for its `top` kernels by total time. Sums CUDA-kernel
    events only: the aten-op rows overlap their kernels."""
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != "Memset (Device)":
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time)
    kinds = {kind: [0, 0.0] for kind, _ in PROFILE_KINDS + (("other", ""),)}
    for name, (n, us) in by_name.items():
        kind = next((k for k, pat in PROFILE_KINDS if re.search(pat, name)), "other")
        kinds[kind][0] += n
        kinds[kind][1] += us
    total_n = sum(n for n, _ in by_name.values())
    total = sum(us for _, us in by_name.values())
    log(f"profile {label}: {total / 1e3:.3f} ms of device time in {total_n} device operations; "
        + "; ".join(f"{k} {us / 1e3:.3f} ms x{n}" for k, (n, us) in kinds.items()))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"profile {label}: {us / 1e3:8.3f} ms {n:6d} x  {name[:150]}")


def profile_request(top: int = 25) -> None:
    """Device time by kernel over one 512x512, 25-step request, with
    torch.profiler; not part of the smoke run:

        python3 -c "import chip_smoke as c; c.profile_request()"

    Prints the request's time on the host clock with the profiler off and
    on, the sum of the CUDA kernels' times in all and by kind (layout
    transposes, convolutions, GroupNorm kernels, copies, ...), and the
    kernels by total time."""
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    wrapper, faces = build_server(gen)

    def request(seed):
        t0 = time.perf_counter()
        wrapper.prepare_adaface_embeddings(images=faces["a"])
        wrapper(REQUESTS[0][1], generator=torch.Generator("cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_runs = [request(s) for s in range(3)]  # the first warms up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = request(3)
    log(f"profile: request {', '.join(f'{x:.1f}' for x in plain_runs)} ms unprofiled, "
        f"{profiled:.1f} ms profiled")
    profile_report(prof, "request", top)


def face_parser_batch(rs, batch: int, size: int):
    """Normalized images [B, 3, S, S] fp32 and labels [B, S, S] in 0..18
    with some 255 (ignored), from numpy. Each image gets its own gain and
    per-channel offset, as face crops differ in light and colour: iid noise
    images would give the BNs over pooled [B, 1, 1, C] maps nearly equal
    rows."""
    gain = rs.uniform(0.5, 2.0, (batch, 1, 1, 1))
    offset = rs.uniform(-1.0, 1.0, (batch, 3, 1, 1))
    images = (rs.randn(batch, 3, size, size) * gain + offset).astype(np.float32)
    labels = rs.randint(0, 19, (batch, size, size))
    labels[:, :size // 16] = 255
    return (torch.from_numpy(images).to("cuda", memory_format=torch.channels_last),
            torch.from_numpy(labels).to("cuda"))


@contextmanager
def deterministic_fp32():
    """Deterministic cuDNN algorithms, no TF32 in convolutions or matmuls."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def bn_stats_fp64(x2, eps: float):
    """BN statistics summed in fp64, then rounded to fp32: a second plain
    reference, which sets the envelope of the train-step comparison."""
    xd = x2.double()
    return xd.mean(0).float(), torch.rsqrt(xd.var(0, unbiased=False) + eps).float()


def rel_l2(out: dict, ref: dict) -> tuple[dict, float]:
    """Relative L2 error of each tensor, and of all of them together."""
    per = {n: ((out[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref}
    num = sum(((out[n] - ref[n]) ** 2).sum() for n in ref)
    den = sum((ref[n] ** 2).sum() for n in ref)
    return per, (num / den).sqrt().item()


def train_face_parser(gen) -> dict:
    from adaface_tpu_torch.models.bisenet import N_CLASSES, build_bisenet, parsing_to_face_mask
    from adaface_tpu_torch.ops import _build
    from adaface_tpu_torch.ops import fused_norm as N
    from adaface_tpu_torch.train.face_parsing_train import (
        FaceParsingTrainConfig, face_parsing_loss, make_face_parsing_optimizer,
        make_face_parsing_train_step)

    cfg = FaceParsingTrainConfig()  # the published one: batch 16, crop 448
    rs = np.random.RandomState(SEED)
    batches = [face_parser_batch(rs, cfg.batch_size, cfg.crop_size) for _ in range(2)]
    model = build_bisenet("cuda", gen)
    n_params = sum(p.numel() for p in model.parameters())

    # one step's loss and gradients, kernels against plain, same weights
    def loss_and_grads(m):
        m.zero_grad(set_to_none=True)
        loss, _ = face_parsing_loss(m, *batches[0], cfg)
        loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in m.named_parameters()}

    plain_model, fp64_model = copy.deepcopy(model), copy.deepcopy(model)
    with deterministic_fp32():
        loss_k, grads_k = loss_and_grads(model)
        with plain_versions():
            loss_p, grads_p = loss_and_grads(plain_model)
            with mock.patch.object(N, "bn_stats", bn_stats_fp64):
                _, grads_e = loss_and_grads(fp64_model)
    del plain_model, fp64_model
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    per, glob = rel_l2(grads_k, grads_p)
    per_env, glob_env = rel_l2(grads_e, grads_p)
    worst = max(per, key=per.get)
    bound_glob = max(GRAD_REL_TOL, ENVELOPE * glob_env)
    bound_per = max(GRAD_REL_TOL, ENVELOPE * max(per_env.values()))
    log(f"train: BiSeNet-ResNet18 {n_params} params, batch {cfg.batch_size} crop "
        f"{cfg.crop_size} fp32, deterministic cuDNN, no TF32: loss kernels {loss_k:.6f} plain "
        f"{loss_p:.6f} rel_diff {loss_rel:.3e} (bound {LOSS_REL_TOL:g}); gradients rel L2, "
        f"kernels against plain: all {glob:.3e} (bound {bound_glob:.3e}), largest tensor "
        f"{per[worst]:.3e} at {worst} (bound {bound_per:.3e}); envelope, plain with fp64 "
        f"statistics against plain: all {glob_env:.3e}, largest tensor "
        f"{max(per_env.values()):.3e}")
    if not math.isfinite(loss_k) or loss_rel > LOSS_REL_TOL:
        raise AssertionError(f"train step kernels against plain: loss {loss_k} vs {loss_p}")
    if not (glob <= bound_glob and all(math.isfinite(v) and v <= bound_per
                                       for v in per.values())):
        raise AssertionError(f"train step kernels against plain: gradients rel L2 {glob}, "
                             f"{per[worst]} at {worst}")
    del grads_k, grads_p, grads_e

    # the training path: the port's train step and optimizer, default flags
    opt = make_face_parsing_optimizer(cfg, model)
    step = make_face_parsing_train_step(cfg, model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(*batches[i % 2])
        losses.append(metrics["loss"].item())  # syncs
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    expect_counts(counts, bisenet_forwards=TRAIN_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady = (TRAIN_STEPS - 1) / sum(secs[1:])
    log(f"train: {TRAIN_STEPS} steps, losses {', '.join(f'{v:.4f}' for v in losses)}; "
        f"step times {', '.join(f'{v * 1e3:.1f}' for v in secs)} ms; "
        f"{steady:.3f} steps/sec over steps 2..{TRAIN_STEPS} "
        f"({TRAIN_STEPS / sum(secs):.3f} with the first); peak device memory "
        f"{peak_gib:.2f} GiB; launches {counts}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train: losses not finite: {losses}")

    # eval mode (running statistics, no kernel) at gen_face_masks.py's size
    model.eval()
    image, _ = face_parser_batch(rs, 1, 512)
    _build.reset_launch_counts()
    with torch.inference_mode():
        logits = model(image)
        parsing = logits.argmax(1)[0].cpu().numpy()
    expect_counts(launch_counts())
    mask = parsing_to_face_mask(parsing)
    if tuple(logits.shape) != (1, N_CLASSES, 512, 512) or not torch.isfinite(logits).all():
        raise AssertionError(f"eval: logits {tuple(logits.shape)} not finite or misshaped")
    if mask.shape != (512, 512) or mask.dtype != np.uint8 or not set(
            np.unique(mask)) <= {0, 255}:
        raise AssertionError("eval: face mask is not a binary [512, 512] uint8 map")
    log(f"eval: 512x512 forward to a face mask, {(mask > 0).mean():.3f} of pixels face")
    return dict(counts=counts, losses=losses, secs=secs, steps_per_sec=steady,
                peak_gib=peak_gib, loss_rel=loss_rel, grad_rel=glob, grad_rel_env=glob_env)


def kernel_record(flash: dict, gn: dict, bn: dict, ln: dict, counts: dict) -> dict:
    """The per-kernel record. Each flash kernel counts its launches under
    keys of its own, so an entry's `launches` are those of the kernel in its
    `source`: the wgmma kernel's two entries, the wide kernel's (whose
    `max_abs_err` also covers the tensors off the path that it takes: the
    misaligned case and the masked ones at D 64 and D 200) and the combine
    kernel's. The fp32 CUDA-core kernel is on no path and has no entry; its
    masked case is held against plain above. `ms`, `plain_ms`, `library_ms`
    (one stock PyTorch call that computes the same function, else null) and
    `bound_ms` are those of the shape named in `shape`; the flash entries
    also list every path shape under `shapes`. The one-launch GroupNorm
    kernel stands for both TPU GroupNorm kernels (`replaces`, `replaces_also`)
    and has `F.group_norm` (+ `F.silu`) in the same memory format as its
    library call; its `shapes` hold every path shape it takes, `per_request`
    the sums over all GroupNorms of a request. The split GroupNorm pair and
    BatchNorm are two kernels for what the library's fused op does in one
    call: the statistics kernels have `torch.var_mean` and
    `torch.batch_norm_stats` as their library call, the normalize kernels
    none, and all four carry the pair's times (`pair_ms`, `pair_library_ms`).
    `graph_ms` is the device time of a launch (20 launches in a CUDA graph)."""
    from adaface_tpu_torch.ops.attention import FLASH_COMBINE, FLASH_STD, FLASH_T, FLASH_WIDE
    from adaface_tpu_torch.ops.fused_gn import GN_FUSED, GN_NORM, GN_STATS
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS

    def entry(name, source, replaces, err, shape, ms, plain_ms, library_ms, bound_ms,
              bound_by="bytes", **extra):
        return {"name": name, "route": "cuda", "source": f"adaface_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": counts[name], "max_abs_err": err,
                "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, **extra}

    def flash_entry(name, source, replaces, errs, shape, labels):
        r = flash[shape]
        shapes = {label: {"ms": flash[label]["ms"], "run_ms": flash[label]["run_ms"],
                          "plain_ms": flash[label]["plain_ms"],
                          "library_ms": flash[label]["stock_ms"],
                          "library_run_ms": flash[label]["stock_run_ms"],
                          "graph_ms": flash[label]["graph_ms"],
                          "library_graph_ms": flash[label]["stock_graph_ms"],
                          "host_us": flash[label]["host_us"],
                          "library_host_us": flash[label]["stock_host_us"],
                          "bound_ms": flash[label]["bound_ms"],
                          "bound_by": flash[label]["bound_by"]} for label in labels}
        return entry(name, source, replaces, max(errs), shape, r["ms"], r["plain_ms"],
                     r["stock_ms"], r["bound_ms"], r["bound_by"], shapes=shapes)

    path = {label: d for (label, *_, d) in FLASH_CASES}
    short = [label for label, d in path.items() if flash[label]["variant"] == "wg" and d < 128]
    long_ = [label for label, d in path.items() if flash[label]["variant"] == "wg" and d >= 128]
    wide = [label for label in path if flash[label]["variant"] == "wide"]
    # off the path: the contiguous case counts as FLASH_T, the masked and
    # causal ones as FLASH_STD, whatever the wide kernel takes as FLASH_WIDE
    off_path = {k: r for k, r in flash.items() if k not in path and k != "combine"}
    short_off = [r["err"] for k, r in off_path.items()
                 if r["variant"] == "wg" and not k.startswith("masked")]
    long_off = [r["err"] for k, r in off_path.items()
                if r["variant"] == "wg" and k.startswith("masked")]
    wide_off = [r["err"] for r in off_path.values() if r["variant"] == "wide"]
    g, gs, b_, l_, c = gn[JSON_GN], gn[JSON_GN_SPLIT], bn[JSON_BN], ln[JSON_LN], flash["combine"]
    gn_keys = ("ms", "graph_ms", "plain_ms", "stock_ms", "stock_graph_ms", "host_us",
               "stock_host_us", "bound_fn", "launches")
    gn_shapes = {kind: {case[0]: {k.replace("stock", "library"): gn[case[0]][k] for k in gn_keys}
                        for case in GN_CASES if gn[case[0]]["kernel"] == kind}
                 for kind in ("fused", "split")}
    gn_errs = lambda kind, key: max(r[key] for r in gn.values()
                                    if isinstance(r, dict) and r.get("kernel") == kind)
    gn_pair = dict(pair_ms=gs["ms"], pair_library_ms=gs["stock_ms"], pair_graph_ms=gs["graph_ms"],
                   pair_library_graph_ms=gs["stock_graph_ms"], shapes=gn_shapes["split"])
    bn_pair = dict(pair_ms=b_["ms"], pair_library_ms=b_["stock_ms"], pair_graph_ms=b_["graph_ms"],
                   pair_library_graph_ms=b_["stock_graph_ms"])
    return {"kernels": [
        flash_entry(FLASH_T, "flash_attn_wgmma.cu", "adaface_tpu/ops/attention.py:165",
                    [flash[k]["err"] for k in short] + short_off, JSON_FLASH_T, short),
        flash_entry(FLASH_STD, "flash_attn_wgmma.cu", "adaface_tpu/ops/attention.py:89",
                    [flash[k]["err"] for k in long_] + long_off, JSON_FLASH_STD, long_),
        flash_entry(FLASH_WIDE, "flash_attn_wide.cu", "adaface_tpu/ops/attention.py:89",
                    [flash[k]["err"] for k in wide] + wide_off, JSON_FLASH_WIDE, wide),
        entry(FLASH_COMBINE, "flash_attn_wide.cu", "adaface_tpu/ops/attention.py:89",
              c["err"], "2 splits of vae mid self", c["ms"], c["plain_ms"], None,
              c["bound_ms"], c["bound_by"]),
        entry(GN_FUSED, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:23",
              gn_errs("fused", "err"), JSON_GN, g["ms"], g["plain_ms"], g["stock_ms"],
              g["bound_fn"], replaces_also="adaface_tpu/ops/fused_gn.py:40",
              graph_ms=g["graph_ms"], library_graph_ms=g["stock_graph_ms"],
              shapes=gn_shapes["fused"], per_request=gn["per request"]),
        entry(GN_STATS, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:23",
              gn_errs("split", "stats_err"), JSON_GN_SPLIT, gs["ms_stats"], gs["plain_stats"],
              gs["stock_stats"], gs["bound_stats"], graph_ms=gs["graph_stats"],
              library_graph_ms=gs["stock_graph_stats"], **gn_pair),
        entry(GN_NORM, "group_norm_silu.cu", "adaface_tpu/ops/fused_gn.py:40",
              gn_errs("split", "norm_err"), JSON_GN_SPLIT, gs["ms_norm"], gs["plain_norm"], None,
              gs["bound_norm"], graph_ms=gs["graph_norm"], **gn_pair),
        entry(BN_STATS, "batch_norm_act.cu", "adaface_tpu/ops/fused_norm.py:31",
              max(r["stats_abs"] for r in bn.values()), JSON_BN, b_["ms_stats"],
              b_["plain_stats"], b_["stock_stats"], b_["bound_stats"],
              graph_ms=b_["graph_stats"], library_graph_ms=b_["stock_graph_stats"], **bn_pair),
        entry(BN_NORM_ACT, "batch_norm_act.cu", "adaface_tpu/ops/fused_norm.py:48",
              max(r["norm_err"] for r in bn.values()), JSON_BN, b_["ms_norm"],
              b_["plain_norm"], None, b_["bound_norm"], graph_ms=b_["graph_norm"], **bn_pair),
        entry(LAYER_NORM, "layer_norm.cu", "adaface_tpu/ops/fused_ln.py:25",
              max(r["err"] for r in ln.values()), JSON_LN, l_["ms"], l_["plain_ms"],
              l_["stock_ms"], l_["bound_ms"], graph_ms=l_["graph_ms"],
              library_graph_ms=l_["stock_graph_ms"]),
    ]}


def main() -> int:
    t0 = time.perf_counter()
    card = require_cuda()
    build_kernels()
    flash, gn, bn, ln = check_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    unet = check_unet(gen)
    served = serve(gen)
    trained = train_face_parser(gen)
    log(f"card: {card}; whole run {time.perf_counter() - t0:.1f} s")
    # each kernel's launches in the path that runs it
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM

    counts = {**served["counts"], **trained["counts"],
              LAYER_NORM: unet["ln_counts"][LAYER_NORM]}
    print(json.dumps(kernel_record(flash, gn, bn, ln, counts)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
