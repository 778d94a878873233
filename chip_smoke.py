"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from `adaface_tpu_torch/csrc/`;
  3. hold every kernel against its plain PyTorch version at the shapes its
     path gives it: the SD1.5 serving path's (bf16), the fused-LN UNet's
     (LayerNorm, bf16) and the face parser's (train-mode BN + activation at
     batch 16, 448x448, fp32, with the BN Function's gradients); print errors
     and median times (the stock PyTorch op beside them, for the record
     only);
  4. one full-width SD1.5 UNet call at CFG batch 2, kernels against plain;
     then the same call in the fused-LN configuration (`fused_ln=True`),
     kernels against plain, with its 48 LayerNorm launches;
  5. the personalized text-to-image path through the port's AdaFaceWrapper:
     a small request, kernels against plain; then 3 requests for 2
     subjects at 512x512, 25 DDIM steps, guidance 6.0, random full-size
     weights from a seeded torch.Generator, with the kernels' launch counts;
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
# (label, shape, groups, eps, silu): GroupNorms of the UNet (CFG batch 2) and
# of the VAE decoder (batch 1)
GN_CASES = [
    ("unet resnet 64x64", (2, 320, 64, 64), 32, 1e-5, True),
    ("unet resnet concat 64x64", (2, 960, 64, 64), 32, 1e-5, True),
    ("unet transformer 64x64", (2, 320, 64, 64), 32, 1e-6, False),
    ("unet resnet 32x32", (2, 640, 32, 32), 32, 1e-5, True),
    ("unet resnet 16x16", (2, 1280, 16, 16), 32, 1e-5, True),
    ("unet resnet concat 8x8", (2, 2560, 8, 8), 32, 1e-5, True),
    ("vae mid attn norm 64x64", (1, 512, 64, 64), 32, 1e-6, False),
    ("vae resnet 256x256", (1, 512, 256, 256), 32, 1e-6, True),
    ("vae resnet 512x512 256ch", (1, 256, 512, 512), 32, 1e-6, True),
    ("vae resnet 512x512", (1, 128, 512, 512), 32, 1e-6, True),
]
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
JSON_GN = "unet resnet 64x64"
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


def max_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max(1, max |ref|)) in fp32."""
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    return (out - ref).abs().max().item(), max(1.0, ref.abs().max().item())


def check_flash(gen) -> dict:
    from adaface_tpu_torch.ops import attention as A

    results = {}

    def qkv(b, h, sq, sk, d, dtype):
        mk = lambda s: torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        return mk(sq), mk(sk), mk(sk)

    for label, b, h, sq, sk, d in FLASH_CASES:
        q, k, v = qkv(b, h, sq, sk, d, torch.bfloat16)
        out = A._flash_cuda(q, k, v, None, False, 1.0 / math.sqrt(d))
        ref = A.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
        err, mag = max_err(out, ref)
        ok = err <= BF16_TOL * mag
        ms = median_ms(lambda: A._flash_cuda(q, k, v, None, False, 1.0 / math.sqrt(d)))
        plain_ms = median_ms(lambda: A.scaled_dot_product_attention(q, k, v))
        stock_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        log(f"flash {label:18s} B{b} H{h} Sq{sq} Sk{sk} D{d}: max_abs_err {err:.3e} "
            f"(bound {BF16_TOL * mag:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"stock sdpa {stock_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"flash {label}: error {err} above bound")
        results[label] = dict(err=err, ms=ms, plain_ms=plain_ms, stock_ms=stock_ms)

    # masked + causal at ragged lengths (Sq 200, Sk 177: the causal offset
    # Sk - Sq = -23 leaves rows 0..22 only masked keys; batch 1 also masks
    # keys 0..15), on both variants of the kernel: bf16 D 64 (tensor cores),
    # bf16 D 200 and fp32 D 64 (CUDA cores)
    for dtype, d, tol in ((torch.bfloat16, 64, BF16_TOL), (torch.bfloat16, 200, BF16_TOL),
                          (torch.float32, 64, FP32_TOL)):
        q, k, v = qkv(2, 2, 200, 177, d, dtype)
        mask = torch.ones((2, 177), device="cuda")
        mask[1, :16] = 0.0
        mask[0, 150:] = 0.0
        out = A._flash_cuda(q, k, v, mask, True, 1.0 / math.sqrt(d))
        ref = A.scaled_dot_product_attention(q, k, v, kv_mask=mask, causal=True)
        err, mag = max_err(out, ref)
        log(f"flash masked+causal Sq200 Sk177 D{d} {dtype}: max_abs_err {err:.3e} "
            f"(bound {tol * mag:.3e})")
        if err > tol * mag:
            raise AssertionError(f"flash masked+causal D{d} {dtype}: error {err} above bound")
        results[f"masked causal D{d} {dtype}"] = dict(err=err)
    return results


def check_gn(gen) -> dict:
    from adaface_tpu_torch.ops import fused_gn as G

    results = {}
    for label, shape, groups, eps, silu in GN_CASES:
        c = shape[1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(torch.bfloat16)
        scale = (torch.randn((c,), generator=gen, device="cuda") + 1.0).to(torch.bfloat16)
        bias = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        stats = G.gn_stats(x, groups, eps)
        stats_ref = G.gn_stats_plain(x, groups, eps)
        stats_err = (stats - stats_ref).abs().max().item()
        norm = G.gn_norm(x, stats, scale, bias, groups, silu)
        norm_err, mag = max_err(norm, G.gn_norm_plain(x, stats, scale, bias, groups, silu))
        err, mag = max_err(G.group_norm_silu(x, scale, bias, groups, eps, silu),
                           G.gn_silu_plain(x, scale, bias, groups, eps, silu))
        torch.cuda.synchronize()
        ms_stats = median_ms(lambda: G.gn_stats(x, groups, eps))
        plain_stats = median_ms(lambda: G.gn_stats_plain(x, groups, eps))
        ms_norm = median_ms(lambda: G.gn_norm(x, stats, scale, bias, groups, silu))
        plain_norm = median_ms(lambda: G.gn_norm_plain(x, stats, scale, bias, groups, silu))
        ms = median_ms(lambda: G.group_norm_silu(x, scale, bias, groups, eps, silu))
        plain_ms = median_ms(lambda: G.gn_silu_plain(x, scale, bias, groups, eps, silu))
        act = F.silu if silu else (lambda t: t)
        stock_ms = median_ms(lambda: act(F.group_norm(x, groups, scale, bias, eps)))
        log(f"gn {label:26s} {shape} eps {eps:g} silu {silu}: stats max_abs_err {stats_err:.3e} "
            f"norm max_abs_err {norm_err:.3e} full max_abs_err {err:.3e} "
            f"(bound {BF16_TOL * mag:.3e}) | stats {ms_stats:.3f} ms (plain {plain_stats:.3f}) "
            f"norm {ms_norm:.3f} ms (plain {plain_norm:.3f}) "
            f"full {ms:.3f} ms plain {plain_ms:.3f} ms stock {stock_ms:.3f} ms")
        if stats_err > FP32_TOL or norm_err > BF16_TOL * mag or err > BF16_TOL * mag:
            raise AssertionError(f"gn {label}: error above bound")
        results[label] = dict(stats_err=stats_err, norm_err=norm_err, err=err,
                              ms_stats=ms_stats, plain_stats=plain_stats,
                              ms_norm=ms_norm, plain_norm=plain_norm, ms=ms,
                              plain_ms=plain_ms, stock_ms=stock_ms)
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
        log(f"bn {label:20s} R{r} C{c} slope {slope:g} {dtype}: stats rel_err {stats_err:.3e} "
            f"(bound {FP32_TOL:g}) norm max_abs_err {norm_err:.3e} (bound {tol * mag:.3e}) "
            f"full max_abs_err {err:.3e} | stats {ms_stats:.3f} ms (plain {plain_stats:.3f}) "
            f"norm {ms_norm:.3f} ms (plain {plain_norm:.3f}) full {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms stock {stock_ms:.3f} ms")
        if stats_err > FP32_TOL or norm_err > tol * mag or err > tol * mag_full:
            raise AssertionError(f"bn {label}: error above bound")
        results[label] = dict(stats_err=stats_err, stats_abs=stats_abs, norm_err=norm_err,
                              err=err, ms_stats=ms_stats, plain_stats=plain_stats,
                              ms_norm=ms_norm, plain_norm=plain_norm, ms=ms, plain_ms=plain_ms,
                              stock_ms=stock_ms)
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
        log(f"ln {label:16s} [{rows}, {c}] {dtype}: max_abs_err {err:.3e} "
            f"(bound {tol * mag:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"stock {stock_ms:.3f} ms")
        if err > tol * mag:
            raise AssertionError(f"ln {label}: error {err} above bound")
        results[label] = dict(err=err, ms=ms, plain_ms=plain_ms, stock_ms=stock_ms)
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
        flash, gn, bn, ln = check_flash(gen), check_gn(gen), check_bn(gen), check_ln(gen)
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


def expect_counts(counts: dict, unet_calls: int = 0, decodes: int = 0,
                  fused_ln_calls: int = 0, bisenet_forwards: int = 0):
    """30 flash launches per UNet call (20 at head dim 40/80, 10 at 160)
    and 1 per VAE decode (D 512); 61 GroupNorms per UNet call, 30 per
    decode, each one gn_stats and one gn_norm launch; 48 LayerNorm launches
    per UNet call in the fused-LN configuration (16 transformer blocks x 3),
    0 in the default one; one bn_stats and one bn_norm_act launch for each
    of the 31 train-mode BNs of a BiSeNet forward. No other launch."""
    from adaface_tpu_torch.ops.attention import FLASH_STD, FLASH_T
    from adaface_tpu_torch.ops.fused_gn import GN_NORM, GN_STATS
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS

    want = {FLASH_T: 20 * unet_calls, FLASH_STD: 10 * unet_calls + decodes,
            GN_STATS: 61 * unet_calls + 30 * decodes,
            GN_NORM: 61 * unet_calls + 30 * decodes,
            LAYER_NORM: 48 * fused_ln_calls,
            BN_STATS: BISENET_BNS * bisenet_forwards,
            BN_NORM_ACT: BISENET_BNS * bisenet_forwards}
    want = {k: v for k, v in want.items() if v}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")


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
        eps = unet(x, t, ctx).float()
        torch.cuda.synchronize()
        expect_counts(launch_counts(), unet_calls=1, decodes=0)
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
    latencies, images = [], []
    t_all = time.perf_counter()
    for i, (subject, prompt) in enumerate(REQUESTS):
        t0 = time.perf_counter()
        ada = wrapper.prepare_adaface_embeddings(images=faces[subject])
        img = wrapper(prompt, generator=torch.Generator("cuda").manual_seed(100 + i))
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
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
    expect_counts(counts, unet_calls=25 * len(REQUESTS), decodes=len(REQUESTS))
    if torch.equal(images[0], images[1]):
        raise AssertionError("two subjects gave the same image")
    log(f"serve: {len(REQUESTS)} requests in {total:.2f} s: {len(REQUESTS) / total:.3f} imgs/sec, "
        f"latency per request {', '.join(f'{x * 1e3:.1f}' for x in latencies)} ms "
        f"(first includes warm-up); launches {counts}")
    return dict(counts=counts, latencies=latencies, total=total, small_err=err)


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
    from adaface_tpu_torch.ops.attention import FLASH_STD, FLASH_T
    from adaface_tpu_torch.ops.fused_gn import GN_NORM, GN_STATS
    from adaface_tpu_torch.ops.fused_ln import LAYER_NORM
    from adaface_tpu_torch.ops.fused_norm import BN_NORM_ACT, BN_STATS

    short = [r["err"] for (label, *_, d) in FLASH_CASES for r in [flash[label]] if d < 128]
    long_ = [r["err"] for (label, *_, d) in FLASH_CASES for r in [flash[label]] if d >= 128]
    long_ += [v["err"] for k, v in flash.items() if k.startswith("masked causal")]
    src_fa = "adaface_tpu_torch/csrc/flash_attn_fwd.cu"
    src_gn = "adaface_tpu_torch/csrc/group_norm_silu.cu"
    src_bn = "adaface_tpu_torch/csrc/batch_norm_act.cu"
    return {"kernels": [
        {"name": FLASH_T, "route": "cuda", "source": src_fa,
         "replaces": "adaface_tpu/ops/attention.py:165", "launches": counts[FLASH_T],
         "max_abs_err": max(short), "ms": flash[JSON_FLASH_T]["ms"],
         "plain_ms": flash[JSON_FLASH_T]["plain_ms"]},
        {"name": FLASH_STD, "route": "cuda", "source": src_fa,
         "replaces": "adaface_tpu/ops/attention.py:89", "launches": counts[FLASH_STD],
         "max_abs_err": max(long_), "ms": flash[JSON_FLASH_STD]["ms"],
         "plain_ms": flash[JSON_FLASH_STD]["plain_ms"]},
        {"name": GN_STATS, "route": "cuda", "source": src_gn,
         "replaces": "adaface_tpu/ops/fused_gn.py:23", "launches": counts[GN_STATS],
         "max_abs_err": max(r["stats_err"] for r in gn.values()),
         "ms": gn[JSON_GN]["ms_stats"], "plain_ms": gn[JSON_GN]["plain_stats"]},
        {"name": GN_NORM, "route": "cuda", "source": src_gn,
         "replaces": "adaface_tpu/ops/fused_gn.py:40", "launches": counts[GN_NORM],
         "max_abs_err": max(r["norm_err"] for r in gn.values()),
         "ms": gn[JSON_GN]["ms_norm"], "plain_ms": gn[JSON_GN]["plain_norm"]},
        {"name": BN_STATS, "route": "cuda", "source": src_bn,
         "replaces": "adaface_tpu/ops/fused_norm.py:31", "launches": counts[BN_STATS],
         "max_abs_err": max(r["stats_abs"] for r in bn.values()),
         "ms": bn[JSON_BN]["ms_stats"], "plain_ms": bn[JSON_BN]["plain_stats"]},
        {"name": BN_NORM_ACT, "route": "cuda", "source": src_bn,
         "replaces": "adaface_tpu/ops/fused_norm.py:48", "launches": counts[BN_NORM_ACT],
         "max_abs_err": max(r["norm_err"] for r in bn.values()),
         "ms": bn[JSON_BN]["ms_norm"], "plain_ms": bn[JSON_BN]["plain_norm"]},
        {"name": LAYER_NORM, "route": "cuda", "source": "adaface_tpu_torch/csrc/layer_norm.cu",
         "replaces": "adaface_tpu/ops/fused_ln.py:25", "launches": counts[LAYER_NORM],
         "max_abs_err": max(r["err"] for r in ln.values()),
         "ms": ln[JSON_LN]["ms"], "plain_ms": ln[JSON_LN]["plain_ms"]},
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
