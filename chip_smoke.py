"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from `adaface_tpu_torch/csrc/`;
  3. hold every kernel against its plain PyTorch version, in bf16, at the
     shapes the SD1.5 serving path gives it; print errors and median times
     (the stock PyTorch op beside them, for the record only);
  4. one full-width SD1.5 UNet call at CFG batch 2, kernels against plain;
  5. the personalized text-to-image path through the port's AdaFaceWrapper:
     a small request, kernels against plain; then 3 requests for 2
     subjects at 512x512, 25 DDIM steps, guidance 6.0, random full-size
     weights from a seeded torch.Generator, with the kernels' launch counts.
The line before the last holds the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.

The script imports only torch, numpy and the port (`adaface_tpu_torch`).
"""

from __future__ import annotations

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
# shapes whose times go into the JSON record: the heaviest of each kernel
# that the UNet, which runs 25 times per image, gives it
JSON_FLASH_T = "unet 64x64 self"
JSON_FLASH_STD = "unet 16x16 self"
JSON_GN = "unet resnet 64x64"


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


def check_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        return check_flash(gen), check_gn(gen)


@contextmanager
def plain_versions():
    """Route the port's kernel wrappers to their plain versions on CUDA
    tensors, for the kernel-against-plain comparisons of whole modules."""
    from adaface_tpu_torch.ops import attention as A
    from adaface_tpu_torch.ops import fused_gn as G

    def flash_plain(q, k, v, kv_mask=None, causal=False, scale=None):
        return A.scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                              scale=scale)

    with mock.patch.object(A, "flash_attention", flash_plain), \
            mock.patch.object(G, "group_norm_silu", G.gn_silu_plain):
        yield


def launch_counts() -> dict:
    from adaface_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


def expect_counts(counts: dict, unet_calls: int, decodes: int):
    """30 flash launches per UNet call (20 at head dim 40/80, 10 at 160)
    and 1 per VAE decode (D 512); 61 GroupNorms per UNet call, 30 per
    decode, each one gn_stats and one gn_norm launch."""
    from adaface_tpu_torch.ops.attention import FLASH_STD, FLASH_T
    from adaface_tpu_torch.ops.fused_gn import GN_NORM, GN_STATS

    want = {FLASH_T: 20 * unet_calls, FLASH_STD: 10 * unet_calls + decodes,
            GN_STATS: 61 * unet_calls + 30 * decodes,
            GN_NORM: 61 * unet_calls + 30 * decodes}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")


def check_unet(gen) -> dict:
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.ops import _build

    unet = build(lambda: UNet2DConditionModel(SD15_UNET), "cuda", torch.bfloat16,
                 init_unet_weights_, gen)
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
    del unet
    torch.cuda.empty_cache()
    return dict(rel=rel, ms=ms, plain_ms=plain_ms)


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


def kernel_record(flash: dict, gn: dict, counts: dict) -> dict:
    from adaface_tpu_torch.ops.attention import FLASH_STD, FLASH_T
    from adaface_tpu_torch.ops.fused_gn import GN_NORM, GN_STATS

    short = [r["err"] for (label, *_, d) in FLASH_CASES for r in [flash[label]] if d < 128]
    long_ = [r["err"] for (label, *_, d) in FLASH_CASES for r in [flash[label]] if d >= 128]
    long_ += [v["err"] for k, v in flash.items() if k.startswith("masked causal")]
    src_fa = "adaface_tpu_torch/csrc/flash_attn_fwd.cu"
    src_gn = "adaface_tpu_torch/csrc/group_norm_silu.cu"
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
    ]}


def main() -> int:
    t0 = time.perf_counter()
    card = require_cuda()
    build_kernels()
    flash, gn = check_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    check_unet(gen)
    served = serve(gen)
    log(f"card: {card}; whole run {time.perf_counter() - t0:.1f} s")
    print(json.dumps(kernel_record(flash, gn, served["counts"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
