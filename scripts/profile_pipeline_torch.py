"""Stage-level profile of the PyTorch port's inference pipeline on one GPU:
the counterpart of `scripts/profile_pipeline.py`.

Times each stage of `bench_torch.py`'s configuration (random SD1.5-sized
bf16 weights, 512², 25-step CFG DDIM, guidance 6.0) at one batch: the text
encode, one UNet call at CFG batch 2·batch, the 25-step loop less its two
text encodes (cond and uncond) and the VAE decode. Each stage has its time
between CUDA events (the mean of a few calls after a warm-up) and its device
time (the sum of its kernels' durations under `torch.profiler`, one call).
Prints each stage's share, the loop's overhead beyond 25 UNet calls, and the
UNet call's model FLOP utilisation: its FLOPs counted analytically from the
`UNetConfig` (`unet_flops`: convolutions, linear layers, and attention as
4·B·H·Sq·Sk·D) over the card's dense bf16 peak (`BF16_PEAK`), beside the
card's name and power limit.

    python scripts/profile_pipeline_torch.py [batch]      # default 32
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

PROMPT = "portrait photo of z person at the beach, high quality"
NEGATIVE_PROMPT = "lowres, low quality"
STEPS = 25
BF16_PEAK = 989e12  # dense bf16 tensor-core FLOP/s of an H100 SXM


def _conv(b: int, cin: int, cout: int, k: int, hw: int) -> int:
    return 2 * b * hw * hw * cin * cout * k * k


def _linear(rows: int, cin: int, cout: int) -> int:
    return 2 * rows * cin * cout


def _attention(b: int, sq: int, sk: int, width: int) -> int:
    """4·B·H·Sq·Sk·D with H·D = width: the logits and the weighted values."""
    return 4 * b * sq * sk * width


def unet_flops(cfg, batch: int, latent_hw: int = 64, context_len: int = 77) -> int:
    """FLOPs of one `UNet2DConditionModel(cfg)` call on [batch, C, hw, hw]
    latents with a context of `context_len` tokens: every convolution and
    linear layer (2 per multiply-add) and every attention's two products;
    the normalizations, activations and adds are not counted."""
    from adaface_tpu_torch.models.unet import _block_depth

    b, ch, temb = batch, cfg.block_channels, cfg.time_embed_dim
    flops = _conv(b, cfg.in_channels, ch[0], 3, latent_hw)
    flops += _linear(b, ch[0], temb) + _linear(b, temb, temb)
    if cfg.addition_time_embed_dim is not None:
        add_in = cfg.addition_pooled_dim + cfg.addition_num_time_ids * cfg.addition_time_embed_dim
        flops += _linear(b, add_in, temb) + _linear(b, temb, temb)

    def resnet(cin, cout, hw):
        f = _conv(b, cin, cout, 3, hw) + _linear(b, temb, cout) + _conv(b, cout, cout, 3, hw)
        return f + (_conv(b, cin, cout, 1, hw) if cin != cout else 0)

    def transformer(c, hw, depth):
        n, rows = hw * hw, b * hw * hw
        f = 2 * _conv(b, c, c, 1, hw)
        per_block = (_linear(rows, c, 3 * c) + _attention(b, n, n, c) + _linear(rows, c, c)
                     + _linear(rows, c, c) + _linear(b * context_len, cfg.cross_attn_dim, 2 * c)
                     + _attention(b, n, context_len, c) + _linear(rows, c, c)
                     + _linear(rows, c, 8 * c) + _linear(rows, 4 * c, c))
        return f + depth * per_block

    hw, cin = latent_hw, ch[0]
    for bi, cout in enumerate(ch):
        for li in range(cfg.layers_per_block):
            flops += resnet(cin if li == 0 else cout, cout, hw)
            if cfg.down_has_attn[bi]:
                flops += transformer(cout, hw, _block_depth(cfg, bi))
        if bi < len(ch) - 1:
            hw //= 2
            flops += _conv(b, cout, cout, 3, hw)
        cin = cout
    flops += 2 * resnet(ch[-1], ch[-1], hw)
    flops += transformer(ch[-1], hw, cfg.mid_transformer_depth)
    rev = list(reversed(ch))
    for bi in range(len(ch)):
        cout, prev_out = rev[bi], rev[max(bi - 1, 0)]
        for li in range(cfg.layers_per_block + 1):
            skip = rev[min(bi + 1, len(ch) - 1)] if li == cfg.layers_per_block else cout
            flops += resnet((prev_out if li == 0 else cout) + skip, cout, hw)
            if cfg.up_has_attn[bi]:
                flops += transformer(cout, hw, _block_depth(cfg, len(ch) - 1 - bi))
        if bi < len(ch) - 1:
            hw *= 2
            flops += _conv(b, cout, cout, 3, hw)
    return flops + _conv(b, ch[0], cfg.out_channels, 3, latent_hw)


def event_ms(fn, n: int = 3, warmup: int = 1):
    """(mean ms a call between CUDA events over `n` calls after `warmup`,
    the last call's output)."""
    for _ in range(warmup):
        out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, out


@torch.inference_mode()
def profile_stages(pipe, batch: int, n: int = 3, loop_n: int = 2) -> dict:
    """Each stage's ms between CUDA events and of device time at `batch`, the
    shares, the loop's overhead beyond 25 UNet calls and the UNet's MFU on
    both clocks (the pipeline on the card)."""
    m = pipe.m
    prompts = [PROMPT] * batch
    from adaface_tpu_torch.utils.profiling import device_operations

    dev, dt = pipe.device, pipe.dtype
    text = lambda: pipe.encode_prompt(prompts)[0]  # noqa: E731
    b2 = 2 * batch
    cfg = m.unets[0].cfg
    x = torch.zeros((b2, cfg.in_channels, 64, 64), dtype=dt, device=dev)
    t = torch.full((b2,), 500, dtype=torch.long, device=dev)
    ctx = torch.zeros((b2, 77, cfg.cross_attn_dim), dtype=dt, device=dev)
    unet = lambda: m.unet_eps(x, t, ctx)  # noqa: E731

    def loop():
        return pipe(prompts, negative_prompt=NEGATIVE_PROMPT, num_inference_steps=STEPS,
                    guidance_scale=6.0, generator=torch.Generator(dev).manual_seed(1),
                    return_latents=True)

    out = {"batch": batch}
    out["text_ms"], _ = event_ms(text, n)
    _, out["text_device_ms"] = device_operations(text, warmup=False)
    out["unet_ms"], _ = event_ms(unet, n)
    out["unet_operations"], out["unet_device_ms"] = device_operations(unet, warmup=False)
    loop_ms, z0 = event_ms(loop, loop_n)
    out["loop_operations"], loop_dev = device_operations(loop, warmup=False)
    # the pipeline encodes the prompt twice (cond, uncond): not the loop's
    out["loop_ms"] = max(loop_ms - 2 * out["text_ms"], 0.0)
    out["loop_device_ms"] = max(loop_dev - 2 * out["text_device_ms"], 0.0)
    decode = lambda: m.vae(z0.to(dt))  # noqa: E731
    out["decode_ms"], _ = event_ms(decode, n)
    _, out["decode_device_ms"] = device_operations(decode, warmup=False)
    for clock in ("", "_device"):
        total = out[f"loop{clock}_ms"] + out[f"decode{clock}_ms"] + 2 * out[f"text{clock}_ms"]
        out[f"total{clock}_ms"] = total
        out[f"shares{clock}"] = {"text": 2 * out[f"text{clock}_ms"] / total,
                                 "loop": out[f"loop{clock}_ms"] / total,
                                 "decode": out[f"decode{clock}_ms"] / total}
        out[f"loop_overhead{clock}_ms"] = out[f"loop{clock}_ms"] - STEPS * out[f"unet{clock}_ms"]
    out["imgs_per_sec"] = batch / (out["total_ms"] / 1e3)
    flops = unet_flops(cfg, b2)
    out["unet_flops"] = flops
    out["unet_tflops_per_s"] = flops / (out["unet_ms"] / 1e3) / 1e12
    out["mfu"] = flops / (out["unet_ms"] / 1e3) / BF16_PEAK
    out["mfu_device"] = flops / (out["unet_device_ms"] / 1e3) / BF16_PEAK
    return out


def report(r: dict, card: str) -> str:
    b, b2 = r["batch"], 2 * r["batch"]
    return "\n".join([
        f"batch={b}  card: {card}",
        f"text encode       : {r['text_ms']:9.1f} ms events, {r['text_device_ms']:9.1f} ms "
        f"device (x2 a request: {r['shares']['text']:5.1%})",
        f"1 UNet call (B{b2}) : {r['unet_ms']:9.1f} ms events, {r['unet_device_ms']:9.1f} ms "
        f"device  flops={r['unet_flops'] / 1e12:.2f}T  {r['unet_tflops_per_s']:.1f} TFLOP/s  "
        f"mfu@{BF16_PEAK / 1e12:.0f}T={r['mfu']:5.1%} (device {r['mfu_device']:5.1%})",
        f"25-step DDIM loop : {r['loop_ms']:9.1f} ms events, {r['loop_device_ms']:9.1f} ms "
        f"device ({r['shares']['loop']:5.1%})  [25x unet = {STEPS * r['unet_ms']:.1f} ms -> "
        f"loop overhead {r['loop_overhead_ms']:.1f} ms events, "
        f"{r['loop_overhead_device_ms']:.1f} ms device]",
        f"VAE decode        : {r['decode_ms']:9.1f} ms events, {r['decode_device_ms']:9.1f} ms "
        f"device ({r['shares']['decode']:5.1%})",
        f"total             : {r['total_ms']:9.1f} ms  -> {r['imgs_per_sec']:.3f} imgs/s"])


def main(argv=None) -> None:
    from adaface_tpu_torch.core.device import require_card
    from adaface_tpu_torch.inference.pipeline import DiffusionPipeline, PipelineModules

    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if argv else 32
    card = require_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe = DiffusionPipeline(PipelineModules.random_init(gen, "cuda", torch.bfloat16))
    r = profile_stages(pipe, batch)
    print(report(r, card))
    print(json.dumps({**r, "card": card}))


if __name__ == "__main__":
    main()
