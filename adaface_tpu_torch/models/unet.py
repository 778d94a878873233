"""SD1.5 UNet (UNet2DConditionModel), the text→image serving path.

Counterpart of `unet_apply` in `adaface_tpu/models/unet.py` with no LoRA,
DeepCache, ToMe, int8 or motion branch. NCHW latents in and out, as the JAX
interface (`unet.py:685`). Two options of `unet_apply` that the recon
iteration uses are ported: `img_mask` [B, 1, H, W] drops the keys outside
the mask from every self-attention (resized nearest to each level), and
`capture` (`AttnRuntime.capture`) sends the last up block's three
cross-attentions through explicit fp32 probabilities and hands them back,
keyed 22, 23, 24 as the JAX package labels them (only the probabilities,
`"attn"`: what the recon loss reads).

Inside, activations and convolution weights are kept in channels-last
memory (logical shapes stay NCHW): cuDNN's bf16 convolutions run in that
layout without transposes, `csrc/group_norm_silu.cu` reads a map as
[B, H·W, C] rows, and the transformer blocks' [B, H·W, C] tokens are a view
of the map. Every GroupNorm goes through the GN kernels, and every
attention with q-length >= 256 through the flash kernel (64², 32² and 16²
levels: 15 transformers × self + cross = 30 launches per call; the 8²
mid-block runs the plain version, as the JAX package ran XLA there).
Convolutions and projections are cuDNN/cuBLAS, as the JAX package left them
to XLA. With `UNetConfig.fused_ln` set (default: `ADAFACE_FUSED_LN=1`, the
JAX package's toggle, `unet.py:176`) the 48 LayerNorms of the 16
transformer blocks go through the LayerNorm kernel; unset, they stay
`nn.LayerNorm`, as the JAX default stays XLA.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.params import init_fan_in_, normal_
from adaface_tpu_torch.ops.attention import multi_head_attention
from adaface_tpu_torch.ops.fused_gn import GroupNorm
from adaface_tpu_torch.ops.fused_ln import LayerNorm
from adaface_tpu_torch.ops.resize import resize_nearest


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attn_dim: int = 768
    num_heads: int = 8
    norm_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    down_has_attn: tuple = (True, True, True, False)
    up_has_attn: tuple = (False, True, True, True)
    time_embed_dim: int = 1280
    fused_ln: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("ADAFACE_FUSED_LN", "0") == "1")


SD15_UNET = UNetConfig()
CAPTURE_LAYER_BASE = 22  # the JAX package's label of the first captured layer


def timestep_freqs(dim: int, max_period: float = 10000.0, device=None):
    """The dim // 2 frequencies of `timestep_embedding`, fp32."""
    half = dim // 2
    return torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=device) / half)


def timestep_embedding(t, dim: int, max_period: float = 10000.0, freqs=None):
    """[B] → [B, dim] = [cos, sin] (flip_sin_to_cos, shift 0), fp32; `freqs`
    is `timestep_freqs(dim, max_period)` on t's device, where the caller
    keeps it."""
    if freqs is None:
        freqs = timestep_freqs(dim, max_period, t.device)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _conv(cin, cout, k=3, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, cfg: UNetConfig):
        super().__init__()
        self.norm1 = GroupNorm(cin, cfg.norm_groups, cfg.norm_eps)
        self.conv1 = _conv(cin, cout)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(cout, cfg.norm_groups, cfg.norm_eps)
        self.conv2 = _conv(cout, cout)
        self.conv_shortcut = _conv(cin, cout, k=1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class FusedLinear(nn.Linear):
    """`parts` bias-free projections of one input as one weight
    [parts · out, in]: one matmul reads the input once. `core.bridge` stacks
    the parts' separate weights into it, `core.params` draws each part on
    its own."""

    def __init__(self, in_features: int, out_features: int, parts: int):
        super().__init__(in_features, parts * out_features, bias=False)
        self.parts = parts


class Attention(nn.Module):
    """q/k/v without bias, o with; [B, N, C] tokens. Self-attention keeps
    q, k and v as one weight (`qkv`), cross-attention k and v (`kv`)."""

    def __init__(self, q_dim, kv_dim, num_heads, cross: bool):
        super().__init__()
        if cross:
            self.q = nn.Linear(q_dim, q_dim, bias=False)
            self.kv = FusedLinear(kv_dim, q_dim, parts=2)
        else:
            self.qkv = FusedLinear(q_dim, q_dim, parts=3)
        self.o = nn.Linear(q_dim, q_dim)
        self.num_heads = num_heads

    def forward(self, x, context=None, kv_mask=None, capture: list | None = None):
        """`kv_mask` [B, Sk]: 1 keeps a key. With `capture` (a list) the
        probabilities are computed explicitly in fp32, as the JAX capture path
        does, and appended to it in x's dtype."""
        b, n, c = x.shape
        if context is None:
            q, k, v = self.qkv(x).split(c, dim=-1)
        else:
            q = self.q(x)
            k, v = self.kv(context).split(c, dim=-1)
        hd = c // self.num_heads
        split = lambda t: t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        scale = 1.0 / math.sqrt(hd)
        if capture is not None:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            if kv_mask is not None:
                logits = torch.where(kv_mask[:, None, None, :] > 0, logits, -1e9)
            probs = torch.softmax(logits, dim=-1)
            out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(x.dtype)
            capture.append(probs.to(x.dtype))
        else:
            out = multi_head_attention(q, k, v, kv_mask=kv_mask, scale=scale)
        return self.o(out.transpose(1, 2).reshape(b, n, c))


class TransformerBlock(nn.Module):
    def __init__(self, dim, cross_dim, num_heads, fused_ln: bool):
        super().__init__()
        norm = LayerNorm if fused_ln else nn.LayerNorm
        self.norm1 = norm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, num_heads, cross=False)
        self.norm2 = norm(dim, eps=1e-5)
        self.attn2 = Attention(dim, cross_dim, num_heads, cross=True)
        self.norm3 = norm(dim, eps=1e-5)
        self.ff = nn.ModuleDict({"proj_in": nn.Linear(dim, dim * 8),  # GEGLU 2·4·dim
                                 "proj_out": nn.Linear(dim * 4, dim)})

    def forward(self, y, context, img_mask=None, capture: list | None = None):
        y = y + self.attn1(self.norm1(y), kv_mask=img_mask)
        y = y + self.attn2(self.norm2(y), context, capture=capture)
        val, gate = self.ff["proj_in"](self.norm3(y)).chunk(2, dim=-1)
        return y + self.ff["proj_out"](val * F.gelu(gate, approximate="tanh"))


class Transformer2D(nn.Module):
    def __init__(self, c, cross_dim, cfg: UNetConfig):
        super().__init__()
        self.norm = GroupNorm(c, cfg.norm_groups, cfg.transformer_norm_eps)
        self.proj_in = _conv(c, c, k=1)
        self.proj_out = _conv(c, c, k=1)
        self.block = TransformerBlock(c, cross_dim, cfg.num_heads, cfg.fused_ln)

    def forward(self, x, context, img_mask=None, capture: list | None = None):
        """img_mask [B, 1, H0, W0] or None: the self-attention's key mask,
        resized nearest to this map."""
        b, c, h, w = x.shape
        if img_mask is not None:
            img_mask = resize_nearest(img_mask.float(), (h, w)).reshape(b, h * w)
        y = self.proj_in(self.norm(x))
        # a channels-last map is the [B, H·W, C] token matrix: views both ways
        y = self.block(y.permute(0, 2, 3, 1).reshape(b, h * w, c), context, img_mask, capture)
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class UNetBlock(nn.Module):
    """A down or up block: resnets, optional transformers, optional
    stride-2 downsample or nearest-2x upsample conv."""

    def __init__(self, resnets, attentions, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.downsample = downsample
        self.upsample = upsample


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig = SD15_UNET):
        super().__init__()
        self.cfg = cfg
        ch, temb = cfg.block_channels, cfg.time_embed_dim
        self.conv_in = _conv(cfg.in_channels, ch[0])
        self.time_mlp = nn.ModuleDict({"fc1": nn.Linear(ch[0], temb),
                                       "fc2": nn.Linear(temb, temb)})
        down, cin = [], ch[0]
        for bi, cout in enumerate(ch):
            res, att = [], []
            for li in range(cfg.layers_per_block):
                res.append(ResnetBlock(cin if li == 0 else cout, cout, temb, cfg))
                if cfg.down_has_attn[bi]:
                    att.append(Transformer2D(cout, cfg.cross_attn_dim, cfg))
            last = bi == len(ch) - 1
            down.append(UNetBlock(
                res, att, downsample=None if last else _conv(cout, cout, stride=2)))
            cin = cout
        self.down_blocks = nn.ModuleList(down)
        self.mid = nn.ModuleDict({
            "resnet1": ResnetBlock(ch[-1], ch[-1], temb, cfg),
            "attention": Transformer2D(ch[-1], cfg.cross_attn_dim, cfg),
            "resnet2": ResnetBlock(ch[-1], ch[-1], temb, cfg),
        })
        rev = list(reversed(ch))
        up = []
        for bi in range(len(ch)):
            cout, prev_out = rev[bi], rev[max(bi - 1, 0)]
            res, att = [], []
            for li in range(cfg.layers_per_block + 1):
                skip = rev[min(bi + 1, len(ch) - 1)] if li == cfg.layers_per_block else cout
                res.append(ResnetBlock((prev_out if li == 0 else cout) + skip, cout, temb, cfg))
                if cfg.up_has_attn[bi]:
                    att.append(Transformer2D(cout, cfg.cross_attn_dim, cfg))
            last = bi == len(ch) - 1
            up.append(UNetBlock(res, att, upsample=None if last else _conv(cout, cout)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], cfg.norm_groups, cfg.norm_eps)
        self.conv_out = _conv(ch[0], cfg.out_channels)
        # the timestep embedding's frequencies; not in the state dict
        self.register_buffer("time_freqs", timestep_freqs(ch[0]), persistent=False)
        # convolution weights in channels-last memory, once; loading a state
        # dict or initialising in place keeps the strides
        self.to(memory_format=torch.channels_last)

    def reset_buffers(self):
        """Fill `time_freqs` anew, in fp32: `core.params.build` calls this
        once the module has been materialised and cast."""
        self.time_freqs = timestep_freqs(self.cfg.block_channels[0],
                                         device=self.time_freqs.device)

    def forward(self, x, t, context, img_mask=None, capture: dict | None = None):
        """eps [B, 4, h, w] for latents x [B, 4, h, w], timesteps t [B] and
        text context [B, S, cross_attn_dim]; computes in context's dtype.
        img_mask [B, 1, H, W]: the self-attentions' key mask; `capture` (a
        dict) receives {"attn": {22 + i: [B, heads, N, S] probabilities}} of
        the last up block's cross-attentions."""
        x = x.to(context.dtype).contiguous(memory_format=torch.channels_last)
        if self.time_freqs.dtype != torch.float32:
            raise ValueError("UNet: time_freqs must stay fp32 (call reset_buffers() after "
                             "casting the module)")
        temb = timestep_embedding(t, self.cfg.block_channels[0],
                                  freqs=self.time_freqs).to(context.dtype)
        temb = self.time_mlp["fc2"](F.silu(self.time_mlp["fc1"](temb)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[li](h, context, img_mask)
                skips.append(h)
            if blk.downsample is not None:
                h = blk.downsample(h)
                skips.append(h)
        h = self.mid["resnet1"](h, temb)
        h = self.mid["attention"](h, context, img_mask)
        h = self.mid["resnet2"](h, temb)
        for bi, blk in enumerate(self.up_blocks):
            last = bi == len(self.up_blocks) - 1
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    probs = [] if capture is not None and last else None
                    h = blk.attentions[li](h, context, img_mask, probs)
                    if probs:
                        capture.setdefault("attn", {})[CAPTURE_LAYER_BASE + li] = probs[0]
            if blk.upsample is not None:
                h = blk.upsample(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(h, silu=True)).contiguous()


def init_unet_weights_(model: UNet2DConditionModel, gen: torch.Generator) -> None:
    """`init_unet_params` scales: N(0, 1/fan_in) weights, zero biases,
    unit norms, and conv_out at std 1e-4."""
    init_fan_in_(model, gen)
    normal_(model.conv_out.weight, 1e-4, gen)
