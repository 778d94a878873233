"""SD1.5 UNet (UNet2DConditionModel), the text→image serving path.

Counterpart of `unet_apply` in `adaface_tpu/models/unet.py` with the
default `AttnRuntime` and no LoRA, DeepCache, ToMe, int8, motion or capture
branch. NCHW latents in and out, as the JAX interface (`unet.py:685`).

Inside, activations stay NCHW contiguous, so each GroupNorm group is one
contiguous span for `csrc/group_norm_silu.cu`; the transformer blocks work
on [B, H·W, C] tokens. Every GroupNorm goes through the GN kernel, and every
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


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """[B] → [B, dim] = [cos, sin] (flip_sin_to_cos, shift 0), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
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


class Attention(nn.Module):
    """q/k/v without bias, o with; [B, N, C] tokens."""

    def __init__(self, q_dim, kv_dim, num_heads):
        super().__init__()
        self.q = nn.Linear(q_dim, q_dim, bias=False)
        self.k = nn.Linear(kv_dim, q_dim, bias=False)
        self.v = nn.Linear(kv_dim, q_dim, bias=False)
        self.o = nn.Linear(q_dim, q_dim)
        self.num_heads = num_heads

    def forward(self, x, context=None):
        b, n, c = x.shape
        if context is None:
            # fused QKV (`unet.py:512-518`): one matmul reads x once
            w = torch.cat([self.q.weight, self.k.weight, self.v.weight], dim=0)
            q, k, v = F.linear(x, w).split(c, dim=-1)
        else:
            q = self.q(x)
            w = torch.cat([self.k.weight, self.v.weight], dim=0)
            k, v = F.linear(context, w).split(c, dim=-1)
        hd = c // self.num_heads
        split = lambda t: t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        out = multi_head_attention(split(q), split(k), split(v), scale=1.0 / math.sqrt(hd))
        return self.o(out.transpose(1, 2).reshape(b, n, c))


class TransformerBlock(nn.Module):
    def __init__(self, dim, cross_dim, num_heads, fused_ln: bool):
        super().__init__()
        norm = LayerNorm if fused_ln else nn.LayerNorm
        self.norm1 = norm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, num_heads)
        self.norm2 = norm(dim, eps=1e-5)
        self.attn2 = Attention(dim, cross_dim, num_heads)
        self.norm3 = norm(dim, eps=1e-5)
        self.ff = nn.ModuleDict({"proj_in": nn.Linear(dim, dim * 8),  # GEGLU 2·4·dim
                                 "proj_out": nn.Linear(dim * 4, dim)})

    def forward(self, y, context):
        y = y + self.attn1(self.norm1(y))
        y = y + self.attn2(self.norm2(y), context)
        val, gate = self.ff["proj_in"](self.norm3(y)).chunk(2, dim=-1)
        return y + self.ff["proj_out"](val * F.gelu(gate, approximate="tanh"))


class Transformer2D(nn.Module):
    def __init__(self, c, cross_dim, cfg: UNetConfig):
        super().__init__()
        self.norm = GroupNorm(c, cfg.norm_groups, cfg.transformer_norm_eps)
        self.proj_in = _conv(c, c, k=1)
        self.proj_out = _conv(c, c, k=1)
        self.block = TransformerBlock(c, cross_dim, cfg.num_heads, cfg.fused_ln)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        # contiguous: the reshape of the permuted map is a strided view
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
        y = self.block(y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        return self.proj_out(y) + x


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

    def forward(self, x, t, context):
        """eps [B, 4, h, w] for latents x [B, 4, h, w], timesteps t [B] and
        text context [B, S, cross_attn_dim]; computes in context's dtype."""
        x = x.to(context.dtype)
        temb = timestep_embedding(t, self.cfg.block_channels[0]).to(context.dtype)
        temb = self.time_mlp["fc2"](F.silu(self.time_mlp["fc1"](temb)))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[li](h, context)
                skips.append(h)
            if blk.downsample is not None:
                h = blk.downsample(h)
                skips.append(h)
        h = self.mid["resnet1"](h, temb)
        h = self.mid["attention"](h, context)
        h = self.mid["resnet2"](h, temb)
        for blk in self.up_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[li](h, context)
            if blk.upsample is not None:
                h = blk.upsample(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(h, silu=True))


def init_unet_weights_(model: UNet2DConditionModel, gen: torch.Generator) -> None:
    """`init_unet_params` scales: N(0, 1/fan_in) weights, zero biases,
    unit norms, and conv_out at std 1e-4."""
    init_fan_in_(model, gen)
    normal_(model.conv_out.weight, 1e-4, gen)
