"""SD VAE decoder (AutoencoderKL decode half).

Counterpart of `vae_decode` and the unmasked `_attnblock` of
`adaface_tpu/models/vae.py`: post_quant_conv, the CompVis decoder with its
single-head mid-block attention (D = 512 at full width, through the flash
kernel when H·W >= 256), and 0.18215 latent scaling. Logical shapes are
NCHW; inside, activations and convolution weights are kept in channels-last
memory, so cuDNN's convolutions run without layout transposes, the GN
kernels read a map as [B, H·W, C] rows and the attention's tokens are a view
of the map. Every GroupNorm goes through the GN kernels.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.ops.attention import multi_head_attention
from adaface_tpu_torch.ops.fused_gn import GroupNorm

SD_LATENT_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    base_ch: int = 128
    ch_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    norm_groups: int = 32
    norm_eps: float = 1e-6

    @property
    def spatial_scale(self) -> int:
        """Pixel-to-latent downscale factor (8 for the SD VAE)."""
        return 2 ** (len(self.ch_mult) - 1)


SD_VAE = VAEConfig()


def _conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, cfg: VAEConfig):
        super().__init__()
        self.norm1 = GroupNorm(cin, cfg.norm_groups, cfg.norm_eps)
        self.conv1 = _conv(cin, cout)
        self.norm2 = GroupNorm(cout, cfg.norm_groups, cfg.norm_eps)
        self.conv2 = _conv(cout, cout)
        self.nin_shortcut = _conv(cin, cout, k=1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x, silu=True)), silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head attention over all positions (`vae.py:124-145`, unmasked)."""

    def __init__(self, c, cfg: VAEConfig):
        super().__init__()
        self.norm = GroupNorm(c, cfg.norm_groups, cfg.norm_eps)
        self.q = _conv(c, c, k=1)
        self.k = _conv(c, c, k=1)
        self.v = _conv(c, c, k=1)
        self.proj_out = _conv(c, c, k=1)

    def forward(self, x):
        b, c, h, w = x.shape
        # a channels-last map is the [B, HW, C] token matrix: a view
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        # the 1x1 convs as linears on the tokens: q/k/v come out [B, HW, C]
        # with a contiguous channel axis, as the flash kernel takes them
        proj = lambda conv, t: F.linear(t, conv.weight[:, :, 0, 0], conv.bias)
        q, k, v = (proj(conv, y)[:, None] for conv in (self.q, self.k, self.v))
        out = multi_head_attention(q, k, v, scale=1.0 / math.sqrt(c))[:, 0]
        out = proj(self.proj_out, out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + out


class Level(nn.Module):
    def __init__(self, blocks, upsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.upsample = upsample


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        self.conv_in = _conv(cfg.z_channels, chs[-1])
        self.mid = nn.ModuleDict({"block_1": ResBlock(chs[-1], chs[-1], cfg),
                                  "attn_1": AttnBlock(chs[-1], cfg),
                                  "block_2": ResBlock(chs[-1], chs[-1], cfg)})
        levels, cin = [], chs[-1]
        for i in reversed(range(len(chs))):  # lowest resolution first
            cout = chs[i]
            blocks = [ResBlock(cin if j == 0 else cout, cout, cfg)
                      for j in range(cfg.num_res_blocks + 1)]
            levels.append(Level(blocks, _conv(cout, cout) if i > 0 else None))
            cin = cout
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(chs[0], cfg.norm_groups, cfg.norm_eps)
        self.conv_out = _conv(chs[0], cfg.in_channels)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid["block_2"](self.mid["attn_1"](self.mid["block_1"](h)))
        for level in self.up:
            for blk in level.blocks:
                h = blk(h)
            if level.upsample is not None:
                h = level.upsample(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.norm_out(h, silu=True))


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = _conv(cfg.z_channels, cfg.z_channels, k=1)
        # convolution weights in channels-last memory, once; loading a state
        # dict or initialising in place keeps the strides
        self.to(memory_format=torch.channels_last)

    def forward(self, z, scale: float = SD_LATENT_SCALE):
        """Scaled latent [B, 4, h, w] → image [B, 3, 8h, 8w] in [-1, 1]."""
        z = (z / scale).contiguous(memory_format=torch.channels_last)
        return self.decoder(self.post_quant_conv(z)).contiguous()
