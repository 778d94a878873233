"""SD VAE (AutoencoderKL): decoder and encoder, with the masked-encoder
variant.

Counterpart of `adaface_tpu/models/vae.py`. `VAEDecoder` is `vae_decode`:
post_quant_conv, the CompVis decoder with its single-head mid-block
attention (D = 512 at full width, through the flash kernel when
H·W >= 256), and 0.18215 latent scaling. `VAEEncoder` is
`vae_encode_moments`: the CompVis encoder (an asymmetric (0, 1) pad before
each stride-2 convolution), the same mid block, and quant_conv, giving the
moments (mean ‖ logvar) that `gaussian_sample`, `gaussian_kl` and
`vae_encode` read. With fg/aug masks the encoder's mid-block attention
zeroes, after the softmax and without renormalising, the probabilities of
pixel pairs of which one is foreground and one background; that branch
builds the [B, HW, HW] probabilities in plain PyTorch (training-time
encodes), never through the flash kernel.

`vae_decode` runs the decoder on a latent that may require grad (the recon
loss decodes its predictions with gradient, the weights frozen): in the
weights' dtype, the image returned in fp32, the decoder's activations
recomputed in the backward (`torch.utils.checkpoint`), as the JAX package
remats its loss decodes (`adaface_tpu/train/recon_step.py:384`). With
gradient the forward runs twice, so its kernels count two launches a decode.

Logical shapes are NCHW; inside, activations and convolution weights are
kept in channels-last memory, so cuDNN's convolutions run without layout
transposes, the GN kernels read a map as [B, H·W, C] rows and the
attention's tokens are a view of the map. Every GroupNorm goes through the
GN kernels.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.ops.attention import multi_head_attention
from adaface_tpu_torch.ops.fused_gn import GroupNorm
from adaface_tpu_torch.ops.resize import resize_nearest

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
    """Single-head attention over all positions (`vae.py:124-168`); `mask`
    {'fg_mask': [B, 1, H0, W0] | None, 'aug_mask': ... | None} zeroes the
    probabilities of fg/bg pairs after the softmax."""

    def __init__(self, c, cfg: VAEConfig):
        super().__init__()
        self.norm = GroupNorm(c, cfg.norm_groups, cfg.norm_eps)
        self.q = _conv(c, c, k=1)
        self.k = _conv(c, c, k=1)
        self.v = _conv(c, c, k=1)
        self.proj_out = _conv(c, c, k=1)

    def forward(self, x, mask: dict | None = None):
        b, c, h, w = x.shape
        # a channels-last map is the [B, HW, C] token matrix: a view
        y = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        # the 1x1 convs as linears on the tokens: q/k/v come out [B, HW, C]
        # with a contiguous channel axis, as the flash kernel takes them
        proj = lambda conv, t: F.linear(t, conv.weight[:, :, 0, 0], conv.bias)
        q, k, v = (proj(conv, y) for conv in (self.q, self.k, self.v))
        if mask is None or mask.get("fg_mask") is None:
            out = multi_head_attention(q[:, None], k[:, None], v[:, None],
                                       scale=1.0 / math.sqrt(c))[:, 0]
        else:
            out = self._masked_attention(q, k, v, mask, (h, w)).to(x.dtype)
        out = proj(self.proj_out, out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + out

    @staticmethod
    def _masked_attention(q, k, v, mask: dict, hw: tuple):
        """fp32 softmax over all keys, then the pairs of one fg and one bg
        pixel (and every pair with a pixel outside the aug mask) set to 0."""
        b, n, c = q.shape
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(c)
        probs = torch.softmax(logits, dim=-1)
        fg = resize_nearest(mask["fg_mask"].float(), hw)
        bg = 1.0 - fg
        aug = mask.get("aug_mask")
        if aug is not None:
            aug = resize_nearest(aug.float(), hw)
            fg, bg = fg * aug, bg * aug
        fg, bg = fg.reshape(b, n), bg.reshape(b, n)
        homo = (fg[:, :, None] * fg[:, None, :] + bg[:, :, None] * bg[:, None, :]) > 0
        probs = torch.where(homo, probs, 0.0)
        return torch.matmul(probs.to(v.dtype).float(), v.float())


class Level(nn.Module):
    """One resolution's residual blocks, then the decoder's upsample or the
    encoder's downsample convolution (none at the last level)."""

    def __init__(self, blocks, upsample=None, downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.upsample = upsample
        self.downsample = downsample


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


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = [cfg.base_ch * m for m in cfg.ch_mult]
        self.conv_in = _conv(cfg.in_channels, chs[0])
        levels, cin = [], chs[0]
        for i, cout in enumerate(chs):
            blocks = [ResBlock(cin if j == 0 else cout, cout, cfg)
                      for j in range(cfg.num_res_blocks)]
            down = nn.Conv2d(cout, cout, 3, stride=2, padding=0) if i < len(chs) - 1 else None
            levels.append(Level(blocks, downsample=down))
            cin = cout
        self.down = nn.ModuleList(levels)
        self.mid = nn.ModuleDict({"block_1": ResBlock(chs[-1], chs[-1], cfg),
                                  "attn_1": AttnBlock(chs[-1], cfg),
                                  "block_2": ResBlock(chs[-1], chs[-1], cfg)})
        self.norm_out = GroupNorm(chs[-1], cfg.norm_groups, cfg.norm_eps)
        self.conv_out = _conv(chs[-1], 2 * cfg.z_channels)

    def forward(self, x, mask: dict | None = None):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.blocks:
                h = blk(h)
            if level.downsample is not None:
                # CompVis downsample: one row and one column of zeros after
                # the map, then a stride-2 convolution without padding; the
                # padded copy keeps channels-last memory
                h = level.downsample(F.pad(h, (0, 1, 0, 1)))
        h = self.mid["block_2"](self.mid["attn_1"](self.mid["block_1"](h), mask))
        return self.conv_out(self.norm_out(h, silu=True))


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = _conv(2 * cfg.z_channels, 2 * cfg.z_channels, k=1)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, mask: dict | None = None):
        """Image [B, 3, H, W] in [-1, 1] → moments [B, 2z, H/8, W/8]
        (mean ‖ logvar); `mask` as `AttnBlock` takes it."""
        x = x.contiguous(memory_format=torch.channels_last)
        return self.quant_conv(self.encoder(x, mask)).contiguous()


def vae_encode_moments(encoder: VAEEncoder, x, mask: dict | None = None):
    """→ moments [B, 2z, H/8, W/8] (mean ‖ logvar)."""
    return encoder(x, mask)


def _mean_logvar(moments):
    mean, logvar = moments.chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def gaussian_sample(moments, generator: torch.Generator | None = None, noise=None):
    """A sample of the diagonal Gaussian the moments describe: mean + std ·
    (`noise`, or a draw from `generator` on the moments' device); the mode
    when neither is given."""
    mean, logvar = _mean_logvar(moments)
    if generator is None and noise is None:
        return mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device).to(mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise


def gaussian_kl(moments):
    """KL of the diagonal Gaussian from N(0, 1), summed per sample → [B]."""
    mean, logvar = _mean_logvar(moments)
    return 0.5 * torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar, dim=(1, 2, 3))


def vae_encode(encoder: VAEEncoder, x, generator: torch.Generator | None = None,
               mask: dict | None = None, scale: float = SD_LATENT_SCALE,
               shift: float = 0.0, noise=None):
    """Image → scaled latent [B, 4, H/8, W/8]; the posterior's mode when
    neither `generator` nor `noise` is given. `shift`: SD3-family VAEs
    subtract a shift factor before scaling."""
    return (gaussian_sample(encoder(x, mask), generator, noise) - shift) * scale


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = _conv(cfg.z_channels, cfg.z_channels, k=1)
        # convolution weights in channels-last memory, once; loading a state
        # dict or initialising in place keeps the strides
        self.to(memory_format=torch.channels_last)

    def forward(self, z, scale: float = SD_LATENT_SCALE, shift: float = 0.0):
        """Scaled latent [B, z_channels, h, w] → image [B, 3, 8h, 8w] in
        [-1, 1]; `shift` (SD3's VAE) is added after the unscaling."""
        z = z / scale
        if shift:
            z = z + shift
        z = z.contiguous(memory_format=torch.channels_last)
        return self.decoder(self.post_quant_conv(z)).contiguous()


def vae_decode(decoder: VAEDecoder, z, scale: float = SD_LATENT_SCALE, shift: float = 0.0):
    """Scaled latent [B, z_channels, h, w] → image [B, 3, 8h, 8w] in
    [-1, 1], fp32; computed in the decoder's weights' dtype, recomputed in
    the backward where z requires grad."""
    dtype = next(decoder.parameters()).dtype
    z = z.to(dtype)
    if torch.is_grad_enabled() and z.requires_grad:
        from torch.utils.checkpoint import checkpoint as remat

        return remat(decoder, z, scale, shift, use_reentrant=False).float()
    return decoder(z, scale, shift).float()
