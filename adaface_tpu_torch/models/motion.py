"""Temporal motion modules of the video UNet (AdaFace-Animate).

Counterpart of `adaface_tpu/models/motion.py`: AnimateDiff-style temporal
transformers that plug into the SD1.5 UNet (`models/unet.py`, `motion=`),
one after every (resnet, attention) pair of each down and up block and one
in the mid block. The modules' names mirror the JAX tree
(`{"down": [[m] * 2] * 4, "mid": m, "up": [[m] * 3] * 4}`), so
`core/bridge.py` loads `init_motion_params`' tree or the AnimateDiff
converter's (`tools/convert_motion.py`) into `MotionModules`.

A module (`motion_apply`, `motion.py:187-220`) on the UNet's map
[B·F, C, H, W] (channels-last memory, frames contiguous per video):
GroupNorm without SiLU (32 groups, eps 1e-6; the GroupNorm kernels, as the
JAX package runs `fused_group_norm_silu(apply_silu=False)`) → `proj_in` →
the tokens regrouped [B·H·W, F, C] (a copy) → per block two temporal
self-attentions (LayerNorm eps 1e-5, the sinusoidal position table added to
the normed input, q/k/v without bias, heads over the frames) and a GEGLU
feed-forward, each residual → `proj_out` (zero at init: the module is an
identity) → back to the map, added to its input. One frame is an identity.

The temporal attention is plain PyTorch (`ops.attention.
scaled_dot_product_attention`: fp32 scores and softmax, the probabilities in
the compute dtype into the second product), as the JAX package runs XLA's
(`use_flash=False`, `motion.py:182`) over F ≤ 32 frames; so are the
LayerNorms (`motion.py:153-158`). The projections are cuBLAS products with
fp32 accumulation.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.params import init_fan_in_
from adaface_tpu_torch.models.unet import FusedLinear
from adaface_tpu_torch.ops.attention import scaled_dot_product_attention
from adaface_tpu_torch.ops.fused_gn import GroupNorm


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    num_heads: int = 8
    num_layers: int = 1  # transformer blocks per module
    attns_per_block: int = 2  # ("Temporal_Self", "Temporal_Self")
    max_frames: int = 32  # the position table's rows (v2)
    norm_groups: int = 32
    norm_eps: float = 1e-6
    ff_mult: int = 4


MM_SD15_V2 = MotionConfig()


def sinusoidal_position_encoding(length: int, dim: int, dtype=torch.float32,
                                 device=None) -> torch.Tensor:
    """The transformer position table [length, dim], sin in the even columns
    and cos in the odd ones, computed in fp32 and cast to `dtype`."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: dim // 2])
    return pe.to(dtype)


class TemporalAttention(nn.Module):
    """LayerNorm, then self-attention over the frame axis of [B', F, C]
    (`_temporal_attention`, `motion.py:168-184`): q, k, v without bias as
    one weight (`qkv`), `o` with bias."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.LayerNorm(c, eps=1e-5)
        self.qkv = FusedLinear(c, c, parts=3)
        self.o = nn.Linear(c, c)

    def forward(self, y, pe, num_heads: int):
        b, f, c = y.shape
        hd = c // num_heads
        h = self.norm(y) + pe[None, :f]
        split = lambda t: t.reshape(b, f, num_heads, hd).transpose(1, 2)  # noqa: E731
        q, k, v = (split(t) for t in self.qkv(h).split(c, dim=-1))
        out = scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(hd))
        return self.o(out.transpose(1, 2).reshape(b, f, c))


class MotionBlock(nn.Module):
    def __init__(self, c: int, cfg: MotionConfig):
        super().__init__()
        self.attn = nn.ModuleList(TemporalAttention(c) for _ in range(cfg.attns_per_block))
        self.norm_ff = nn.LayerNorm(c, eps=1e-5)
        self.ff = nn.ModuleDict({"proj_in": nn.Linear(c, c * cfg.ff_mult * 2),  # GEGLU
                                 "proj_out": nn.Linear(c * cfg.ff_mult, c)})

    def forward(self, y, pe, num_heads: int):
        for attn in self.attn:
            y = y + attn(y, pe, num_heads)
        val, gate = self.ff["proj_in"](self.norm_ff(y)).chunk(2, dim=-1)
        return y + self.ff["proj_out"](val * F.gelu(gate, approximate="tanh"))


class MotionModule(nn.Module):
    """One temporal transformer of `c` channels (`_init_module`,
    `motion.py:74-103`)."""

    def __init__(self, c: int, cfg: MotionConfig = MM_SD15_V2):
        super().__init__()
        self.cfg = cfg
        self.norm = GroupNorm(c, cfg.norm_groups, cfg.norm_eps)
        self.proj_in = nn.Linear(c, c)
        self.blocks = nn.ModuleList(MotionBlock(c, cfg) for _ in range(cfg.num_layers))
        self.proj_out = nn.Linear(c, c)
        # the position table's first max_frames rows, cast with the module
        # (not in the state dict)
        self.register_buffer("pe", sinusoidal_position_encoding(cfg.max_frames, c),
                             persistent=False)

    def reset_buffers(self):
        """Fill `pe` anew in the module's dtype: `core.params.build` calls
        this once the module has been materialised and cast."""
        w = self.proj_in.weight
        self.pe = sinusoidal_position_encoding(self.cfg.max_frames, w.shape[1], w.dtype, w.device)

    def position_table(self, num_frames: int, dtype) -> torch.Tensor:
        """The table's first `num_frames` rows in `dtype` (computed where
        the buffer is too short)."""
        if num_frames <= self.pe.shape[0]:
            return self.pe[:num_frames].to(dtype)
        return sinusoidal_position_encoding(num_frames, self.pe.shape[1], dtype, self.pe.device)

    def forward(self, x, num_frames: int):
        """x [B·F, C, H, W] → the same shape (`motion_apply`), with the
        settings the module was built with."""
        if num_frames <= 1:
            return x
        num_heads = self.cfg.num_heads
        bf, c, hh, ww = x.shape
        b, n = bf // num_frames, hh * ww
        y = self.norm(x)
        # a channels-last map is the [B·F, H·W, C] token matrix: a view
        y = self.proj_in(y.permute(0, 2, 3, 1).reshape(bf, n, c))
        # [B, F, N, C] → [B·N, F, C]: the frames of one position together
        y = y.reshape(b, num_frames, n, c).transpose(1, 2).reshape(b * n, num_frames, c)
        pe = self.position_table(num_frames, y.dtype)
        for blk in self.blocks:
            y = blk(y, pe, num_heads)
        y = self.proj_out(y)
        y = y.reshape(b, n, num_frames, c).transpose(1, 2).reshape(bf, hh, ww, c)
        return x + y.permute(0, 3, 1, 2)


class MotionModules(nn.Module):
    """The video UNet's temporal modules (`init_motion_params`,
    `motion.py:106-134`): `down[b][l]` after down block b's l-th pair,
    `mid`, `up[b][l]` after up block b's l-th pair."""

    def __init__(self, unet_cfg, cfg: MotionConfig = MM_SD15_V2):
        super().__init__()
        self.cfg = cfg
        ch = unet_cfg.block_channels
        n = unet_cfg.layers_per_block
        self.down = nn.ModuleList(nn.ModuleList(MotionModule(c, cfg) for _ in range(n))
                                  for c in ch)
        self.mid = MotionModule(ch[-1], cfg)
        self.up = nn.ModuleList(nn.ModuleList(MotionModule(c, cfg) for _ in range(n + 1))
                                for c in reversed(ch))


def init_motion_weights_(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX initialiser's scales: q/k/v and dense weights N(0, 1/fan_in),
    biases 0, norms 1/0, and each module's `proj_out` 0 (an identity)."""
    init_fan_in_(module, gen)
    for m in module.modules():
        if isinstance(m, MotionModule):
            nn.init.zeros_(m.proj_out.weight)
            nn.init.zeros_(m.proj_out.bias)
