"""MMDiT, the Stable Diffusion 3 transformer.

Counterpart of `adaface_tpu/models/mmdit.py` (diffusers'
`SD3Transformer2DModel` semantics; the module's names mirror the JAX tree, so
`core/bridge.py` loads it and `tools/convert_mmdit.py` fills it from a
diffusers checkpoint):

- a 2x2 patchify convolution of the 16-channel latent, and the 2-D sin/cos
  position table, computed at `pos_embed_max_size` and center-cropped to the
  latent grid, or a checkpoint's own table (`pos_embed_table`) cropped so
  (`mmdit.py:163-189`, `:289-300`);
- the conditioning embedding MLP(Fourier(t)) + MLP(pooled [2048]), and the
  context embedder 4096 → hidden;
- joint blocks: a latent and a context stream, each modulated by its
  adaLN-zero (six chunks; the last block's context stream two, and no output
  of its own), attending together over [latent ‖ context], latent first
  (`mmdit.py:197-266`), with the optional RMS qk-norm;
- the final adaLN-continuous norm, the linear head, and unpatchify to the
  velocity [B, C, H, W] (`mmdit.py:316-326`).

The joint attention is the one place where the port's route differs from the
JAX package's: JAX computes it as explicit einsums (fp32 logits, softmax, the
probabilities in the compute dtype into the second product), which is the
plain version here (`ops.attention.scaled_dot_product_attention`, on the
CPU); on the card it goes through the flash kernel (`flash_attention`, the
wgmma kernel at head dim 64), the same function without the fp32 logits,
which at SD3's 4429 tokens would be [2, 24, 4429, 4429]: 3.8 GB a layer. The
LayerNorms (no affine, fp32 statistics) and everything else are plain
PyTorch, as XLA ran them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.params import normal_
from adaface_tpu_torch.models.unet import timestep_embedding
from adaface_tpu_torch.ops import attention


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    depth: int = 24
    hidden: int = 1536
    num_heads: int = 24
    context_dim: int = 4096  # joint_attention_dim (padded CLIP ‖ T5)
    pooled_dim: int = 2048  # CLIP-L (768) ‖ bigG (1280) projected poolings
    pos_embed_max_size: int = 192
    time_embed_dim: int = 256  # Fourier width before the MLP
    mlp_ratio: float = 4.0
    qk_norm: bool = False  # SD3-medium: off; SD3.5: RMS qk-norm


SD3_MEDIUM = MMDiTConfig()  # sd3-medium (2B)


def sincos_pos_embed_2d(dim: int, grid: int) -> np.ndarray:
    """The 2-D sin/cos table [grid², dim] (`mmdit.py:146-160`: dim / 2 per
    axis, [sin, cos] per frequency, rows then columns), in float64 cast to
    float32."""
    def one_axis(pos):
        d = dim // 2
        omega = 1.0 / (10000.0 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0)))
        out = np.einsum("p,f->pf", pos.astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(grid, dtype=np.float64)
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    emb = np.concatenate([one_axis(gy.reshape(-1)), one_axis(gx.reshape(-1))], axis=1)
    return emb.astype(np.float32)


def _crop(table, gh: int, gw: int):
    """The center gh x gw of a square [m², D] table → [gh·gw, D]."""
    m = math.isqrt(table.shape[0])
    top, left = (m - gh) // 2, (m - gw) // 2
    return table.reshape(m, m, -1)[top:top + gh, left:left + gw].reshape(gh * gw, -1)


def _layer_norm(x, eps: float = 1e-6):
    """No affine, statistics in fp32, back to x's dtype (`_layer_norm`)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def _rms(x, scale, eps: float = 1e-6):
    """RMS norm over the head dim, fp32, with a [head dim] scale (`_rms`)."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale.float()).to(x.dtype)


class JointProjections(nn.Module):
    """One stream's q, k, v (and o, except the last block's context stream)
    projections, with biases, and the qk-norm's scales."""

    def __init__(self, h: int, head_dim: int, out: bool, qk_norm: bool):
        super().__init__()
        self.q, self.k, self.v = nn.Linear(h, h), nn.Linear(h, h), nn.Linear(h, h)
        if out:
            self.o = nn.Linear(h, h)
        if qk_norm:
            self.q_rms = nn.Parameter(torch.ones(head_dim))
            self.k_rms = nn.Parameter(torch.ones(head_dim))

    def qkv(self, x, num_heads: int):
        """→ q, k, v [B, S, H, head dim] (q and k RMS-normed where set)."""
        b, s, _ = x.shape
        q, k, v = (t.reshape(b, s, num_heads, -1) for t in (self.q(x), self.k(x), self.v(x)))
        if hasattr(self, "q_rms"):
            q, k = _rms(q, self.q_rms), _rms(k, self.k_rms)
        return q, k, v


def _mlp(h: int, ratio: float) -> nn.ModuleDict:
    return nn.ModuleDict({"fc1": nn.Linear(h, int(h * ratio)), "fc2": nn.Linear(int(h * ratio), h)})


class MMDiTBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only: bool):
        super().__init__()
        h, hd = cfg.hidden, cfg.hidden // cfg.num_heads
        self.pre_only = pre_only
        self.num_heads = cfg.num_heads
        self.ada_x = nn.Linear(h, 6 * h)
        self.attn = JointProjections(h, hd, out=True, qk_norm=cfg.qk_norm)
        self.mlp_x = _mlp(h, cfg.mlp_ratio)
        self.attn_ctx = JointProjections(h, hd, out=not pre_only, qk_norm=cfg.qk_norm)
        self.ada_ctx = nn.Linear(h, (2 if pre_only else 6) * h)
        if not pre_only:
            self.mlp_ctx = _mlp(h, cfg.mlp_ratio)

    def _joint_attention(self, x, ctx):
        """Attention over [latent ‖ context] (`_joint_attention`,
        `mmdit.py:197-231`) → (latent out, context out or None)."""
        b, n, h = x.shape
        qx, kx, vx = self.attn.qkv(x, self.num_heads)
        qc, kc, vc = self.attn_ctx.qkv(ctx, self.num_heads)
        # [B, S, H, hd] joined along S, seen as [B, H, S, hd]
        q, k, v = (torch.cat(pair, dim=1).transpose(1, 2)
                   for pair in ((qx, qc), (kx, kc), (vx, vc)))
        out = attention.flash_attention(q, k, v, scale=1.0 / math.sqrt(h // self.num_heads))
        out = out.transpose(1, 2).reshape(b, -1, h)
        out_x, out_c = self.attn.o(out[:, :n]), out[:, n:]
        return out_x, None if self.pre_only else self.attn_ctx.o(out_c)

    def forward(self, x, ctx, emb):
        silu_emb = F.silu(emb)
        sx, cx, gx, sm, cm, gm = self.ada_x(silu_emb).chunk(6, dim=-1)
        mc = self.ada_ctx(silu_emb)
        if self.pre_only:  # diffusers' pre-only AdaLayerNormZero order: [scale, shift]
            c_scale, c_shift = mc.chunk(2, dim=-1)
            ctx_in = _modulate(_layer_norm(ctx), c_shift, c_scale)
        else:
            cs, cc, cg, csm, ccm, cgm = mc.chunk(6, dim=-1)
            ctx_in = _modulate(_layer_norm(ctx), cs, cc)
        ax, ac = self._joint_attention(_modulate(_layer_norm(x), sx, cx), ctx_in)
        x = x + gx[:, None] * ax
        hx = _modulate(_layer_norm(x), sm, cm)
        x = x + gm[:, None] * self.mlp_x["fc2"](
            F.gelu(self.mlp_x["fc1"](hx), approximate="tanh"))
        if self.pre_only:
            return x, ctx
        ctx = ctx + cg[:, None] * ac
        hc = _modulate(_layer_norm(ctx), csm, ccm)
        ctx = ctx + cgm[:, None] * self.mlp_ctx["fc2"](
            F.gelu(self.mlp_ctx["fc1"](hc), approximate="tanh"))
        return x, ctx


class MMDiT(nn.Module):
    def __init__(self, cfg: MMDiTConfig = SD3_MEDIUM, pos_embed_rows: int | None = None):
        """`pos_embed_rows`: a checkpoint's own position table of that many
        (square) rows, `pos_embed_table`; None computes the sin/cos table."""
        super().__init__()
        self.cfg = cfg
        h, p = cfg.hidden, cfg.patch_size
        self.patch_embed = nn.Conv2d(cfg.in_channels, h, p, stride=p)
        if pos_embed_rows is not None:
            self.pos_embed_table = nn.Parameter(torch.zeros(pos_embed_rows, h))
        self.time_mlp = nn.ModuleDict({"fc1": nn.Linear(cfg.time_embed_dim, h),
                                       "fc2": nn.Linear(h, h)})
        self.pooled_mlp = nn.ModuleDict({"fc1": nn.Linear(cfg.pooled_dim, h),
                                         "fc2": nn.Linear(h, h)})
        self.context_embedder = nn.Linear(cfg.context_dim, h)
        self.blocks = nn.ModuleList(MMDiTBlock(cfg, pre_only=i == cfg.depth - 1)
                                    for i in range(cfg.depth))
        self.ada_out = nn.Linear(h, 2 * h)
        self.proj_out = nn.Linear(h, p * p * cfg.out_channels)
        self._pos_cache: dict = {}

    def _pos_embed(self, gh: int, gw: int, device):
        if hasattr(self, "pos_embed_table"):
            return _crop(self.pos_embed_table, gh, gw)
        key = (gh, gw, device)
        if key not in self._pos_cache:
            m = self.cfg.pos_embed_max_size
            table = sincos_pos_embed_2d(self.cfg.hidden, m)
            self._pos_cache[key] = torch.from_numpy(_crop(table, gh, gw).copy()).to(device)
        return self._pos_cache[key]

    def forward(self, x, t, context, pooled):
        """Velocity [B, C, H, W] for latents x [B, C, H, W], float timesteps
        t [B] (σ·1000), context [B, S, context_dim] and pooled
        [B, pooled_dim]; computes in context's dtype (`mmdit_apply`)."""
        cfg = self.cfg
        dtype = context.dtype
        b, _, hh, ww = x.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        lat = F.conv2d(x.to(dtype), self.patch_embed.weight.to(dtype),
                       self.patch_embed.bias.to(dtype), stride=p)
        lat = lat.flatten(2).transpose(1, 2)  # [B, gh·gw, hidden], rows then columns
        lat = lat + self._pos_embed(gh, gw, x.device).to(dtype)[None]
        temb = timestep_embedding(t, cfg.time_embed_dim).to(dtype)
        temb = self.time_mlp["fc2"](F.silu(self.time_mlp["fc1"](temb)))
        pemb = self.pooled_mlp["fc2"](F.silu(self.pooled_mlp["fc1"](pooled.to(dtype))))
        emb = temb + pemb
        ctx = self.context_embedder(context)
        for block in self.blocks:
            lat, ctx = block(lat, ctx, emb)
        # adaLN-continuous, chunks [scale, shift] as the pre-only norm
        scale, shift = self.ada_out(F.silu(emb)).chunk(2, dim=-1)
        out = self.proj_out(_modulate(_layer_norm(lat), shift, scale))
        c = cfg.out_channels
        out = out.reshape(b, gh, gw, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return out.reshape(b, c, gh * p, gw * p)


def init_mmdit_weights_(model: MMDiT, gen: torch.Generator) -> None:
    """`init_mmdit_params` scales: linears and the patch embedding
    N(0, 0.02²), biases 0, the adaLN-zero modulations and the head 0, the
    qk-norm scales 1."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            normal_(m.weight, 0.02, gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, JointProjections) and hasattr(m, "q_rms"):
            nn.init.ones_(m.q_rms)
            nn.init.ones_(m.k_rms)
    for m in [model.ada_out, model.proj_out,
              *(lin for blk in model.blocks for lin in (blk.ada_x, blk.ada_ctx))]:
        nn.init.zeros_(m.weight)
