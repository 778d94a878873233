"""Projection and attention modules of the ID encoders.

Counterpart of `adaface_tpu/id2ada/layers.py`, plain PyTorch (XLA code
there, no Pallas kernel): ExpandEmbs, the background prompt translator's
CrossAttention, Perceiver attention, LearnedSoftAggregate, the perceiver
feed-forward and ConsistentID's `ProjPlus` (a 512-d ID embedding and CLIP
image features → 4 ID tokens). Parameter names mirror the JAX pytree; a
projection the JAX tree leaves out (identity `to_v` / `to_out`) is left out
here too. Dense weights start at N(0, 1/fan_in) and norms at 1/0, as
`_dense` and `_ln_params` have them, so `core.params.init_fan_in_` is their
random init.

ProjPlus and the perceiver feed-forward use the exact erf GELU (torch's
`nn.GELU()` in the reference), unlike the CLIP towers' tanh form.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _attend(q, k, v, heads: int):
    """softmax(q·kᵀ/√d)·v over `heads` heads, fp32 logits; q [B, Nq, H·d],
    k and v [B, Nk, H·d] → [B, Nq, H·d]."""
    b, nq, inner = q.shape
    hd = inner // heads
    split = lambda t: t.reshape(b, -1, heads, hd).transpose(1, 2)
    logits = torch.matmul(split(q).float(), split(k).float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, split(v)).transpose(1, 2).reshape(b, nq, -1)


class ExpandEmbs(nn.Module):
    """[B, D_in] → [B, K, D_out]: one linear, then LayerNorm per token."""

    def __init__(self, d_in: int, d_out: int, expansion_ratio: int):
        super().__init__()
        self.proj = nn.Linear(d_in, d_out * expansion_ratio)
        self.ln = nn.LayerNorm(d_out)

    def forward(self, x):
        return self.ln(self.proj(x).reshape(x.shape[0], -1, self.ln.normalized_shape[0]))


class CrossAttention(nn.Module):
    """Queries attend over a context (the background path's prompt
    translator, `layers.py:65-115`); `identity_to_v` / `identity_to_out`
    leave those projections out."""

    def __init__(self, dim: int, num_heads: int = 6, identity_to_v: bool = False,
                 identity_to_out: bool = True, v_has_skip: bool = True,
                 out_has_skip: bool = False):
        super().__init__()
        self.num_heads, self.v_has_skip, self.out_has_skip = num_heads, v_has_skip, out_has_skip
        self.ln_q, self.ln_k = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = None if identity_to_v else nn.Linear(dim, dim, bias=False)
        self.to_out = None if identity_to_out else nn.Linear(dim, dim, bias=False)

    def forward(self, queries, context):
        q = self.to_q(self.ln_q(queries))
        k = self.to_k(self.ln_k(context))
        v = context
        if self.to_v is not None:
            v = self.to_v(context) + (context if self.v_has_skip else 0)
        out = _attend(q, k, v, self.num_heads)
        if self.to_out is not None:
            o = self.to_out(out)
            out = o + out if self.out_has_skip else o
        return out


class PerceiverAttention(nn.Module):
    """Latent queries attend over [features; latents] (`layers.py:117-147`)."""

    def __init__(self, dim: int, dim_head: int = 64, num_heads: int = 8):
        super().__init__()
        inner = dim_head * num_heads
        self.num_heads = num_heads
        self.ln_x, self.ln_lat = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x, lat = self.ln_x(x), self.ln_lat(latents)
        k, v = self.to_kv(torch.cat([x, lat], dim=1)).chunk(2, dim=-1)
        return self.to_out(_attend(self.to_q(lat), k, v, self.num_heads))


class LearnedSoftAggregate(nn.Module):
    """Softmax-weighted sum over `group_dim`, one learned score a feature."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.attn = nn.Linear(feat_dim, 1, bias=False)

    def forward(self, x, group_dim: int = 1, keepdim: bool = False):
        w = torch.softmax(self.attn(x), dim=group_dim)
        return (x * w).sum(dim=group_dim, keepdim=keepdim)


class PerceiverFF(nn.Module):
    """LayerNorm → Linear(dim → 4·dim) → erf GELU → Linear, no biases."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * 4, bias=False)
        self.fc2 = nn.Linear(dim * 4, dim, bias=False)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.ln(x))))


class Resampler(nn.Module):
    def __init__(self, clip_dim: int, out_dim: int, depth: int, dim_head: int):
        super().__init__()
        self.proj_in = nn.Linear(clip_dim, out_dim)
        self.proj_out = nn.Linear(out_dim, out_dim)
        self.norm_out = nn.LayerNorm(out_dim)
        self.layers = nn.ModuleList(
            nn.ModuleDict({"attn": PerceiverAttention(out_dim, dim_head, out_dim // dim_head),
                           "ff": PerceiverFF(out_dim)}) for _ in range(depth))


class ProjPlus(nn.Module):
    """ConsistentID's image projection (`layers.py:184-240`): an ID-MLP makes
    `num_tokens` latents from the 512-d ID embedding; a perceiver resampler
    (`depth` blocks of attention + feed-forward over the projected CLIP
    features) refines them. Heads of 64 (12 at out_dim 768; one head of
    out_dim below 64, as the JAX init shrinks them for tiny configs)."""

    def __init__(self, id_dim: int = 512, clip_dim: int = 1280, out_dim: int = 768,
                 num_tokens: int = 4, depth: int = 4):
        super().__init__()
        self.out_dim = out_dim
        self.proj = nn.ModuleDict({"fc1": nn.Linear(id_dim, id_dim * 2),
                                   "fc2": nn.Linear(id_dim * 2, out_dim * num_tokens)})
        self.norm = nn.LayerNorm(out_dim)
        self.resampler = Resampler(clip_dim, out_dim, depth, min(64, out_dim))

    def forward(self, faceid_embs, clip_image_embeds, shortcut: bool = False,
                scale: float = 1.0):
        """faceid [B, 512], CLIP features [B, N, D_clip] → [B, num_tokens, out_dim]."""
        h = self.proj["fc2"](F.gelu(self.proj["fc1"](faceid_embs)))
        tokens = self.norm(h.reshape(faceid_embs.shape[0], -1, self.out_dim))
        r = self.resampler
        x = r.proj_in(clip_image_embeds)
        latents = tokens
        for layer in r.layers:
            latents = layer["attn"](x, latents) + latents
            latents = layer["ff"](latents) + latents
        out = r.norm_out(r.proj_out(latents))
        return tokens + scale * out if shortcut else out
