"""Pre-norm ViT: DINO ViT-S/16, the backbone of the DINO evaluator.

Counterpart of `adaface_tpu/models/vit.py` (facebook/dino-vits16: patch
16, width 384, 12 layers, 6 heads, the class token's final state as the
feature). It computes what the JAX function computes:
- LayerNorm statistics in fp32, eps 1e-6 (`vit.py:45-50`);
- attention logits in fp32 (`preferred_element_type`), a softmax over all
  197 tokens in plain PyTorch: below the flash kernel's 256-token
  threshold, as the JAX model runs XLA einsums;
- the MLP's GELU is `jax.nn.gelu`'s default, the tanh approximation
  (`vit.py:117`), where published DINO uses the erf GELU (a difference of
  the reference, kept here; ROADMAP §3).

The modules mirror the JAX pytree (`layers.3.attn.qkv` is
`p["layers"][3]["attn"]["qkv"]`); the patch kernel, OIHW in that tree, is
re-laid by `core.bridge.vit_tree` before `bridge.load`.
`convert_dino_state_dict` maps a facebookresearch/dino state dict onto that
tree in numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.params import init_fan_in_, normal_


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 16
    image_size: int = 224
    layer_norm_eps: float = 1e-6

    @property
    def num_tokens(self) -> int:
        """Class token + patches."""
        return (self.image_size // self.patch_size) ** 2 + 1


DINO_VITS16 = ViTConfig()


class LayerNorm32(nn.LayerNorm):
    """LayerNorm with its statistics in fp32, the output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.attn = nn.ModuleDict({"qkv": nn.Linear(d, 3 * d), "proj": nn.Linear(d, d)})
        self.ln2 = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, d * cfg.mlp_ratio),
                                  "fc2": nn.Linear(d * cfg.mlp_ratio, d)})
        self.num_heads = cfg.num_heads

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.num_heads
        q, k, v = (t.reshape(b, n, self.num_heads, hd).transpose(1, 2)
                   for t in self.attn["qkv"](self.ln1(x)).chunk(3, dim=-1))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        att = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        x = x + self.attn["proj"](att.transpose(1, 2).reshape(b, n, d))
        y = F.gelu(self.mlp["fc1"](self.ln2(x)), approximate="tanh")
        return x + self.mlp["fc2"](y)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig = DINO_VITS16):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.num_tokens, d))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values) -> dict:
        """pixel_values [B, 3, H, W] → {"cls": [B, D], "tokens": [B, N, D]}
        (`vit_encode`): the patch projection in fp32, its bias added to the
        tokens, the class token in front, the first N + 1 position rows."""
        b = pixel_values.shape[0]
        w = self.patch_embedding.weight
        patches = F.conv2d(pixel_values.float(), w.float(), stride=self.cfg.patch_size)
        x = patches.flatten(2).transpose(1, 2).to(w.dtype) + self.patch_embedding.bias
        x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
        x = x + self.position_embedding[None, :x.shape[1]]
        for layer in self.layers:
            x = layer(x)
        x = self.final_ln(x)
        return {"cls": x[:, 0], "tokens": x[:, 1:]}


def init_vit_weights_(model: ViT, gen: torch.Generator) -> None:
    """`init_vit_params` scales: dense weights N(0, 1/fan_in), the class
    token, patch kernel and positions N(0, 0.02²), biases 0, norms 1/0."""
    init_fan_in_(model, gen)
    for p in (model.cls_token, model.patch_embedding.weight, model.position_embedding):
        normal_(p, 0.02, gen)


def convert_dino_state_dict(sd: Mapping[str, np.ndarray],
                            cfg: ViTConfig = DINO_VITS16) -> dict:
    """facebookresearch/dino ViT state dict → the JAX package's ViT tree
    (`adaface_tpu/models/vit.py:124`) in numpy float32: dense weights
    transposed to [in, out], the patch kernel OIHW as it is."""

    def a(key):
        return np.asarray(sd[key], np.float32)

    def dense(pre):
        return {"w": a(f"{pre}.weight").T.copy(), "b": a(f"{pre}.bias")}

    def ln(pre):
        return {"scale": a(f"{pre}.weight"), "bias": a(f"{pre}.bias")}

    return {
        "cls_token": a("cls_token"),
        "patch_embedding": {"w": a("patch_embed.proj.weight"), "b": a("patch_embed.proj.bias")},
        "position_embedding": a("pos_embed")[0],
        "layers": [{"ln1": ln(f"blocks.{i}.norm1"),
                    "attn": {"qkv": dense(f"blocks.{i}.attn.qkv"),
                             "proj": dense(f"blocks.{i}.attn.proj")},
                    "ln2": ln(f"blocks.{i}.norm2"),
                    "mlp": {"fc1": dense(f"blocks.{i}.mlp.fc1"),
                            "fc2": dense(f"blocks.{i}.mlp.fc2")}}
                   for i in range(cfg.num_layers)],
        "final_ln": ln("norm"),
    }
