"""CLIP text and vision transformers.

Counterpart of `adaface_tpu/models/clip.py`: `text_encode` with
`input_embs` injection and CLIP-skip `skip_weights`, token lookup and
position-embedding extension; `vision_encode` with the fg/bg image mask of
`CLIPVisionModelWithMask` (`:377-446`). Attention here is plain PyTorch
(77 causal tokens, or 257 patch tokens with an additive mask), as the JAX
towers ran through XLA and never through the flash kernel. The modules'
parameter names mirror the JAX pytree (`layers.3.attn.q` is
`p["layers"][3]["attn"]["q"]`), which is what `core/bridge.py` relies on.

MKV attention (`_mkv_attention`, `clip.py:218-266`): a layer's K and V may
be `mult`·D wide, the multiplier implicit in their weights' shapes; the
copies fold into the key axis token-interleaved, and the causal and additive
biases are repeated per copy (`repeat_interleave`, as `jnp.repeat`: key j
attends like token j // mult). `extend_mkv`, `squeeze_mkv` and
`layer_multipliers` (`clip.py:467-535`) work on a module or its state dict;
`fit_kv_widths_` rebuilds a module's K and V at a state dict's widths before
it is loaded.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.core.params import normal_
from adaface_tpu_torch.ops.resize import resize_nearest
from adaface_tpu_torch.utils.tensor import Draws, perturb_tensor


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # OpenAI CLIP; laion towers use "gelu"
    projection_dim: int | None = None  # the bias-free text_projection of the pooled state


CLIP_L_TEXT = CLIPTextConfig()
# laion OpenCLIP ViT-bigG/14 text tower (text_encoder_2 of SDXL and SD3,
# `clip.py:63-66`): its penultimate hidden states feed the context, its
# projected eos pooling the added text embedding
CLIP_BIGG_TEXT = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                                intermediate_size=5120, hidden_act="gelu",
                                projection_dim=1280)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    num_channels: int = 3
    projection_dim: int | None = None
    hidden_act: str = "quick_gelu"

    @property
    def num_tokens(self) -> int:
        """Class token + patches."""
        return (self.image_size // self.patch_size) ** 2 + 1


CLIP_L_VISION = CLIPVisionConfig()
# laion CLIP-ViT-H-14, ConsistentID's image encoder (laion towers use gelu)
CLIP_H_VISION = CLIPVisionConfig(hidden_size=1280, num_layers=32, num_heads=16,
                                 intermediate_size=5120, projection_dim=1024,
                                 hidden_act="gelu")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu,
         "gelu": lambda x: nn.functional.gelu(x, approximate="tanh")}


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig | CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = nn.ModuleDict({n: nn.Linear(d, d) for n in ("q", "k", "v", "o")})
        self.ln2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, cfg.intermediate_size),
                                  "fc2": nn.Linear(cfg.intermediate_size, d)})
        self.num_heads = cfg.num_heads
        self.act = _ACTS[cfg.hidden_act]

    @property
    def kv_mult(self) -> int:
        return self.attn["k"].out_features // self.attn["q"].out_features

    def set_kv_mult(self, mult: int) -> None:
        """K and V rebuilt mult·D wide (uninitialised) on their device, in
        their dtype, trainable as they were."""
        d = self.attn["q"].out_features
        for n in ("k", "v"):
            old = self.attn[n]
            new = nn.Linear(d, d * mult, device=old.weight.device, dtype=old.weight.dtype)
            new.requires_grad_(old.weight.requires_grad)
            self.attn[n] = new

    def _attention(self, x, attn_bias, causal: bool):
        """Self-attention, fp32 softmax (`_mkv_attention`): K and V's `mult`
        copies token-interleaved ([B, S, mult·D] → [B, H, S·mult, hd]); a
        causal mask and `attn_bias` ([B, 1, S or 1, S]) on the logits, each
        repeated `mult` times per key."""
        b, s, d = x.shape
        hd = d // self.num_heads
        mult = self.kv_mult
        split = lambda t, n: t.reshape(b, n, self.num_heads, hd).transpose(1, 2)  # noqa: E731
        q = split(self.attn["q"](x), s)
        k, v = (split(self.attn[n](x), s * mult) for n in ("k", "v"))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            rows = torch.arange(s, device=x.device)[:, None]
            cols = torch.arange(s, device=x.device)[None, :]
            logits = logits + torch.where(cols <= rows, 0.0, -1e9).repeat_interleave(mult, -1)
        if attn_bias is not None:
            logits = logits + attn_bias.float().repeat_interleave(mult, -1)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return self.attn["o"](out.transpose(1, 2).reshape(b, s, d))

    def forward(self, x, attn_bias=None, causal: bool = True):
        x = x + self._attention(self.ln1(x), attn_bias, causal)
        return x + self.mlp["fc2"](self.act(self.mlp["fc1"](self.ln2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids, input_embs=None, skip_weights=None,
                return_hidden_states: bool = False, return_pooled: bool = False):
        """→ last_hidden_state [B, S, D] (`text_encode`, `clip.py:303-365`);
        with `return_hidden_states` or `return_pooled`, a dict of it and:

        - hidden_states: [embeddings, each layer's output] (no final LN;
          SDXL and SD3 read [-2], the penultimate layer's);
        - pooled: the final state at each row's argmax of `input_ids` (the
          eos, until placeholder ids past it extend the vocabulary: then the
          first of the largest, as in JAX) and, with a projection,
          pooled_proj = pooled · text_projection.

        input_embs [B, S, D] replaces the token lookup; skip_weights [k] or
        [k, D] weights the last k hidden states (embeddings + layer outputs),
        normalised over k, before the final LayerNorm.
        """
        if input_embs is None:
            input_embs = self.token_embedding[input_ids]
        s = input_embs.shape[1]
        x = input_embs + self.position_embedding[None, :s]
        states = [x]
        for layer in self.layers:
            x = layer(x)
            states.append(x)
        if skip_weights is not None:
            w = skip_weights.float()
            if w.dim() == 1:
                w = w[:, None]
            w = w / w.sum(dim=0, keepdim=True)
            stacked = torch.stack(states[-w.shape[0]:], dim=0).float()
            x = (stacked * w[:, None, None, :]).sum(dim=0).to(x.dtype)
        out = self.final_ln(x)
        if not (return_hidden_states or return_pooled):
            return out
        results = {"last_hidden_state": out}
        if return_pooled:
            pooled = out[torch.arange(out.shape[0], device=out.device), input_ids.argmax(dim=-1)]
            results["pooled"] = pooled
            if self.cfg.projection_dim is not None:
                results["pooled_proj"] = F.linear(pooled,
                                                  self.text_projection.weight.to(pooled.dtype))
        if return_hidden_states:
            results["hidden_states"] = states
        return results


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIP_L_VISION):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Parameter(torch.zeros(d, cfg.num_channels, p, p))  # OIHW
        self.position_embedding = nn.Parameter(torch.zeros(cfg.num_tokens, d))
        self.pre_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.post_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        if cfg.projection_dim is not None:
            self.visual_projection = nn.Linear(d, cfg.projection_dim)

    @fp32_convolutions()
    def forward(self, pixel_values, image_mask=None, mask_mode: str = "soft_pair",
                return_hidden_states: bool = False) -> dict:
        """pixel_values [B, 3, H, W], image_mask [B, 1, H', W'] (any size,
        nearest-resized to the patch grid; the class token always counts) →
        {last_hidden_state, pooled, token_mask [B, S, 1] or None,
        image_embeds (with a projection), hidden_states (if asked)}.

        mask_mode "soft_pair" is the reference's: the 0/1 pairwise mask
        maskᵢ·maskⱼ is *added* to the logits, a +1 bias on kept pairs and
        none on the others (`clip.py:390-396`); "hard" adds −1e9 over the
        masked keys."""
        cfg = self.cfg
        b, d = pixel_values.shape[0], cfg.hidden_size
        patches = F.conv2d(pixel_values.float(), self.patch_embedding.float(),
                           stride=cfg.patch_size)  # [B, D, g, g]
        g = patches.shape[-1]
        x = torch.cat([self.class_embedding.expand(b, 1, d),
                       patches.flatten(2).transpose(1, 2)], dim=1)
        x = self.pre_ln(x + self.position_embedding[None, :x.shape[1]])

        attn_bias = token_mask = None
        if image_mask is not None:
            m = resize_nearest(image_mask.float(), (g, g)).reshape(b, 1, g * g)
            token_mask = torch.cat([m.new_ones(b, 1, 1), m], dim=-1)  # [B, 1, S]
            if mask_mode == "soft_pair":
                attn_bias = token_mask[:, :, :, None] * token_mask[:, :, None, :]
            elif mask_mode == "hard":
                attn_bias = (token_mask[:, :, None, :] - 1.0) * 1e9
            else:
                raise ValueError(f"unknown mask_mode {mask_mode!r}")
        states = [x]
        for layer in self.layers:
            x = layer(x, attn_bias, causal=False)
            states.append(x)
        pooled = self.post_ln(x[:, 0])
        out = {"last_hidden_state": x, "pooled": pooled,
               "token_mask": None if token_mask is None else token_mask.transpose(1, 2)}
        if cfg.projection_dim is not None:
            out["image_embeds"] = self.visual_projection(pooled)
        if return_hidden_states:
            out["hidden_states"] = states
        return out


def token_embeddings(model: CLIPTextModel, input_ids):
    """Token lookup alone (`clip.py:367`)."""
    return model.token_embedding[input_ids]


def extend_position_embedding(model: CLIPTextModel, new_len: int) -> None:
    """Grow the position table to new_len by repeating its last rows
    (`clip.py:454-464`). Updates the module in place."""
    pe = model.position_embedding
    cur = pe.shape[0]
    if new_len <= cur:
        return
    with torch.no_grad():
        grown = torch.cat([pe, pe[-(new_len - cur):]], dim=0)
    model.position_embedding = nn.Parameter(grown, requires_grad=pe.requires_grad)


def init_text_weights_(model: CLIPTextModel, gen: torch.Generator) -> None:
    """`init_text_params` scales: linears (the text projection too)
    N(0, 0.02²), token table N(0, 0.02²), positions N(0, 0.01²), norms 1/0,
    biases 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 0.02, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    normal_(model.token_embedding, 0.02, gen)
    normal_(model.position_embedding, 0.01, gen)


def init_vision_weights_(model: CLIPVisionModel, gen: torch.Generator) -> None:
    """`init_vision_params` scales (`clip.py:179-210`): linears (the
    projection too) N(0, 0.02²), class and patch embeddings N(0, 0.02²),
    positions N(0, 0.01²), norms 1/0, biases 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 0.02, gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    normal_(model.class_embedding, 0.02, gen)
    normal_(model.patch_embedding, 0.02, gen)
    normal_(model.position_embedding, 0.01, gen)


# ---------------------------------------------------------------------------
# MKV weight surgery (`clip.py:467-535`)
# ---------------------------------------------------------------------------


def _layer_count(sd: dict, prefix: str) -> int:
    n = 0
    while f"{prefix}layers.{n}.attn.k.weight" in sd:
        n += 1
    return n


def layer_multipliers(model_or_sd, prefix: str = "") -> list[int]:
    """Each layer's K/V multiplier, read from the widths: K's rows over Q's."""
    sd = model_or_sd.state_dict() if isinstance(model_or_sd, nn.Module) else model_or_sd
    return [sd[f"{prefix}layers.{i}.attn.k.weight"].shape[0]
            // sd[f"{prefix}layers.{i}.attn.q.weight"].shape[0]
            for i in range(_layer_count(sd, prefix))]


def fit_kv_widths_(module: nn.Module, sd: dict) -> nn.Module:
    """Every `EncoderLayer` of `module` rebuilt with K and V at the widths
    `sd` (a state dict of `module`) holds, so that it loads."""
    for name, m in module.named_modules():
        if isinstance(m, EncoderLayer):
            key = f"{name}.attn.k.weight" if name else "attn.k.weight"
            if key in sd and sd[key].shape[0] != m.attn["k"].out_features:
                m.set_kv_mult(sd[key].shape[0] // m.attn["q"].out_features)
    return module


def _in_place(model: nn.Module, fn) -> nn.Module:
    sd = fn(model.state_dict())
    fit_kv_widths_(model, sd)
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return model


def extend_mkv(model_or_sd, multipliers: list[int], draws: Draws | None = None,
               perturb_std: float = 0.1, prefix: str = ""):
    """Each layer's K/V extended by its multiplier (`extend_mkv`,
    `CLIPAttentionMKV.extend_weights`): the weight's rows repeated, the
    added copies perturbed by noise of `perturb_std` times their own std,
    the biases repeated unperturbed. Draws, in order: per layer whose
    multiplier is not 1, a normal of K's added rows, then V's (JAX's draws
    are the transposes: its weights are [in, out]). A module is extended in
    place and returned; a state dict, as a new one."""
    if isinstance(model_or_sd, nn.Module):
        return _in_place(model_or_sd, lambda sd: extend_mkv(sd, multipliers, draws,
                                                            perturb_std, prefix))
    sd = dict(model_or_sd)
    for i in range(_layer_count(sd, prefix)):
        mult = multipliers[i] if i < len(multipliers) else 1
        if mult == 1:
            continue
        for name in ("k", "v"):
            key = f"{prefix}layers.{i}.attn.{name}"
            w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
            extra = w.repeat(mult - 1, 1)
            noise = draws.normal(extra.shape, w.device)
            sd[f"{key}.weight"] = torch.cat([w, perturb_tensor(extra, perturb_std, noise)])
            sd[f"{key}.bias"] = b.repeat(mult)
    return sd


def squeeze_mkv(model_or_sd, divisors: list[int], prefix: str = ""):
    """The multiplier copies averaged back down (`squeeze_mkv`,
    `CLIPAttentionMKV.squeeze_weights`): each layer's K/V rows and biases as
    `divisor` blocks, averaged. A module in place; a state dict, as a new one."""
    if isinstance(model_or_sd, nn.Module):
        return _in_place(model_or_sd, lambda sd: squeeze_mkv(sd, divisors, prefix))
    sd = dict(model_or_sd)
    for i in range(_layer_count(sd, prefix)):
        div = divisors[i] if i < len(divisors) else 1
        if div == 1:
            continue
        for name in ("k", "v"):
            key = f"{prefix}layers.{i}.attn.{name}"
            w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
            sd[f"{key}.weight"] = w.reshape(div, -1, w.shape[1]).mean(dim=0)
            sd[f"{key}.bias"] = b.reshape(div, -1).mean(dim=0)
    return sd
