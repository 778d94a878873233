"""SD1.5 UNet (UNet2DConditionModel) with the training path's adapters and
the serving speed modes.

Counterpart of `unet_apply` in `adaface_tpu/models/unet.py` without its
motion and SDXL branches. NCHW latents in and out, as the JAX interface
(`unet.py:685`). The serving speed modes:

- `deepcache` (`unet.py:698-731`): "collect" also returns the feature that
  enters the last up block; ("shallow", feat) runs conv_in, down block 0
  without its downsample, the last up block on `feat` and the head;
- `tome` (`ops/tome.py`, `_transformer2d` `unet.py:605-668`): token
  merging around each self-attention (and by the config the
  cross-attention's queries and the GEGLU) of every transformer whose map
  has at least `min_tokens` tokens, unless an `img_mask` is given;
- int8: `ops.quant.quantize_unet` swaps the convolutions (and optionally
  the biased projections) for `Int8Conv2d` / `Int8Linear`; a DoRA adapter
  composes on their dequantized weight (`unet.py:214-217`, `:233-236`).

The options the training iterations use:

- `img_mask` [B, 1, H, W] drops the keys outside the mask from every
  self-attention (resized nearest to each level);
- `AttnRuntime` (`unet.py:114-126`): the per-call flags of the attention
  LoRA, the FFN LoRA and its adapter, q2 driving the query, the
  cross-attention normalization and attention-matrix mixing, and the
  gradient scale of the up blocks' skip features;
- the adapters (`AttnLoRA`, `FFNLoRA`: DoRA on q/out of the last up
  block's three cross-attentions, labelled 22-24 as the JAX package labels
  them, and on its resnets[1, 2] conv1/conv2 with three named adapters),
  each gated row by row (`attn_lora_gate`, `ffn_lora_gate`);
- capture (a dict passed as `capture`): the last up block's
  cross-attentions go through the explicit path (fp32 logits, softmax) and
  hand back q, q2, k, v ([B, C, N], scaled by the square root of the
  attention scale), attn, attnscore (compute dtype), attn_out and outfeat,
  keyed `capture[key][label]`. Under normalization or mixing every
  cross-attention takes the explicit path, as in JAX (`unet.py:548-598`).

Inside, activations and convolution weights are kept in channels-last
memory (logical shapes stay NCHW): cuDNN's bf16 convolutions run in that
layout without transposes, `csrc/group_norm_silu.cu` reads a map as
[B, H·W, C] rows, and the transformer blocks' [B, H·W, C] tokens are a view
of the map. Every GroupNorm goes through the GN kernels, and every
attention with q-length >= 256 outside the explicit path through the flash
kernel (64², 32² and 16² levels: 15 transformers × self + cross = 30
launches per plain call; the 8² mid-block runs the plain version, as the JAX
package ran XLA there). Convolutions and projections are cuDNN/cuBLAS, as
the JAX package left them to XLA. With `UNetConfig.fused_ln` set (default:
`ADAFACE_FUSED_LN=1`, the JAX package's toggle, `unet.py:176`) the 48
LayerNorms of the 16 transformer blocks go through the LayerNorm kernel;
unset, they stay `nn.LayerNorm`, as the JAX default stays XLA.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.params import init_fan_in_, normal_
from adaface_tpu_torch.ops import tome as tome_ops
from adaface_tpu_torch.ops.attention import multi_head_attention
from adaface_tpu_torch.ops.fused_gn import GroupNorm
from adaface_tpu_torch.ops.fused_ln import LayerNorm
from adaface_tpu_torch.ops.resize import resize_nearest
from adaface_tpu_torch.utils.tensor import gen_gradient_scaler, gradient_scale


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
    lora_rank: int = 192
    lora_alpha: int = 24  # rank / 8: the adapters' scale is alpha / rank
    fused_ln: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("ADAFACE_FUSED_LN", "0") == "1")

    @property
    def lora_scale(self) -> float:
        return self.lora_alpha / self.lora_rank


SD15_UNET = UNetConfig()
CAPTURE_LAYER_BASE = 22  # the JAX package's label of the first captured layer
FFN_ADAPTERS = ("recon_loss", "unet_distill", "comp_distill")


@dataclasses.dataclass(frozen=True)
class AttnRuntime:
    """Per-call attention flags (`AttnRuntime`, `unet.py:114-126`)."""

    capture: bool = False
    use_attn_lora: bool = False
    use_ffn_lora: bool = False
    ffn_adapter: str | None = None  # recon_loss | unet_distill | comp_distill
    q_lora_updates_query: bool = False
    normalize_cross_attn: bool = False
    mix_attn_mats_in_batch: bool = False
    res_hidden_gradscale: float = 1.0


PLAIN = AttnRuntime()


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


def _base_weight(base: nn.Module) -> torch.Tensor:
    """A layer's weight for a DoRA adapter to compose on: an int8 layer's
    dequantized w_q · w_scale (`ops.quant.Int8Conv2d` / `Int8Linear`),
    else its own."""
    dequantized = getattr(base, "dequantized", None)
    return base.weight if dequantized is None else dequantized()


def _gated(gate, adapted, plain):
    """Row by row: `adapted` where gate > 0, else `plain` (`jnp.where` on a
    [B] gate); the memory format of `adapted` kept."""
    shape = (-1,) + (1,) * (adapted.dim() - 1)
    out = torch.where(gate.reshape(shape) > 0, adapted, plain)
    if adapted.dim() == 4:
        out = out.contiguous(memory_format=torch.channels_last)
    return out


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------


class DoRALinear(nn.Module):
    """DoRA adapter of a projection (`dora_dense`, `unet.py:207-225`):
    W' = mag ⊙ (W + s·B A) / ‖W + s·B A‖ over each output's inputs. lora_a
    [r, in], lora_b [out, r] (JAX's a [in, r], b [r, out] transposed)."""

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__()
        self.lora_a = nn.Parameter(torch.zeros(rank, in_features))
        self.lora_b = nn.Parameter(torch.zeros(out_features, rank))
        self.magnitude = nn.Parameter(torch.ones(out_features))

    def forward(self, base: nn.Linear, x, scale: float):
        w = _base_weight(base).float() + scale * (self.lora_b.float() @ self.lora_a.float())
        w = w * (self.magnitude[:, None] / (torch.linalg.vector_norm(w, dim=1, keepdim=True)
                                            + 1e-8))
        bias = None if base.bias is None else base.bias.to(x.dtype)
        return F.linear(x, w.to(x.dtype), bias)


class DoRAConv(nn.Module):
    """DoRA adapter of a 3x3 convolution (`dora_conv`, `unet.py:228-250`):
    the magnitude per output channel over its (in, h, w) norm. lora_a
    [r, in, 3, 3], lora_b [out, r, 1, 1] (JAX's HWIO a and b transposed)."""

    def __init__(self, cin: int, cout: int, rank: int, k: int = 3):
        super().__init__()
        self.lora_a = nn.Parameter(torch.zeros(rank, cin, k, k))
        self.lora_b = nn.Parameter(torch.zeros(cout, rank, 1, 1))
        self.magnitude = nn.Parameter(torch.ones(cout))

    def forward(self, base: nn.Conv2d, x, scale: float):
        delta = torch.einsum("or,rihw->oihw", self.lora_b[:, :, 0, 0].float(),
                             self.lora_a.float())
        w = _base_weight(base).float() + scale * delta
        w = w * (self.magnitude[:, None, None, None]
                 / (torch.sqrt((w * w).sum(dim=(1, 2, 3), keepdim=True)) + 1e-8))
        w = w.to(x.dtype).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, base.bias.to(x.dtype), stride=base.stride, padding=base.padding)


class AttnLoRALayer(nn.Module):
    """One captured cross-attention's adapters: q, k, v, out, and the
    normalization's scale factor (k and v exist but are never enabled, as in
    JAX, `unet.py:535-537`)."""

    def __init__(self, c: int, cross_dim: int, rank: int):
        super().__init__()
        self.q = DoRALinear(c, c, rank)
        self.k = DoRALinear(cross_dim, c, rank)
        self.v = DoRALinear(cross_dim, c, rank)
        self.out = DoRALinear(c, c, rank)
        self.scale_factor = nn.Parameter(torch.tensor(0.8))


class AttnLoRA(nn.ModuleDict):
    """The attention adapters of the last up block's three cross-attentions,
    keyed "22", "23", "24" (`init_attn_lora_params`, `unet.py:403-423`)."""

    def __init__(self, cfg: UNetConfig = SD15_UNET):
        c = cfg.block_channels[0]
        super().__init__({str(CAPTURE_LAYER_BASE + li): AttnLoRALayer(c, cfg.cross_attn_dim,
                                                                       cfg.lora_rank)
                          for li in range(3)})


class FFNLoRA(nn.ModuleDict):
    """DoRA adapters of up_blocks[-1].resnets[1, 2].conv1/conv2 under three
    names (`init_ffn_lora_params`, `unet.py:426-455`): adapter → "1" / "2" →
    conv1 (the [h; skip] input, 2c channels) / conv2."""

    def __init__(self, cfg: UNetConfig = SD15_UNET):
        c, r = cfg.block_channels[0], cfg.lora_rank
        super().__init__({ad: nn.ModuleDict({
            str(ri): nn.ModuleDict({"conv1": DoRAConv(2 * c, c, r), "conv2": DoRAConv(c, c, r)})
            for ri in (1, 2)}) for ad in FFN_ADAPTERS})


def init_lora_weights_(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX initialisers' scales: A ~ N(0, 1/fan_in) (fan_in over its
    input channels and window), B 0, magnitudes 1, scale factors 0.8."""
    for m in module.modules():
        if isinstance(m, (DoRALinear, DoRAConv)):
            normal_(m.lora_a, m.lora_a[0].numel() ** -0.5, gen)
            nn.init.zeros_(m.lora_b)
            nn.init.ones_(m.magnitude)
        elif isinstance(m, AttnLoRALayer):
            nn.init.constant_(m.scale_factor, 0.8)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, temb_dim, cfg: UNetConfig):
        super().__init__()
        self.norm1 = GroupNorm(cin, cfg.norm_groups, cfg.norm_eps)
        self.conv1 = _conv(cin, cout)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNorm(cout, cfg.norm_groups, cfg.norm_eps)
        self.conv2 = _conv(cout, cout)
        self.conv_shortcut = _conv(cin, cout, k=1) if cin != cout else None

    def _conv(self, name, h, lora, scale, gate):
        conv = getattr(self, name)
        if lora is None:
            return conv(h)
        y = lora[name](conv, h, scale)
        # the reference enables the comp FFN LoRA on some rows only
        # (`unet.py:469-473`)
        return y if gate is None else _gated(gate, y, conv(h))

    def forward(self, x, temb, ffn_lora=None, lora_scale: float = 0.0, lora_gate=None):
        h = self._conv("conv1", self.norm1(x, silu=True), ffn_lora, lora_scale, lora_gate)
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self._conv("conv2", self.norm2(h, silu=True), ffn_lora, lora_scale, lora_gate)
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

    def forward(self, x, context=None, kv_mask=None, rt: AttnRuntime = PLAIN,
                lora: AttnLoRALayer | None = None, subj_mask=None, lora_scale: float = 0.0,
                capture: dict | None = None, lora_gate=None):
        """`_cross_attention` (`unet.py:486-602`). `kv_mask` [B, Sk]: 1 keeps
        a key; `lora` this layer's adapters, `lora_gate` [B] (1 adapted, 0
        plain); `subj_mask` [B, Sk] the subject tokens the normalization
        rescales; `capture` (a dict) receives this layer's tensors."""
        b, n, c = x.shape
        cross = context is not None
        use_lora = cross and rt.use_attn_lora and lora is not None
        if not cross:
            q, k, v = self.qkv(x).split(c, dim=-1)
            q2 = q
        else:
            q = q2 = self.q(x)
            # q's adapter feeds only the capture and, by the flag, the query:
            # where neither reads it, it is not computed (XLA drops it too)
            if use_lora and (capture is not None or rt.q_lora_updates_query):
                q2 = lora.q(self.q, x, lora_scale)
                if lora_gate is not None:
                    q2 = _gated(lora_gate, q2, q)
                if rt.q_lora_updates_query:
                    q = q2
            k, v = self.kv(context).split(c, dim=-1)
        hd = c // self.num_heads
        split = lambda t: t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)  # noqa: E731
        q, q2, k, v = split(q), split(q2), split(k), split(v)
        scale = 1.0 / math.sqrt(hd)
        if cross and (capture is not None or rt.normalize_cross_attn
                      or rt.mix_attn_mats_in_batch):
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
            if kv_mask is not None:
                logits = torch.where(kv_mask[:, None, None, :] > 0, logits, -1e9)
            if rt.mix_attn_mats_in_batch:
                # batch halves [sc, mc]; both get the sc-gradient average
                sc, mc = logits.chunk(2)
                mixed = (sc + mc.detach()) / 2.0
                logits = torch.cat([mixed, mixed])
            elif rt.normalize_cross_attn and subj_mask is not None:
                mean_q = logits.mean(dim=2, keepdim=True).detach()
                factor = 1.0 if lora is None else gradient_scale(lora.scale_factor, 10.0)
                logits = torch.where(subj_mask[:, None, None, :] > 0,
                                     (logits - mean_q) * factor, logits)
            probs = torch.softmax(logits, dim=-1)
            out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(x.dtype)
            if capture is not None:
                rs = math.sqrt(scale)
                flat = lambda t: (t * rs).transpose(-1, -2).reshape(b, c, -1)  # noqa: E731
                capture.update(q=flat(q), q2=flat(q2), k=flat(k), v=flat(v),
                               attn=probs.to(x.dtype), attnscore=logits.to(x.dtype))
        else:
            out = multi_head_attention(q, k, v, kv_mask=kv_mask, scale=scale)
        out = out.transpose(1, 2).reshape(b, n, c)
        if use_lora:
            adapted = lora.out(self.o, out, lora_scale)
            out = adapted if lora_gate is None else _gated(lora_gate, adapted, self.o(out))
        else:
            out = self.o(out)
        if capture is not None:
            capture["attn_out"] = out.transpose(1, 2)
        return out


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

    def forward(self, y, context, img_mask=None, tome=None, **cross):
        """`tome`: (ToMeConfig, merge, unmerge) of this block's tokens, or
        None; merge and unmerge go around attn1, around attn2 with
        `merge_crossattn` (not under capture, the cross-attention's
        normalization or mixing, `unet.py:647-649`) and around the GEGLU
        with `merge_mlp`."""
        cfg, merge, unmerge = tome or (None, None, None)
        if merge is None:
            y = y + self.attn1(self.norm1(y), kv_mask=img_mask)
        else:
            y = y + unmerge(self.attn1(merge(self.norm1(y)), kv_mask=img_mask))
        rt = cross.get("rt", PLAIN)
        merge_ca = (merge is not None and cfg.merge_crossattn and cross.get("capture") is None
                    and not rt.normalize_cross_attn and not rt.mix_attn_mats_in_batch)
        if merge_ca:
            y = y + unmerge(self.attn2(merge(self.norm2(y)), context, **cross))
        else:
            y = y + self.attn2(self.norm2(y), context, **cross)
        merge_mlp = merge is not None and cfg.merge_mlp
        ff_in = self.norm3(y)
        val, gate = self.ff["proj_in"](merge(ff_in) if merge_mlp else ff_in).chunk(2, dim=-1)
        ff_out = self.ff["proj_out"](val * F.gelu(gate, approximate="tanh"))
        return y + (unmerge(ff_out) if merge_mlp else ff_out)


class Transformer2D(nn.Module):
    def __init__(self, c, cross_dim, cfg: UNetConfig):
        super().__init__()
        self.norm = GroupNorm(c, cfg.norm_groups, cfg.transformer_norm_eps)
        self.proj_in = _conv(c, c, k=1)
        self.proj_out = _conv(c, c, k=1)
        self.block = TransformerBlock(c, cross_dim, cfg.num_heads, cfg.fused_ln)

    def forward(self, x, context, img_mask=None, tome=None, **cross):
        """img_mask [B, 1, H0, W0] or None: the self-attention's key mask,
        resized nearest to this map; `tome`: a `ToMeConfig` or None (on
        only at ratio > 0, at least `min_tokens` tokens and no img_mask; the
        merge is built from the `proj_in` tokens); `cross`: the
        cross-attention's options (`Attention.forward`)."""
        b, c, h, w = x.shape
        if img_mask is not None:
            img_mask = resize_nearest(img_mask.float(), (h, w)).reshape(b, h * w)
        y = self.proj_in(self.norm(x))
        # a channels-last map is the [B, H·W, C] token matrix: views both ways
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        merging = None
        if tome is not None and tome.ratio > 0.0 and h * w >= tome.min_tokens \
                and img_mask is None:
            merge, unmerge, _ = tome_ops.build_merge(y, h, w, int(h * w * tome.ratio), tome.sx,
                                                     tome.sy, tome.rand_seed)
            merging = (tome, merge, unmerge)
        y = self.block(y, context, img_mask, tome=merging, **cross)
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

    def forward(self, x, t, context, img_mask=None, capture: dict | None = None,
                rt: AttnRuntime = PLAIN, kv_mask=None, attn_lora: AttnLoRA | None = None,
                ffn_lora: FFNLoRA | None = None, subj_mask=None, attn_lora_gate=None,
                ffn_lora_gate=None, tome: tome_ops.ToMeConfig | None = None, deepcache=None):
        """eps [B, 4, h, w] for latents x [B, 4, h, w], timesteps t [B] and
        text context [B, S, cross_attn_dim]; computes in context's dtype.
        img_mask [B, 1, H, W]: the self-attentions' key mask; kv_mask [B, S]:
        the cross-attentions' key mask; `capture` (a dict, or rt.capture)
        receives {key: {22 + i: tensor}} of the last up block's
        cross-attentions (q, q2, k, v, attn, attnscore, attn_out, outfeat);
        `rt` the adapters' and the attention's flags; subj_mask [B, S] the
        subject tokens; the gates [B] select the adapters row by row; `tome`
        merges tokens in every transformer it applies to.

        `deepcache` (`unet.py:698-731`): "collect" → (eps, the feature that
        enters the last up block, channels-last); ("shallow", feat) → eps of
        conv_in, down block 0 without its downsample (the three skips they
        push are the three the last up block pops), the last up block on
        `feat` and the head. The captured cross-attentions 22-24 live in the
        last up block, so a shallow call captures them exactly."""
        dc_mode, dc_feat = None, None
        if deepcache == "collect":
            dc_mode = "collect"
        elif deepcache is not None:
            dc_mode, dc_feat = deepcache
            if dc_mode != "shallow":
                raise ValueError(f"UNet: deepcache is None, 'collect' or ('shallow', feat), "
                                 f"got {deepcache!r}")
        if rt.capture and capture is None:
            raise ValueError("UNet: rt.capture needs a dict to fill (capture=)")
        x = x.to(context.dtype).contiguous(memory_format=torch.channels_last)
        if self.time_freqs.dtype != torch.float32:
            raise ValueError("UNet: time_freqs must stay fp32 (call reset_buffers() after "
                             "casting the module)")
        temb = timestep_embedding(t, self.cfg.block_channels[0],
                                  freqs=self.time_freqs).to(context.dtype)
        temb = self.time_mlp["fc2"](F.silu(self.time_mlp["fc1"](temb)))
        cross = dict(rt=rt, kv_mask=kv_mask, subj_mask=subj_mask, tome=tome)
        ffn_ad = None
        if rt.use_ffn_lora and ffn_lora is not None and rt.ffn_adapter is not None:
            ffn_ad = ffn_lora[rt.ffn_adapter]
        scale = self.cfg.lora_scale
        shallow = dc_mode == "shallow"
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks[:1] if shallow else self.down_blocks:
            for li, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[li](h, context, img_mask, **cross)
                skips.append(h)
            if blk.downsample is not None and not shallow:
                h = blk.downsample(h)
                skips.append(h)
        if not shallow:
            h = self.mid["resnet1"](h, temb)
            h = self.mid["attention"](h, context, img_mask, **cross)
            h = self.mid["resnet2"](h, temb)
        grad_scale = gen_gradient_scaler(rt.res_hidden_gradscale)
        feat = None
        for bi, blk in enumerate(self.up_blocks):
            last = bi == len(self.up_blocks) - 1
            if shallow:
                if not last:
                    continue
                h = dc_feat.to(context.dtype).contiguous(memory_format=torch.channels_last)
            elif dc_mode == "collect" and last:
                feat = h
            for li, res in enumerate(blk.resnets):
                skip = skips.pop()
                if bi >= 1:  # the skip features' gradient scale (`unet.py:811-815`)
                    skip = grad_scale(skip)
                ffn = ffn_ad[str(li)] if last and ffn_ad is not None and str(li) in ffn_ad \
                    else None
                h = res(torch.cat([h, skip], dim=1), temb, ffn, scale, ffn_lora_gate)
                if len(blk.attentions):
                    label = CAPTURE_LAYER_BASE + li
                    lora = attn_lora[str(label)] if last and attn_lora is not None else None
                    cap = {} if last and capture is not None else None
                    h = blk.attentions[li](h, context, img_mask, lora=lora, lora_scale=scale,
                                           capture=cap, lora_gate=attn_lora_gate, **cross)
                    if cap is not None:
                        for key, val in (*cap.items(), ("outfeat", h)):
                            capture.setdefault(key, {})[label] = val
            if blk.upsample is not None:
                h = blk.upsample(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        eps = self.conv_out(self.conv_norm_out(h, silu=True)).contiguous()
        return (eps, feat) if dc_mode == "collect" else eps


def init_unet_weights_(model: UNet2DConditionModel, gen: torch.Generator) -> None:
    """`init_unet_params` scales: N(0, 1/fan_in) weights, zero biases,
    unit norms, and conv_out at std 1e-4."""
    init_fan_in_(model, gen)
    normal_(model.conv_out.weight, 1e-4, gen)
