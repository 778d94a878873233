"""SubjBasisGenerator: image-prompt embeddings → ada embeddings.

Counterpart of `adaface_tpu/id2ada/subj_basis_generator.py`
(`inverse_img_prompt_embs` and `subj_basis_forward`, `:179-330`).

Face path: the N_ID image-prompt embeddings are spliced into the tokenised
template "photo of a , , …" at its filler positions (static image-suffix
embeddings, when enabled, overwrite the N_SFX tokens after them), the
prompt2token_proj CLIP-L tower runs over it with learnable last-3-hidden-
state weights, and the N_ID (+ N_SFX) output positions are the ada
embeddings; the N_ID of them are mixed toward the all-pad prompt's
embeddings by `out_id_embs_cfg_scale`. Non-face subjects take the
`obj_proj_in` expansion of a DINO embedding instead. The dormant layerwise
projection keeps the JAX package's deviation from the reference (its skip
broadcasts over layers, `:318-325`).

Background path (`placeholder_is_bg`): CLIP image features → linear +
LayerNorm → plus normalised position embeddings; LayerNorm'd latent queries
cross-attend over them (the prompt translator), scaled by output_dim^-0.5.

At inference the gradient scaler on the layer weights is the identity; the
MKV extension of prompt2token_proj waits for the training slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.params import init_fan_in_, normal_
from adaface_tpu_torch.id2ada.layers import CrossAttention, ExpandEmbs
from adaface_tpu_torch.models.clip import (CLIP_L_TEXT, CLIPTextConfig, CLIPTextModel,
                                           init_text_weights_)
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer

EMB_TYPES = ("core", "full", "full_pad", "full_half_pad")


@dataclasses.dataclass(frozen=True)
class SubjBasisConfig:
    num_id_vecs: int = 16  # arc2face 16, consistentID 4
    num_static_img_suffix_embs: int = 0
    output_dim: int | None = None  # None: the prompt2token_proj tower's width
    max_prompt_length: int = 77
    placeholder_is_bg: bool = False
    bg_image_embedding_dim: int = 1024
    obj_embedding_dim: int = 384
    num_bg_encoder_heads: int = 6
    num_out_embs_bg: int = 64
    use_layerwise_proj: bool = False
    layerwise_num_layers: int = 16
    layerwise_dim_mult: int = 2
    clip: CLIPTextConfig = CLIP_L_TEXT

    @property
    def out_dim(self) -> int:
        return self.output_dim or self.clip.hidden_size


def _build_template(tokenizer: CLIPTokenizer, n_fillers: int,
                    max_length: int) -> tuple[np.ndarray, int]:
    """Tokenize 'photo of a ' + ', '*N; return (ids [S], first filler pos)."""
    ids = tokenizer(["photo of a " + ", " * n_fillers], max_length=max_length)[0]
    comma_id = tokenizer.encode_text(",")[0]
    first = int(np.argmax(ids == comma_id))
    if ids[first] != comma_id:
        raise ValueError("template tokenization has no filler token")
    return ids, first


def _ln(x, norm: nn.LayerNorm):
    """The JAX `_ln`: fp32 statistics, eps 1e-5, cast back."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        1e-5).to(x.dtype)


class LayerwiseProj(nn.Module):
    """[B, N, D] → [B, L, N, D]: wide linear → GELU → linear, + skip, LN.
    Weights in the JAX layout ([in, out], names w1, b1, w2, b2)."""

    def __init__(self, d: int, num_layers: int, dim_mult: int):
        super().__init__()
        self.num_layers, self.dim_mult = num_layers, dim_mult
        self.w1 = nn.Parameter(torch.zeros(d, num_layers * dim_mult * d))
        self.b1 = nn.Parameter(torch.zeros(num_layers * dim_mult * d))
        self.w2 = nn.Parameter(torch.zeros(dim_mult * d, d))
        self.b2 = nn.Parameter(torch.zeros(d))
        self.ln = nn.LayerNorm(d)

    def forward(self, x):
        b, n, d = x.shape
        h = torch.matmul(x, self.w1.to(x.dtype)) + self.b1
        h = F.gelu(h.reshape(b, n, self.num_layers, self.dim_mult * d), approximate="tanh")
        y = torch.matmul(h, self.w2.to(x.dtype)) + self.b2
        return _ln(y + x[:, :, None], self.ln).transpose(1, 2)


class SubjBasisGenerator(nn.Module):
    """Face (and non-face) path: `clip` is the prompt2token_proj tower, its
    token and position tables the frozen buffers of the JAX version.
    Background path: the projection and the prompt translator alone."""

    def __init__(self, cfg: SubjBasisConfig, tokenizer: CLIPTokenizer):
        super().__init__()
        self.cfg = cfg
        d = cfg.out_dim
        if cfg.placeholder_is_bg:
            self.bg_proj_in = nn.ModuleDict({
                "proj": nn.Linear(cfg.bg_image_embedding_dim, d, bias=False),
                "ln": nn.LayerNorm(d)})
            self.pos_embs = nn.Parameter(torch.zeros(1, 257, d))
            self.pos_embs_ln = nn.LayerNorm(d)
            self.latent_queries = nn.Parameter(torch.zeros(1, cfg.num_out_embs_bg, d))
            self.latent_queries_ln = nn.LayerNorm(d)
            self.prompt_translator = CrossAttention(d, cfg.num_bg_encoder_heads)
            return
        self.clip = CLIPTextModel(cfg.clip)
        self.hidden_state_layer_weights = nn.Parameter(
            torch.tensor([[1.0], [2.0], [4.0]]))
        if cfg.num_static_img_suffix_embs > 0:
            self.static_img_suffix_embs = nn.Parameter(
                torch.zeros(1, cfg.num_static_img_suffix_embs, d))
        self.obj_proj_in = ExpandEmbs(cfg.obj_embedding_dim, d, cfg.num_id_vecs)
        if cfg.use_layerwise_proj:
            self.layerwise_proj = LayerwiseProj(d, cfg.layerwise_num_layers,
                                                cfg.layerwise_dim_mult)
        # N_ID + 2 fillers: static suffix embeddings overwrite what follows
        # the ID tokens rather than lengthen the template (`:130-134`)
        self.template_ids, self.id_start = _build_template(
            tokenizer, cfg.num_id_vecs + 2, cfg.max_prompt_length)
        self.pad_token_id = tokenizer.pad_token_id

    def pad_embeddings(self):
        """Token + position embeddings of an all-pad prompt [L, D]."""
        n = self.cfg.max_prompt_length
        return self.clip.token_embedding[self.pad_token_id] + self.clip.position_embedding[:n]

    def inverse_img_prompt_embs(self, face_prompt_embs, return_emb_types=("core",),
                                enable_static_img_suffix_embs: bool = False) -> tuple:
        """Template splice → prompt2token_proj → the embeddings asked for:
        'core' (the N_ID [+ N_SFX] ID embeddings), 'full' (all positions),
        'full_pad' (the tail after ID, suffix and two fillers replaced by
        the pad embeddings), 'full_half_pad' (half that tail replaced)."""
        cfg = self.cfg
        b = face_prompt_embs.shape[0]
        n_id, n_sfx = cfg.num_id_vecs, cfg.num_static_img_suffix_embs
        start = self.id_start
        end = start + n_id
        pad_begin = end + n_sfx + 2
        ids = torch.as_tensor(self.template_ids, dtype=torch.long,
                              device=face_prompt_embs.device).expand(b, -1)
        token_embs = self.clip.token_embedding[ids]
        token_embs[:, start:end] = face_prompt_embs.to(token_embs.dtype)
        if enable_static_img_suffix_embs and n_sfx > 0:
            token_embs[:, end:end + n_sfx] = self.static_img_suffix_embs.to(token_embs.dtype)
        out = self.clip(ids, input_embs=token_embs,
                        skip_weights=self.hidden_state_layer_weights)
        core_end = end + n_sfx if enable_static_img_suffix_embs else end
        results = []
        for t in return_emb_types:
            if t not in EMB_TYPES:
                raise ValueError(f"unknown emb type {t}")
            if t == "core":
                results.append(out[:, start:core_end])
                continue
            p = out.clone()
            pad = self.pad_embeddings().to(out.dtype)
            if t == "full_pad":
                p[:, pad_begin:-1] = pad[pad_begin:-1]
            elif t == "full_half_pad":
                pads = out.shape[1] - pad_begin - 1
                if pads >= 2:
                    p[:, pad_begin:pad_begin + pads // 2] = pad[pad_begin:pad_begin + pads // 2]
            results.append(p)
        return tuple(results)

    def forward(self, face_prompt_embs=None, out_id_embs_cfg_scale: float = 1.0,
                clip_features=None, raw_id_embs=None, is_face: bool = True,
                enable_static_img_suffix_embs: bool = False):
        """Face: [B, N_ID, D] image-prompt embeddings → [B, N_ID (+ N_SFX), D]
        ada embeddings ([B, L, N, D] with the layerwise projection).
        Non-face: raw_id_embs [B, 384] → [B, N_ID, D]. Background:
        clip_features [B, 257, D_clip] → [B, num_out_embs_bg, D]."""
        cfg = self.cfg
        if cfg.placeholder_is_bg:
            feats = _ln(self.bg_proj_in["proj"](clip_features), self.bg_proj_in["ln"])
            feats = feats + _ln(self.pos_embs, self.pos_embs_ln)
            queries = _ln(self.latent_queries, self.latent_queries_ln).expand(
                feats.shape[0], -1, -1)
            return self.prompt_translator(queries, feats) * (cfg.out_dim ** -0.5)
        if is_face:
            (ada,) = self.inverse_img_prompt_embs(
                face_prompt_embs, ("core",),
                enable_static_img_suffix_embs=enable_static_img_suffix_embs)
        else:
            ada = self.obj_proj_in(raw_id_embs)
        if out_id_embs_cfg_scale != 1.0:
            # CFG mix toward the pad embeddings; never on the static suffix
            n_id, start = cfg.num_id_vecs, self.id_start
            pad = self.pad_embeddings()[start:start + n_id].to(ada.dtype)
            s = out_id_embs_cfg_scale
            ada = torch.cat([ada[:, :n_id] * s + pad[None] * (1.0 - s), ada[:, n_id:]], dim=1)
        if cfg.use_layerwise_proj and is_face:
            ada = self.layerwise_proj(ada)
        return ada


def init_sbg_weights_(sbg: SubjBasisGenerator, gen: torch.Generator) -> None:
    """`init_subj_basis_generator` scales: a random CLIP-L tower, the
    hidden-state layer weights at their [1, 2, 4] start, suffix embeddings
    and latent queries N(0, 1), the layerwise projection N(0, 1/fan_in),
    dense layers N(0, 1/fan_in), norms 1/0, the bg position embeddings 0."""
    cfg = sbg.cfg
    if cfg.placeholder_is_bg:
        init_fan_in_(sbg, gen)
        with torch.no_grad():
            sbg.pos_embs.zero_()
        normal_(sbg.latent_queries, 1.0, gen)
        return
    init_text_weights_(sbg.clip, gen)
    with torch.no_grad():
        sbg.hidden_state_layer_weights.copy_(torch.tensor([[1.0], [2.0], [4.0]]))
    if cfg.num_static_img_suffix_embs > 0:
        normal_(sbg.static_img_suffix_embs, 1.0, gen)
    init_fan_in_(sbg.obj_proj_in, gen)
    if cfg.use_layerwise_proj:
        lw = sbg.layerwise_proj
        normal_(lw.w1, lw.w1.shape[0] ** -0.5, gen)
        normal_(lw.w2, lw.w2.shape[0] ** -0.5, gen)
        for p in (lw.b1, lw.b2, lw.ln.bias):
            nn.init.zeros_(p)
        nn.init.ones_(lw.ln.weight)
