"""Text→image Stable Diffusion 3 pipeline (MMDiT).

Counterpart of `adaface_tpu/inference/sd3_pipeline.py` (the reference's
"text2img3" branch): CLIP-L and OpenCLIP bigG, both with projected eos
poolings, whose penultimate hidden states concatenate and are zero-padded to
the 4096-d joint context; then a T5 segment of `t5_len` tokens, zeros when no
T5 tower runs (diffusers' text_encoder_3=None path) or the caller's
`t5_embs`; the pooled vector CLIP-L 768 ‖ bigG 1280; the MMDiT velocity
model; rectified-flow Euler sampling (shift 3.0, 28 steps, guidance 7.0);
the 16-channel VAE at latent scale 1.5305 and shift 0.0609. Runs on the
device its modules are on.

Ada placeholders live only in encoder 1; encoder 2 reads `prompts_2`, the
plain prompt, through 0-padded ids. Encoder 1 pools at the argmax of its
ids: with placeholders past eos in the vocabulary, that is the last
placeholder's position, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.models.clip import (CLIP_BIGG_TEXT, CLIP_L_TEXT, CLIPTextConfig,
                                           CLIPTextModel, init_text_weights_)
from adaface_tpu_torch.models.mmdit import SD3_MEDIUM, MMDiT, MMDiTConfig, init_mmdit_weights_
from adaface_tpu_torch.models.vae import VAEConfig, VAEDecoder
from adaface_tpu_torch.ops.samplers import rectified_flow_sample
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer, zero_pad_after_eos

SD3_LATENT_SCALE = 1.5305
SD3_LATENT_SHIFT = 0.0609
SD3_VAE = VAEConfig(z_channels=16)  # 16 latent channels, the SD VAE's topology otherwise
# SD3's CLIP-L is CLIPTextModelWithProjection (768)
SD3_CLIP_L_TEXT = dataclasses.replace(CLIP_L_TEXT, projection_dim=768)


@dataclasses.dataclass
class SD3PipelineModules:
    mmdit: MMDiT
    vae: VAEDecoder
    text_encoder: CLIPTextModel  # CLIP-L with projection, extended with the placeholders
    text_encoder_2: CLIPTextModel  # bigG with projection
    tokenizer: CLIPTokenizer
    latent_scale: float = SD3_LATENT_SCALE
    latent_shift: float = SD3_LATENT_SHIFT
    t5_len: int = 256  # the zero-filled T5 segment's length (no T5 tower)

    @property
    def device(self) -> torch.device:
        return self.mmdit.context_embedder.weight.device

    @classmethod
    def random_init(cls, gen: torch.Generator, device, dtype=torch.bfloat16,
                    mmdit_cfg: MMDiTConfig = SD3_MEDIUM, vae_cfg: VAEConfig = SD3_VAE,
                    text_cfg: CLIPTextConfig = SD3_CLIP_L_TEXT,
                    text2_cfg: CLIPTextConfig = CLIP_BIGG_TEXT, t5_len: int = 256,
                    tokenizer: CLIPTokenizer | None = None):
        """Random weights at the JAX init scales (the MMDiT's modulations
        and head are 0 there, so its velocity is 0 until they are trained),
        drawn from `gen` and built directly on `device` in `dtype`."""
        return cls(
            mmdit=build(lambda: MMDiT(mmdit_cfg), device, dtype, init_mmdit_weights_, gen),
            vae=build(lambda: VAEDecoder(vae_cfg), device, dtype, init_fan_in_, gen),
            text_encoder=build(lambda: CLIPTextModel(text_cfg), device, dtype,
                               init_text_weights_, gen),
            text_encoder_2=build(lambda: CLIPTextModel(text2_cfg), device, dtype,
                                 init_text_weights_, gen),
            tokenizer=tokenizer or default_tokenizer(), t5_len=t5_len,
        )


class SD3Pipeline:
    def __init__(self, modules: SD3PipelineModules, dtype=torch.bfloat16):
        self.m = modules
        self.dtype = dtype
        self.device = modules.device

    def encode_prompt(self, prompts: list[str], prompts_2: list[str] | None = None,
                      t5_embs: torch.Tensor | None = None):
        """→ (context [B, 77 + t5_len, 4096], pooled [B, 2048]) in the
        pipeline dtype (`encode_prompt`, `sd3_pipeline.py:97-138`)."""
        if prompts_2 is None:
            prompts_2 = prompts
        tok = self.m.tokenizer
        d_joint = self.m.mmdit.cfg.context_dim
        ids1 = torch.as_tensor(tok(prompts, max_length=77), dtype=torch.long, device=self.device)
        ids2 = torch.as_tensor(zero_pad_after_eos(tok(prompts_2, max_length=77),
                                                  tok.eos_token_id),
                               dtype=torch.long, device=self.device)
        o1 = self.m.text_encoder(ids1, return_hidden_states=True, return_pooled=True)
        o2 = self.m.text_encoder_2(ids2, return_hidden_states=True, return_pooled=True)
        clip_ctx = torch.cat([o1["hidden_states"][-2], o2["hidden_states"][-2]], dim=-1)
        clip_ctx = F.pad(clip_ctx, (0, d_joint - clip_ctx.shape[-1]))
        if t5_embs is None:
            t5_embs = clip_ctx.new_zeros((len(prompts), self.m.t5_len, d_joint))
        ctx = torch.cat([clip_ctx, t5_embs.to(clip_ctx.device, clip_ctx.dtype)], dim=1)
        pooled = torch.cat([o1.get("pooled_proj", o1["pooled"]),
                            o2.get("pooled_proj", o2["pooled"])], dim=-1)
        return ctx.to(self.dtype), pooled.to(self.dtype)

    @torch.inference_mode()
    def __call__(self, prompts: str | list[str], prompts_2: str | list[str] | None = None,
                 negative_prompt: str = "", num_inference_steps: int = 28,
                 guidance_scale: float = 7.0, height: int = 1024, width: int = 1024,
                 generator: torch.Generator | None = None, latents: torch.Tensor | None = None,
                 return_latents: bool = False, sigma_shift: float = 3.0,
                 t5_embs: torch.Tensor | None = None, neg_t5_embs: torch.Tensor | None = None):
        """→ images [B, 3, H, W] float32 in [0, 1] (or the final latents).
        `latents` [B, 16, H/8, W/8] replaces the initial noise from
        `generator`. A caller that hands in `t5_embs` (a real T5's) should
        hand in `neg_t5_embs` for the negative prompt too."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(prompts_2, str):
            prompts_2 = [prompts_2]
        b = len(prompts)
        if latents is None:
            s = self.m.vae.cfg.spatial_scale
            latents = torch.randn((b, self.m.mmdit.cfg.in_channels, height // s, width // s),
                                  generator=generator, device=self.device).to(self.dtype)
        cond, pooled = self.encode_prompt(prompts, prompts_2, t5_embs)
        uncond_ctx = None
        if guidance_scale > 1:
            uncond, neg_pooled = self.encode_prompt([negative_prompt] * b, t5_embs=neg_t5_embs)
            uncond_ctx = {"ctx": uncond, "pooled": neg_pooled}

        def model_fn(x, t, both):
            return self.m.mmdit(x, t, both["ctx"], both["pooled"])

        z0 = rectified_flow_sample(model_fn, latents, {"ctx": cond, "pooled": pooled},
                                   uncond_ctx, num_inference_steps=num_inference_steps,
                                   guidance_scale=guidance_scale, shift=sigma_shift)
        if return_latents:
            return z0
        img = self.m.vae(z0.to(self.dtype), self.m.latent_scale, self.m.latent_shift).float()
        return ((img + 1.0) / 2.0).clamp(0.0, 1.0)
