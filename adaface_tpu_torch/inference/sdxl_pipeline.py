"""Text→image SDXL pipeline.

Counterpart of `adaface_tpu/inference/sdxl_pipeline.py` (the reference's
"text2imgxl" branch): two CLIP text towers, CLIP-L and OpenCLIP bigG, whose
penultimate hidden states (no final LN) concatenate into the UNet's 2048-d
context; bigG's projected eos pooling as the added text embedding; the
micro-conditioning time ids (h, w, 0, 0, h, w); the Euler sampler by default
(DDIM on request); the VAE at SDXL's latent scale 0.13025. Runs on the device
its modules are on.

Ada placeholders live only in encoder 1 (CLIP-L, extended by the wrapper);
encoder 2 reads `prompts_2`, the plain prompt, through the bigG tokenizer's
ids: the same BPE, 0-padded after the first eos (`zero_pad_after_eos`).
"""

from __future__ import annotations

import dataclasses

import torch

from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.models.clip import (CLIP_BIGG_TEXT, CLIP_L_TEXT, CLIPTextConfig,
                                           CLIPTextModel, init_text_weights_)
from adaface_tpu_torch.models.unet import (SDXL_UNET, UNet2DConditionModel, UNetConfig,
                                           init_unet_weights_)
from adaface_tpu_torch.models.vae import SD_VAE, VAEConfig, VAEDecoder
from adaface_tpu_torch.ops.samplers import DDIMConfig, ddim_sample, euler_sample
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer, zero_pad_after_eos

SDXL_LATENT_SCALE = 0.13025  # the SDXL VAE's scaling_factor


@dataclasses.dataclass
class SDXLPipelineModules:
    unet: UNet2DConditionModel
    vae: VAEDecoder
    text_encoder: CLIPTextModel  # CLIP-L, extended with the placeholder tokens
    text_encoder_2: CLIPTextModel  # OpenCLIP bigG with its text projection
    tokenizer: CLIPTokenizer
    schedule: DiffusionSchedule | None = None
    latent_scale: float = SDXL_LATENT_SCALE
    # SDXL-base: an empty negative prompt conditions on zeros, not on the
    # encoded "" (force_zeros_for_empty_prompt in its model config)
    force_zeros_for_empty_prompt: bool = True

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = DiffusionSchedule.create()

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @classmethod
    def random_init(cls, gen: torch.Generator, device, dtype=torch.bfloat16,
                    unet_cfg: UNetConfig = SDXL_UNET, vae_cfg: VAEConfig = SD_VAE,
                    text_cfg: CLIPTextConfig = CLIP_L_TEXT,
                    text2_cfg: CLIPTextConfig = CLIP_BIGG_TEXT,
                    tokenizer: CLIPTokenizer | None = None):
        """Random weights at the JAX init scales, drawn from `gen` and built
        directly on `device` in `dtype`."""
        return cls(
            unet=build(lambda: UNet2DConditionModel(unet_cfg), device, dtype,
                       init_unet_weights_, gen),
            vae=build(lambda: VAEDecoder(vae_cfg), device, dtype, init_fan_in_, gen),
            text_encoder=build(lambda: CLIPTextModel(text_cfg), device, dtype,
                               init_text_weights_, gen),
            text_encoder_2=build(lambda: CLIPTextModel(text2_cfg), device, dtype,
                                 init_text_weights_, gen),
            tokenizer=tokenizer or default_tokenizer(),
        )


class SDXLPipeline:
    def __init__(self, modules: SDXLPipelineModules, dtype=torch.bfloat16):
        self.m = modules
        self.dtype = dtype
        self.device = modules.device

    def _ids(self, prompts: list[str], zero_pad: bool = False) -> torch.Tensor:
        ids = self.m.tokenizer(prompts, max_length=77)
        if zero_pad:  # tokenizer_2's ids (`_ids2`, `sdxl_pipeline.py:95-103`)
            ids = zero_pad_after_eos(ids, self.m.tokenizer.eos_token_id)
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _encode_one(self, prompts: list[str], prompts_2: list[str]):
        """→ (context [B, 77, 768 + 1280], pooled [B, 1280]) in the pipeline
        dtype (`_encode_one`, `sdxl_pipeline.py:105-120`)."""
        h1 = self.m.text_encoder(self._ids(prompts), return_hidden_states=True)
        out2 = self.m.text_encoder_2(self._ids(prompts_2, zero_pad=True),
                                     return_hidden_states=True, return_pooled=True)
        ctx = torch.cat([h1["hidden_states"][-2], out2["hidden_states"][-2]], dim=-1)
        return ctx.to(self.dtype), out2["pooled_proj"].to(self.dtype)

    def encode_prompt(self, prompts: list[str], prompts_2: list[str] | None = None,
                      negative_prompts: list[str] | None = None):
        """→ (cond context, pooled, uncond context or None, negative pooled or
        None); all-empty negatives are zeros under
        `force_zeros_for_empty_prompt`."""
        if prompts_2 is None:
            prompts_2 = prompts
        cond, pooled = self._encode_one(prompts, prompts_2)
        uncond = neg_pooled = None
        if negative_prompts is not None:
            if self.m.force_zeros_for_empty_prompt and all(p == "" for p in negative_prompts):
                uncond, neg_pooled = torch.zeros_like(cond), torch.zeros_like(pooled)
            else:
                uncond, neg_pooled = self._encode_one(negative_prompts, negative_prompts)
        return cond, pooled, uncond, neg_pooled

    @torch.inference_mode()
    def __call__(self, prompts: str | list[str], prompts_2: str | list[str] | None = None,
                 negative_prompt: str = "", num_inference_steps: int = 25,
                 guidance_scale: float = 5.0, height: int = 1024, width: int = 1024,
                 generator: torch.Generator | None = None, latents: torch.Tensor | None = None,
                 return_latents: bool = False, scheduler: str = "euler"):
        """→ images [B, 3, H, W] float32 in [0, 1] (or the final latents).
        `latents` [B, 4, H/8, W/8] replaces the initial noise from
        `generator`. `scheduler`: "euler" (SDXL's default) or "ddim"."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if isinstance(prompts_2, str):
            prompts_2 = [prompts_2]
        b = len(prompts)
        if latents is None:
            s = self.m.vae.cfg.spatial_scale
            latents = torch.randn((b, 4, height // s, width // s), generator=generator,
                                  device=self.device).to(self.dtype)
        cond, pooled, uncond, neg_pooled = self.encode_prompt(
            prompts, prompts_2, [negative_prompt] * b if guidance_scale > 1 else None)
        # micro-conditioning (orig h, w, crop top, left, target h, w): the
        # output size, no crop
        time_ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                                device=self.device)

        def model_fn(x, t, both):
            added = {"text_embeds": both["pooled"],
                     "time_ids": time_ids.expand(x.shape[0], -1)}
            return self.m.unet(x, t, both["ctx"], added_cond=added)

        cond_ctx = {"ctx": cond, "pooled": pooled}
        uncond_ctx = None if uncond is None else {"ctx": uncond, "pooled": neg_pooled}
        cfg = DDIMConfig(num_inference_steps=num_inference_steps, guidance_scale=guidance_scale)
        if scheduler == "euler":
            z0 = euler_sample(model_fn, self.m.schedule, latents, cond_ctx, uncond_ctx, cfg)
        elif scheduler == "ddim":
            z0 = ddim_sample(model_fn, self.m.schedule, latents, cond_ctx, uncond_ctx, cfg)
        else:
            raise ValueError(f"unknown scheduler {scheduler!r}: euler or ddim")
        if return_latents:
            return z0
        img = self.m.vae(z0.to(self.dtype), self.m.latent_scale).float()
        return ((img + 1.0) / 2.0).clamp(0.0, 1.0)
