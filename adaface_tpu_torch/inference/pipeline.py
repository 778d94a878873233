"""Text→image diffusion pipeline (SD1.5).

Counterpart of `adaface_tpu/inference/pipeline.py`: CLIP-L prompt encoding,
the sampling loop over the SD1.5 UNet (CFG DDIM, or DPM-Solver++, PNDM or
LCM by the `scheduler` argument), VAE decode, then (img + 1) / 2 clipped to
[0, 1]. Runs on the device its modules are on; nothing moves to another
device on the way. LoRA, UNet ensembles, DeepCache, ToMe and int8 are not
ported.
"""

from __future__ import annotations

import dataclasses

import torch

from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.models.clip import (CLIP_L_TEXT, CLIPTextConfig, CLIPTextModel,
                                           init_text_weights_)
from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel, UNetConfig,
                                           init_unet_weights_)
from adaface_tpu_torch.models.vae import SD_VAE, VAEConfig, VAEDecoder, VAEEncoder
from adaface_tpu_torch.ops.samplers import (DDIMConfig, ddim_sample, dpm_solver_pp_sample,
                                            lcm_sample, pndm_sample)
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer


@dataclasses.dataclass
class PipelineModules:
    unet: UNet2DConditionModel
    vae: VAEDecoder
    text_encoder: CLIPTextModel
    tokenizer: CLIPTokenizer
    schedule: DiffusionSchedule | None = None
    vae_encoder: VAEEncoder | None = None  # img2img only

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = DiffusionSchedule.create()

    @classmethod
    def random_init(cls, gen: torch.Generator, device, dtype=torch.bfloat16,
                    unet_cfg: UNetConfig = SD15_UNET, vae_cfg: VAEConfig = SD_VAE,
                    text_cfg: CLIPTextConfig = CLIP_L_TEXT,
                    tokenizer: CLIPTokenizer | None = None):
        """Random weights at the JAX init scales, drawn from `gen` and built
        directly on `device` in `dtype`; the VAE encoder last, so that a
        seed gives the other modules the weights it gave them without it."""
        return cls(
            unet=build(lambda: UNet2DConditionModel(unet_cfg), device, dtype,
                       init_unet_weights_, gen),
            vae=build(lambda: VAEDecoder(vae_cfg), device, dtype, init_fan_in_, gen),
            text_encoder=build(lambda: CLIPTextModel(text_cfg), device, dtype,
                               init_text_weights_, gen),
            tokenizer=tokenizer or default_tokenizer(),
            vae_encoder=build(lambda: VAEEncoder(vae_cfg), device, dtype, init_fan_in_, gen),
        )


class DiffusionPipeline:
    def __init__(self, modules: PipelineModules, dtype=torch.bfloat16):
        self.m = modules
        self.dtype = dtype
        self.device = modules.unet.conv_in.weight.device

    def encode_prompt(self, prompts: list[str], negative_prompts: list[str] | None = None,
                      max_length: int = 77):
        """→ (cond [B, S, D], uncond [B, S, D] | None) in the pipeline dtype."""
        def encode(texts):
            ids = torch.as_tensor(self.m.tokenizer(texts, max_length=max_length),
                                  dtype=torch.long, device=self.device)
            return self.m.text_encoder(ids).to(self.dtype)

        cond = encode(prompts)
        uncond = encode(negative_prompts) if negative_prompts is not None else None
        return cond, uncond

    @torch.inference_mode()
    def __call__(self, prompts: str | list[str], negative_prompt: str = "",
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 guidance_scale_min: float | None = None, height: int = 512,
                 width: int = 512, generator: torch.Generator | None = None,
                 latents: torch.Tensor | None = None, return_latents: bool = False,
                 scheduler: str = "ddim", eta: float = 0.0,
                 noise: torch.Tensor | None = None):
        """→ images [B, 3, H, W] float32 in [0, 1] (or the final latents).
        `latents` [B, 4, H/s, W/s] replaces the initial noise from `generator`.
        `scheduler`: "ddim" (with `eta`), "dpm++", "pndm" or "lcm" (no CFG).
        The samplers that draw inside their loop (DDIM at eta > 0, LCM) draw
        from `generator`, or take `noise` [draws, B, 4, H/s, W/s]."""
        if isinstance(prompts, str):
            prompts = [prompts]
        b = len(prompts)
        if latents is None:
            s = self.m.vae.cfg.spatial_scale
            latents = torch.randn((b, 4, height // s, width // s), generator=generator,
                                  device=self.device).to(self.dtype)
        max_len = self.m.text_encoder.position_embedding.shape[0]
        cond, uncond = self.encode_prompt(
            prompts, [negative_prompt] * b if guidance_scale > 1 else None,
            max_length=max_len)
        unet, schedule = self.m.unet, self.m.schedule
        if scheduler == "ddim":
            ddim_cfg = DDIMConfig(num_inference_steps=num_inference_steps, eta=eta,
                                  guidance_scale=guidance_scale,
                                  guidance_scale_min=guidance_scale_min)
            z0 = ddim_sample(unet, schedule, latents, cond, uncond, ddim_cfg,
                             generator=generator, noise=noise)
        elif scheduler == "dpm++":
            z0 = dpm_solver_pp_sample(unet, schedule, latents, cond, uncond,
                                      num_inference_steps=num_inference_steps,
                                      guidance_scale=guidance_scale)
        elif scheduler == "pndm":
            z0 = pndm_sample(unet, schedule, latents, cond, uncond,
                             num_inference_steps=num_inference_steps,
                             guidance_scale=guidance_scale)
        elif scheduler == "lcm":
            z0 = lcm_sample(unet, schedule, latents, cond,
                            num_inference_steps=num_inference_steps, generator=generator,
                            noise=noise)
        else:
            raise ValueError(f"unknown scheduler {scheduler!r}: ddim, dpm++, pndm or lcm")
        if return_latents:
            return z0
        img = self.m.vae(z0.to(self.dtype)).float()
        return ((img + 1.0) / 2.0).clamp(0.0, 1.0)
