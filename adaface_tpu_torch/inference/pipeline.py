"""Text→image diffusion pipeline (SD1.5).

Counterpart of `adaface_tpu/inference/pipeline.py`: CLIP-L prompt encoding,
the sampling loop over the SD1.5 UNet (CFG DDIM, or DPM-Solver++, PNDM or
LCM by the `scheduler` argument), VAE decode, then (img + 1) / 2 clipped to
[0, 1]. Runs on the device its modules are on; nothing moves to another
device on the way. The UNet may carry trained attention and FFN DoRA
adapters (`attn_lora`, `ffn_lora`, as `AdaFaceWrapper.load_unet_lora_weights`
loads them), and may be a list of UNets whose predictions are weighted
(`unet_weights`, the JAX package's UNet ensemble).

The three speed modes of the JAX pipeline (`:74-81`, `:131-179`,
`:199-262`): `quantize_unet` (int8 PTQ of the UNet's convolutions,
`ops/quant.py`; each member of an ensemble), `deepcache_interval` (DDIM
only: the full UNet every Nth step, the shallow one on its cached feature
between) and `tome_ratio` / `tome` (token merging, `ops/tome.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.models.clip import (CLIP_L_TEXT, CLIPTextConfig, CLIPTextModel,
                                           init_text_weights_)
from adaface_tpu_torch.models.unet import (SD15_UNET, AttnLoRA, AttnRuntime, FFNLoRA,
                                           UNet2DConditionModel, UNetConfig, init_unet_weights_)
from adaface_tpu_torch.models.vae import SD_VAE, VAEConfig, VAEDecoder, VAEEncoder
from adaface_tpu_torch.ops import quant
from adaface_tpu_torch.ops.tome import ToMeConfig
from adaface_tpu_torch.ops.samplers import (DDIMConfig, ddim_sample, dpm_solver_pp_sample,
                                            lcm_sample, pndm_sample)
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer


@dataclasses.dataclass
class PipelineModules:
    unet: UNet2DConditionModel | list[UNet2DConditionModel]  # a list for an ensemble
    vae: VAEDecoder
    text_encoder: CLIPTextModel
    tokenizer: CLIPTokenizer
    schedule: DiffusionSchedule | None = None
    vae_encoder: VAEEncoder | None = None  # img2img only
    # the ensemble's weights, normalized to sum 1; None weighs each UNet 1/n
    unet_weights: tuple | None = None
    # trained DoRA adapters of the UNet (`load_unet_lora_weights`); the FFN
    # adapters run under the name `ffn_adapter`
    attn_lora: AttnLoRA | None = None
    ffn_lora: FFNLoRA | None = None
    ffn_adapter: str = "comp_distill"

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = DiffusionSchedule.create()

    @property
    def unets(self) -> list[UNet2DConditionModel]:
        return list(self.unet) if isinstance(self.unet, (list, tuple)) else [self.unet]

    @property
    def device(self) -> torch.device:
        return self.unets[0].conv_in.weight.device

    def runtime(self) -> AttnRuntime:
        """The UNet's flags for the adapters this holds (`_unet_eps`)."""
        return AttnRuntime(use_attn_lora=self.attn_lora is not None,
                           use_ffn_lora=self.ffn_lora is not None,
                           ffn_adapter=self.ffn_adapter if self.ffn_lora is not None else None)

    def unet_eps(self, x, t, ctx, tome: ToMeConfig | None = None, deepcache=None):
        """The UNet's prediction with the adapters (`_unet_eps`,
        `adaface_tpu/inference/pipeline.py:110-128`); for a list of UNets
        Σ wᵢ·epsᵢ in fp32, w normalized to sum 1. `tome` and `deepcache` go
        to the UNet's call (with "collect" it returns (eps, cache)); an
        ensemble takes no `deepcache`."""
        kw = dict(rt=self.runtime(), attn_lora=self.attn_lora, ffn_lora=self.ffn_lora,
                  tome=tome)
        if not isinstance(self.unet, (list, tuple)):
            return self.unet(x, t, ctx, deepcache=deepcache, **kw)
        if deepcache is not None:
            raise ValueError("deepcache is not supported with UNet ensembles")
        n = len(self.unet)
        w = torch.tensor(self.unet_weights or [1.0 / n] * n, dtype=torch.float32)
        if len(w) != n:
            raise ValueError(f"unet_weights has {len(w)} weights for {n} UNets")
        w = (w / w.sum()).tolist()
        return sum(wi * unet(x, t, ctx, **kw).float() for wi, unet in zip(w, self.unet))

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
    def __init__(self, modules: PipelineModules, dtype=torch.bfloat16,
                 quantize_unet: bool = False):
        """quantize_unet: serve int8 PTQ UNets (`ops.quant.quantize_unet`,
        convolutions only, each member of an ensemble); the caller's
        `modules` keep their UNets."""
        if quantize_unet:
            unets = [quant.quantize_unet(u) for u in modules.unets]
            modules = dataclasses.replace(
                modules, unet=unets if isinstance(modules.unet, (list, tuple)) else unets[0])
        self.m = modules
        self.dtype = dtype
        self.device = modules.device

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
                 noise: torch.Tensor | None = None, deepcache_interval: int = 0,
                 tome_ratio: float = 0.0, tome: ToMeConfig | None = None):
        """→ images [B, 3, H, W] float32 in [0, 1] (or the final latents).
        `latents` [B, 4, H/s, W/s] replaces the initial noise from `generator`.
        `scheduler`: "ddim" (with `eta`), "dpm++", "pndm" or "lcm" (no CFG).
        The samplers that draw inside their loop (DDIM at eta > 0, LCM) draw
        from `generator`, or take `noise` [draws, B, 4, H/s, W/s].

        `deepcache_interval` > 1: DDIM runs the full UNet every Nth step and
        the shallow one between (an ensemble raises); dpm++, pndm and lcm
        ignore it, as the JAX pipeline does. `tome_ratio` > 0: ToMe at that
        ratio with the other defaults of `ToMeConfig`; `tome` (a whole
        config) overrides it. Every scheduler takes ToMe."""
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
        if tome is None and tome_ratio > 0.0:
            tome = ToMeConfig(ratio=tome_ratio)
        schedule = self.m.schedule

        def unet(x, t, ctx):
            return self.m.unet_eps(x, t, ctx, tome=tome)

        if scheduler == "ddim":
            ddim_cfg = DDIMConfig(num_inference_steps=num_inference_steps, eta=eta,
                                  guidance_scale=guidance_scale,
                                  guidance_scale_min=guidance_scale_min)
            dc = None
            if deepcache_interval > 1:  # an ensemble raises in `unet_eps`

                def full(x, t, ctx):
                    return self.m.unet_eps(x, t, ctx, tome=tome, deepcache="collect")

                def shallow(x, t, ctx, cache):
                    return self.m.unet_eps(x, t, ctx, tome=tome, deepcache=("shallow", cache))

                dc = (deepcache_interval, full, shallow, None)
            z0 = ddim_sample(unet, schedule, latents, cond, uncond, ddim_cfg,
                             generator=generator, noise=noise, deepcache=dc)
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
