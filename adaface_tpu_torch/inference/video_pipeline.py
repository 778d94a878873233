"""Personalized text→video (AdaFace-Animate).

Counterpart of `adaface_tpu/inference/video_pipeline.py`: the SD1.5 UNet
with temporal motion modules (`models/motion.py`, the UNet's `motion=`),
the ada-token text encoder, the CFG DDIM loop and a chunked VAE decode.
Latents are [V·F, 4, h, w] with the frames of a video contiguous; the text
context is repeated per frame (`repeat_interleave`, JAX's `jnp.repeat(...,
axis=0)`), so classifier-free guidance batches [uncond; cond] as the image
pipeline does: a 16-frame clip is a UNet batch of 32. `to_gif` writes a
clip with `utils.image.write_gif` (numpy and the standard library; PIL in
the JAX package).

Like the JAX pipeline, the video UNet runs without the UNet's adapters, as
one UNet (no ensemble), unquantized and with DDIM only; where the modules
hold adapters or a list of UNets it raises rather than ignore them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.inference.pipeline import DiffusionPipeline, PipelineModules
from adaface_tpu_torch.models.motion import MM_SD15_V2, MotionConfig, MotionModules
from adaface_tpu_torch.ops.samplers import DDIMConfig, ddim_sample


class VideoPipeline(DiffusionPipeline):
    """DiffusionPipeline + motion modules → video clips. `motion`: the
    port's `MotionModules`, or the JAX package's tree of them
    (`init_motion_params`, `tools.convert_motion`), loaded by the bridge;
    either way it is moved to the pipeline's device and every floating
    tensor cast to `dtype` (`video_pipeline.py:39-42`)."""

    def __init__(self, modules: PipelineModules, motion, motion_cfg: MotionConfig | None = None,
                 dtype=torch.bfloat16):
        if isinstance(modules.unet, (list, tuple)):
            raise NotImplementedError("the video pipeline runs one UNet, not an ensemble")
        if modules.attn_lora is not None or modules.ffn_lora is not None:
            raise NotImplementedError("the video pipeline runs the UNet without its adapters "
                                      "(attn_lora / ffn_lora)")
        super().__init__(modules, dtype=dtype)
        if isinstance(motion, nn.Module):
            if motion_cfg is not None and motion_cfg != motion.cfg:
                raise ValueError(f"motion_cfg {motion_cfg} differs from the modules' own "
                                 f"{motion.cfg}")
        else:
            motion = bridge.load(MotionModules(modules.unet.cfg, motion_cfg or MM_SD15_V2),
                                 motion)
        self.motion = motion.to(self.device, dtype).requires_grad_(False).eval()

    @torch.inference_mode()
    def __call__(self, prompts: str | list[str], negative_prompt: str = "",  # type: ignore[override]
                 num_frames: int = 16, num_inference_steps: int = 25,
                 guidance_scale: float = 7.5, height: int = 512, width: int = 512,
                 generator: torch.Generator | None = None, latents: torch.Tensor | None = None,
                 return_latents: bool = False, decode_chunk: int = 8):
        """→ frames [V, F, 3, H, W] float32 in [0, 1] (or the final latents
        [V, F, 4, H/s, W/s]). `latents` [V·F, 4, H/s, W/s] replaces the
        initial noise drawn from `generator`; the decode takes
        `decode_chunk` frames at a time."""
        if isinstance(prompts, str):
            prompts = [prompts]
        v = len(prompts)
        if latents is None:
            s = self.m.vae.cfg.spatial_scale
            latents = torch.randn((v * num_frames, 4, height // s, width // s),
                                  generator=generator, device=self.device).to(self.dtype)
        max_len = self.m.text_encoder.position_embedding.shape[0]
        cond, uncond = self.encode_prompt(
            prompts, [negative_prompt] * v if guidance_scale > 1 else None, max_length=max_len)
        cond = cond.repeat_interleave(num_frames, dim=0)
        if uncond is not None:
            uncond = uncond.repeat_interleave(num_frames, dim=0)

        def unet(x, t, ctx):
            return self.m.unet(x, t, ctx, motion=self.motion, num_frames=num_frames)

        ddim_cfg = DDIMConfig(num_inference_steps=num_inference_steps,
                              guidance_scale=guidance_scale)
        z0 = ddim_sample(unet, self.m.schedule, latents, cond, uncond, ddim_cfg)
        if return_latents:
            return z0.reshape(v, num_frames, *z0.shape[1:])
        img = torch.cat([self.m.vae(z0[i:i + decode_chunk].to(self.dtype)).float()
                         for i in range(0, z0.shape[0], decode_chunk)])
        img = ((img + 1.0) / 2.0).clamp(0.0, 1.0)
        return img.reshape(v, num_frames, *img.shape[1:])

    def to_gif(self, video, path: str, fps: int = 8) -> str:
        """One clip [F, 3, H, W] in [0, 1] → an animated GIF at `path`."""
        from adaface_tpu_torch.utils.image import write_gif

        if isinstance(video, torch.Tensor):
            video = video.float().cpu().numpy()
        arr = (np.asarray(video) * 255).astype(np.uint8).transpose(0, 2, 3, 1)
        write_gif(path, arr, fps=fps)
        return path
