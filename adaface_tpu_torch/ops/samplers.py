"""DDIM sampling with classifier-free guidance.

Counterpart of the DDIM part of `adaface_tpu/ops/samplers.py` (`:31-172`).
The JAX `lax.scan` over steps is a Python loop here; the per-step scalars
(alphas, guidance scale) are float32 numbers computed on the host, so a
step issues only the UNet call and a few elementwise ops. CFG batches
[uncond; cond] into one model call per step, and x is cast back to x_T's
dtype after each update, as in the JAX loop. Deterministic DDIM only
(eta = 0, the JAX default and the only value the serving path uses).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from adaface_tpu_torch.ops.schedules import DiffusionSchedule, ddim_timesteps

# model_fn(x [B,C,H,W], t [B] int64, ctx) -> eps prediction
ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_inference_steps: int = 50
    # dual guidance: linear from guidance_scale (first step) to
    # guidance_scale_min (last step)
    guidance_scale: float = 6.0
    guidance_scale_min: float | None = None
    spacing: str = "leading"
    steps_offset: int = 1
    set_alpha_to_one: bool = False


def _alpha_tables(schedule: DiffusionSchedule, cfg: DDIMConfig):
    """→ (timesteps int64, alpha_t float32, alpha_prev float32), each [n]."""
    ts = ddim_timesteps(schedule.num_timesteps, cfg.num_inference_steps,
                        steps_offset=cfg.steps_offset, spacing=cfg.spacing)
    ac = schedule.alphas_cumprod
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(ac[0])
    prev_ts = ts - schedule.num_timesteps // cfg.num_inference_steps
    alpha_prev = np.where(prev_ts >= 0, ac[np.clip(prev_ts, 0, None)], final_alpha)
    return ts, ac[ts].astype(np.float32), alpha_prev.astype(np.float32)


def guidance_scales(cfg: DDIMConfig) -> np.ndarray:
    hi = cfg.guidance_scale
    lo = cfg.guidance_scale_min if cfg.guidance_scale_min is not None else hi
    return np.linspace(hi, lo, cfg.num_inference_steps, dtype=np.float32)


def ddim_step(x, eps, alpha_t: np.float32, alpha_prev: np.float32):
    """One deterministic DDIM update x_t → x_{t_prev} in fp32; the scalar
    coefficients in float32, as the JAX step computes them."""
    one = np.float32(1.0)
    x = x.float()
    eps = eps.float()
    pred_x0 = (x - float(np.sqrt(one - alpha_t)) * eps) / float(np.sqrt(alpha_t))
    dir_xt = float(np.sqrt(np.maximum(one - alpha_prev, np.float32(0)))) * eps
    return float(np.sqrt(alpha_prev)) * pred_x0 + dir_xt


def ddim_sample(model_fn: ModelFn, schedule: DiffusionSchedule, x_T, cond_ctx,
                uncond_ctx=None, cfg: DDIMConfig = DDIMConfig()):
    """The DDIM loop; with uncond_ctx, CFG over [uncond; cond] per step."""
    ts, alpha_t, alpha_prev = _alpha_tables(schedule, cfg)
    scales = guidance_scales(cfg)
    b = x_T.shape[0]
    use_cfg = uncond_ctx is not None
    ctx = torch.cat([uncond_ctx, cond_ctx], dim=0) if use_cfg else cond_ctx
    x = x_T
    for i in range(len(ts)):
        tb = torch.full((2 * b if use_cfg else b,), int(ts[i]), dtype=torch.long,
                        device=x.device)
        x2 = torch.cat([x, x], dim=0) if use_cfg else x
        eps2 = model_fn(x2, tb, ctx).float()
        if use_cfg:
            eps_u, eps_c = eps2.chunk(2, dim=0)
            eps = eps_u + float(scales[i]) * (eps_c - eps_u)
        else:
            eps = eps2
        x = ddim_step(x, eps, alpha_t[i], alpha_prev[i]).to(x_T.dtype)
    return x
