"""Samplers: DDIM with classifier-free guidance, DPM-Solver++(2M), PNDM,
LCM, Euler, rectified flow, and the training-time multistep denoiser.

Counterpart of `adaface_tpu/ops/samplers.py`. The JAX `lax.scan` loops are
Python loops here; the per-step scalars (alphas, sigmas, guidance scale)
are numbers computed on the host, in float32 where the JAX loop computes
them on fp32 arrays and in float64 where it uses numpy, so a step launches
only the model call and a few elementwise ops. CFG batches [uncond; cond]
into one model call per step, and the state is cast as in the JAX loops.
`ddim_sample` takes the JAX function's `deepcache` (encoder caching: the full
UNet every `interval`-th step, the shallow one on its cached feature between).

Where the JAX function draws noise from a key inside its loop (`ddim_sample`
at eta > 0, `lcm_sample`), the function here draws from a `torch.Generator`,
or takes the draws as a tensor (`noise`), one slice per draw.
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
    eta: float = 0.0
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


def ddim_step(x, eps, alpha_t, alpha_prev, eta: float = 0.0, noise=None):
    """One DDIM update x_t → x_{t_prev} in fp32 → (x_prev, pred_x0).

    alpha_t, alpha_prev: float32 host scalars (one value for the batch: the
    coefficients are then float32 numbers, as the JAX step computes them),
    or fp32 tensors that broadcast over x (a value per sample, on x's
    device: the coefficients are computed there). `noise` is added, scaled
    by sigma, when eta > 0."""
    x = x.float()
    eps = eps.float()
    if isinstance(alpha_t, torch.Tensor):
        a_t, a_p = alpha_t.float(), alpha_prev.float()
        sigma = eta * torch.sqrt((1 - a_p) / (1 - a_t) * (1 - a_t / a_p))
        c_eps, c_x, c_dir, c_x0 = (torch.sqrt(1 - a_t), torch.sqrt(a_t),
                                   torch.sqrt((1 - a_p - sigma**2).clamp_min(0)),
                                   torch.sqrt(a_p))
    else:
        one, a_t, a_p = np.float32(1), np.float32(alpha_t), np.float32(alpha_prev)
        sigma = np.float32(eta) * np.sqrt((one - a_p) / (one - a_t) * (one - a_t / a_p))
        c_eps, c_x, c_dir, c_x0, sigma = (float(c) for c in (
            np.sqrt(one - a_t), np.sqrt(a_t),
            np.sqrt(np.maximum(one - a_p - sigma**2, np.float32(0))), np.sqrt(a_p), sigma))
    pred_x0 = (x - c_eps * eps) / c_x
    x_prev = c_x0 * pred_x0 + c_dir * eps
    if eta > 0 and noise is not None:
        x_prev = x_prev + sigma * noise
    return x_prev, pred_x0


def _cfg_model(model_fn: ModelFn, cond_ctx, uncond_ctx, batch: int, device):
    """→ eps(x, t, scale): the model's fp32 prediction for one timestep `t`
    (a host number) of the whole batch; with uncond_ctx, CFG over
    [uncond; cond] in one model call, mixed with weight `scale`."""
    use_cfg = uncond_ctx is not None
    ctx = torch.cat([uncond_ctx, cond_ctx], dim=0) if use_cfg else cond_ctx

    def eps(x, t, scale: float, dtype=torch.long):
        tb = torch.full((2 * batch if use_cfg else batch,), t, dtype=dtype, device=device)
        if not use_cfg:
            return model_fn(x, tb, ctx).float()
        eps_u, eps_c = model_fn(torch.cat([x, x], dim=0), tb, ctx).float().chunk(2, dim=0)
        return eps_u + scale * (eps_c - eps_u)

    return eps


def _draws(noise, n: int, shape, generator, device):
    """The n fp32 draws of a loop, [n, *shape]: `noise` if handed in, else
    from `generator` on `device`."""
    if noise is not None:
        if tuple(noise.shape) != (n, *shape):
            raise ValueError(f"noise must be {(n, *shape)}, got {tuple(noise.shape)}")
        return noise.to(device, torch.float32)
    return torch.randn((n, *shape), generator=generator, device=device)


def ddim_sample(model_fn: ModelFn, schedule: DiffusionSchedule, x_T, cond_ctx,
                uncond_ctx=None, cfg: DDIMConfig = DDIMConfig(),
                generator: torch.Generator | None = None, noise=None,
                deepcache: tuple | None = None):
    """The DDIM loop; with uncond_ctx, CFG over [uncond; cond] per step.
    At eta > 0 each step adds sigma · (a draw from `generator`, or
    `noise[i]` of `noise` [n, *x_T.shape]).

    deepcache = (interval, full_fn, shallow_fn, init_cache), as in JAX
    (`samplers.py:102-168`): at interval > 1, step i runs
    `full_fn(x, t, ctx) -> (eps, cache)` where i % interval == 0 and
    `shallow_fn(x, t, ctx, cache) -> eps` on the last cache otherwise. Step 0
    is always full, so `init_cache` is never read (None will do); the
    argument keeps the JAX call's shape."""
    ts, alpha_t, alpha_prev = _alpha_tables(schedule, cfg)
    scales = guidance_scales(cfg)
    step = 0
    if deepcache is not None and deepcache[0] > 1:
        interval, full_fn, shallow_fn, cache = deepcache

        def model_fn(x, t, ctx):  # noqa: F811 (the cached UNet for step `step`)
            nonlocal cache
            if step % interval == 0:
                eps, cache = full_fn(x, t, ctx)
                return eps
            return shallow_fn(x, t, ctx, cache)

    eps_fn = _cfg_model(model_fn, cond_ctx, uncond_ctx, x_T.shape[0], x_T.device)
    if cfg.eta > 0:
        noise = _draws(noise, len(ts), x_T.shape, generator, x_T.device)
    x = x_T
    for step in range(len(ts)):
        eps = eps_fn(x, int(ts[step]), float(scales[step]))
        x_prev, _ = ddim_step(x, eps, alpha_t[step], alpha_prev[step], cfg.eta,
                              noise[step] if cfg.eta > 0 else None)
        x = x_prev.to(x_T.dtype)
    return x


def multistep_denoise(model_fn: ModelFn, schedule: DiffusionSchedule, x_start, noises,
                      timesteps):
    """Training-time multi-step denoising: at step s the current x_start
    estimate is re-noised at timesteps[s] [B] with noises[s] and denoised;
    the eps prediction rolls the estimate forward.
    → stacked (noise_preds, x_starts, x_ts), each [S, ...]."""
    x0 = x_start
    noise_preds, x_starts, x_ts = [], [], []
    for noise, t in zip(noises, timesteps):
        x_t = schedule.q_sample(x0, t, noise)
        eps = model_fn(x_t, t, None)
        x0 = schedule.predict_start_from_noise(x_t, t, eps)
        noise_preds.append(eps)
        x_starts.append(x0)
        x_ts.append(x_t)
    return torch.stack(noise_preds), torch.stack(x_starts), torch.stack(x_ts)


def dpm_solver_pp_sample(model_fn: ModelFn, schedule: DiffusionSchedule, x_T, cond_ctx,
                         uncond_ctx=None, num_inference_steps: int = 25,
                         guidance_scale: float = 6.0):
    """DPM-Solver++(2M) multistep: data-prediction form with log-SNR
    interpolation, second-order from the second step on. fp32 state, float64
    host coefficients."""
    ts = ddim_timesteps(schedule.num_timesteps, num_inference_steps)
    ac = schedule.alphas_cumprod
    alpha = np.sqrt(ac[ts])
    sigma = np.sqrt(1.0 - ac[ts])
    lam = np.log(alpha / sigma)
    # the final (t = 0) point: alpha 1, sigma ~0
    alpha = np.append(alpha, 1.0)
    sigma = np.append(sigma, 1e-3)
    lam = np.append(lam, np.log(alpha[-1] / sigma[-1]))
    eps_fn = _cfg_model(model_fn, cond_ctx, uncond_ctx, x_T.shape[0], x_T.device)

    x = x_T.float()
    d_prev = None
    for i in range(num_inference_steps):
        eps = eps_fn(x.to(x_T.dtype), int(ts[i]), guidance_scale)
        d_cur = (x - float(sigma[i]) * eps) / float(alpha[i])  # data prediction x0
        h = lam[i + 1] - lam[i]
        if d_prev is None:
            d = d_cur
        else:
            r = (lam[i] - lam[i - 1]) / h
            d = float(1 + 1 / (2 * r)) * d_cur - float(1 / (2 * r)) * d_prev
        x = float(sigma[i + 1] / sigma[i]) * x - float(alpha[i + 1]) * float(np.expm1(-h)) * d
        d_prev = d_cur
    return x.to(x_T.dtype)


def pndm_sample(model_fn: ModelFn, schedule: DiffusionSchedule, x_T, cond_ctx,
                uncond_ctx=None, num_inference_steps: int = 50,
                guidance_scale: float = 6.0):
    """PNDM (pseudo linear multistep): 4th-order Adams-Bashforth on the eps
    history after a DDIM-stepped warm-up (no Runge-Kutta phase, as diffusers
    with `skip_prk_steps=True`). fp32 state, float32 host coefficients."""
    ts = ddim_timesteps(schedule.num_timesteps, num_inference_steps)
    ac = schedule.alphas_cumprod
    step_gap = schedule.num_timesteps // num_inference_steps
    eps_fn = _cfg_model(model_fn, cond_ctx, uncond_ctx, x_T.shape[0], x_T.device)
    one = np.float32(1)

    def transfer(x, t, t_prev, eps):
        a_t = ac[max(t, 0)]
        a_p = ac[max(t_prev, 0)] if t_prev >= 0 else one
        x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        return float(np.sqrt(a_p)) * x0 + float(np.sqrt(one - a_p)) * eps

    x = x_T.float()
    history = []
    for i in range(num_inference_steps):
        t = int(ts[i])
        eps = eps_fn(x.to(x_T.dtype), t, guidance_scale)
        history.append(eps)
        if len(history) == 1:
            eps_used = eps
        elif len(history) == 2:
            eps_used = (3 * history[-1] - history[-2]) / 2
        elif len(history) == 3:
            eps_used = (23 * history[-1] - 16 * history[-2] + 5 * history[-3]) / 12
        else:
            eps_used = (55 * history[-1] - 59 * history[-2] + 37 * history[-3]
                        - 9 * history[-4]) / 24
            history.pop(0)
        x = transfer(x, t, t - step_gap, eps_used)
    return x.to(x_T.dtype)


def lcm_sample(model_fn: ModelFn, schedule: DiffusionSchedule, x_T, cond_ctx,
               num_inference_steps: int = 4, generator: torch.Generator | None = None,
               original_inference_steps: int = 50, noise=None):
    """LCM few-step sampler: consistency x0 prediction with the boundary
    condition's skip/out scalings, re-noised between steps with a draw from
    `generator` (or `noise[i]` of `noise` [n - 1, *x_T.shape]). No CFG: LCM
    distils guidance into the model."""
    k = schedule.num_timesteps // original_inference_steps
    lcm_origin = np.arange(1, original_inference_steps + 1) * k - 1
    idx = np.linspace(0, len(lcm_origin) - 1, num_inference_steps)
    ts = lcm_origin[::-1][idx.astype(int)]
    ac = schedule.alphas_cumprod
    one = np.float32(1)
    sigma_data = 0.5
    eps_fn = _cfg_model(model_fn, cond_ctx, None, x_T.shape[0], x_T.device)
    noise = _draws(noise, len(ts) - 1, x_T.shape, generator, x_T.device)

    x = x_T.float()
    for i, t in enumerate(ts):
        eps = eps_fn(x.to(x_T.dtype), int(t), 1.0)
        a_t = ac[int(t)]
        x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
        t_scaled = float(t) / 10.0  # timestep scaling 10, then / 0.1
        c_skip = sigma_data**2 / ((t_scaled / 10) ** 2 + sigma_data**2)
        c_out = (t_scaled / 10) / np.sqrt((t_scaled / 10) ** 2 + sigma_data**2)
        denoised = c_skip * x + float(c_out) * x0
        if i < len(ts) - 1:
            a_next = ac[int(ts[i + 1])]
            x = float(np.sqrt(a_next)) * denoised + float(np.sqrt(one - a_next)) * noise[i]
        else:
            x = denoised
    return x.to(x_T.dtype)


def euler_sample(model_fn: ModelFn, schedule: DiffusionSchedule, x_T, cond_ctx,
                 uncond_ctx=None, cfg: DDIMConfig = DDIMConfig()):
    """Euler discrete sampler, eps-prediction: sigma_i = sqrt((1 - a) / a),
    x_{i+1} = x_i + eps · (sigma_{i+1} - sigma_i), the model's input scaled
    by 1 / sqrt(sigma² + 1) and x_T by sqrt(sigma_max² + 1); dual-scale CFG
    as `guidance_scales`."""
    ts = ddim_timesteps(schedule.num_timesteps, cfg.num_inference_steps,
                        steps_offset=cfg.steps_offset, spacing=cfg.spacing)
    ac = schedule.alphas_cumprod
    sigmas = np.sqrt((1.0 - ac[ts]) / ac[ts]).astype(np.float32)  # descending with the loop
    sigma_next = np.append(sigmas[1:], np.float32(0))
    scales = guidance_scales(cfg)
    eps_fn = _cfg_model(model_fn, cond_ctx, uncond_ctx, x_T.shape[0], x_T.device)
    one = np.float32(1)

    x = x_T.float() * float(np.sqrt(sigmas[0] ** 2 + one))
    for i in range(len(ts)):
        x_in = (x / float(np.sqrt(sigmas[i] ** 2 + one))).to(x_T.dtype)
        eps = eps_fn(x_in, int(ts[i]), float(scales[i]))
        x = x + eps * float(sigma_next[i] - sigmas[i])
    return x.to(x_T.dtype)


def rectified_flow_sample(model_fn: ModelFn, x_T, cond_ctx, uncond_ctx=None,
                          num_inference_steps: int = 28, guidance_scale: float = 7.0,
                          shift: float = 3.0):
    """Flow-matching Euler sampler: the model predicts the velocity v on
    x_sigma = (1 - sigma) x0 + sigma eps and is fed sigma · 1000 as a float
    timestep; sigma follows the resolution shift s·u / (1 + (s - 1)·u),
    applied to the train grid's endpoints and again to the inference grid
    between them (so sigma_min is ~0.009 at shift 3, not 1 / n). One step:
    x ← x + v · (sigma_next - sigma)."""
    n_train = 1000
    sig_min_t = shift * (1.0 / n_train) / (1.0 + (shift - 1.0) * (1.0 / n_train))
    u = np.linspace(1.0, sig_min_t, num_inference_steps)
    sigmas = (shift * u / (1.0 + (shift - 1.0) * u)).astype(np.float32)
    sigma_next = np.append(sigmas[1:], np.float32(0))
    v_fn = _cfg_model(model_fn, cond_ctx, uncond_ctx, x_T.shape[0], x_T.device)

    x = x_T.float()
    for sig, sig_next in zip(sigmas, sigma_next):
        v = v_fn(x.to(x_T.dtype), float(sig * np.float32(1000.0)), guidance_scale,
                 dtype=torch.float32)
        x = x + v * float(sig_next - sig)
    return x.to(x_T.dtype)
