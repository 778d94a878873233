"""Diffusion noise schedule and the DDIM timestep grid.

Counterpart of `adaface_tpu/ops/schedules.py`: the beta schedules, the
DDPM tables, the per-sample schedule operations and `ddim_timesteps`. The
tables are computed in float64 numpy and kept as float32 numpy arrays: the
samplers read a handful of scalars from them per step on the host. The
per-sample operations (`q_sample`, ...) gather `t [B]` from a copy of the
table on the tensor's device, made at the first use there, in fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_beta_schedule(schedule: str = "linear", n_timestep: int = 1000,
                       linear_start: float = 0.00085, linear_end: float = 0.012,
                       cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedules of the reference; 'linear' is SD1.5's sqrt-space
    linear ("scaled_linear") schedule."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule '{schedule}'")
    return betas.astype(np.float64)


def extract(table: torch.Tensor, t: torch.Tensor, broadcast_shape) -> torch.Tensor:
    """Gather table[t] ([B]) in fp32 as [B, 1, 1, ...], to broadcast over x."""
    out = table[t].float()
    return out.reshape(out.shape[0], *((1,) * (len(broadcast_shape) - 1)))


@dataclasses.dataclass(frozen=True, eq=False)
class DiffusionSchedule:
    """DDPM schedule tables, [T] float32, as host numpy arrays."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    # (table name, device) -> the table as a tensor there
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, schedule: str = "linear", timesteps: int = 1000,
               linear_start: float = 0.00085, linear_end: float = 0.012,
               cosine_s: float = 8e-3, v_posterior: float = 0.0) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end,
                                   cosine_s)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas, axis=0)
        ac_prev = np.append(1.0, ac[:-1])
        posterior_variance = ((1 - v_posterior) * betas * (1.0 - ac_prev) / (1.0 - ac)
                              + v_posterior * betas)
        f32 = lambda a: np.asarray(a, np.float32)
        return cls(
            betas=f32(betas), alphas_cumprod=f32(ac), alphas_cumprod_prev=f32(ac_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / ac)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / ac - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)))

    def table(self, name: str, device) -> torch.Tensor:
        """The table `name` as an fp32 tensor on `device` (copied there once)."""
        key = (name, torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(getattr(self, name)).to(key[1])
        return self._on_device[key]

    def _extract(self, name: str, t, x) -> torch.Tensor:
        return extract(self.table(name, x.device), t, x.shape)

    def q_sample(self, x_start, t, noise):
        """Diffuse x_start to timestep t: sqrt(a_t) x0 + sqrt(1 - a_t) eps."""
        return (self._extract("sqrt_alphas_cumprod", t, x_start) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t, x_start) * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        """Invert q_sample: x0 = sqrt(1/a_t) x_t - sqrt(1/a_t - 1) eps."""
        return (self._extract("sqrt_recip_alphas_cumprod", t, x_t) * x_t
                - self._extract("sqrt_recipm1_alphas_cumprod", t, x_t) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        return ((self._extract("sqrt_recip_alphas_cumprod", t, x_t) * x_t - x0)
                / self._extract("sqrt_recipm1_alphas_cumprod", t, x_t))

    def q_posterior(self, x_start, x_t, t):
        """→ (mean, variance, clipped log variance) of q(x_{t-1} | x_t, x0)."""
        mean = (self._extract("posterior_mean_coef1", t, x_t) * x_start
                + self._extract("posterior_mean_coef2", t, x_t) * x_t)
        return (mean, self._extract("posterior_variance", t, x_t),
                self._extract("posterior_log_variance_clipped", t, x_t))

    def velocity(self, x_start, t, noise):
        """v-prediction target: v = sqrt(a_t) eps - sqrt(1 - a_t) x0."""
        return (self._extract("sqrt_alphas_cumprod", t, x_start) * noise
                - self._extract("sqrt_one_minus_alphas_cumprod", t, x_start) * x_start)


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   steps_offset: int = 1, spacing: str = "leading") -> np.ndarray:
    """Descending inference timesteps, diffusers-DDIMScheduler semantics."""
    if spacing == "leading":
        step_ratio = num_train_timesteps // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
        ts += steps_offset
    elif spacing == "trailing":
        step_ratio = num_train_timesteps / num_inference_steps
        ts = np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64)
        ts -= 1
    elif spacing == "uniform":
        c = num_train_timesteps // num_inference_steps
        ts = (np.asarray(list(range(0, num_train_timesteps, c))) + 1)[::-1].copy()
    else:
        raise ValueError(f"unknown timestep spacing '{spacing}'")
    return np.clip(ts.astype(np.int64), 0, num_train_timesteps - 1)
