"""Diffusion noise schedule and the DDIM timestep grid.

Counterpart of `adaface_tpu/ops/schedules.py`, as far as DDIM sampling
needs it: the beta schedules, the cumulative alphas, and `ddim_timesteps`.
The tables are computed in float64 numpy and kept as float32 numpy arrays:
the sampler reads a handful of scalars from them per step on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM schedule tables, [T] float32."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, schedule: str = "linear", timesteps: int = 1000,
               linear_start: float = 0.00085, linear_end: float = 0.012,
               cosine_s: float = 8e-3) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end,
                                   cosine_s)
        return cls(betas=betas.astype(np.float32),
                   alphas_cumprod=np.cumprod(1.0 - betas).astype(np.float32))


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
