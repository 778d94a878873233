"""Frozen UNet teachers for stage-1 distillation.

Counterpart of `adaface_tpu/id2ada/teachers.py`: a teacher denoises for up
to 10 steps with the student's noise schedule, with a CFG scale planned on
the host, and samples each next timestep inside [t·0.5^k, t·0.7^k] of the
current one (k = (steps − 1)^-0.3). It runs under `torch.no_grad()` in the
UNet's own dtype (bf16 on the card) and returns fp32. A list of UNets is an
ensemble: the weighted mean of their predictions. Draws go through
`utils.tensor.Draws`, two a step in the JAX package's order (the relative
position of the next timestep, [B] uniforms, then the next noise).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.utils.tensor import Draws


@dataclasses.dataclass
class UNetTeacher:
    name: str = "simple_unet"
    unet: torch.nn.Module | Sequence[torch.nn.Module] | None = None
    p_uses_cfg: float = 0.0
    cfg_scale_range: tuple[float, float] = (1.3, 2.0)
    unet_weights: Sequence[float] | None = None  # ensemble weights

    def sample_cfg_scale(self, rng: np.random.RandomState,
                         force_uses_cfg: bool = False) -> float:
        """The iteration's CFG scale, planned on the host: 1 unless CFG is
        drawn (probability `p_uses_cfg`), then uniform in the range."""
        uses = force_uses_cfg or (self.p_uses_cfg > 0 and rng.rand() < self.p_uses_cfg)
        if not uses:
            return 1.0
        return float(rng.uniform(*self.cfg_scale_range))

    def _unet_eps(self, x, t, context):
        unets = self.unet if isinstance(self.unet, (list, tuple)) else [self.unet]
        dtype = next(unets[0].parameters()).dtype
        preds = [u(x, t, context.to(dtype)).float() for u in unets]
        if len(preds) == 1:
            return preds[0]
        w = torch.tensor(self.unet_weights or [1.0 / len(preds)] * len(preds))
        w = (w / w.sum()).tolist()
        return sum(wi * p for wi, p in zip(w, preds))

    @torch.no_grad()
    def __call__(self, schedule: DiffusionSchedule, x_start, noise, t, teacher_context,
                 draws: Draws, negative_context=None, num_denoising_steps: int = 1,
                 cfg_scale: float = 1.0, same_t_noise_across_instances: bool = False,
                 global_t_lb: int = 0, global_t_ub: int = 1000):
        """x_start, noise [B, 4, h, w], t [B], context [B, S, D] (or
        [neg ‖ pos] along the batch under CFG without `negative_context`) →
        (noise_preds [S, B, …], x_starts [S + 1, B, …], noises [S, B, …],
        ts [S, B]), fp32."""
        if num_denoising_steps > 10:
            raise ValueError("a teacher denoises for at most 10 steps")
        if same_t_noise_across_instances:
            t = t[:1].expand_as(t)
            noise = noise[:1].expand_as(noise)
        uses_cfg = negative_context is not None or cfg_scale > 1.0
        k = np.power(max(num_denoising_steps - 1, 1), -0.3)
        shrink_lb, shrink_ub = float(np.power(0.5, k)), float(np.power(0.7, k))
        x0 = x_start.float()
        preds, x_starts, noises, ts = [], [x0], [], []
        for _ in range(num_denoising_steps):
            x_noisy = schedule.q_sample(x0, t, noise)
            if uses_cfg and negative_context is not None:
                pos = self._unet_eps(x_noisy, t, teacher_context)
                neg = self._unet_eps(x_noisy, t, negative_context)
                eps = pos * cfg_scale - neg * (cfg_scale - 1.0)
            elif uses_cfg:
                both = self._unet_eps(torch.cat([x_noisy, x_noisy]), torch.cat([t, t]),
                                      teacher_context)
                pos, neg = both.chunk(2)
                eps = pos * cfg_scale - neg * (cfg_scale - 1.0)
            else:
                eps = self._unet_eps(x_noisy, t, teacher_context)
            pred_x0 = schedule.predict_start_from_noise(x_noisy, t, eps)
            preds.append(eps)
            x_starts.append(pred_x0)
            noises.append(noise)
            ts.append(t)
            rel = draws.uniforms(t.shape, t.device)
            t_lb = (t.float() * shrink_lb).clamp_min(global_t_lb)
            t_ub = (t.float() * shrink_ub).clamp_max(global_t_ub)
            t_next = ((t_ub - t_lb) * rel + t_lb).to(torch.int32)
            noise_next = draws.normal(x0.shape, x0.device)
            if same_t_noise_across_instances:
                t_next = t_next[:1].expand_as(t_next)
                noise_next = noise_next[:1].expand_as(noise_next)
            x0, t, noise = pred_x0, t_next, noise_next
        return (torch.stack(preds), torch.stack(x_starts), torch.stack(noises),
                torch.stack(ts))


def create_unet_teacher(teacher_type, **kwargs) -> UNetTeacher:
    """A teacher by type: `arc2face` (no CFG), `consistentID` (CFG half the
    time), `simple_unet`, `unet_ensemble` (or a list of types)."""
    if isinstance(teacher_type, (tuple, list)) and len(teacher_type) == 1:
        teacher_type = teacher_type[0]
    if teacher_type == "arc2face":
        kwargs.setdefault("cfg_scale_range", (1.0, 1.0))
        return UNetTeacher(name="arc2face", **kwargs)
    if teacher_type == "consistentID":
        kwargs.setdefault("p_uses_cfg", 0.5)
        return UNetTeacher(name="consistentID", **kwargs)
    if teacher_type == "simple_unet":
        return UNetTeacher(name="simple_unet", **kwargs)
    if teacher_type == "unet_ensemble" or isinstance(teacher_type, (tuple, list)):
        return UNetTeacher(name="unet_ensemble", **kwargs)
    raise NotImplementedError(f"teacher type {teacher_type}")
