"""Optimizers as `torch.optim.Optimizer`s, and their schedules.

Counterpart of `adaface_tpu/train/optimizers.py` for the two optimizers the
training configurations use:
- `CautiousAdamW`: AdamW whose first moment is masked wherever it disagrees
  in sign with the gradient (renormalised by the surviving fraction) before
  the denominator; weight decay unmasked (`cautious_adamw`, `:35-94`);
- `Prodigy`: D-adaptation Adam, learning the distance-to-solution scale d
  on the fly (`prodigy`, `:101-193`), at lr 1 times its schedule;
- `warmup_cosine` and `prodigy_cycle_schedule` (`Linear`,
  `CosineAnnealingWarmRestarts`, `CyclicLR`);
- `make_optimizer`: the optimizer behind optax's `clip_by_global_norm`, and
  `optax.MultiSteps`'s accumulation (`MultiSteps`): the update is applied at
  every k-th `step()` with the mean of the k gradients, clipped.
A learning rate is a float or a schedule: a function of the optimizer's own
update count (before the update), as optax calls it. `muon`, `adam8bit`,
`adamw`, `nadam` and the generic `cautious` wrapper are not ported
(ROADMAP §1).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


class CautiousAdamW(torch.optim.Optimizer):
    """The reference's cautious AdamW (`ldm/c_adamw.py:90-122`): with
    step_size = lr·√(1 − β₂ᵗ)/(1 − β₁ᵗ), u = −step_size·(m ∘ mask)/(√v + ε)
    − lr·wd·p, mask = [m·g > 0] / max(mean(mask), 1e-3) per tensor."""

    def __init__(self, params, lr: float | Schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.005):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.count = 0

    @torch.no_grad()
    def step(self):
        t = self.count + 1
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr_t = _lr_at(group["lr"], self.count)
            step_size = lr_t * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                m, v = state["m"], state["v"]
                m.mul_(b1).add_(g * (1.0 - b1))
                v.mul_(b2).add_(g * g * (1.0 - b2))
                mask = (m * g > 0).to(g.dtype)
                mask = mask / mask.mean().clamp_min(1e-3)
                upd = -step_size * (m * mask) / (v.sqrt() + group["eps"])
                if group["weight_decay"]:
                    upd = upd - lr_t * group["weight_decay"] * p
                p.add_(upd)
        self.count = t


class Prodigy(torch.optim.Optimizer):
    """Prodigy (Mishchenko & Defazio), the JAX package's form: d, d_max and
    the numerator are shared by every parameter (one group), kept as fp32
    scalars on the parameters' device; `safeguard_warmup` is accepted and,
    as there, has no effect."""

    def __init__(self, params, lr: float | Schedule = 1.0, betas=(0.9, 0.999),
                 beta3: float | None = None, eps: float = 1e-8, weight_decay: float = 0.0,
                 d0: float = 1e-6, d_coef: float = 1.0, growth_rate: float = float("inf"),
                 safeguard_warmup: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        if len(self.param_groups) != 1:
            raise ValueError("Prodigy: one parameter group (d is shared by all parameters)")
        self.beta3 = betas[1] ** 0.5 if beta3 is None else beta3
        self.d0, self.d_coef, self.growth_rate = d0, d_coef, growth_rate
        self.safeguard_warmup = safeguard_warmup
        params = self.param_groups[0]["params"]
        device = params[0].device
        self.d = torch.tensor(d0, dtype=torch.float32, device=device)
        self.d_max = self.d.clone()
        self.numerator = torch.zeros((), dtype=torch.float32, device=device)
        self.count = 0
        for p in params:  # p0: the parameters at the start
            self.state[p] = dict(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p),
                                 s=torch.zeros_like(p), p0=p.detach().clone())

    @torch.no_grad()
    def step(self):
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        beta3, d0 = self.beta3, self.d0
        d = self.d
        dlr = d * _lr_at(group["lr"], self.count)
        params = [p for p in group["params"] if p.grad is not None]
        dot = sum((p.grad.float() * (self.state[p]["p0"] - p).float()).sum() for p in params)
        self.numerator = self.numerator * beta3 + (d / d0) * dlr * dot
        s_l1 = torch.zeros((), device=d.device)
        for p in params:
            s = self.state[p]["s"]
            s.mul_(beta3).add_(p.grad.float() * ((d / d0) * dlr))
            s_l1 = s_l1 + s.abs().sum()
        d_hat = torch.where(s_l1 > 0, self.d_coef * self.numerator / (s_l1 + 1e-30), d)
        d_next = torch.minimum(torch.maximum(d, d_hat), d * self.growth_rate)
        d_next = torch.maximum(d_next, d)
        self.d_max = torch.maximum(self.d_max, d_next)
        for p in params:
            g, state = p.grad, self.state[p]
            m, v = state["exp_avg"], state["exp_avg_sq"]
            m.mul_(b1).add_(g * d * (1 - b1))
            v.mul_(b2).add_((g * d) ** 2 * (1 - b2))
            upd = -dlr * m / (v.sqrt() + d * group["eps"])
            if group["weight_decay"] > 0:
                upd = upd - dlr * group["weight_decay"] * p
            p.add_(upd)
        self.d = d_next
        self.count += 1


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int, lr_min: float = 0.0,
                  lr_start: float = 0.0) -> Schedule:
    """LambdaWarmUpCosineScheduler: optax's linear warmup from `lr_start`
    joined at `warmup_steps` to a cosine decay to `lr_min`."""
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = lr_min / max(base_lr, 1e-12)

    def sched(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (lr_start - base_lr) * frac + base_lr
        count = min(step - warmup_steps, decay_steps)
        return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
                          + alpha)

    return sched


def prodigy_cycle_schedule(warm_up_steps: int, total_steps: int, scheduler_cycles: float = 1,
                           scheduler_type: str = "Linear") -> Schedule:
    """The lr factor of Prodigy (`SequentialLR2`): 1 for `warm_up_steps`,
    then `scheduler_cycles` cycles over the rest: `Linear` (each cycle from 1
    down toward 1 - 1/1.1, the last taking the remainder),
    `CosineAnnealingWarmRestarts` (between 1 and 0.1) or `CyclicLR` (a
    triangle between 1 and 0.1, starting at the peak; half a cycle fewer)."""
    if scheduler_type not in ("Linear", "CosineAnnealingWarmRestarts", "CyclicLR"):
        raise ValueError(f"unknown scheduler_type '{scheduler_type}'")
    total_cycle = float(max(total_steps - warm_up_steps, 1))
    num = float(scheduler_cycles) - (0.5 if scheduler_type == "CyclicLR" else 0.0)
    single = total_cycle / max(num, 0.5)

    def sched(step: int) -> float:
        if step < warm_up_steps:
            return 1.0
        t = float(step - warm_up_steps)
        if scheduler_type == "Linear":
            n_int = max(int(scheduler_cycles), 1)
            idx = min(math.floor(t / single), n_int - 1)
            cyc_len = total_cycle - single * (n_int - 1) if idx == n_int - 1 else single
            return min(max(1.0 - (t - idx * single) / (cyc_len * 1.1), 0.0), 1.0)
        if scheduler_type == "CosineAnnealingWarmRestarts":
            return 0.1 + 0.45 * (1.0 + math.cos(math.pi * math.fmod(t, single) / single))
        pos = math.fmod(t / (single / 2.0), 2.0)  # 0 at the peak, 1 at the trough
        return 0.1 + 0.9 * (1.0 - pos if pos <= 1.0 else pos - 1.0)

    return sched


def global_norm(tensors) -> torch.Tensor:
    """√(Σ ‖t‖²) over the tensors, in fp32 (`optax.global_norm`)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class MultiSteps:
    """`optax.MultiSteps(chain(clip_by_global_norm(clip), optimizer), k)`:
    each `step()` folds the parameters' `.grad` into a running mean
    (acc + (g − acc)/(n + 1)); at every k-th the mean, clipped to global norm
    `grad_clip`, becomes the gradient of one step of `optimizer`. k = 1 is
    clip and step. → `step()` returns whether the parameters moved."""

    def __init__(self, optimizer: torch.optim.Optimizer, grad_clip: float, every_k: int = 1):
        self.optimizer = optimizer
        self.grad_clip = grad_clip
        self.every_k = every_k
        self.mini_step = 0
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        for p, acc in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (self.mini_step + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        norm = global_norm(self.acc)
        for p, acc in zip(self.params, self.acc):
            # optax: t unchanged below the norm, else t / ‖g‖ · clip
            p.grad = torch.where(norm < self.grad_clip, acc, acc / norm * self.grad_clip)
        self.optimizer.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0
        return True

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)


def make_optimizer(name: str, params, lr: float, warmup_steps: int = 600,
                   total_steps: int = 120_000, grad_clip: float = 0.2,
                   weight_decay: float = 0.005, accum_steps: int = 1, **kw) -> MultiSteps:
    """`make_optimizer` (`configure_optimizers`): `cadamw` (or
    `cautious_adamw`) at warmup-cosine lr, or `prodigy` at lr 1 times
    `prodigy_cycle_schedule` (kw: scheduler_cycles, scheduler_type, d_coef,
    betas (default (0.985, 0.993)), ...; weight decay off as in the
    reference), behind the global-norm clip and `accum_steps`-step
    accumulation."""
    params = list(params)
    if name in ("cadamw", "cautious_adamw"):
        core = CautiousAdamW(params, warmup_cosine(lr, warmup_steps, total_steps),
                             weight_decay=weight_decay)
    elif name == "prodigy":
        cycles = kw.pop("scheduler_cycles", 1)
        sched = prodigy_cycle_schedule(warmup_steps, total_steps, cycles,
                                       kw.pop("scheduler_type", "Linear"))
        kw.setdefault("safeguard_warmup", cycles > 1)
        kw.setdefault("betas", (0.985, 0.993))
        core = Prodigy(params, lr=sched, **kw)
    else:
        raise ValueError(f"optimizer '{name}' is not ported (cadamw, prodigy; muon and "
                         "adam8bit wait in ROADMAP §1)")
    return MultiSteps(core, grad_clip, accum_steps)
