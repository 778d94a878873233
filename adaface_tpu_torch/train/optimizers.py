"""Optimizers as `torch.optim.Optimizer`s, and their schedules.

Counterpart of `adaface_tpu/train/optimizers.py`, each held to the optax
transform the JAX package builds (not to torch's namesake: torch's NAdam
has a momentum decay that optax's `nadamw` lacks):
- `CautiousAdamW`: AdamW whose first moment is masked wherever it disagrees
  in sign with the gradient (renormalised by the surviving fraction) before
  the denominator; weight decay unmasked (`cautious_adamw`, `:35-94`);
- `Cautious`: the generic wrapper, masking an inner optimizer's update
  where it agrees in sign with the gradient (`cautious`, `:35-55`);
- `AdamW` (optax's `adamw`) and, with `nesterov`, optax's `nadamw`;
- `Prodigy`: D-adaptation Adam, learning the distance-to-solution scale d
  on the fly (`prodigy`, `:101-193`), at lr 1 times its schedule;
- `Muon`: Newton–Schulz-orthogonalised Nesterov momentum for weights of two
  or more axes, Adam for the rest (`muon`, `:205-287`), each weight seen as
  the JAX tree holds it (`jax_layouts`);
- `Adam8bit`: Adam with int8 block-quantised moments (`adam8bit`,
  `:290-394`), its blocks over the JAX layout's element order;
- `warmup_cosine` and `prodigy_cycle_schedule` (`Linear`,
  `CosineAnnealingWarmRestarts`, `CyclicLR`);
- `make_optimizer`: an optimizer by the JAX package's name behind optax's
  `clip_by_global_norm`, and `optax.MultiSteps`'s accumulation
  (`MultiSteps`): the update is applied at every k-th `step()` with the
  mean of the k gradients, clipped.
A learning rate is a float or a schedule: a function of the optimizer's own
update count (before the update), as optax calls it. Each optimizer
computes its parameters' additive updates (`updates()`) before `step()`
adds them, as optax composes transforms. Powers of the betas are taken in
fp32, as JAX takes them.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable

import torch
from torch import nn

Schedule = Callable[[int], float]


def _lr_at(lr, count: int) -> float:
    return float(lr(count)) if callable(lr) else float(lr)


def _correction(beta: float, t: int) -> float:
    """1 − βᵗ in fp32 (optax's `bias_correction`)."""
    return float(1.0 - torch.tensor(beta, dtype=torch.float32) ** t)


class UpdateOptimizer(torch.optim.Optimizer):
    """An optimizer in optax's form: `updates()` → [(parameter, its additive
    update)] from the parameters' `.grad`, advancing the state; `step()`
    adds them. `count` is the number of updates made."""

    def updates(self) -> list:
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        for p, u in self.updates():
            p.add_(u)


class CautiousAdamW(UpdateOptimizer):
    """The reference's cautious AdamW (`ldm/c_adamw.py:90-122`): with
    step_size = lr·√(1 − β₂ᵗ)/(1 − β₁ᵗ), u = −step_size·(m ∘ mask)/(√v + ε)
    − lr·wd·p, mask = [m·g > 0] / max(mean(mask), 1e-3) per tensor."""

    def __init__(self, params, lr: float | Schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.005):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.count = 0

    @torch.no_grad()
    def updates(self) -> list:
        t = self.count + 1
        out = []
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
                out.append((p, upd))
        self.count = t
        return out


class Cautious:
    """`cautious(inner)` (`optimizers.py:35-55`): the inner optimizer's update
    kept where it agrees with the gradient's descent (u·g < 0), rescaled by
    1 / max(mean(mask), 1e-3) per tensor."""

    def __init__(self, inner: UpdateOptimizer):
        self.inner = inner
        self.param_groups = inner.param_groups

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def updates(self) -> list:
        out = []
        for p, u in self.inner.updates():
            m = (u * p.grad < 0).to(u.dtype)
            out.append((p, u * m / torch.clamp(m.mean(), min=1e-3)))
        return out

    @torch.no_grad()
    def step(self):
        for p, u in self.updates():
            p.add_(u)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)


class AdamW(UpdateOptimizer):
    """optax's `adamw` (decoupled weight decay, scaled by the learning rate):
    u = −lr·(m̂ / (√v̂ + ε) + wd·p); with `nesterov`, optax's `nadamw`:
    m̂ = β₁·m / (1 − β₁ᵗ⁺¹) + (1 − β₁)·g / (1 − β₁ᵗ)."""

    def __init__(self, params, lr: float | Schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.nesterov = nesterov
        self.count = 0

    @torch.no_grad()
    def updates(self) -> list:
        t = self.count + 1
        out = []
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr_t = _lr_at(group["lr"], self.count)
            c1, c2 = _correction(b1, t), _correction(b2, t)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if not state:
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                m, v = state["m"], state["v"]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * g ** 2 + b2 * v)
                if self.nesterov:
                    m_hat = b1 * (m / _correction(b1, t + 1)) + (1 - b1) * (g / c1)
                else:
                    m_hat = m / c1
                u = m_hat / (torch.sqrt(v / c2) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                out.append((p, -lr_t * u))
        self.count = t
        return out


class Prodigy(UpdateOptimizer):
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
    def updates(self) -> list:
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
        out = []
        for p in params:
            g, state = p.grad, self.state[p]
            m, v = state["exp_avg"], state["exp_avg_sq"]
            m.mul_(b1).add_(g * d * (1 - b1))
            v.mul_(b2).add_((g * d) ** 2 * (1 - b2))
            upd = -dlr * m / (v.sqrt() + d * group["eps"])
            if group["weight_decay"] > 0:
                upd = upd - dlr * group["weight_decay"] * p
            out.append((p, upd))
        self.d = d_next
        self.count += 1
        return out


# ---------------------------------------------------------------------------
# the JAX tree's view of a parameter
# ---------------------------------------------------------------------------


def jax_layouts(*modules: nn.Module) -> dict:
    """{parameter: (kind, parts)} for the parameters whose JAX leaf is laid
    out otherwise (`core/bridge.py`): "dense" (a Linear's [out, in] weight,
    [in, out] in JAX; `parts` separate leaves where the module fuses q, k, v
    into one weight), "conv" (a Conv2d's OIHW weight, HWIO in JAX), and the
    adapters' `lora_a` / `lora_b` by their axes. Any other parameter is as
    the JAX leaf."""
    out = {}
    for module in modules:
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                if name == "weight" and isinstance(m, nn.Linear):
                    out[p] = ("dense", getattr(m, "parts", 1))
                elif name == "weight" and isinstance(m, nn.Conv2d):
                    out[p] = ("conv", 1)
                elif name in ("lora_a", "lora_b"):
                    out[p] = ("dense" if p.dim() == 2 else "conv", 1)
    return out


def _to_jax(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "dense":
        return t.T
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    return t


def _from_jax(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "dense":
        return t.T
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    return t


def _jax_leaves(t: torch.Tensor, layout: tuple) -> list[torch.Tensor]:
    """`t` as the JAX leaves it stands for."""
    kind, parts = layout
    return [_to_jax(c, kind) for c in t.chunk(parts, dim=0)]


def _from_jax_leaves(leaves: list[torch.Tensor], layout: tuple) -> torch.Tensor:
    kind, _ = layout
    return torch.cat([_from_jax(x, kind) for x in leaves], dim=0)


# ---------------------------------------------------------------------------
# Muon
# ---------------------------------------------------------------------------


def _newton_schulz(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Orthogonalise by the quintic Newton–Schulz iteration (public Muon), fp32."""
    a, b, c = 3.4445, -4.7750, 2.0315
    x = g.float()
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + eps)
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * xxt @ xxt) @ x
    return x.T if transposed else x


class Muon(UpdateOptimizer):
    """`muon` (`optimizers.py:205-287`): for every parameter of two or more
    axes, Nesterov momentum orthogonalised by Newton–Schulz on the JAX leaf's
    matrix view ([first axis, the rest]) and scaled by √max(1, rows/cols) of
    that view, times `lr`·`matrix_lr_mult`; Adam (β 0.9, 0.95, no weight
    decay) at `adam_lr` for the rest. `layouts` (`jax_layouts`) says how each
    parameter's JAX leaf is laid out: a Linear's [in, out] gives in/out where
    its torch [out, in] would give out/in, and a ≥3-D leaf's matrix view
    takes its first JAX axis."""

    def __init__(self, params, lr: float | Schedule = 0.02, momentum: float = 0.95,
                 nesterov: bool = True, adam_lr: float | Schedule = 3e-4,
                 adam_b1: float = 0.9, adam_b2: float = 0.95, matrix_lr_mult: float = 1.0,
                 layouts: dict | None = None):
        super().__init__(params, dict(lr=lr, adam_lr=adam_lr))
        self.momentum, self.nesterov = momentum, nesterov
        self.adam_b1, self.adam_b2, self.matrix_lr_mult = adam_b1, adam_b2, matrix_lr_mult
        self.layouts = layouts or {}
        self.count = 0

    def _orthogonalised(self, eff: torch.Tensor, layout: tuple) -> torch.Tensor:
        outs = []
        for x in _jax_leaves(eff, layout):
            mat = x.reshape(x.shape[0], -1)
            o = _newton_schulz(mat).reshape(x.shape)
            scale = max(1.0, x.shape[0] / max(mat.shape[1], 1)) ** 0.5
            outs.append(scale * o)
        return _from_jax_leaves(outs, layout)

    @torch.no_grad()
    def updates(self) -> list:
        t = self.count + 1
        out = []
        for group in self.param_groups:
            lr_t = _lr_at(group["lr"], self.count)
            adam_lr_t = _lr_at(group["adam_lr"], self.count)
            c1, c2 = _correction(self.adam_b1, t), _correction(self.adam_b2, t)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if p.dim() >= 2:
                    if not state:
                        state["momentum"] = torch.zeros_like(p)
                    m = state["momentum"]
                    m.copy_(m * self.momentum + g)
                    eff = g + self.momentum * m if self.nesterov else m
                    o = self._orthogonalised(eff, self.layouts.get(p, ("plain", 1)))
                    out.append((p, -lr_t * self.matrix_lr_mult * o.to(g.dtype)))
                    continue
                if not state:
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                m, v = state["m"], state["v"]
                m.copy_((1 - self.adam_b1) * g + self.adam_b1 * m)
                v.copy_((1 - self.adam_b2) * g ** 2 + self.adam_b2 * v)
                out.append((p, -adam_lr_t * ((m / c1) / (torch.sqrt(v / c2) + 1e-8))))
        self.count = t
        return out


# ---------------------------------------------------------------------------
# 8-bit Adam
# ---------------------------------------------------------------------------


class Adam8bit(UpdateOptimizer):
    """`adam8bit` (`optimizers.py:290-394`, the reference's bitsandbytes
    `Adam8bit` branch): Adam whose moments are kept as int8 with one fp32
    absmax scale a `block_size` block (linear quantisation, rounding half to
    even as `jnp.round`) for parameters of at least `min_8bit_size`
    elements, fp32 below. The blocks run over the JAX leaf's element order
    (`layouts`), so the int8 states are JAX's: `state[p]["leaves"]` holds one
    dict a JAX leaf, fp32 `m`, `v` or int8 `qm`, `qv` with their fp32 scales
    `sm`, `sv`."""

    def __init__(self, params, lr: float | Schedule, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, block_size: int = 256, min_8bit_size: int = 4096,
                 layouts: dict | None = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.block_size, self.min_8bit_size = block_size, min_8bit_size
        self.layouts = layouts or {}
        self.count = 0

    def _quant(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """fp32 (JAX order) → (int8 [nb, block], fp32 absmax [nb])."""
        n, bs = x.numel(), self.block_size
        nb = (n + bs - 1) // bs
        xb = torch.nn.functional.pad(x.reshape(-1), (0, nb * bs - n)).reshape(nb, bs)
        scale = xb.abs().amax(dim=1)
        q = torch.round(xb * (127.0 / torch.clamp(scale, min=1e-30))[:, None])
        return q.to(torch.int8), scale

    @staticmethod
    def _dequant(q, scale, shape):
        x = q.float() * (scale * (1.0 / 127.0))[:, None]
        return x.reshape(-1)[:math.prod(shape)].reshape(shape)

    @torch.no_grad()
    def updates(self) -> list:
        t = self.count + 1
        out = []
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr_t = _lr_at(group["lr"], self.count)
            c1, c2 = _correction(b1, t), _correction(b2, t)
            for p in group["params"]:
                layout = self.layouts.get(p, ("plain", 1))
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads = _jax_leaves(g.float(), layout)
                leaves = self.state[p].setdefault("leaves", [{} for _ in grads])
                upds = []
                for gj, st in zip(grads, leaves):
                    small = gj.numel() < self.min_8bit_size
                    if not st:
                        if small:
                            st.update(m=torch.zeros_like(gj), v=torch.zeros_like(gj))
                        else:
                            st.update(zip(("qm", "sm"), self._quant(torch.zeros_like(gj))))
                            st.update(zip(("qv", "sv"), self._quant(torch.zeros_like(gj))))
                    if small:
                        m, v = st["m"], st["v"]
                    else:
                        m = self._dequant(st["qm"], st["sm"], gj.shape)
                        v = self._dequant(st["qv"], st["sv"], gj.shape)
                    m = b1 * m + (1.0 - b1) * gj
                    v = b2 * v + (1.0 - b2) * gj * gj
                    upds.append(-lr_t * ((m / c1) / (torch.sqrt(v / c2) + group["eps"])))
                    if small:
                        st.update(m=m, v=v)
                    else:
                        st.update(zip(("qm", "sm"), self._quant(m)))
                        st.update(zip(("qv", "sv"), self._quant(v)))
                upd = _from_jax_leaves(upds, layout)
                if group["weight_decay"]:
                    upd = upd - lr_t * group["weight_decay"] * p.float()
                out.append((p, upd.to(p.dtype)))
        self.count = t
        return out


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
                   weight_decay: float = 0.005, accum_steps: int = 1,
                   layouts: dict | None = None, **kw) -> MultiSteps:
    """`make_optimizer` (`configure_optimizers`), by the JAX package's names:
    `cadamw` (or `cautious_adamw`), `adamw`, `nadam` (optax's `nadamw`) and
    `adam8bit` at warmup-cosine lr; `prodigy` at lr 1 times
    `prodigy_cycle_schedule` (kw: scheduler_cycles, scheduler_type, d_coef,
    betas (default (0.985, 0.993)), ...; weight decay off as in the
    reference); `muon` with 5x the learning rate on matrices and the
    warmup-cosine schedule for both parts. Behind the global-norm clip and
    `accum_steps`-step accumulation. `layouts` (`jax_layouts` of the
    trained modules) gives muon and adam8bit the JAX view of each weight.
    Keyword arguments the optimizer does not take are dropped with a note
    (the AdamWs take none, as in JAX): JAX passes a configuration's prodigy
    keywords on to adam8bit and muon, which raise (ROADMAP §3)."""
    params = list(params)
    takes = {"adam8bit": Adam8bit, "muon": Muon}.get(name)
    if takes is not None or name in ("cadamw", "cautious_adamw", "adamw", "nadam"):
        names = set(inspect.signature(takes).parameters) if takes else set()
        dropped = sorted(k for k in kw if k not in names)
        if dropped:
            print(f"optimizer keywords {name} does not take, dropped: {dropped}", flush=True)
        kw = {k: v for k, v in kw.items() if k in names}
    sched = warmup_cosine(lr, warmup_steps, total_steps)
    if name in ("cadamw", "cautious_adamw"):
        core = CautiousAdamW(params, sched, weight_decay=weight_decay)
    elif name in ("adamw", "nadam"):
        core = AdamW(params, sched, weight_decay=weight_decay, nesterov=name == "nadam")
    elif name == "adam8bit":
        core = Adam8bit(params, sched, weight_decay=weight_decay, layouts=layouts, **kw)
    elif name == "prodigy":
        cycles = kw.pop("scheduler_cycles", 1)
        sched = prodigy_cycle_schedule(warmup_steps, total_steps, cycles,
                                       kw.pop("scheduler_type", "Linear"))
        kw.setdefault("safeguard_warmup", cycles > 1)
        kw.setdefault("betas", (0.985, 0.993))
        core = Prodigy(params, lr=sched, **kw)
    elif name == "muon":
        kw.setdefault("matrix_lr_mult", 5.0)
        core = Muon(params, lr=sched, adam_lr=sched, layouts=layouts, **kw)
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    return MultiSteps(core, grad_clip, accum_steps)
