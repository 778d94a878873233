"""Random draws, perturbation and gradient scaling.

Counterpart of `adaface_tpu/utils/tensor.py`: `perturb_tensor`,
`gradient_scale` / `gen_gradient_scaler` (an autograd Function in place of
the custom VJP), `ortho_subtract`, `anneal_value` and
`anneal_perturb_embedding`. JAX draws from a `PRNGKey` that torch cannot
repeat, so every draw here goes through `Draws`: from a `torch.Generator`,
or handed in, in the order the computation takes them (the CPU tests hand
over the draws JAX made from its keys).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from adaface_tpu_torch.parallel.collectives import gnorm, gstd, to_local


class Draws:
    """Standard normal and uniform draws in the order they are taken: from
    `generator`, or popped from `handed` (arrays, or scalars for uniforms).
    A draw's `batch_axis` names the axis that runs over the batch's
    instances: `parallel.mesh.ShardedDraws` takes such a draw for the global
    batch and keeps a rank's slice; here it changes nothing."""

    def __init__(self, generator: torch.Generator | None = None,
                 handed: Sequence | None = None):
        if (generator is None) == (handed is None):
            raise ValueError("Draws takes a generator or handed draws, not both")
        self.generator = generator
        self._handed = None if handed is None else list(handed)

    def fork(self) -> "Draws":
        """A second stream that gives the draws this one gives from here on,
        this one left as it is: a generator of the same state (no device
        read), or a copy of the draws left to hand."""
        if self.generator is None:
            return Draws(handed=list(self._handed))
        gen = torch.Generator(self.generator.device)
        gen.set_state(self.generator.get_state())
        return Draws(generator=gen)

    def _pop(self, what: str):
        if not self._handed:
            raise ValueError(f"no handed draw left for {what}")
        return self._handed.pop(0)

    def normal(self, shape, device, batch_axis: int | None = None) -> torch.Tensor:
        """[shape] float32 N(0, 1) on `device`."""
        shape = tuple(shape)
        if self.generator is None:
            x = torch.as_tensor(np.array(self._pop(f"a normal draw of {shape}")),
                                dtype=torch.float32)
            if tuple(x.shape) != shape:
                raise ValueError(f"handed draw of shape {tuple(x.shape)}, wanted {shape}")
            return x.to(device)
        x = torch.randn(shape, generator=self.generator, device=self.generator.device)
        return x.to(device)

    def uniform(self) -> float:
        """One U[0, 1) draw."""
        if self.generator is None:
            return float(np.asarray(self._pop("a uniform draw")))
        return torch.rand((), generator=self.generator,
                          device=self.generator.device).item()

    def integers(self, shape, low: int, high: int, device,
                 batch_axis: int | None = None) -> torch.Tensor:
        """[shape] int64 uniform in [low, high) on `device`."""
        shape = tuple(shape)
        if self.generator is None:
            x = torch.as_tensor(np.array(self._pop(f"integer draws of {shape}")),
                                dtype=torch.int64)
            if tuple(x.shape) != shape:
                raise ValueError(f"handed draw of shape {tuple(x.shape)}, wanted {shape}")
            return x.to(device)
        return torch.randint(low, high, shape, generator=self.generator,
                             device=self.generator.device).to(device)

    def uniforms(self, shape, device, batch_axis: int | None = None) -> torch.Tensor:
        """[shape] float32 U[0, 1) on `device`."""
        shape = tuple(shape)
        if self.generator is None:
            x = torch.as_tensor(np.array(self._pop(f"uniform draws of {shape}")),
                                dtype=torch.float32)
            if tuple(x.shape) != shape:
                raise ValueError(f"handed draw of shape {tuple(x.shape)}, wanted {shape}")
            return x.to(device)
        return torch.rand(shape, generator=self.generator, device=self.generator.device).to(device)


_CONSTANTS: dict = {}


def device_constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype)` on `device`, made at the first
    call for (values, dtype, device) and kept: a step that reads a constant
    from the card copies nothing from pageable host memory, a copy that
    waits for the stream to drain. Made outside inference mode, so autograd
    can save it; never write to it."""
    key = (tuple(values), dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTANTS[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return t


def as_draws(rng, device) -> Draws:
    """`rng` as Draws: Draws as they are, a torch.Generator, handed draws (a
    list or tuple), or None for a generator on `device` seeded 0 (the JAX
    package's default `PRNGKey(0)`)."""
    if isinstance(rng, Draws):
        return rng
    if isinstance(rng, torch.Generator):
        return Draws(generator=rng)
    if isinstance(rng, (list, tuple)):
        return Draws(handed=rng)
    if rng is None:
        return Draws(generator=torch.Generator(device).manual_seed(0))
    raise TypeError(f"rng must be Draws, a torch.Generator, a sequence or None, not {rng!r}")


def perturb_tensor(x: torch.Tensor, perturb_std: float, noise: torch.Tensor,
                   std_is_relative: bool = True, keep_norm: bool = False) -> torch.Tensor:
    """x plus Gaussian noise, its std `perturb_std` times x's own (population)
    std by default; with `keep_norm` the result is scaled back to x's
    Frobenius norm, so only the direction moves. `noise` is the standard
    normal draw, of x's shape (from `Draws`)."""
    if perturb_std == 0.0:
        return x
    std = perturb_std * x.std(unbiased=False) if std_is_relative else perturb_std
    out = x + noise.to(x.device, x.dtype) * std
    if keep_norm:
        out = out * (x.norm() / (out.norm() + 1e-8))
    return out


class _GradientScale(torch.autograd.Function):
    """Identity forward; the backward multiplies the gradient by `scale`."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def gradient_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """`gradient_scale` (`adaface_tpu/utils/tensor.py:40-55`): x, with its
    gradient multiplied by `scale`."""
    return _GradientScale.apply(x, float(scale))


def gen_gradient_scaler(scale: float):
    """fn(x) scaling x's gradient by `scale`; scale <= 0 detaches, 1 is the
    identity (`gen_gradient_scaler`, `:66-72`)."""
    if scale <= 0:
        return lambda x: x.detach()
    if scale == 1:
        return lambda x: x
    return lambda x: gradient_scale(x, scale)


def ortho_subtract(a: torch.Tensor, b: torch.Tensor, b_discount: float = 1.0,
                   on_last_n_dims: int = 1, eps: float = 1e-6) -> torch.Tensor:
    """a minus (b_discount ×) its projection onto b over the last
    `on_last_n_dims` axes (`ortho_subtract`, `:75-89`)."""
    if on_last_n_dims > 1:
        a, b = torch.broadcast_tensors(a, b)
        shape = a.shape
        flat = shape[:-on_last_n_dims] + (-1,)
        out = ortho_subtract(a.reshape(flat), b.reshape(flat), b_discount=b_discount, eps=eps)
        return out.reshape(shape)
    dot = (a * b).sum(dim=-1, keepdim=True)
    norm_sq = (b * b).sum(dim=-1, keepdim=True)
    return a - dot / (norm_sq + eps) * b * b_discount


def anneal_value(training_percent: float, final_percent: float,
                 value_range: tuple[float, float]) -> float:
    """v_init + (v_final - v_init) · training_percent until final_percent,
    then v_final (`anneal_value`, `:92-102`: the slope is not normalised by
    final_percent, as in the reference)."""
    v_init, v_final = value_range
    if training_percent < final_percent:
        return v_init + (v_final - v_init) * training_percent
    return v_final


def anneal_perturb_embedding(draws: Draws, embeddings: torch.Tensor, training_percent: float,
                             begin_std_range: tuple[float, float],
                             end_std_range: tuple[float, float] | None, perturb_prob: float,
                             std_is_relative: bool = True,
                             keep_norm: bool = False) -> torch.Tensor:
    """Embeddings plus Gaussian noise of a std drawn from an annealed range,
    with probability `perturb_prob` (`anneal_perturb_embedding`,
    `:105-128`). Draws, in order: a uniform for the std, a normal of the
    embeddings' shape (axis 0 the batch's), a uniform against
    `perturb_prob`. The two uniforms stay on the embeddings' device (the std
    and the decision in fp64 there, as on the host), so no draw reads the
    device back. The std and the norms are the global batch's under data
    parallelism (`parallel.collectives`)."""
    if end_std_range is not None:
        lo = anneal_value(training_percent, 1.0, (begin_std_range[0], end_std_range[0]))
        hi = anneal_value(training_percent, 1.0, (begin_std_range[1], end_std_range[1]))
    else:
        lo, hi = begin_std_range
    dev = embeddings.device
    std = (lo + (hi - lo) * draws.uniforms((), dev).double()).float()
    noise = draws.normal(embeddings.shape, dev, batch_axis=0).to(embeddings.dtype)
    apply = draws.uniforms((), dev).double() < perturb_prob
    noise_std = std * to_local(gstd(embeddings)) if std_is_relative else std
    out = embeddings + noise * noise_std
    if keep_norm:
        out = out * to_local(gnorm(embeddings) / (gnorm(out) + 1e-8))
    return torch.where(apply, out, embeddings)
