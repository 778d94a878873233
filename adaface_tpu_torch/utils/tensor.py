"""Random draws and perturbation for the ID encoders.

Counterpart of `perturb_tensor` in `adaface_tpu/utils/tensor.py:18-37`. JAX
draws from a `PRNGKey` that torch cannot repeat, so every draw here goes
through `Draws`: from a `torch.Generator`, or handed in, in the order the
computation takes them (the CPU tests hand over the draws JAX made from its
keys). The gradient scalers wait for the training slices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Draws:
    """Standard normal and uniform draws in the order they are taken: from
    `generator`, or popped from `handed` (arrays, or scalars for uniforms)."""

    def __init__(self, generator: torch.Generator | None = None,
                 handed: Sequence | None = None):
        if (generator is None) == (handed is None):
            raise ValueError("Draws takes a generator or handed draws, not both")
        self.generator = generator
        self._handed = None if handed is None else list(handed)

    def _pop(self, what: str):
        if not self._handed:
            raise ValueError(f"no handed draw left for {what}")
        return self._handed.pop(0)

    def normal(self, shape, device) -> torch.Tensor:
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
