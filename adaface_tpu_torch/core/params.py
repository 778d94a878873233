"""Building modules with random weights at the JAX package's init scales.

The JAX package initialises every weight with `jax.random` at fixed scales
(`adaface_tpu/models/unet.py:258-276`, `models/vae.py:80-90`,
`models/clip.py:117-145`). The port draws from a seeded `torch.Generator`
at the same scales; the numbers differ, the distributions do not. A module
is built on the `meta` device and materialised on the target device, so a
full-size model is never first built on the host.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """Fill p with N(0, std²) drawn on the generator's device."""
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=gen, device=gen.device) * std)


def init_fan_in_(module: nn.Module, gen: torch.Generator) -> None:
    """Conv and linear weights N(0, 1/fan_in), biases 0, norms 1/0 — the
    `_init_conv`/`_init_dense` rule of the UNet and the VAE."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            # a fused projection (`parts` of them in one weight) draws each
            # part on its own, as separate projections would
            for part in m.weight.chunk(getattr(m, "parts", 1), dim=0):
                normal_(part, m.weight[0].numel() ** -0.5, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif hasattr(m, "weight") and hasattr(m, "bias") and m.weight is not None \
                and m.weight.dim() == 1:
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def build(make: Callable[[], nn.Module], device, dtype,
          init: Callable[[nn.Module, torch.Generator], None],
          gen: torch.Generator) -> nn.Module:
    """make() on the meta device → empty on `device` in `dtype` → init(gen);
    buffers that no state dict holds are filled by the module's own
    `reset_buffers()`."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device).to(dtype)
    init(module, gen)
    for m in module.modules():
        if hasattr(m, "reset_buffers"):
            m.reset_buffers()
    return module.requires_grad_(False).eval()
