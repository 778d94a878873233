"""The fg-seeded start of a comp iteration.

Counterpart of `adaface_tpu/train/init_x.py` (the reference's
`init_x_with_fg_from_training_image`, `ldm/util.py:1599-1672`): keep the
training latent inside the fg mask, fill the background with noise, shrink
the fg bilinearly into the canvas with a random offset (a smaller scale for
large faces), and blend a little noise over the result. The scale and the
offset are planned on the host from a numpy RandomState, as in JAX; the
three noise tensors are drawn from `Draws` or handed in.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from adaface_tpu_torch.ops.resize import resize_bilinear_scale_factor


def plan_fg_init(fg_mask_percent: float, rng: np.random.RandomState,
                 base_scale_range=(0.8, 1.0), hw: tuple[int, int] | None = None):
    """(scale, dh, dw) (`ldm/util.py:1604-1652`): with `hw` the offset's
    perturbation takes the reference's bounds (min(pad1 − 1, pad2 − 1, 4),
    high exclusive), else ±4."""
    lb, ub = base_scale_range
    if fg_mask_percent > 0.2:
        extra = math.pow(0.2 / fg_mask_percent, 0.35)
        lb2, ub2 = lb * extra, max(0.5, ub * extra)
        scale = rng.rand() * (ub2 - lb2) + lb2
    else:
        scale = rng.rand() * (ub - lb) + lb
    scale = float(min(scale, 1.0))
    if hw is not None:
        h, w = hw
        ns_h, ns_w = int(h * scale), int(w * scale)
        pad_h1, pad_w1 = (h - ns_h) // 2, (w - ns_w) // 2
        pad_h2, pad_w2 = h - ns_h - pad_h1, w - ns_w - pad_w1
        max_h = min(pad_h1 - 1, pad_h2 - 1, 4)
        max_w = min(pad_w1 - 1, pad_w2 - 1, 4)
        dh = int(rng.randint(-max_h, max_h)) if max_h > 0 else 0
        dw = int(rng.randint(-max_w, max_w)) if max_w > 0 else 0
    else:
        dh, dw = int(rng.randint(-4, 5)), int(rng.randint(-4, 5))
    return scale, dh, dw


def init_x_with_fg_from_training_image(x_start: torch.Tensor, fg_mask: torch.Tensor,
                                       draws=None, scale: float = 0.9, dh: int = 0, dw: int = 0,
                                       fg_noise_amount: float = 0.2, bg_noise1=None,
                                       bg_noise2=None, blend_noise=None):
    """→ (x_init, the scaled fg mask), the reference's writes in order: the
    background filled with noise 1; [x ‖ mask] scaled (align_corners=False)
    and zero-padded back with the (dh, dw)-moved centring; outside the scaled
    mask noise 2; the whole tensor blended with noise 3. x_start
    [B, 4, h, w], fg_mask [B, 1, h, w]; noises drawn from `draws` in that
    order where not handed in."""
    b, c, h, w = x_start.shape
    dev = x_start.device
    if draws is not None:
        bg_noise1 = draws.normal(x_start.shape, dev) if bg_noise1 is None else bg_noise1
        bg_noise2 = draws.normal(x_start.shape, dev) if bg_noise2 is None else bg_noise2
        blend_noise = draws.normal(x_start.shape, dev) if blend_noise is None else blend_noise
    x_maskfilled = torch.where(fg_mask > 0, x_start, bg_noise1)
    small = resize_bilinear_scale_factor(torch.cat([x_maskfilled, fg_mask.to(x_start.dtype)],
                                                   dim=1), scale)
    ns_h, ns_w = small.shape[-2:]
    pad_h1 = min(max((h - ns_h) // 2 + dh, 0), h - ns_h)
    pad_w1 = min(max((w - ns_w) // 2 + dw, 0), w - ns_w)
    canvas = torch.zeros((b, c + 1, h, w), dtype=x_start.dtype, device=dev)
    canvas[:, :, pad_h1:pad_h1 + ns_h, pad_w1:pad_w1 + ns_w] = small
    fg_scaled = canvas[:, c:]
    x_init = torch.where(fg_scaled > 0, canvas[:, :c], bg_noise2)
    return blend_noise * fg_noise_amount + x_init * (1 - fg_noise_amount), fg_scaled
