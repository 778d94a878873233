"""Spatial resizes that BiSeNet and the training losses use, with the JAX
package's index rules.

Counterpart of `resize_nearest`, `resize_bilinear_align_corners` and
`resize_bilinear_half_pixel` in `adaface_tpu/ops/resize.py:25,53,110`,
plain PyTorch. All gather whole rows and columns with integer index
tensors, so the source pixel of every output pixel is the one the JAX
package takes:
- nearest: src = floor(dst · in / out), in integers (the torch/PIL
  'nearest' convention);
- bilinear, align_corners=True: src = dst · (in − 1)/(out − 1) in fp32,
  blended from floor(src) and min(floor(src) + 1, in − 1);
- bilinear, half pixel (`F.interpolate(align_corners=False)` without
  antialiasing): src = (dst + 0.5) · in / out − 0.5, clamped to [0, in − 1].
"""

from __future__ import annotations

import torch


def resize_nearest(x, out_hw: tuple[int, int], spatial_axes: tuple[int, int] = (-2, -1)):
    """Nearest resize along two axes (src_idx = dst_idx · in // out)."""
    ah, aw = spatial_axes
    in_h, in_w = x.shape[ah], x.shape[aw]
    out_h, out_w = out_hw
    if (in_h, in_w) == (out_h, out_w):
        return x
    idx_h = torch.arange(out_h, device=x.device) * in_h // out_h
    idx_w = torch.arange(out_w, device=x.device) * in_w // out_w
    return x.index_select(ah, idx_h).index_select(aw, idx_w)


def resize_bilinear_align_corners(x, out_hw: tuple[int, int],
                                  spatial_axes: tuple[int, int] = (1, 2)):
    """Bilinear resize with align_corners=True, as two separable 1-D gathers."""

    def interp_axis(x, axis, out_n):
        in_n = x.shape[axis]
        if in_n == out_n:
            return x
        src = (torch.arange(out_n, dtype=torch.float32, device=x.device)
               * (max(in_n - 1, 1) / max(out_n - 1, 1)))
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=in_n - 1)
        shape = [1] * x.dim()
        shape[axis] = out_n
        w = (src - lo).reshape(shape).to(x.dtype)
        return x.index_select(axis, lo) * (1 - w) + x.index_select(axis, hi) * w

    x = interp_axis(x, spatial_axes[0], out_hw[0])
    return interp_axis(x, spatial_axes[1], out_hw[1])


def resize_bilinear_half_pixel(x, out_hw: tuple[int, int],
                               spatial_axes: tuple[int, int] = (1, 2)):
    """Bilinear resize with half-pixel centres and no antialiasing, as two
    separable 1-D gathers."""

    def interp_axis(x, axis, out_n):
        in_n = x.shape[axis]
        if in_n == out_n:
            return x
        src = ((torch.arange(out_n, dtype=torch.float32, device=x.device) + 0.5)
               * (in_n / out_n) - 0.5).clamp(0.0, in_n - 1.0)
        lo = torch.floor(src).long()
        hi = torch.clamp(lo + 1, max=in_n - 1)
        shape = [1] * x.dim()
        shape[axis] = out_n
        w = (src - lo).reshape(shape).to(x.dtype)
        return x.index_select(axis, lo) * (1 - w) + x.index_select(axis, hi) * w

    x = interp_axis(x, spatial_axes[0], out_hw[0])
    return interp_axis(x, spatial_axes[1], out_hw[1])
