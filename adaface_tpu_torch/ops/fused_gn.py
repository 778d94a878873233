"""GroupNorm (+ SiLU): plain PyTorch version and the hand-written kernel.

Counterpart of `adaface_tpu/ops/fused_gn.py` (forward only), on NCHW
contiguous tensors: group g of sample b is one contiguous span of
(C/G)·H·W elements, which `csrc/group_norm_silu.cu` exploits.

Two kernels, each with its plain version beside it:
- `gn_stats`: per-(sample, group) mean and rstd = 1/sqrt(var + eps), fp32;
- `gn_norm`: (x - mean)·rstd·scale + bias, then SiLU when asked.
`group_norm_silu` runs the two. On a CPU tensor it takes the plain versions;
on a CUDA tensor it launches the kernels or raises. Every GroupNorm of the
UNet and the VAE goes through it, as every GroupNorm on the TPU went through
the Pallas pair.
"""

from __future__ import annotations

import torch
from torch import nn

from adaface_tpu_torch.ops import _build

GN_STATS = "gn_stats"
GN_NORM = "gn_norm"


def gn_stats_plain(x, groups: int, eps: float):
    """→ [B·G, 2] fp32 (mean, rstd) of NCHW x, population variance."""
    xf = x.float().reshape(x.shape[0] * groups, -1)
    mean = xf.mean(dim=1)
    var = xf.var(dim=1, unbiased=False)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def gn_norm_plain(x, stats, scale, bias, groups: int, apply_silu: bool):
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    st = stats.reshape(b, groups, 2)
    y = ((xf - st[..., :1]) * st[..., 1:]).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    y = y * scale.float().reshape(bshape) + bias.float().reshape(bshape)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def gn_silu_plain(x, scale, bias, groups: int, eps: float, apply_silu: bool = True):
    """The `_gn_silu_ref` math (`adaface_tpu/ops/fused_gn.py:49-59`) on NCHW."""
    return gn_norm_plain(x, gn_stats_plain(x, groups, eps), scale, bias,
                         groups, apply_silu)


def _check(x, groups: int):
    if x.device.type != "cuda":
        raise ValueError(f"group norm kernel: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group norm kernel: dtype {x.dtype} is not supported")
    if x.dim() < 3 or not x.is_contiguous():
        raise ValueError(f"group norm kernel: x must be contiguous [B, C, ...], "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.shape[1] % groups:
        raise ValueError(f"group norm kernel: {x.shape[1]} channels, {groups} groups")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"group norm kernel: {x.device} is not the current device")


def gn_stats(x, groups: int, eps: float):
    """Kernel `gn_stats` on CUDA x [B, C, ...] → [B·G, 2] fp32."""
    _check(x, groups)
    bg = x.shape[0] * groups
    stats = torch.empty((bg, 2), dtype=torch.float32, device=x.device)
    rc = _build.load_library().gn_stats(
        x.data_ptr(), stats.data_ptr(), bg, x.numel() // bg, float(eps),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_STATS)
    _build.LAUNCHES[GN_STATS] += 1
    return stats


def gn_norm(x, stats, scale, bias, groups: int, apply_silu: bool):
    """Kernel `gn_norm` on CUDA x [B, C, ...] with stats from `gn_stats`."""
    _check(x, groups)
    b, c = x.shape[:2]
    for name, t in (("scale", scale), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"group norm kernel: {name} must be a contiguous [{c}] "
                             f"{x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (tuple(stats.shape) != (b * groups, 2) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError("group norm kernel: stats must come from gn_stats")
    y = torch.empty_like(x)
    rc = _build.load_library().gn_norm(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), x.numel(), x.numel() // (b * c), c, groups, int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_NORM)
    _build.LAUNCHES[GN_NORM] += 1
    return y


def group_norm_silu(x, scale, bias, groups: int, eps: float, apply_silu: bool = True):
    """GroupNorm (+ SiLU) on NCHW x; the kernels on CUDA, plain on the CPU."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, scale, bias, groups, eps, apply_silu)
    return gn_norm(x, gn_stats(x, groups, eps), scale, bias, groups, apply_silu)


class GroupNorm(nn.Module):
    """GroupNorm module over `group_norm_silu`; SiLU is chosen per call."""

    def __init__(self, channels: int, groups: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = groups
        self.eps = eps

    def forward(self, x, silu: bool = False):
        return group_norm_silu(x, self.weight, self.bias, self.groups, self.eps, silu)
