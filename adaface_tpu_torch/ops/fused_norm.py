"""Train-mode batch norm + leaky-ReLU: plain PyTorch versions, the kernels,
and the autograd Function around them.

Counterpart of `adaface_tpu/ops/fused_norm.py` (the InPlace-ABN stand-in),
in the JAX layout: the last axis is C, any leading axes, and the kernels see
`x` as a contiguous [R, C] view (R = N·H·W). BiSeNet keeps its activations
channels_last, so its NCHW tensors permuted to NHWC are such views.

Two kernels (`csrc/batch_norm_act.cu`), each with its plain version beside it:
- `bn_stats`: per-channel mean and rstd = 1/sqrt(E[x²] − mean² + eps), fp32;
- `bn_norm_act`: (x − mean)·rstd·scale + bias, then leaky-ReLU at `slope`
  (0 is ReLU, 1 is the identity).
On a CPU tensor the wrappers' callers take the plain versions; on a CUDA
tensor the wrappers launch the kernels or raise.

`fused_bn_act` is a `torch.autograd.Function`. Its backward is plain
PyTorch, as the JAX backward was XLA. For slope ≠ 0 it keeps only
(y, mean, rstd, scale, bias) and inverts the activation, as `_fused_bwd`
does. For slope = 0 the activation cannot be inverted: the JAX package's
inversion loses every clipped unit and passes the gradient through the
clipped −0.0. Here the forward then also keeps x, and the backward is the
true ReLU gradient, the autodiff of the JAX forward. Sync-BN (`axis_name`)
is not ported.
"""

from __future__ import annotations

import torch

from adaface_tpu_torch.ops import _build

BN_STATS = "bn_stats"
BN_NORM_ACT = "bn_norm_act"
# rows each block of the statistics pass sums at the least, and the blocks
# the pass aims for: 8 per SM of an H100
_STATS_MIN_ROWS = 32
_STATS_TARGET_BLOCKS = 132 * 8


def bn_stats_plain(x2, eps: float):
    """[R, C] → (mean, rstd), each [C] fp32, as `_fused_bn_act_fwd_xla`."""
    xf = x2.float()
    count = x2.shape[0]
    mean = xf.sum(0) / count
    var = (xf * xf).sum(0) / count - mean * mean
    return mean, torch.rsqrt(var + eps)


def bn_norm_act_plain(x2, mean, rstd, scale, bias, slope: float):
    y = (x2.float() - mean) * rstd * scale.float() + bias.float()
    return torch.where(y >= 0, y, y * slope).to(x2.dtype)


def fused_bn_act_plain(x, scale, bias, slope: float = 0.01, eps: float = 1e-5):
    """The `_fused_bn_act_fwd_xla` math (`adaface_tpu/ops/fused_norm.py:108-122`)."""
    x2 = x.reshape(-1, x.shape[-1])
    mean, rstd = bn_stats_plain(x2, eps)
    return bn_norm_act_plain(x2, mean, rstd, scale, bias, slope).reshape(x.shape)


def _check(x2):
    if x2.device.type != "cuda":
        raise ValueError(f"batch norm kernel: no kernel for device {x2.device}")
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"batch norm kernel: dtype {x2.dtype} is not supported")
    if x2.dim() != 2 or not x2.is_contiguous() or x2.numel() == 0:
        raise ValueError(f"batch norm kernel: x must be a contiguous non-empty [R, C], "
                         f"got shape {tuple(x2.shape)} strides {x2.stride()}")
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"batch norm kernel: {x2.device} is not the current device")


def _check_channel_vector(name, t, c, device):
    if (tuple(t.shape) != (c,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"batch norm kernel: {name} must be a contiguous [{c}] fp32 "
                         f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def bn_stats(x2, eps: float):
    """Kernel `bn_stats` on CUDA x2 [R, C] → (mean, rstd), each [C] fp32.

    Blocks sum fixed row chunks into a [chunks, C] workspace; a second pass
    combines the chunks in a fixed order, so the sums repeat run to run."""
    _check(x2)
    r, c = x2.shape
    cblocks = -(-c // 32)
    chunks = max(1, min(-(-r // _STATS_MIN_ROWS), _STATS_TARGET_BLOCKS // cblocks))
    partial = torch.empty((2, chunks, c), dtype=torch.float32, device=x2.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    rc = _build.load_library().bn_stats(
        x2.data_ptr(), partial.data_ptr(), stats.data_ptr(), r, c, chunks, float(eps),
        int(x2.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, BN_STATS)
    _build.LAUNCHES[BN_STATS] += 1
    return stats[0], stats[1]


def bn_norm_act(x2, mean, rstd, scale, bias, slope: float):
    """Kernel `bn_norm_act` on CUDA x2 [R, C]; mean and rstd from `bn_stats`,
    scale and bias [C] (taken in fp32)."""
    _check(x2)
    c = x2.shape[1]
    scale, bias = scale.float(), bias.float()
    for name, t in (("mean", mean), ("rstd", rstd), ("scale", scale), ("bias", bias)):
        _check_channel_vector(name, t, c, x2.device)
    y = torch.empty_like(x2)
    rc = _build.load_library().bn_norm_act(
        x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), x2.shape[0], c, float(slope), int(x2.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, BN_NORM_ACT)
    _build.LAUNCHES[BN_NORM_ACT] += 1
    return y


class _FusedBNAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, slope: float, eps: float):
        if x2.device.type == "cpu":
            mean, rstd = bn_stats_plain(x2, eps)
            y = bn_norm_act_plain(x2, mean, rstd, scale, bias, slope)
        else:
            mean, rstd = bn_stats(x2, eps)
            y = bn_norm_act(x2, mean, rstd, scale, bias, slope)
        ctx.slope = slope
        # the "in-place" residuals; x only where the activation is not invertible
        ctx.save_for_backward(y, mean, rstd, scale, bias, x2 if slope == 0 else None)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, g, _gmean, _grstd):
        y, mean, rstd, scale, bias, x2 = ctx.saved_tensors
        slope = ctx.slope
        yf, gf, sf = y.float(), g.float(), scale.float()
        if slope == 0:
            dz = torch.where(yf > 0, gf, 0.0)
            xhat = (x2.float() - mean) * rstd
        else:
            # invert the leaky-ReLU from the output (`_fused_bwd`)
            z = torch.where(yf >= 0, yf, yf / slope)
            dz = torch.where(yf >= 0, gf, gf * slope)
            safe_scale = torch.where(sf.abs() < 1e-12, 1e-12, sf)
            xhat = (z - bias.float()) / safe_scale
        count = y.shape[0]
        sum_dz = dz.sum(0)
        sum_dz_xhat = (dz * xhat).sum(0)
        dx = rstd * (dz * sf - sum_dz * sf / count - xhat * sum_dz_xhat * sf / count)
        return (dx.to(y.dtype), sum_dz_xhat.to(scale.dtype), sum_dz.to(bias.dtype),
                None, None)


def fused_bn_act_stats(x, scale, bias, slope: float = 0.01, eps: float = 1e-5):
    """Train-mode BN + leaky-ReLU over the last axis → (y, mean, rstd).

    x [..., C] must view as a contiguous [R, C]: this raises on any other
    layout rather than copy it."""
    x2 = x.view(-1, x.shape[-1])
    y, mean, rstd = _FusedBNAct.apply(x2, scale, bias, float(slope), float(eps))
    return y.view(x.shape), mean, rstd


def fused_bn_act(x, scale, bias, slope: float = 0.01, eps: float = 1e-5):
    """Train-mode BN + leaky-ReLU over the last axis of x [..., C]."""
    return fused_bn_act_stats(x, scale, bias, slope, eps)[0]
