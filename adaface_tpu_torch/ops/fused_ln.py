"""LayerNorm over the last axis: plain PyTorch version, the kernel, the
autograd Function and the module.

Counterpart of `adaface_tpu/ops/fused_ln.py`. The kernel
(`csrc/layer_norm.cu`) normalises each row of a contiguous [rows, C] view
with fp32 statistics and applies the affine. The backward recomputes
through the plain version, as `_ln_bwd` recomputes through `_ln_ref`: the
kernel is forward only. On a CPU tensor the Function takes the plain
version; on a CUDA tensor the wrapper launches the kernel or raises. Both
raise on an input that is not contiguous, rather than copy it.
"""

from __future__ import annotations

import torch
from torch import nn

from adaface_tpu_torch.ops import _build

LAYER_NORM = "layer_norm"


def layer_norm_plain(x, weight, bias, eps: float):
    """The `_ln_ref` math (`adaface_tpu/ops/fused_ln.py:37-42`)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _check_rows(x):
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"layer norm: x must be contiguous and non-empty, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")


def layer_norm(x, weight, bias, eps: float):
    """Kernel `layer_norm` on CUDA x [..., C] (contiguous); weight, bias [C]
    of x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"layer norm kernel: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer norm kernel: dtype {x.dtype} is not supported")
    _check_rows(x)
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"layer norm kernel: {x.device} is not the current device")
    c = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer norm kernel: {name} must be a contiguous [{c}] "
                             f"{x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    y = torch.empty_like(x)
    rc = _build.load_library().layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // c, c,
        float(eps), int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, LAYER_NORM)
    _build.LAUNCHES[LAYER_NORM] += 1
    return y


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        _check_rows(x)  # on every device, so that the CPU tests see the layout too
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_plain(x, weight, bias, eps)
        return layer_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = layer_norm_plain(*inputs, ctx.eps)
        return (*torch.autograd.grad(y, inputs, g), None)


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of x; the kernel on CUDA."""
    return _LayerNormFn.apply(x, weight, bias, float(eps))


class LayerNorm(nn.Module):
    """LayerNorm module over `fused_layer_norm`, with `weight` and `bias`
    named as `nn.LayerNorm`'s."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        return fused_layer_norm(x, self.weight, self.bias, self.eps)
