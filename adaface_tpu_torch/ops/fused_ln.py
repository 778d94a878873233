"""LayerNorm over the last axis: plain PyTorch version, the kernel, the
autograd Function and the module.

Counterpart of `adaface_tpu/ops/fused_ln.py`. The kernel
(`csrc/layer_norm.cu`) normalises each row of a contiguous [rows, C] view
with fp32 statistics and applies the affine; `ln_plan`, a pure function of
shape and dtype, fits the lanes of a warp (or, for few wide rows, the warps
of a block) to the row and the grid to the card. The backward recomputes
through the plain version, as `_ln_bwd` recomputes through `_ln_ref`: the
kernel is forward only. On a CPU tensor the Function takes the plain
version; on a CUDA tensor the wrapper launches the kernel or raises. Both
raise on an input that is not contiguous, rather than copy it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from adaface_tpu_torch.ops import _build

LAYER_NORM = "layer_norm"
MAX_PACKS = 8  # 16-byte packs of a row a lane holds in registers at the most
ROW_LANES = (8, 16, 32)  # lanes of a warp that can share a row
MAX_THREADS = 256
WAVES = 2  # blocks per SM the plan aims at before it stops shrinking the block
MAX_SPLIT = 8  # warps one row is split over at the most
SPLIT_MAX_ROWS = 1024  # rows up to which a wide row is split over warps


@dataclasses.dataclass(frozen=True)
class LnPlan:
    """Geometry of one `layer_norm` launch on [rows, C]."""
    packs: int  # 16-byte packs a lane holds: the row in registers; 0 takes the looped kernel
    lanes: int  # lanes of a warp that share a row
    threads: int  # threads a block
    warps: int = 1  # warps that share a row: above 1 the split kernel, one row a block

    @property
    def rows_per_block(self) -> int:
        return self.threads // (self.lanes * self.warps)

    def blocks(self, rows: int) -> int:
        return -(-rows // self.rows_per_block)


@functools.lru_cache(maxsize=None)  # a handful of shapes on a path; the wrapper asks every call
def ln_plan(rows: int, c: int, dtype, sms: int = 132, aligned: bool = True) -> LnPlan:
    """The `layer_norm` launch for [rows, c]. Where c is whole 16-byte packs,
    the pointers are `aligned` and the fewest lanes of ROW_LANES that hold the
    row in at most MAX_PACKS packs each divide it evenly, the row lives in
    registers (320 bf16 channels: 8 lanes x 5 packs; 640: 16 x 5; 1280: 32 x
    5; 320 fp32: 16 x 5), and the block shrinks from MAX_THREADS to one warp
    until the grid has WAVES blocks an SM. At most SPLIT_MAX_ROWS rows of a
    whole number (2 to MAX_SPLIT) of warps' packs each (1280 bf16 channels: 5
    warps) take the split kernel: a row over the warps of one block, one pack
    a lane (measured on an H100: `chip_compare.py --sweep`). Every other row
    takes the looped kernel, one warp a row, eight rows a block."""
    pack = 16 // torch.empty((), dtype=dtype).element_size()
    if aligned and c % pack == 0:
        warps, rest = divmod(c // pack, 32)
        if rest == 0 and 2 <= warps <= MAX_SPLIT and rows <= SPLIT_MAX_ROWS:
            return LnPlan(1, 32, 32 * warps, warps)
        for lanes in ROW_LANES:
            packs, rest = divmod(c // pack, lanes)
            if rest == 0 and packs <= MAX_PACKS:
                threads = MAX_THREADS
                while threads > 32 and -(-rows // (threads // lanes)) < WAVES * sms:
                    threads //= 2
                return LnPlan(packs, lanes, threads)
    return LnPlan(0, 32, MAX_THREADS)


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


def layer_norm(x, weight, bias, eps: float, plan: LnPlan | None = None):
    """Kernel `layer_norm` on CUDA x [..., C] (contiguous); weight, bias [C]
    of x's dtype; one launch with the geometry of `plan` (`ln_plan`'s unless
    given)."""
    # dtype and layout first: they read no device, so a CPU tensor shows them too
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer norm kernel: dtype {x.dtype} is not supported")
    _check_rows(x)
    c = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"layer norm kernel: {name} must be a contiguous [{c}] "
                             f"{x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"layer norm kernel: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"layer norm kernel: {x.device} is not the current device")
    y = torch.empty_like(x)
    rows = x.numel() // c
    if plan is None:
        aligned = not (x.data_ptr() | weight.data_ptr() | bias.data_ptr() | y.data_ptr()) % 16
        plan = ln_plan(rows, c, x.dtype, _build.sm_count(x.device.index), aligned)
    rc = _build.load_library().layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c, plan.packs,
        plan.lanes, plan.warps, plan.threads, float(eps), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, LAYER_NORM)
    _build.count(LAYER_NORM)
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
