"""GroupNorm (+ SiLU): plain PyTorch version and the hand-written kernels.

Counterpart of `adaface_tpu/ops/fused_gn.py`. Logical shapes
are NCHW; the kernels of `csrc/group_norm_silu.cu` take x in channels-last
memory, i.e. as [B, H·W, C] rows like the TPU kernels, which is the layout
the UNet and the VAE keep inside (`models/unet.py`, `models/vae.py`).

Three kernels, counted apart in `_build.LAUNCHES`:
- `gn_fused`: the whole GroupNorm in one launch, x read once; a thread-block
  cluster holds a (sample, channel slab) in its shared memory;
- `gn_stats` + `gn_norm`: for maps too large for that. `gn_stats` writes
  per-chunk group partials (mean, M2), `gn_norm` folds them and normalizes.
`gn_plan` says which of the two a shape takes, and with what geometry; it
is a pure function of shape, dtype and SM count. `group_norm_silu` follows
it. On a CPU tensor it takes the plain version; on a CUDA tensor it launches
the kernels or raises. Every GroupNorm of the UNet and the VAE goes through
it, as every GroupNorm on the TPU went through the Pallas pair.

Where autograd records the call, `group_norm_silu` is `_GroupNormSiLU`, the
counterpart of the JAX package's custom VJP (`_gn_fwd` / `_gn_bwd`,
`:138-148`): it saves x, scale and bias, and its backward is, on the card,
`gn_stats` for the statistics and the two backward kernels `gn_bwd_reduce`
and `gn_bwd_dx` on the split pair's geometry (`gn_silu_bwd`); on the CPU
`gn_silu_bwd_plain`, the VJP of `_gn_silu_ref` in closed form in fp32.

`gn_silu_chunked` repeats the kernels' arithmetic in plain PyTorch, for the
CPU tests.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn

from adaface_tpu_torch.ops import _build

GN_STATS = "gn_stats"
GN_NORM = "gn_norm"
GN_FUSED = "gn_fused"
GN_BWD_REDUCE = "gn_bwd_reduce"
GN_BWD_DX = "gn_bwd_dx"

SMEM_BYTES = 232448  # dynamic shared memory a block may ask for on sm_90
MAX_CLUSTER = 16  # blocks of a cluster; above 8 is "non-portable", the H100 takes 16
MAX_THREADS = 512
MIN_SLAB = 64  # channels a fused block spans at least: 128-byte row segments in bf16
MIN_ROWS = 8  # rows a block of a cluster gets at least
FUSED_TILE_BYTES = 128 * 1024  # shared memory of a fused block the plan goes up to unforced
SPLIT_MIN_SLAB = 128  # the split pair streams from device memory: longer segments
SPLIT_WAVES = 2  # blocks per SM the split pair aims at
SPLIT_THREADS = 512
SPLIT_MIN_ROWS = 16


def gn_stats_plain(x, groups: int, eps: float):
    """→ [B·G, 2] fp32 (mean, rstd) of x [B, C, ...] in either memory format,
    population variance."""
    xf = x.float().reshape(x.shape[0] * groups, -1)
    mean = xf.mean(dim=1)
    var = xf.var(dim=1, unbiased=False)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def _per_channel(stats, x, groups: int):
    """[B·G, 2] (mean, rstd) → each as [B, C, 1, ...], to broadcast over x."""
    b, c = x.shape[:2]
    per_channel = stats.reshape(b, groups, 2).repeat_interleave(c // groups, dim=1)
    shape = (b, c) + (1,) * (x.dim() - 2)
    return per_channel[..., 0].reshape(shape), per_channel[..., 1].reshape(shape)


def gn_norm_plain(x, stats, scale, bias, groups: int, apply_silu: bool):
    """(x - mean)·rstd·scale + bias per channel, then SiLU when asked; the
    result keeps x's memory format (only broadcasts touch x)."""
    mean, rstd = _per_channel(stats, x, groups)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x.float() - mean) * rstd
    y = y * scale.float().reshape(bshape) + bias.float().reshape(bshape)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def gn_silu_plain(x, scale, bias, groups: int, eps: float, apply_silu: bool = True):
    """The `_gn_silu_ref` math (`adaface_tpu/ops/fused_gn.py:49-59`) on logical NCHW."""
    return gn_norm_plain(x, gn_stats_plain(x, groups, eps), scale, bias,
                         groups, apply_silu)


def gn_finalize_plain(part, rows: int, cpg: int, chunk_rows: int, eps: float):
    """Fold per-chunk group partials [B, G, K, 2] (mean, M2), chunk k over
    min(chunk_rows, rows - k·chunk_rows) rows of cpg channels, into [B·G, 2]
    (mean, rstd): mean = Σ n_k·mean_k / N, M2 = Σ (M2_k + n_k·(mean_k - mean)²),
    the form `combine_chunks` of the kernels uses."""
    b, g, k, _ = part.shape
    n = torch.tensor([min(chunk_rows, rows - i * chunk_rows) * cpg for i in range(k)],
                     dtype=torch.float32, device=part.device)
    total = float(rows * cpg)
    mean = (n * part[..., 0]).sum(-1) / total  # [B, G]
    m2 = (part[..., 1] + n * (part[..., 0] - mean[..., None]) ** 2).sum(-1)
    return torch.stack([mean, torch.rsqrt(m2 / total + eps)], dim=-1).reshape(b * g, 2)


def gn_partials_chunked(x, groups: int, slab: int, chunks: int):
    """The kernels' statistics in plain PyTorch → ([B, G, K, 2], rows per
    chunk): for each chunk of rows and each channel, sums of (x - p) and
    (x - p)² around the pivot p = the chunk's first row give the channel's
    (mean, M2); the channels of a group fold into the group's. `slab` only
    says which channels share a block: the result does not depend on it."""
    b, c = x.shape[:2]
    cpg = c // groups
    if c % slab or slab % cpg:
        raise ValueError(f"slab {slab} is not whole groups of {cpg} of {c} channels")
    rows2 = x.float().reshape(b, c, -1).transpose(1, 2)  # [B, rows, C]
    rows = rows2.shape[1]
    chunk_rows = -(-rows // chunks)
    parts = []
    for r0 in range(0, rows, chunk_rows):
        xs = rows2[:, r0:r0 + chunk_rows]
        n = xs.shape[1]
        d = xs - xs[:, :1]
        s, q = d.sum(1), (d * d).sum(1)  # [B, C]
        cmean = (xs[:, 0] + s / n).reshape(b, groups, cpg)
        cm2 = (q - s * s / n).clamp_min(0.0).reshape(b, groups, cpg)
        gmean = cmean.mean(-1)
        gm2 = (cm2 + n * (cmean - gmean[..., None]) ** 2).sum(-1)
        parts.append(torch.stack([gmean, gm2], dim=-1))
    return torch.stack(parts, dim=2), chunk_rows


def gn_silu_chunked(x, scale, bias, groups: int, eps: float, apply_silu: bool = True,
                    slab: int | None = None, chunks: int = 1):
    """GroupNorm (+ SiLU) with the arithmetic of `csrc/group_norm_silu.cu`:
    chunk partials, the fixed-form fold, then (x - mean)·(rstd·scale) + bias."""
    cpg = x.shape[1] // groups
    part, chunk_rows = gn_partials_chunked(x, groups, slab or cpg, chunks)
    stats = gn_finalize_plain(part, x[0, 0].numel(), cpg, chunk_rows, eps)
    mean, rstd = _per_channel(stats, x, groups)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    y = (x.float() - mean) * (rstd * scale.float().reshape(bshape)) + bias.float().reshape(bshape)
    if apply_silu:
        y = y / (1.0 + torch.exp(-y))
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class GnPlan:
    kernel: str  # "fused": one cluster launch; "split": gn_stats + gn_norm
    slab: int  # channels a block works on: whole groups and whole 16-byte packs
    chunks: int  # blocks that share the rows of one (sample, slab); the cluster size if fused
    threads: int
    smem: int  # bytes of dynamic shared memory of the fused kernel (0 for the split pair)

    def blocks(self, b: int, c: int) -> int:
        return b * (c // self.slab) * self.chunks


def _fused_smem(rows_per: int, slab: int, cpg: int, threads: int, itemsize: int) -> int:
    """`fused_smem` of the source: the tile, then the statistics' scratch."""
    lanes = threads // (slab * itemsize // 16)
    mids = min(lanes, max(1, threads // slab))
    return rows_per * slab * itemsize + 4 * (2 * (lanes + mids) * slab + 3 * slab
                                             + 4 * (slab // cpg))


def _threads(packs: int, packs_per_row: int) -> int:
    """Threads of a fused block: about four packs a thread, a whole number
    of warps, at least a row of packs, 128 to 256 (512 measured slower: the
    lanes' sums pass through shared memory)."""
    want = min(256, max(128, -(-packs // 4)))
    return 32 * -(-max(want, packs_per_row) // 32)


def _slab(c: int, cpg: int, vec: int, least: int) -> int:
    """The smallest whole number of groups that is whole 16-byte packs, at
    least `least` channels wide where C has them, and divides C."""
    base = cpg * vec // math.gcd(cpg, vec)
    mult = next((k for k in range(1, c // base + 1)
                 if (c // base) % k == 0 and base * k >= least), c // base)
    if base * mult // vec > MAX_THREADS:
        raise ValueError(f"group norm kernel: a slab of {base * mult} channels is wider "
                         "than a block")
    return base * mult


@functools.lru_cache(maxsize=None)  # a few dozen shapes on a path; the wrapper asks every call
def gn_plan(dtype, b: int, c: int, rows: int, groups: int, sms: int,
            kernel: str | None = None) -> GnPlan:
    """Which kernel a [B, C, rows] GroupNorm takes, and its geometry.

    Fused when a cluster of at most MAX_CLUSTER blocks holds a (sample,
    slab) in shared memory: the cluster grows (powers of two) until the grid
    has the largest power of two of blocks that is at most half the SMs
    (more, smaller blocks measured no faster), while every block keeps
    MIN_ROWS rows, and further until the tile fits. The fused kernel's
    passes do not overlap, so beyond FUSED_TILE_BYTES a block it loses to
    the split pair reading from L2; such maps, and those no cluster can
    hold, take the split pair, its rows cut so that the grid is SPLIT_WAVES
    blocks per SM. `kernel` forces one of the two (ValueError where the
    fused one cannot hold the map)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    if c % groups or c % vec:
        raise ValueError(f"group norm kernel: {c} channels in {groups} groups of {dtype}: "
                         f"C must be a multiple of the groups and of {vec}")
    cpg = c // groups
    if kernel != "split":
        slab = _slab(c, cpg, vec, MIN_SLAB)

        def fused(cluster):
            rows_per = -(-rows // cluster)
            threads = _threads(rows_per * slab // vec, slab // vec)
            return GnPlan("fused", slab, -(-rows // rows_per), threads,
                          _fused_smem(rows_per, slab, cpg, threads, itemsize))

        limit = SMEM_BYTES if kernel == "fused" else FUSED_TILE_BYTES
        target = 1 << ((sms // 2).bit_length() - 1)  # 64 blocks on 132 SMs
        cluster = 1
        while cluster < MAX_CLUSTER and rows // (2 * cluster) >= MIN_ROWS and (
                b * (c // slab) * cluster < target or fused(cluster).smem > limit):
            cluster *= 2
        if fused(cluster).smem <= limit:
            return fused(cluster)
        if kernel == "fused":
            raise ValueError(f"group norm kernel: [{b}, {c}, {rows}] {dtype} does not fit the "
                             "shared memory of a cluster")
    slab = _slab(c, cpg, vec, SPLIT_MIN_SLAB)
    chunks = max(1, -(-SPLIT_WAVES * sms // (b * (c // slab))))
    rows_per = max(min(SPLIT_MIN_ROWS, rows), -(-rows // chunks))
    return GnPlan("split", slab, -(-rows // rows_per), SPLIT_THREADS, 0)


def plan_for(x, groups: int, kernel: str | None = None) -> GnPlan:
    b, c, h, w = x.shape
    return gn_plan(x.dtype, b, c, h * w, groups, _build.sm_count(x.device.index), kernel)


def _check(x, groups: int):
    """Raise on what the kernels do not take; reads only dtype, shape and
    strides, so it runs on a CPU tensor too."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group norm kernel: dtype {x.dtype} is not supported")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"group norm kernel: x must be [B, C, H, W] in channels-last memory, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if x.shape[1] % groups:
        raise ValueError(f"group norm kernel: {x.shape[1]} channels, {groups} groups")


def _check_cuda(x, groups: int):
    _check(x, groups)
    if x.device.type != "cuda":
        raise ValueError(f"group norm kernel: no kernel for device {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"group norm kernel: {x.device} is not the current device")
    if x.data_ptr() % 16:
        raise ValueError("group norm kernel: x is not 16-byte aligned")


def _check_affine(x, scale, bias):
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"group norm kernel: {name} must be a contiguous, 16-byte aligned "
                             f"[{c}] {x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def _geometry(x, groups: int, plan: GnPlan):
    """The arguments every entry point of the source takes after its pointers."""
    b, c, h, w = x.shape
    return b, h * w, c, groups, plan.slab, plan.chunks, plan.threads


def gn_fused(x, scale, bias, groups: int, eps: float, apply_silu: bool,
             plan: GnPlan | None = None):
    """Kernel `gn_fused` on a channels-last CUDA x [B, C, H, W]: one launch."""
    _check_cuda(x, groups)
    _check_affine(x, scale, bias)
    plan = plan or plan_for(x, groups, "fused")
    y = torch.empty_like(x)
    rc = _build.load_library().gn_fused(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        *_geometry(x, groups, plan), float(eps), int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_FUSED)
    _build.count(GN_FUSED)
    return y


def gn_stats(x, groups: int, plan: GnPlan | None = None):
    """Kernel `gn_stats` on a channels-last CUDA x [B, C, H, W] → group
    partials [B, G, plan.chunks, 2] fp32 (mean, M2), for `gn_norm` (or
    `gn_finalize_plain`) with the same plan."""
    _check_cuda(x, groups)
    plan = plan or plan_for(x, groups, "split")
    part = torch.empty((x.shape[0], groups, plan.chunks, 2), dtype=torch.float32,
                       device=x.device)
    rc = _build.load_library().gn_stats(
        x.data_ptr(), part.data_ptr(), *_geometry(x, groups, plan),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_STATS)
    _build.count(GN_STATS)
    return part


def gn_norm(x, part, scale, bias, groups: int, eps: float, apply_silu: bool,
            plan: GnPlan | None = None):
    """Kernel `gn_norm` on a channels-last CUDA x with `gn_stats`' partials."""
    _check_cuda(x, groups)
    _check_affine(x, scale, bias)
    plan = plan or plan_for(x, groups, "split")
    if (tuple(part.shape) != (x.shape[0], groups, plan.chunks, 2)
            or part.dtype != torch.float32 or part.device != x.device
            or not part.is_contiguous()):
        raise ValueError("group norm kernel: the partials must come from gn_stats with the "
                         "same plan")
    y = torch.empty_like(x)
    rc = _build.load_library().gn_norm(
        x.data_ptr(), part.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        *_geometry(x, groups, plan), float(eps), int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_NORM)
    _build.count(GN_NORM)
    return y


def _group_means(t, groups: int):
    """Per-(sample, group) means of t [B, C, ...] fp32, broadcast back to
    [B, C, 1, ...]."""
    b, c = t.shape[:2]
    m = t.reshape(b, groups, -1).mean(dim=2)
    return m.repeat_interleave(c // groups, dim=1).reshape((b, c) + (1,) * (t.dim() - 2))


def gn_silu_bwd_plain(x, scale, bias, g, groups: int, eps: float, apply_silu: bool = True):
    """The VJP of `_gn_silu_ref` (`adaface_tpu/ops/fused_gn.py:49-60`,
    `:143-148`) in closed form, in fp32: with x̂ the normalized x, z = γx̂ + β
    and dz = g·silu′(z) (or g), dβ = Σdz, dγ = Σdz·x̂ and
    dx = rstd·(γdz - mean_g(γdz) - x̂·mean_g(γdz·x̂)), the means over each
    (sample, group). → (dx in x's dtype, dγ, dβ in theirs)."""
    mean, rstd = _per_channel(gn_stats_plain(x, groups, eps), x, groups)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    xhat = (x.float() - mean) * rstd
    gamma = scale.float().reshape(bshape)
    dz = g.float()
    if apply_silu:
        z = xhat * gamma + bias.float().reshape(bshape)
        sg = torch.sigmoid(z)
        dz = dz * sg * (1.0 + z * (1.0 - sg))
    dims = (0,) + tuple(range(2, x.dim()))
    dbeta, dgamma = dz.sum(dim=dims), (dz * xhat).sum(dim=dims)
    dxhat = dz * gamma
    dx = rstd * (dxhat - _group_means(dxhat, groups) - xhat * _group_means(dxhat * xhat, groups))
    return dx.to(x.dtype), dgamma.to(scale.dtype), dbeta.to(bias.dtype)


def gn_bwd_reduce(x, g, part, scale, bias, groups: int, eps: float, apply_silu: bool,
                  plan: GnPlan):
    """Kernel `gn_bwd_reduce` on channels-last CUDA x and g with `gn_stats`'
    partials of the same split plan → [B, plan.chunks, C, 2] fp32: each
    chunk's per-channel (Σdz, Σdz·x̂)."""
    b, c = x.shape[:2]
    sums = torch.empty((b, plan.chunks, c, 2), dtype=torch.float32, device=x.device)
    rc = _build.load_library().gn_bwd_reduce(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        sums.data_ptr(), *_geometry(x, groups, plan), float(eps), int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_BWD_REDUCE)
    _build.count(GN_BWD_REDUCE)
    return sums


def gn_bwd_dx(x, g, part, sums, scale, bias, groups: int, eps: float, apply_silu: bool,
              plan: GnPlan):
    """Kernel `gn_bwd_dx`: dx of x's dtype and memory format."""
    dx = torch.empty_like(x)
    rc = _build.load_library().gn_bwd_dx(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), sums.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), *_geometry(x, groups, plan), float(eps),
        int(apply_silu), int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_BWD_DX)
    _build.count(GN_BWD_DX)
    return dx


def gn_silu_bwd(x, scale, bias, g, groups: int, eps: float, apply_silu: bool = True):
    """The backward on channels-last CUDA tensors: `gn_stats`, `gn_bwd_reduce`,
    `gn_bwd_dx` on the split plan; dγ and dβ are the (sample, chunk) sums of
    the reduce's partials. → (dx, dγ, dβ), the function of
    `gn_silu_bwd_plain`."""
    _check_cuda(x, groups)
    _check_affine(x, scale, bias)
    g = g.contiguous(memory_format=torch.channels_last)
    if g.shape != x.shape or g.dtype != x.dtype or g.data_ptr() % 16:
        raise ValueError(f"group norm backward: g must be like x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(g.shape)} {g.dtype}")
    plan = plan_for(x, groups, "split")
    part = gn_stats(x, groups, plan)
    sums = gn_bwd_reduce(x, g, part, scale, bias, groups, eps, apply_silu, plan)
    dx = gn_bwd_dx(x, g, part, sums, scale, bias, groups, eps, apply_silu, plan)
    dbeta, dgamma = sums.sum(dim=(0, 1)).unbind(dim=-1)
    return dx, dgamma.to(scale.dtype), dbeta.to(bias.dtype)


def _gn_forward(x, scale, bias, groups: int, eps: float, apply_silu: bool):
    if x.device.type == "cpu":
        return gn_silu_plain(x, scale, bias, groups, eps, apply_silu)
    _check_cuda(x, groups)
    plan = plan_for(x, groups)
    if plan.kernel == "fused":
        return gn_fused(x, scale, bias, groups, eps, apply_silu, plan)
    return gn_norm(x, gn_stats(x, groups, plan), scale, bias, groups, eps, apply_silu, plan)


class _GroupNormSiLU(torch.autograd.Function):
    """GroupNorm (+ SiLU) with its backward: kernels on the card, the closed
    form on the CPU."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float, apply_silu: bool):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps, ctx.apply_silu = groups, eps, apply_silu
        ctx.shape = tuple(x.shape)  # read by launch censuses without unpacking the saved tensors
        return _gn_forward(x, scale, bias, groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        bwd = gn_silu_bwd_plain if x.device.type == "cpu" else gn_silu_bwd
        dx, dgamma, dbeta = bwd(x, scale, bias, g, ctx.groups, ctx.eps, ctx.apply_silu)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, None, None, None)


def group_norm_silu(x, scale, bias, groups: int, eps: float, apply_silu: bool = True):
    """GroupNorm (+ SiLU) on x [B, C, H, W]: the plain version on the CPU
    (either memory format); on CUDA the kernel `gn_plan` names, which takes
    channels-last memory only. Recorded by autograd as `_GroupNormSiLU` when
    an input requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)
    return _gn_forward(x, scale, bias, groups, eps, apply_silu)


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
