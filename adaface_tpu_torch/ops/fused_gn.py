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
`:138-148`): its forward keeps the (mean, rstd) the kernel used ([B, G, 2]
fp32, written by the forward kernel itself) and saves them with x, scale and
bias; its backward (`gn_silu_bwd`) reads them and launches what
`gn_bwd_plan` names: `gn_bwd_fused`, one cluster launch, for every map a
cluster's shared memory holds, else `gn_bwd_reduce` + `gn_bwd_dx`. On the
CPU the backward is `gn_silu_bwd_plain`, the VJP of `_gn_silu_ref` in closed
form in fp32.

`gn_silu_chunked` and `gn_silu_bwd_tiled` repeat the kernels' arithmetic in
plain PyTorch, for the CPU tests.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import torch
from torch import nn

from adaface_tpu_torch.ops import _build

GN_STATS = "gn_stats"
GN_NORM = "gn_norm"
GN_FUSED = "gn_fused"
GN_BWD_FUSED = "gn_bwd_fused"
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
# the backward (`gn_bwd_plan`)
BWD_TILE_BYTES = 112 * 1024  # a fused backward block's shared memory the plan aims under: 2 an SM
BWD_MAX_STAGES = 8  # the mbarriers a fused backward block's rows land on (`kMaxStages`)
BWD_STAGE_ROWS = 32  # rows a stage holds at least
BWD_MAX_BOX = 256  # rows, and channels, of a stage's tensor-map box at most
BWD_SPLIT_THREADS = 256
BWD_SPLIT_WAVES = 2  # blocks per SM the split backward aims at (a sweep: 2 won or tied 4)

# backward calls whose incoming gradient was not in channels-last memory and
# was copied to it (`gn_silu_bwd`), by shape: a training path should have none
G_COPIES: collections.Counter = collections.Counter()


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


def _packs(dtype, c: int, groups: int) -> tuple[int, int]:
    """(bytes an element, elements a 16-byte pack) of `dtype`, where C is a
    whole number of groups and of packs."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    if c % groups or c % vec:
        raise ValueError(f"group norm kernel: {c} channels in {groups} groups of {dtype}: "
                         f"C must be a multiple of the groups and of {vec}")
    return itemsize, vec


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
    itemsize, vec = _packs(dtype, c, groups)
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


@dataclasses.dataclass(frozen=True)
class GnBwdPlan:
    kernel: str  # "fused": gn_bwd_fused, one cluster launch; "split": gn_bwd_reduce + gn_bwd_dx
    slab: int  # channels a block works on: whole groups and whole 16-byte packs
    chunks: int  # blocks that share the rows of one (sample, slab); the cluster size if fused
    threads: int
    stage_rows: int  # fused: rows a stage of a block's loads holds (0 for the split pair)
    smem: int  # fused: bytes of dynamic shared memory a block (0 for the split pair)


def _bwd_fused_smem(rows_per: int, slab: int, cpg: int, threads: int, stage_rows: int,
                    itemsize: int) -> int:
    """`bwd_fused_smem` of the source: the x and dy tiles (whole stages of
    rows), the stages' barriers, then the lanes' and the block's sums."""
    lanes = threads // (slab * itemsize // 16)
    tile_rows = -(-rows_per // stage_rows) * stage_rows
    return (2 * tile_rows * slab * itemsize + 8 * BWD_MAX_STAGES
            + 4 * (2 * lanes * slab + 2 * slab + 6 * (slab // cpg)))


def fused_bwd_geometry(dtype, c: int, rows: int, groups: int, cluster: int,
                       stages: int | None = None) -> GnBwdPlan:
    """The fused backward's geometry at a cluster size: the slab of at least
    MIN_SLAB channels, `_threads`' threads, and stages of at least
    BWD_STAGE_ROWS rows unless given; `smem` over SMEM_BYTES where it cannot
    run (a tile too large, or a box over BWD_MAX_BOX a side)."""
    itemsize, vec = _packs(dtype, c, groups)
    cpg = c // groups
    slab = _slab(c, cpg, vec, MIN_SLAB)
    rows_per = -(-rows // cluster)
    threads = _threads(rows_per * slab // vec, slab // vec)
    stages = stages or min(BWD_MAX_STAGES, max(1, rows_per // BWD_STAGE_ROWS))
    stage_rows = 8 * -(-rows_per // (8 * stages))  # whole 8-row groups: 128-byte boxes
    smem = _bwd_fused_smem(rows_per, slab, cpg, threads, stage_rows, itemsize)
    if stage_rows > BWD_MAX_BOX or slab > BWD_MAX_BOX:
        smem = SMEM_BYTES + 1  # a box of the tensor map spans at most 256 a side
    return GnBwdPlan("fused", slab, -(-rows // rows_per), threads, stage_rows, smem)


def split_bwd_geometry(dtype, b: int, c: int, rows: int, groups: int, sms: int,
                       threads: int = BWD_SPLIT_THREADS,
                       waves: int = BWD_SPLIT_WAVES) -> GnBwdPlan:
    """The split pair's geometry: slabs of at least SPLIT_MIN_SLAB channels,
    rows cut so that the grid is `waves` blocks of `threads` per SM."""
    _, vec = _packs(dtype, c, groups)
    slab = _slab(c, c // groups, vec, SPLIT_MIN_SLAB)
    chunks = max(1, -(-waves * sms // (b * (c // slab))))
    rows_per = max(min(SPLIT_MIN_ROWS, rows), -(-rows // chunks))
    return GnBwdPlan("split", slab, -(-rows // rows_per), threads, 0, 0)


@functools.lru_cache(maxsize=None)  # like gn_plan: asked at every forward autograd records
def gn_bwd_plan(dtype, b: int, c: int, rows: int, groups: int, sms: int,
                kernel: str | None = None) -> GnBwdPlan:
    """Which backward a [B, C, rows] GroupNorm takes, and its geometry.

    Fused when a cluster of at most MAX_CLUSTER blocks holds a (sample,
    slab)'s x and dy in shared memory (`fused_bwd_geometry`): the cluster
    grows (powers of two) until the grid has the largest power of two of
    blocks that is at most the SM count and a block fits SMEM_BYTES, while
    every block keeps MIN_ROWS rows; it grows further until a block's tiles
    are at most BWD_TILE_BYTES (two blocks an SM) or the cluster is
    MAX_CLUSTER, unless the grid is one wave of clusters of 1 or 2 blocks
    (the sweep, `chip_compare.py --gn-bwd-plans`: such whole-SM tiles ran
    1.5x faster than two blocks an SM at 16x320x32²; the same tiles in
    clusters of 8, at 2x640x64², 1.2x slower). Maps no cluster holds take
    the split pair (`split_bwd_geometry`). `kernel` forces one of the two
    (ValueError where the fused one cannot hold the map). Whether the card can co-schedule the
    fused plan's cluster is asked of the card at its first launch
    (`gn_bwd_fused`)."""
    _packs(dtype, c, groups)
    if kernel != "split":
        slab = fused_bwd_geometry(dtype, c, rows, groups, 1).slab
        target = 1 << (sms.bit_length() - 1)  # 128 blocks on 132 SMs

        def grow(cluster):
            blocks = b * (c // slab) * cluster
            smem = fused_bwd_geometry(dtype, c, rows, groups, cluster).smem
            # one wave of clusters of 1 or 2 takes whole-SM tiles; else two blocks an SM
            return blocks < target or smem > SMEM_BYTES or (
                smem > BWD_TILE_BYTES and (blocks > sms or cluster > 2))

        cluster = 1
        while cluster < MAX_CLUSTER and rows // (2 * cluster) >= MIN_ROWS and grow(cluster):
            cluster *= 2
        plan = fused_bwd_geometry(dtype, c, rows, groups, cluster)
        if plan.smem <= SMEM_BYTES:
            return plan
        if kernel == "fused":
            raise ValueError(f"group norm backward: [{b}, {c}, {rows}] {dtype} does not fit the "
                             "shared memory of a cluster")
    return split_bwd_geometry(dtype, b, c, rows, groups, sms)


def bwd_plan_for(x, groups: int, kernel: str | None = None) -> GnBwdPlan:
    b, c, h, w = x.shape
    return gn_bwd_plan(x.dtype, b, c, h * w, groups, _build.sm_count(x.device.index), kernel)


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


def _geometry(x, groups: int, plan: GnPlan | GnBwdPlan):
    """The arguments every entry point of the source takes after its pointers."""
    b, c, h, w = x.shape
    return b, h * w, c, groups, plan.slab, plan.chunks, plan.threads


def _ptr(t):
    """A tensor's address for the library, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


def gn_fused(x, scale, bias, groups: int, eps: float, apply_silu: bool,
             plan: GnPlan | None = None, stats=None):
    """Kernel `gn_fused` on a channels-last CUDA x [B, C, H, W]: one launch.
    `stats`: a [B, G, 2] fp32 tensor the kernel fills with the (mean, rstd)
    it used, or None."""
    _check_cuda(x, groups)
    _check_affine(x, scale, bias)
    plan = plan or plan_for(x, groups, "fused")
    y = torch.empty_like(x)
    rc = _build.load_library().gn_fused(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), _ptr(stats),
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
            plan: GnPlan | None = None, stats=None):
    """Kernel `gn_norm` on a channels-last CUDA x with `gn_stats`' partials;
    `stats` as `gn_fused`'s."""
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
        _ptr(stats), *_geometry(x, groups, plan), float(eps), int(apply_silu),
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


def _xhat_dz(x, scale, bias, g, stats, groups: int, apply_silu: bool):
    """(x̂, dz) in fp32 from (mean, rstd) `stats` [B·G, 2]: dz = g·silu′(z)
    with z = γx̂ + β, or g; and rstd per channel."""
    mean, rstd = _per_channel(stats, x, groups)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    xhat = (x.float() - mean) * rstd
    dz = g.float()
    if apply_silu:
        z = xhat * scale.float().reshape(bshape) + bias.float().reshape(bshape)
        sg = torch.sigmoid(z)
        dz = dz * sg * (1.0 + z * (1.0 - sg))
    return xhat, dz, rstd


def gn_silu_bwd_plain(x, scale, bias, g, groups: int, eps: float, apply_silu: bool = True,
                      stats=None):
    """The VJP of `_gn_silu_ref` (`adaface_tpu/ops/fused_gn.py:49-60`,
    `:143-148`) in closed form, in fp32: with x̂ the normalized x, z = γx̂ + β
    and dz = g·silu′(z) (or g), dβ = Σdz, dγ = Σdz·x̂ and
    dx = rstd·(γdz - mean_g(γdz) - x̂·mean_g(γdz·x̂)), the means over each
    (sample, group). `stats`: the forward's (mean, rstd) [B, G, 2], else
    taken from x. → (dx in x's dtype, dγ, dβ in theirs)."""
    stats = gn_stats_plain(x, groups, eps) if stats is None else stats.reshape(-1, 2)
    xhat, dz, rstd = _xhat_dz(x, scale, bias, g, stats, groups, apply_silu)
    dims = (0,) + tuple(range(2, x.dim()))
    dbeta, dgamma = dz.sum(dim=dims), (dz * xhat).sum(dim=dims)
    dxhat = dz * scale.float().reshape((1, -1) + (1,) * (x.dim() - 2))
    dx = rstd * (dxhat - _group_means(dxhat, groups) - xhat * _group_means(dxhat * xhat, groups))
    return dx.to(x.dtype), dgamma.to(scale.dtype), dbeta.to(bias.dtype)


def gn_silu_bwd_tiled(x, scale, bias, g, stats, groups: int, apply_silu: bool = True,
                      chunks: int = 1):
    """The backward kernels' arithmetic in plain PyTorch, for the CPU tests:
    the forward's (mean, rstd) `stats` [B, G, 2] taken as given; per
    (sample, chunk of rows: a block of `gn_bwd_fused`'s cluster or of
    `gn_bwd_reduce`) each channel's Σdz and Σdz·x̂; those γ-weighted into the
    chunk's group sums, folded over the chunks in order (the cluster's ranks,
    the reduce's chunks); dx = rstd·(γdz - A/N - x̂·Q/N) from them; dβ and
    dγ the channels' chunk sums folded in order, then over the batch (which
    channels share a block changes no sum). → (dx in x's dtype, dγ, dβ in
    theirs)."""
    b, c = x.shape[:2]
    cpg = c // groups
    xhat, dz, rstd = _xhat_dz(x, scale, bias, g, stats.reshape(-1, 2), groups, apply_silu)
    rows = x[0, 0].numel()
    chunk_rows = -(-rows // chunks)
    dz_rows, dzx_rows = dz.reshape(b, c, rows), (dz * xhat).reshape(b, c, rows)
    s1 = torch.stack([dz_rows[..., r0:r0 + chunk_rows].sum(-1)
                      for r0 in range(0, rows, chunk_rows)], dim=1)  # [B, K, C]
    s2 = torch.stack([dzx_rows[..., r0:r0 + chunk_rows].sum(-1)
                      for r0 in range(0, rows, chunk_rows)], dim=1)
    gamma = scale.float()
    parts = [((s * gamma).reshape(b, -1, groups, cpg).sum(-1)) for s in (s1, s2)]  # [B, K, G]

    def in_order(t, dim):
        out = t.select(dim, 0)
        for k in range(1, t.shape[dim]):
            out = out + t.select(dim, k)
        return out

    n = float(rows * cpg)
    bshape = (b, c) + (1,) * (x.dim() - 2)
    c1, c2 = (in_order(p, 1).repeat_interleave(cpg, dim=1).reshape(bshape) / n for p in parts)
    dx = rstd * (dz * gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) - c1 - xhat * c2)
    dbeta, dgamma = (in_order(in_order(s, 1), 0) for s in (s1, s2))
    return dx.to(x.dtype), dgamma.to(scale.dtype), dbeta.to(bias.dtype)


def _check_bwd(x, g, stats, groups: int):
    """Raise on a g or statistics the backward kernels do not take (x itself
    is `_check`'s); reads only dtype, shape, strides and device, so it runs
    on CPU tensors too."""
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"group norm backward: g must be like x {tuple(x.shape)} {x.dtype} in "
                         f"channels-last memory, got {tuple(g.shape)} {g.dtype} strides "
                         f"{g.stride()}")
    if stats is None or (tuple(stats.shape) != (x.shape[0], groups, 2)
                         or stats.dtype != torch.float32 or stats.device != x.device
                         or not stats.is_contiguous()):
        raise ValueError(f"group norm backward: needs the forward's statistics, a contiguous "
                         f"[{x.shape[0]}, {groups}, 2] fp32 tensor on {x.device}")


def _check_bwd_cuda(x, g, stats, scale, bias, groups: int):
    _check_cuda(x, groups)
    _check_affine(x, scale, bias)
    _check_bwd(x, g, stats, groups)
    if g.data_ptr() % 16:
        raise ValueError("group norm backward: g is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _co_scheduled(dtype, index: int, cluster: int, threads: int, smem: int) -> int:
    """Clusters of a fused backward geometry the card holds at once (asked of
    the card once per geometry); raises where it holds none."""
    import ctypes

    active = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _build.load_library().gn_bwd_fused_clusters(
            cluster, threads, smem, int(dtype == torch.bfloat16), ctypes.byref(active))
    _build.check(rc, GN_BWD_FUSED)
    if active.value < 1:
        raise RuntimeError(f"{GN_BWD_FUSED}: the card cannot co-schedule a cluster of {cluster} "
                           f"blocks of {threads} threads and {smem} bytes of shared memory")
    return active.value


def gn_bwd_fused(x, g, stats, scale, bias, groups: int, apply_silu: bool,
                 plan: GnBwdPlan | None = None, channel_sums: bool = False):
    """Kernel `gn_bwd_fused` on channels-last CUDA x and g with the forward's
    `stats` [B, G, 2]: one launch → (dx of x's dtype and memory format,
    [2, B, C] fp32 per-(sample, channel) Σdz and Σdz·x̂ where `channel_sums`,
    else None)."""
    _check_bwd_cuda(x, g, stats, scale, bias, groups)
    plan = plan or bwd_plan_for(x, groups, "fused")
    _co_scheduled(x.dtype, x.device.index, plan.chunks, plan.threads, plan.smem)
    dx = torch.empty_like(x)
    sums = (torch.empty((2, x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
            if channel_sums else None)
    rc = _build.load_library().gn_bwd_fused(
        x.data_ptr(), g.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        dx.data_ptr(), _ptr(sums), *_geometry(x, groups, plan), plan.stage_rows,
        int(apply_silu), int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_BWD_FUSED)
    _build.count(GN_BWD_FUSED)
    return dx, sums


def gn_bwd_reduce(x, g, stats, scale, bias, groups: int, apply_silu: bool,
                  plan: GnBwdPlan | None = None, channel_sums: bool = False):
    """Kernel `gn_bwd_reduce` on channels-last CUDA x and g with the forward's
    `stats` → ([B, G, plan.chunks, 2] fp32 each chunk's γ-weighted group sums
    (Σ γΣdz, Σ γΣdz·x̂) for `gn_bwd_dx` with the same plan, [2, B,
    plan.chunks, C] fp32 each chunk's per-channel Σdz and Σdz·x̂ where
    `channel_sums`, else None)."""
    _check_bwd_cuda(x, g, stats, scale, bias, groups)
    plan = plan or bwd_plan_for(x, groups, "split")
    b, c = x.shape[:2]
    gpart = torch.empty((b, groups, plan.chunks, 2), dtype=torch.float32, device=x.device)
    sums = (torch.empty((2, b, plan.chunks, c), dtype=torch.float32, device=x.device)
            if channel_sums else None)
    rc = _build.load_library().gn_bwd_reduce(
        x.data_ptr(), g.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        gpart.data_ptr(), _ptr(sums), *_geometry(x, groups, plan), int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_BWD_REDUCE)
    _build.count(GN_BWD_REDUCE)
    return gpart, sums


def gn_bwd_dx(x, g, stats, gpart, scale, bias, groups: int, apply_silu: bool,
              plan: GnBwdPlan | None = None):
    """Kernel `gn_bwd_dx` with `gn_bwd_reduce`'s group sums of the same plan:
    dx of x's dtype and memory format."""
    _check_bwd_cuda(x, g, stats, scale, bias, groups)
    plan = plan or bwd_plan_for(x, groups, "split")
    if (tuple(gpart.shape) != (x.shape[0], groups, plan.chunks, 2)
            or gpart.dtype != torch.float32 or gpart.device != x.device
            or not gpart.is_contiguous()):
        raise ValueError("group norm backward: the group sums must come from gn_bwd_reduce with "
                         "the same plan")
    dx = torch.empty_like(x)
    rc = _build.load_library().gn_bwd_dx(
        x.data_ptr(), g.data_ptr(), stats.data_ptr(), gpart.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), *_geometry(x, groups, plan), int(apply_silu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, GN_BWD_DX)
    _build.count(GN_BWD_DX)
    return dx


def gn_silu_bwd(x, scale, bias, g, groups: int, stats, apply_silu: bool = True,
                need: tuple[bool, bool] = (True, True), plan: GnBwdPlan | None = None):
    """The backward on channels-last CUDA tensors with the forward's `stats`
    [B, G, 2]: what the plan names, `gn_bwd_fused` or `gn_bwd_reduce` +
    `gn_bwd_dx`. `need`: whether dγ, dβ are wanted; the kernels write the
    channels' sums, and the wrapper sums them over the batch (and chunks) and
    casts them, only for those. → (dx, dγ or None, dβ or None), the
    function of `gn_silu_bwd_plain`."""
    _check_cuda(x, groups)
    if not g.is_contiguous(memory_format=torch.channels_last):
        G_COPIES[tuple(g.shape)] += 1
        g = g.contiguous(memory_format=torch.channels_last)
    plan = plan or bwd_plan_for(x, groups)
    channel_sums = need[0] or need[1]
    if plan.kernel == "fused":
        dx, sums = gn_bwd_fused(x, g, stats, scale, bias, groups, apply_silu, plan, channel_sums)
    else:
        gpart, sums = gn_bwd_reduce(x, g, stats, scale, bias, groups, apply_silu, plan,
                                    channel_sums)
        dx = gn_bwd_dx(x, g, stats, gpart, scale, bias, groups, apply_silu, plan)
    if not channel_sums:
        return dx, None, None
    # the planes (Σdz, Σdz·x̂) summed over the batch (and chunks): dβ, dγ
    if need[0] and need[1]:
        dbeta, dgamma = sums.flatten(1, -2).sum(dim=1).to(scale.dtype)
    else:
        plane = sums[1] if need[0] else sums[0]
        summed = plane.flatten(0, -2).sum(dim=0).to(scale.dtype)
        dgamma, dbeta = (summed, None) if need[0] else (None, summed)
    return dx, dgamma, dbeta


def _gn_forward(x, scale, bias, groups: int, eps: float, apply_silu: bool,
                with_stats: bool = False):
    """The forward on either device; `with_stats` also returns the (mean,
    rstd) it used, [B, G, 2] fp32, written by the kernel on the card."""
    if x.device.type == "cpu":
        if not with_stats:
            return gn_silu_plain(x, scale, bias, groups, eps, apply_silu)
        stats = gn_stats_plain(x, groups, eps)
        return (gn_norm_plain(x, stats, scale, bias, groups, apply_silu),
                stats.reshape(x.shape[0], groups, 2))
    _check_cuda(x, groups)
    plan = plan_for(x, groups)
    stats = (torch.empty((x.shape[0], groups, 2), dtype=torch.float32, device=x.device)
             if with_stats else None)
    if plan.kernel == "fused":
        y = gn_fused(x, scale, bias, groups, eps, apply_silu, plan, stats)
    else:
        y = gn_norm(x, gn_stats(x, groups, plan), scale, bias, groups, eps, apply_silu, plan,
                    stats)
    return (y, stats) if with_stats else y


class _GroupNormSiLU(torch.autograd.Function):
    """GroupNorm (+ SiLU) with its backward: kernels on the card, the closed
    form on the CPU; the forward's statistics saved for the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float, apply_silu: bool):
        y, stats = _gn_forward(x, scale, bias, groups, eps, apply_silu, with_stats=True)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.groups, ctx.eps, ctx.apply_silu = groups, eps, apply_silu
        # read by launch censuses without unpacking the saved tensors
        ctx.shape = tuple(x.shape)
        ctx.bwd_kernel = "plain" if x.device.type == "cpu" else bwd_plan_for(x, groups).kernel
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        if x.device.type == "cpu":
            dx, dgamma, dbeta = gn_silu_bwd_plain(x, scale, bias, g, ctx.groups, ctx.eps,
                                                  ctx.apply_silu, stats)
        else:
            dx, dgamma, dbeta = gn_silu_bwd(x, scale, bias, g, ctx.groups, stats, ctx.apply_silu,
                                            need=(need[1], need[2]))
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
