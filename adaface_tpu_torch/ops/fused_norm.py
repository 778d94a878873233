"""Train-mode batch norm + leaky-ReLU: plain PyTorch versions, the kernels,
and the autograd Function around them.

Counterpart of `adaface_tpu/ops/fused_norm.py` (the InPlace-ABN stand-in),
in the JAX layout: the last axis is C, any leading axes, and the kernels see
`x` as a contiguous [R, C] view (R = N·H·W). BiSeNet keeps its activations
channels_last, so its NCHW tensors permuted to NHWC are such views.

Two kernels (`csrc/batch_norm_act.cu`), each with its plain version beside it:
- `bn_stats`: per-channel mean and rstd = 1/sqrt(E[x²] − mean² + eps), fp32,
  in one launch: blocks sum row chunks of a channel tile, the block of a
  tile that finishes last folds the tile's chunks in index order. `bn_plan` gives the geometry, a pure function
  of shape, dtype and SM count; `bn_stats_chunked` repeats the kernel's
  arithmetic in plain PyTorch, for the CPU tests;
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

import dataclasses
import functools

import torch

from adaface_tpu_torch.ops import _build

BN_STATS = "bn_stats"
BN_NORM_ACT = "bn_norm_act"
STATS_THREADS = 512  # the largest statistics block, which is also the source's limit
STATS_DEEP_ROWS = 16  # rows a thread of such a block must have; else the block is halved
STATS_SMALL_THREADS = 128  # the one block of a map of at most this many threads' loads
STATS_WAVES = 1  # statistics blocks per SM the plan aims at
STATS_MIN_ROWS = 8  # rows a thread sums at the least before the rows are cut further
STATS_TILE_BYTES = 128  # bytes of a row a statistics block spans: its channel tile
BN_TICKETS = 32  # counters a `bn_stats` launch may use: `kTickets` of the source
TICKET_SLOTS = 256  # streams of one device that can run `bn_stats`


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
    """Raise on what the kernels do not take: dtype and layout first (they
    read no device, so a CPU tensor shows them too), then the device."""
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"batch norm kernel: dtype {x2.dtype} is not supported")
    if x2.dim() != 2 or not x2.is_contiguous() or x2.numel() == 0:
        raise ValueError(f"batch norm kernel: x must be a contiguous non-empty [R, C], "
                         f"got shape {tuple(x2.shape)} strides {x2.stride()}")
    if x2.device.type != "cuda":
        raise ValueError(f"batch norm kernel: no kernel for device {x2.device}")
    if x2.device.index != torch.cuda.current_device():
        raise ValueError(f"batch norm kernel: {x2.device} is not the current device")


def _check_channel_vector(name, t, c, device):
    if (tuple(t.shape) != (c,) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"batch norm kernel: {name} must be a contiguous [{c}] fp32 "
                         f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


@dataclasses.dataclass(frozen=True)
class BnPlan:
    """Geometry of one `bn_stats` launch on x [R, C]."""
    vec: int  # channels a thread loads at once: a 16-byte pack, or 1 (the scalar instance)
    threads: int  # threads a block
    lanes: int  # threads side by side on one row; the block's others take further rows
    chunks: int  # blocks along the rows, each on `chunk_rows` rows
    chunk_rows: int

    @property
    def row_lanes(self) -> int:
        return self.threads // self.lanes

    @property
    def tile(self) -> int:
        """Channels a block covers."""
        return self.lanes * self.vec

    def grid(self, c: int) -> tuple[int, int]:
        return self.chunks, -(-c // self.tile)

    @property
    def parts(self) -> int:
        """Partial sums a channel has in shared memory: one a warp where the
        row lanes of a warp fold by shuffles, else one a row lane."""
        return self.threads // 32 if self.lanes < 32 and 32 % self.lanes == 0 else self.row_lanes

    @property
    def klanes(self) -> int:
        """Threads that share a channel in the fold of a channel tile."""
        k = 1
        while 2 * k * min(self.tile, self.threads) <= self.threads:
            k *= 2
        return k


@functools.lru_cache(maxsize=None)  # a dozen shapes on a path; the wrapper asks every call
def bn_plan(r: int, c: int, dtype, sms: int, aligned: bool = True,
            threads: int | None = None, waves: int = STATS_WAVES,
            tile_bytes: int = STATS_TILE_BYTES, min_rows: int = STATS_MIN_ROWS) -> BnPlan:
    """The `bn_stats` launch for x [r, c]: 16-byte packs where c is a multiple
    of a pack and x is `aligned` to 16 bytes, else single channels. A map of
    at most STATS_MIN_ROWS loads for each of STATS_SMALL_THREADS threads takes
    one such block over all its channels. Any other takes blocks that span
    `tile_bytes` of a row and as many rows at a time as their threads allow;
    the rows are cut into chunks for `waves` blocks an SM over all channel
    tiles, but no further than `min_rows` rows a thread; a block has
    STATS_THREADS threads where each then gets STATS_DEEP_ROWS rows, else
    half as many (measured on an H100: `chip_compare.py --sweep`). `threads`
    forces the block's size."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize if aligned and c % (16 // itemsize) == 0 else 1
    packs = c // vec
    if threads is None and packs <= STATS_SMALL_THREADS and (
            r * packs <= STATS_SMALL_THREADS * min_rows):
        return BnPlan(vec, STATS_SMALL_THREADS, packs, 1, r)
    top = threads or STATS_THREADS
    lanes = min(packs, max(1, tile_bytes // (vec * itemsize)), top)
    ctiles = -(-packs // lanes)
    target = max(1, waves * sms // ctiles)
    if threads is None and r // target < STATS_DEEP_ROWS * (top // lanes):
        top //= 2
    top = min(top, 32 * -(-lanes * r // 32))
    row_lanes = top // lanes
    chunks = max(1, min(target, r // (row_lanes * min_rows)))
    chunk_rows = -(-r // chunks)
    return BnPlan(vec, top, lanes, -(-r // chunk_rows), chunk_rows)


def _tree(t):
    """Fold axis 0 (a power of two long) by halves: row i takes row i + half."""
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        t = t[:half] + t[half:]
    return t[0]


def bn_partials_chunked(x2, plan: BnPlan):
    """`bn_stats_kernel`'s per-chunk sums in plain PyTorch → (psum, psq), each
    [chunks, C] fp32: a thread adds its rows (every `row_lanes`-th of the
    chunk) in order, x² by fused multiply-add; the row lanes of a warp fold
    by halves where the kernel folds them by shuffles; the parts left are
    added in order."""
    r, c = x2.shape
    rl, k, n = plan.row_lanes, plan.chunks, plan.chunk_rows
    steps = -(-n // rl)
    xf = torch.zeros((k * steps * rl, c), dtype=torch.float32, device=x2.device)
    # chunk j, step i, row lane l holds row j·n + i·rl + l; rows past a chunk's end stay 0
    rows = torch.arange(k * steps * rl, device=x2.device).reshape(k, steps * rl)
    src = rows % (steps * rl) + torch.arange(k, device=x2.device)[:, None] * n
    keep = (rows % (steps * rl) < n) & (src < r)
    xf[rows[keep]] = x2.float()[src[keep]]
    xf = xf.reshape(k, steps, rl, c)
    s = torch.zeros((k, rl, c), dtype=torch.float32, device=x2.device)
    q = torch.zeros_like(s)
    for i in range(steps):
        v = xf[:, i]
        s = s + v
        q = (q.double() + v.double() * v.double()).float()  # fmaf: one rounding
    s, q = s.transpose(0, 1), q.transpose(0, 1)  # [row lanes, chunks, C]
    if plan.parts != rl:  # the row lanes of a warp, by halves; then the warps in order
        per_warp = rl // plan.parts
        s = torch.stack([_tree(s[w * per_warp:(w + 1) * per_warp]) for w in range(plan.parts)])
        q = torch.stack([_tree(q[w * per_warp:(w + 1) * per_warp]) for w in range(plan.parts)])
    psum, psq = s[0], q[0]
    for part in range(1, plan.parts):
        psum, psq = psum + s[part], psq + q[part]
    return psum, psq


def bn_finalize_chunked(psum, psq, r: int, eps: float, klanes: int):
    """The last block's fold in plain PyTorch: `klanes` threads a channel each
    add every klanes-th chunk in index order in fp64, the klanes sums fold by
    halves, then mean and rstd in fp64, rounded to fp32."""
    def fold(part):
        k, c = part.shape
        steps = -(-k // klanes)
        padded = torch.zeros((steps * klanes, c), dtype=torch.float64, device=part.device)
        padded[:k] = part.double()
        padded = padded.reshape(steps, klanes, c)
        acc = torch.zeros((klanes, c), dtype=torch.float64, device=part.device)
        for i in range(steps):
            acc = acc + padded[i]
        return _tree(acc)

    mean = fold(psum) / r
    var = fold(psq) / r - mean * mean
    return mean.float(), (1.0 / torch.sqrt(var + eps)).float()


def bn_stats_chunked(x2, eps: float, plan: BnPlan):
    """`bn_stats` with the arithmetic of `csrc/batch_norm_act.cu` in plain
    PyTorch: fp32 chunk sums in the kernel's order, the fixed fp64 fold."""
    psum, psq = bn_partials_chunked(x2, plan)
    return bn_finalize_chunked(psum, psq, x2.shape[0], eps, plan.klanes)


_TICKETS: dict = {}  # device index → zeroed int32 [TICKET_SLOTS, BN_TICKETS]
_TICKET_SLOT: dict = {}  # (device index, stream handle) → slot


def _ticket(device, stream: int) -> int:
    """Address of the BN_TICKETS counters that `bn_stats` launches on `stream`
    share: a launch leaves them at 0, and launches of one stream run one
    after another. Launches captured from one stream into several CUDA
    graphs share them too, so such graphs must not replay at the same time.
    The table is allocated and zeroed at a device's first call, which must
    not be inside a capture (a captured fill would zero the table again at
    every replay)."""
    table = _TICKETS.get(device.index)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("batch norm kernel: the first bn_stats call on a device "
                               "allocates its ticket table and cannot be captured in a "
                               "CUDA graph; call it once before the capture")
        table = torch.zeros((TICKET_SLOTS, BN_TICKETS), dtype=torch.int32, device=device)
        torch.cuda.current_stream(device).synchronize()  # zeroed before any stream reads it
        _TICKETS[device.index] = table
    key = (device.index, stream)
    slot = _TICKET_SLOT.get(key)
    if slot is None:
        slot = sum(1 for d, _ in _TICKET_SLOT if d == device.index)
        if slot >= TICKET_SLOTS:
            raise RuntimeError(f"batch norm kernel: more than {TICKET_SLOTS} streams on "
                               f"{device}")
        _TICKET_SLOT[key] = slot
    return table.data_ptr() + 4 * BN_TICKETS * slot


def plan_for(x2) -> BnPlan:
    return bn_plan(x2.shape[0], x2.shape[1], x2.dtype, _build.sm_count(x2.device.index),
                   x2.data_ptr() % 16 == 0)


def bn_stats(x2, eps: float, plan: BnPlan | None = None):
    """Kernel `bn_stats` on CUDA x2 [R, C] → (mean, rstd), each [C] fp32, in
    one launch with the geometry of `plan` (`bn_plan`'s unless given).

    Blocks sum row chunks of a channel tile into a [chunks, C] workspace and
    the block of a tile that finishes last folds the tile's chunks in index
    order, so the statistics repeat bit for bit from run to run."""
    _check(x2)
    r, c = x2.shape
    plan = plan or plan_for(x2)
    stream = torch.cuda.current_stream().cuda_stream
    ticket = _ticket(x2.device, stream)
    stats = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    # one chunk: the block's sums are the map's, and the kernel writes no partials
    partial = stats if plan.chunks == 1 else torch.empty(
        (2, plan.chunks, c), dtype=torch.float32, device=x2.device)
    rc = _build.load_library().bn_stats(
        x2.data_ptr(), partial.data_ptr(), stats.data_ptr(), ticket, r, c, plan.chunks,
        plan.chunk_rows, plan.threads, plan.lanes, plan.vec, float(eps),
        int(x2.dtype == torch.bfloat16), stream)
    _build.check(rc, BN_STATS)
    _build.count(BN_STATS)
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
    _build.count(BN_NORM_ACT)
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
            # the forward's pre-activation z, recomputed from x in fp32: y
            # cannot tell z = 0 (gradient g) from a clipped negative (0)
            xhat = (x2.float() - mean) * rstd
            dz = torch.where(xhat * sf + bias.float() >= 0, gf, 0.0)
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
