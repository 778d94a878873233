"""Attention: plain PyTorch SDPA, the hand-written flash kernels, and routing.

Counterpart of `adaface_tpu/ops/attention.py`. Tensors are [B, H, S, D] as
there.

- `scaled_dot_product_attention` is the plain version: explicit matmuls and
  an fp32 softmax, the same math as the JAX reference (probabilities are cast
  to v's dtype before P·V, as there).
- `flash_attention` wraps the CUDA kernels that stand in for the two Pallas
  kernels. `flash_plan` picks the variant from dtype, shape, alignment and
  the card's SM count: bf16 at the UNets' head dims (40, 80, 160; 64 in
  SDXL's UNet and SD3's MMDiT) with rows on 16-byte boundaries takes the
  wgmma kernel of `csrc/flash_attn_wgmma.cu` (64-key tiles, 64 or 128 query
  rows a block); every other bf16 tensor
  (160 < D <= 512 in the VAE) the wide-head kernel of
  `csrc/flash_attn_wide.cu` (32-key tiles, the head dim of O in four slices,
  the keys split over several blocks where the grid would not fill the
  card, merged by `flash_combine`); fp32 the CUDA-core kernel of
  `csrc/flash_attn_fwd.cu`. Each variant counts its launches under its own
  key. On a CPU tensor `flash_attention` takes the plain version; on a CUDA
  tensor it launches the kernels or raises.
- Where autograd records the call (grad mode on and an input that requires
  grad) `flash_attention` is `_FlashAttention`, the counterpart of the JAX
  package's custom VJP (`_flash_fwd` / `_flash_bwd`, `:365-447`): it saves
  q, k, v, the mask, the output and, where a bf16 kernel ran, the rows'
  softmax statistics it wrote (m and 1/l: the wgmma kernel, or the wide
  kernel and `flash_combine`). Its backward on the card is `flash_bwd`:
  `flash_bwd_delta`, then at D 40/48, 80, 160 the wgmma dk/dv and dq kernels
  of `csrc/flash_attn_bwd_wg.cu` (with the geometry `flash_bwd_plan`
  picks), at the VAE's D 512 those of `csrc/flash_attn_bwd.cu` (wgmma over a
  thread-block cluster that splits the head dim, of the size
  `flash_bwd_plan` picks), each counted under its own key; on the CPU it is
  `flash_bwd_chunked`, the JAX backward's
  query-chunk scan in plain PyTorch. It computes only the gradients autograd
  asks for: a cross-attention whose query has no grad launches no dq
  kernel. fp32 on the card has no backward kernel, nor has D 64 (no path
  trains SDXL or SD3): such a call raises at the forward.
- `flash_attention_tiled` and `combine_partials` repeat the kernels'
  arithmetic in plain PyTorch (key tiles, log2 online softmax, P rounded to
  v's dtype, head-dim slices, split-keys partials), so that the CPU tests
  hold it against the plain version and the JAX package, and the combine
  kernel has a plain version to be held against on the card;
  `flash_stats_tiled`, `combine_stats` and `flash_bwd_tiled` do the same for
  the statistics the forward kernels keep and for the backward kernels.
- `multi_head_attention` keeps the JAX package's routing: the flash path at
  q-length >= 256 (the JAX rule also requires no bias and no returned
  probabilities; no caller of the port passes either). Which of kernel or
  plain version then runs follows from the tensor's device alone.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math

import torch

from adaface_tpu_torch.ops import _build

NEG_INF = -1e30

# launch-counter keys. The wgmma kernel has one per TPU kernel it stands in
# for: `_dispatch_forward` sent non-causal D < 128 to `_flash_t_kernel`, the
# rest to `_flash_kernel` (adaface_tpu/ops/attention.py:355-361)
FLASH_T = "flash_attn_fwd[d<128]"
FLASH_STD = "flash_attn_fwd[d>=128|causal]"
# the wide-head kernel, which takes `_flash_kernel`'s place at the VAE's head
# dim (and every bf16 tensor the wgmma kernel does not), the kernel that
# merges the partial results of a call whose keys were split, and the
# CUDA-core kernel (fp32)
FLASH_WIDE = "flash_attn_fwd[bf16 wide]"
FLASH_COMBINE = "flash_combine"
FLASH_FP32 = "flash_attn_fwd[fp32]"
# the backward at the UNet's head dims (`csrc/flash_attn_bwd_wg.cu`): delta,
# then the wgmma dk/dv and dq kernels; the forward launch a backward makes
# for the rows' statistics when its forward kept none; and at the VAE's head
# dim 512 delta and the cluster dk/dv and dq kernels (`csrc/flash_attn_bwd.cu`)
FLASH_BWD_DELTA = "flash_bwd_delta"
FLASH_BWD_DKDV_WG = "flash_bwd_dkdv[wg]"
FLASH_BWD_DQ_WG = "flash_bwd_dq[wg]"
FLASH_BWD_STATS = "flash_attn_fwd[bwd stats]"
FLASH_BWD_DELTA_WIDE = "flash_bwd_delta[d512]"
FLASH_BWD_DKDV_WIDE = "flash_bwd_dkdv[d512]"
FLASH_BWD_DQ_WIDE = "flash_bwd_dq[d512]"
BWD_KSTEPS = (3, 5, 10, 32)  # ceil(D / 16) of the backward kernels' instances
BWD_WIDE_KSTEPS = 32  # D 497..512: the cluster kernels
# blocks a D 512 cluster splits the head dim over (kCluster of
# `csrc/flash_attn_bwd.cu`): 2.5-3.1x faster than four at B 1-3 (PERF.md §6)
BWD_CLUSTER = 2
STATS_ROWS = 64  # the rows' statistics are kept for Sq rounded up to this

LOG2E = 1.4426950408889634
MAX_DIM = 512
# ceil(D / 16) of the wgmma kernel's instances: D = 40, 64 (SDXL, SD3), 80, 160
WG_KSTEPS = (3, 4, 5, 10)
MAX_SPLITS = 8


def scaled_dot_product_attention(q, k, v, kv_mask=None, causal: bool = False,
                                 scale=None):
    """SDPA on [B, H, S, D]; fp32 scores and softmax.

    kv_mask [B, Sk]: 1 keeps a key, 0 gives it the logit NEG_INF.
    """
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows + (sk - sq), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """What the CUDA route does with one call."""

    variant: str  # "wg" (bf16, D 40/64/80/160, aligned), "wide" (other bf16) or "fp32"
    key_tile: int  # keys per shared-memory tile
    block_rows: int  # query rows per block
    d_slices: int  # slices of O's head dim, one per warp column
    nsplit: int  # blocks that share one query tile's keys


def flash_plan(dtype, b: int, h: int, sq: int, sk: int, d: int, sm_count: int,
               aligned: bool = True) -> FlashPlan:
    """`aligned`: q, k and v rows start on 16-byte boundaries (pointers and
    batch, head and sequence strides)."""
    if dtype == torch.float32:
        return FlashPlan("fp32", 32, 16, 1, 1)
    # the wgmma kernel has instances for the UNets' and MMDiT's head dims only, and
    # copies whole 16-byte chunks; every other tensor takes the wide kernel
    if aligned and d % 8 == 0 and -(-d // 16) in WG_KSTEPS:
        # 128 query rows a block (K and V pass through shared memory half as
        # often) where such blocks still reach about every SM, else 64
        rows = 128 if -(-sq // 128) * b * h * 10 >= sm_count * 9 else 64
        return FlashPlan("wg", 64, rows, 1, 1)
    # wide kernel: split the keys while the query tiles alone leave SMs idle,
    # every split with at least one key tile
    blocks = -(-sq // 64) * b * h
    ntiles = -(-sk // 32)
    nsplit = max(1, min(sm_count // blocks, MAX_SPLITS, ntiles))
    nsplit = -(-ntiles // -(-ntiles // nsplit))
    return FlashPlan("wide", 32, 64, 4, nsplit)


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    """What the backward's kernels do with one call."""

    variant: str  # "wg" (bf16, D 33..48, 65..80, 145..160) or "cluster" (D 497..512)
    key_block: int  # keys a dk/dv block (cluster) owns
    query_block: int  # queries a dq block (cluster) owns

    @property
    def d_slices(self) -> int:
        """The head-dim slices whose partial S and dP the kernels add
        (`flash_bwd_tiled`'s `d_slices`)."""
        return BWD_CLUSTER if self.variant == "cluster" else 1


def flash_bwd_plan(dtype, b: int, h: int, sq: int, sk: int, d: int,
                   sm_count: int) -> FlashBwdPlan:
    """The backward's kernels and geometry for bf16 [B, H, S, D] at a head
    dim with an instance (`_bwd_refusal` says which)."""
    if dtype != torch.bfloat16 or -(-d // 16) not in BWD_KSTEPS:
        raise ValueError(f"flash_bwd_plan: no backward kernel for {dtype} at head dim {d}")
    if -(-d // 16) == BWD_WIDE_KSTEPS:
        # 64 keys (queries) a cluster of BWD_CLUSTER blocks
        return FlashBwdPlan("cluster", 64, 64)

    def rows(n):
        # two warpgroups a block, sharing the tiles the loop walks (half the
        # loads), where such blocks still give an SM 0.7 blocks or more: so
        # they won or tied at every training shape (PERF.md §6, PR 12)
        return 128 if -(-n // 128) * b * h * 10 >= sm_count * 7 else 64

    return FlashBwdPlan("wg", rows(sk), rows(sq))


def combine_partials(o_part, m_part, l_part):
    """Merge split-keys partials: o_part [S, B, H, Sq, D] unnormalized fp32,
    m_part, l_part [S, B, H, Sq] row maxima (log2 units) and row sums.
    → [B, H, Sq, D] fp32; splits are taken in order, as the kernel does."""
    w = torch.exp2(m_part - m_part.max(dim=0).values)
    l = torch.zeros_like(l_part[0])
    o = torch.zeros_like(o_part[0])
    for s in range(o_part.shape[0]):
        l = l + w[s] * l_part[s]
        o = o + w[s][..., None] * o_part[s]
    return o / torch.where(l == 0, 1.0, l)[..., None]


def combine_stats(m_part, l_part):
    """The rows' statistics of split-keys partials as the forward kernels
    keep them (`flash_combine` for several splits, the wide kernel for one):
    [2, B, H, Sq] fp32, m = the largest m_s and 1/l with l = Σ_s 2^(m_s - m)
    l_s, splits taken in order."""
    m = m_part.max(dim=0).values
    l = torch.zeros_like(l_part[0])
    for s in range(l_part.shape[0]):
        l = l + torch.exp2(m_part[s] - m) * l_part[s]
    return torch.stack((m, 1.0 / torch.where(l == 0, 1.0, l)))


def flash_partials_tiled(q, k, v, kv_mask=None, causal: bool = False, scale=None,
                         key_tile: int = 64, d_slices: int = 1, nsplit: int = 1):
    """The CUDA kernels' arithmetic in plain PyTorch, up to the partial
    results of `nsplit` shares of the key tiles: key tiles of `key_tile`,
    online softmax in log2 units with the scale folded in, masked keys
    NEG_INF, keys past Sk no weight, P rounded to v's dtype before P·V, O's
    head dim in `d_slices` slices. → (o_part [S, B, H, Sq, D] unnormalized,
    m_part, l_part [S, B, H, Sq]), fp32, as the wide kernel writes them."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scale_log2 = scale * LOG2E
    ntiles = -(-sk // key_tile)
    per = -(-ntiles // nsplit)
    if (nsplit - 1) * per >= ntiles:
        raise ValueError(f"flash_partials_tiled: {nsplit} splits of {ntiles} tiles "
                         "would leave one empty")
    rows = torch.arange(sq, device=q.device)[:, None]
    bounds = [d * i // d_slices for i in range(d_slices + 1)]
    qf = q.float()
    parts = []
    for split in range(nsplit):
        m = torch.full((b, h, sq), -math.inf, device=q.device)
        l = torch.zeros((b, h, sq), device=q.device)
        o = torch.zeros((b, h, sq, d), device=q.device)
        for t in range(split * per, min(ntiles, (split + 1) * per)):
            t0, t1 = t * key_tile, min(sk, (t + 1) * key_tile)
            x = torch.matmul(qf, k[:, :, t0:t1].float().transpose(-1, -2)) * scale_log2
            if kv_mask is not None:
                x = torch.where(kv_mask[:, None, None, t0:t1] > 0, x, NEG_INF)
            if causal:
                cols = torch.arange(t0, t1, device=q.device)[None, :]
                x = torch.where(cols <= rows + (sk - sq), x, NEG_INF)
            m_new = torch.maximum(m, x.max(dim=-1).values)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            p = p.to(v.dtype).float()
            vt = v[:, :, t0:t1].float()
            pv = torch.cat([torch.matmul(p, vt[..., lo:hi])
                            for lo, hi in zip(bounds[:-1], bounds[1:])], dim=-1)
            o = o * corr[..., None] + pv
            m = m_new
        parts.append((o, m, l))
    return tuple(torch.stack(t) for t in zip(*parts))


def flash_attention_tiled(q, k, v, kv_mask=None, causal: bool = False, scale=None,
                          key_tile: int = 64, d_slices: int = 1, nsplit: int = 1):
    """`flash_partials_tiled`, its partial results merged by
    `combine_partials` (one share: the kernels' own final division)."""
    parts = flash_partials_tiled(q, k, v, kv_mask, causal, scale, key_tile, d_slices, nsplit)
    return combine_partials(*parts).to(q.dtype)


def flash_stats_tiled(q, k, v, kv_mask=None, causal: bool = False, scale=None):
    """The rows' statistics the wgmma forward keeps for the backward, from
    `flash_partials_tiled`: [2, B, H, Sq] fp32, each row's m (log2 units,
    the scale folded in) and 1/l (the kernel writes them for Sq rounded up
    to STATS_ROWS, zeros past Sq)."""
    _, m, l = flash_partials_tiled(q, k, v, kv_mask, causal, scale)
    return torch.stack((m[0], 1.0 / torch.where(l[0] == 0, 1.0, l[0])))


def flash_bwd_tiled(q, k, v, kv_mask, out, g, causal: bool, scale: float, stats,
                    need_dq: bool = True, need_dkdv: bool = True, d_slices: int = 1):
    """The backward kernels' arithmetic in plain PyTorch: the rows' m and
    1/l from `stats` ([2, B, H, >= Sq], as `flash_stats_tiled` or the forward
    kernel gives them), delta = Σ g·out in fp32, P = exp2(s·scale·log2e -
    m)·(1/l) with masked keys at the logit -1e30, dS = P·(dP - delta); s and
    dP each the sum of `d_slices` partial products over equal slices of the
    head dim, added in slice order (the D 512 kernels' cluster of
    BWD_CLUSTER blocks); dk, dv summed over query tiles of 64 rows
    and dq over key tiles of 64 keys in the kernels' order, with P and dS
    rounded to q's dtype before the products that take them. → (dq, dk, dv)
    in the inputs' dtypes; None for the gradients not asked for."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale_log2 = scale * LOG2E
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    m, inv_l = stats[0, ..., :sq, None].float(), stats[1, ..., :sq, None].float()
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    rnd = lambda t: t.to(q.dtype).float()  # noqa: E731
    tile = 64
    if d % d_slices:
        raise ValueError(f"flash_bwd_tiled: head dim {d} in {d_slices} equal slices")
    bounds = [d * i // d_slices for i in range(d_slices + 1)]

    def product(a, b_):  # a bᵀ over the head dim, its slices' partials added in order
        parts = [torch.matmul(a[..., lo:hi], b_[..., lo:hi].transpose(-1, -2))
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        return total

    def probs(r0, r1, c0, c1):  # (P, dS) of queries r0..r1 by keys c0..c1
        x = product(qf[:, :, r0:r1], kf[:, :, c0:c1]) * scale_log2
        if kv_mask is not None:
            x = torch.where(kv_mask[:, None, None, c0:c1] > 0, x, NEG_INF)
        if causal:
            x = torch.where(cols[:, c0:c1] <= rows[r0:r1] + (sk - sq), x, NEG_INF)
        p = torch.exp2(x - m[:, :, r0:r1]) * inv_l[:, :, r0:r1]
        dp = product(gf[:, :, r0:r1], vf[:, :, c0:c1])
        return p, p * (dp - delta[:, :, r0:r1])

    dq = dk = dv = None
    if need_dkdv:
        dk = torch.zeros((b, h, sk, d), device=q.device)
        dv = torch.zeros((b, h, sk, d), device=q.device)
        for r0 in range(0, sq, tile):
            r1 = min(sq, r0 + tile)
            p, ds = probs(r0, r1, 0, sk)
            dv = dv + torch.matmul(rnd(p).transpose(-1, -2), gf[:, :, r0:r1])
            dk = dk + torch.matmul(rnd(ds).transpose(-1, -2), qf[:, :, r0:r1])
        dk, dv = (dk * scale).to(k.dtype), dv.to(v.dtype)
    if need_dq:
        dq = torch.zeros((b, h, sq, d), device=q.device)
        for c0 in range(0, sk, tile):
            c1 = min(sk, c0 + tile)
            _, ds = probs(0, sq, c0, c1)
            dq = dq + torch.matmul(rnd(ds), kf[:, :, c0:c1])
        dq = (dq * scale).to(q.dtype)
    return dq, dk, dv


def flash_combine(o_part, m_part, l_part, dtype, stats=None):
    """Merge split-keys partials (see `combine_partials`) into [B, H, Sq, D]
    of `dtype`, stored [B, Sq, H, D]; the combine kernel on CUDA tensors,
    which also writes the rows' statistics into `stats` ([2, B, H, Sq rounded
    up to STATS_ROWS] fp32, zeros past Sq; see `combine_stats`) where given."""
    if o_part.device.type == "cpu":
        if stats is not None:
            stats.zero_()
            stats[..., :o_part.shape[3]] = combine_stats(m_part, l_part)
        return combine_partials(o_part, m_part, l_part).to(dtype)
    if o_part.device.type != "cuda":
        raise ValueError(f"flash_combine: no kernel for device {o_part.device}")
    nsplit, b, h, sq, d = o_part.shape
    for name, t, shape in (("o_part", o_part, (nsplit, b, h, sq, d)),
                           ("m_part", m_part, (nsplit, b, h, sq)),
                           ("l_part", l_part, (nsplit, b, h, sq))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != o_part.device):
            raise ValueError(f"flash_combine: {name} must be contiguous fp32 {shape} on "
                             f"{o_part.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_combine: dtype {dtype} is not supported")
    if o_part.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_combine: {o_part.device} is not the current device")
    sqp = -(-sq // STATS_ROWS) * STATS_ROWS
    if stats is not None and (tuple(stats.shape) != (2, b, h, sqp) or stats.dtype != torch.float32
                              or not stats.is_contiguous() or stats.device != o_part.device):
        raise ValueError(f"flash_combine: stats must be contiguous fp32 {(2, b, h, sqp)} on "
                         f"{o_part.device}, got {stats.dtype} {tuple(stats.shape)}")
    out = torch.empty((b, sq, h, d), dtype=dtype, device=o_part.device).transpose(1, 2)
    lib = _build.load_library()
    rc = lib.flash_combine(o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                           out.data_ptr(), (ctypes.c_int64 * 3)(*out.stride()[:3]),
                           nsplit, b, h, sq, d, int(dtype == torch.bfloat16),
                           None if stats is None else stats.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_combine")
    _build.count(FLASH_COMBINE)
    return out


def _prepare(q, k, v, ptrs_aligned: bool):
    """Check one (dtype, device, shape, strides) combination of q, k, v and
    decide what the CUDA route does with it → (plan, launch-counter key,
    (b, h, sq, sk, d), the 12 strides for the C entry points)."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B,H,S,D], got shape {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2] if k.dim() == 4 else -1
    aligned = ptrs_aligned
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if (t.dtype != q.dtype or t.device != q.device or st[-1] != 1
                or (t is not q and tuple(t.shape) != (b, h, sk, d))):
            raise ValueError(
                f"flash_attention: {name} must be [B,H,S,D] with a contiguous head dim, of "
                f"q's dtype {q.dtype}, on q's device {q.device}, k and v of one shape with q's "
                f"B, H and D; got {t.dtype} {tuple(t.shape)} strides {st} on {t.device}, "
                f"q {tuple(q.shape)}")
        aligned = aligned and all(x * t.element_size() % 16 == 0 for x in st[:3])
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype} is not supported")
    if not (1 <= d <= MAX_DIM and sk >= 1 and sq >= 1):
        raise ValueError(f"flash_attention: head dim {d} outside 1..{MAX_DIM}, or an empty "
                         f"sequence (Sq {sq}, Sk {sk})")
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = flash_plan(q.dtype, b, h, sq, sk, d, sm_count, aligned)
    key = {"wide": FLASH_WIDE, "fp32": FLASH_FP32,
           "wg": FLASH_STD if d >= 128 else FLASH_T}[plan.variant]
    # out is stored [B, Sq, H, D]: the caller's merge of heads back into
    # [B, Sq, H*D] is then a view
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                    sq * h * d, d, h * d)
    return plan, key, (b, h, sq, sk, d), strides


def plan_for(q, k, v) -> FlashPlan:
    """The plan a launch on these CUDA tensors follows."""
    return _prepare(q, k, v, (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0)[0]


# `_prepare`'s verdicts by layout: the UNet sends the same few layouts 30
# times a call, and the checks cost the host more than the launch.
# CACHE_LOOKUPS counts the calls that found their layout here and those that
# did not. The trainer's prefetch thread launches beside the main thread: a
# verdict is a pure function of its layout, so two threads that miss at once
# store the same value, and a lookup racing a clear only misses; the
# counter's read-add-write may lose a count (statistics only).
_PREPARED: dict = {}
CACHE_LOOKUPS: collections.Counter = collections.Counter()


def cache_lookups(reset: bool = False) -> dict:
    """Lookups since the last reset of the two caches behind a flash launch:
    the layout cache here and the wgmma kernel's tensor-map cache (two
    lookups a launch that goes by TMA, keyed on k's and v's addresses)."""
    stats = (ctypes.c_int64 * 2)()
    _build.load_library().flash_tensor_map_stats(stats, int(reset))
    out = {"layout_hits": CACHE_LOOKUPS["hit"], "layout_misses": CACHE_LOOKUPS["miss"],
           "tensor_map_hits": stats[0], "tensor_map_misses": stats[1]}
    if reset:
        CACHE_LOOKUPS.clear()
    return out


def _flash_cuda(q, k, v, kv_mask, causal: bool, scale: float, with_stats: bool = False,
                count_as: str | None = None):
    """The forward kernels on CUDA tensors → out, or with `with_stats`
    (out, the rows' statistics [2, B, H, Sq rounded up to STATS_ROWS] fp32
    where a bf16 kernel ran, else None). `count_as`: the launch-counter key,
    where not the variant's own; a combine launch counts as FLASH_COMBINE."""
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    layout = (q.dtype, k.dtype, v.dtype, q.device, k.device, v.device, q.shape, k.shape,
              v.shape, q.stride(), k.stride(), v.stride(), (qp | kp | vp) % 16 == 0)
    prepared = _PREPARED.get(layout)
    CACHE_LOOKUPS["miss" if prepared is None else "hit"] += 1
    if prepared is None:
        prepared = _prepare(q, k, v, layout[-1])
        if len(_PREPARED) >= 1024:
            _PREPARED.clear()
        _PREPARED[layout] = prepared
    plan, key, (b, h, sq, sk, d), strides = prepared
    dtype, device = q.dtype, q.device
    if device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: {device} is not the current device")
    mask_ptr = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, sk) or kv_mask.device != device:
            raise ValueError(f"flash_attention: kv_mask must be [B, Sk] = {(b, sk)} "
                             f"on {device}, got {tuple(kv_mask.shape)} on {kv_mask.device}")
        mask = kv_mask.to(torch.float32).contiguous()  # alive until the launch below
        mask_ptr = mask.data_ptr()
    if causal and key == FLASH_T:
        key = FLASH_STD  # as the JAX dispatch counts it

    key = count_as or key
    out = out_ptr = stats = None
    if plan.nsplit == 1:
        out = torch.empty_strided((b, h, sq, d), (sq * h * d, d, h * d, 1), dtype=dtype,
                                  device=device)
        out_ptr = out.data_ptr()
    args = (qp, kp, vp, mask_ptr, out_ptr, strides, b, h, sq, sk, d, int(causal), scale)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load_library()
    if with_stats and plan.variant != "fp32":
        stats = torch.empty((2, b, h, -(-sq // STATS_ROWS) * STATS_ROWS), dtype=torch.float32,
                            device=device)
    stats_ptr = None if stats is None else stats.data_ptr()
    if plan.variant == "fp32":
        _build.check(lib.flash_fwd_fp32(*args, stream), "flash_fwd_fp32")
    elif plan.variant == "wg":
        _build.check(lib.flash_fwd_bf16_wg(*args, plan.block_rows, stats_ptr, stream),
                     "flash_fwd_bf16_wg")
    elif plan.nsplit == 1:
        _build.check(lib.flash_fwd_bf16_wide(*args, 1, None, None, None, stats_ptr, stream),
                     "flash_fwd_bf16_wide")
    else:
        o_part = torch.empty((plan.nsplit, b, h, sq, d), dtype=torch.float32, device=device)
        m_part = torch.empty((plan.nsplit, b, h, sq), dtype=torch.float32, device=device)
        l_part = torch.empty_like(m_part)
        _build.check(lib.flash_fwd_bf16_wide(*args, plan.nsplit, o_part.data_ptr(),
                                             m_part.data_ptr(), l_part.data_ptr(), None, stream),
                     "flash_fwd_bf16_wide")
        _build.count(key)
        out = flash_combine(o_part, m_part, l_part, dtype, stats)
        return (out, stats) if with_stats else out
    _build.count(key)
    return (out, stats) if with_stats else out


def _pick_bwd_chunk(b: int, h: int, sq: int, sk: int) -> int:
    """`_pick_bwd_chunk` of the JAX package (`:374-381`): query rows per
    chunk, keeping a chunk's [B, H, chunk, Sk] fp32 scores under ~256 MB;
    always divides Sq."""
    chunk = max(128, min(sq, (1 << 28) // max(b * h * sk * 4, 1)))
    chunk = min(chunk, sq)
    while sq % chunk:
        chunk //= 2
    return max(chunk, 1)


def flash_bwd_chunked(q, k, v, kv_mask, out, g, causal: bool, scale: float,
                      need_dq: bool = True, need_dkdv: bool = True):
    """The JAX backward `_flash_bwd` (`adaface_tpu/ops/attention.py:384-447`)
    in plain PyTorch: a loop over query chunks of `_pick_bwd_chunk` rows, the
    probabilities recomputed from q and k in fp32 (the key mask as a -1e30
    bias, the causal rule with the offset Sk - Sq), delta = Σ g·out, and
    ds = p·(g vᵀ - delta)·scale. → (dq, dk, dv) in the inputs' dtypes; None
    for the gradients not asked for."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    chunk = _pick_bwd_chunk(b, h, sq, sk)
    qf, kf, vf, gf, of = q.float(), k.float(), v.float(), g.float(), out.float()
    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None, :] > 0, 0.0, NEG_INF)
    cols = torch.arange(sk, device=q.device)[None, :]
    dk = dv = None
    if need_dkdv:
        dk = torch.zeros((b, h, sk, d), device=q.device)
        dv = torch.zeros((b, h, sk, d), device=q.device)
    dq_chunks = []
    for r0 in range(0, sq, chunk):
        q_c, g_c, o_c = qf[:, :, r0:r0 + chunk], gf[:, :, r0:r0 + chunk], of[:, :, r0:r0 + chunk]
        s = torch.matmul(q_c, kf.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias
        if causal:
            rows = r0 + torch.arange(q_c.shape[2], device=q.device)[:, None]
            s = torch.where(cols <= rows + (sk - sq), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        dp = torch.matmul(g_c, vf.transpose(-1, -2))
        delta = (g_c * o_c).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        if need_dq:
            dq_chunks.append(torch.matmul(ds, kf))
        if need_dkdv:
            dv = dv + torch.matmul(p.transpose(-1, -2), g_c)
            dk = dk + torch.matmul(ds.transpose(-1, -2), q_c)
    dq = torch.cat(dq_chunks, dim=2).to(q.dtype) if need_dq else None
    if need_dkdv:
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def _bwd_refusal(q) -> str | None:
    """Why the backward kernels do not take a CUDA q, or None."""
    if q.dtype != torch.bfloat16:
        return (f"no backward kernel for {q.dtype} (the backward kernels are bf16; an fp32 "
                "flash backward waits in ROADMAP §2)")
    if -(-q.shape[-1] // 16) not in BWD_KSTEPS:
        return (f"no backward kernel for head dim {q.shape[-1]} (instances: ceil(D/16) in "
                f"{BWD_KSTEPS}, D 40/48, 80, 160, 512)")
    return None


def _grad_buffer(b: int, h: int, s: int, d: int, dtype, device):
    """[B, H, S, D] in [B, S, H, D] memory, as the forward writes `out`: the
    caller's merge of heads back into [B, S, H·D] is then a view."""
    return torch.empty_strided((b, h, s, d), (s * h * d, d, h * d, 1), dtype=dtype,
                               device=device)


def _tma_ready(t) -> bool:
    """Rows on 16-byte boundaries, as the wgmma kernels' TMA copies read them."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def flash_bwd(q, k, v, kv_mask, out, g, causal: bool, scale: float,
              need_dq: bool = True, need_dkdv: bool = True, stats=None):
    """The backward kernels on bf16 CUDA tensors → (dq, dk, dv), None for
    those not asked for; the same function as `flash_bwd_chunked`.
    `flash_bwd_delta`, then the dk/dv and dq kernels as asked (the wgmma
    kernels of `csrc/flash_attn_bwd_wg.cu` at the UNet's head dims, the
    cluster kernels of `csrc/flash_attn_bwd.cu` at D 512, with the geometry
    `flash_bwd_plan` picks), which read the rows' softmax statistics from
    `stats` ([2, B, H, Sq rounded up to STATS_ROWS] fp32, as
    `_flash_cuda(..., with_stats=True)` gives them); without them a forward
    launch (counted as FLASH_BWD_STATS) writes them first."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    why = _bwd_refusal(q) if q.device.type == "cuda" else f"no kernel for device {q.device}"
    if why:
        raise ValueError(f"flash backward: {why}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash backward: {q.device} is not the current device")
    if g.stride(-1) != 1:
        g = g.contiguous()
    for name, t, shape in (("k", k, (b, h, sk, d)), ("v", v, (b, h, sk, d)),
                           ("out", out, (b, h, sq, d)), ("g", g, (b, h, sq, d))):
        if (tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1 or q.stride(-1) != 1):
            raise ValueError(f"flash backward: {name} must be {shape} {q.dtype} on {q.device} "
                             f"with a contiguous head dim, got {tuple(t.shape)} {t.dtype} "
                             f"strides {t.stride()}")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, sk) or kv_mask.device != q.device:
            raise ValueError(f"flash backward: kv_mask must be [B, Sk] = {(b, sk)} on {q.device}")
        mask = kv_mask.to(torch.float32).contiguous()
    plan = flash_bwd_plan(q.dtype, b, h, sq, sk, d, _build.sm_count(q.device.index))
    return _flash_bwd_kernels(plan, q, k, v, mask, out, g, causal, scale, need_dq, need_dkdv,
                              stats)


def _flash_bwd_kernels(plan, q, k, v, mask, out, g, causal, scale, need_dq, need_dkdv, stats):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dp = -(-d // 8) * 8
    if dp != d or not all(_tma_ready(t) for t in (q, k, v, out, g)):
        # copies the TMA reads: the head dim padded with zeros to a multiple
        # of 8 (they add nothing to any product), rows on 16-byte boundaries
        q, k, v, out, g = (torch.nn.functional.pad(t, (0, dp - d)).contiguous()
                           for t in (q, k, v, out, g))
    sqp = -(-sq // STATS_ROWS) * STATS_ROWS
    if stats is None:
        stats = _flash_cuda(q, k, v, mask, causal, scale, with_stats=True,
                            count_as=FLASH_BWD_STATS)[1]
    if (tuple(stats.shape) != (2, b, h, sqp) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"flash backward: stats must be contiguous fp32 {(2, b, h, sqp)} on "
                         f"{q.device}, got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    dq = _grad_buffer(b, h, sq, dp, q.dtype, q.device) if need_dq else None
    dk = _grad_buffer(b, h, sk, dp, k.dtype, q.device) if need_dkdv else None
    dv = _grad_buffer(b, h, sk, dp, v.dtype, q.device) if need_dkdv else None
    delta = torch.empty((b, h, sqp), dtype=torch.float32, device=q.device)
    none = (0, 0, 0)
    strides = (ctypes.c_int64 * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        *(dq.stride()[:3] if need_dq else none), *(dk.stride()[:3] if need_dkdv else none),
        *(dv.stride()[:3] if need_dkdv else none))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load_library()
    wg = plan.variant == "wg"
    keys = ((FLASH_BWD_DELTA, FLASH_BWD_DKDV_WG, FLASH_BWD_DQ_WG) if wg else
            (FLASH_BWD_DELTA_WIDE, FLASH_BWD_DKDV_WIDE, FLASH_BWD_DQ_WIDE))
    _build.check(lib.flash_bwd_delta(out.data_ptr(), g.data_ptr(), delta.data_ptr(),
                                     (ctypes.c_int64 * 6)(*out.stride()[:3], *g.stride()[:3]),
                                     b, h, sq, dp, stream), keys[0])
    _build.count(keys[0])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ptr(mask), stats.data_ptr(),
            delta.data_ptr())
    shape = (b, h, sq, sk, dp, int(causal), float(scale))
    if need_dkdv:
        launch = lib.flash_bwd_dkdv_wg if wg else lib.flash_bwd_dkdv_cl
        block = (plan.key_block,) if wg else ()
        _build.check(launch(*args, ptr(dk), ptr(dv), strides, *shape, *block, stream), keys[1])
        _build.count(keys[1])
    if need_dq:
        launch = lib.flash_bwd_dq_wg if wg else lib.flash_bwd_dq_cl
        block = (plan.query_block,) if wg else ()
        _build.check(launch(*args, ptr(dq), strides, *shape, *block, stream), keys[2])
        _build.count(keys[2])
    if dp != d:
        dq, dk, dv = (None if t is None else t[..., :d] for t in (dq, dk, dv))
    return dq, dk, dv


def _flash_forward(q, k, v, kv_mask, causal: bool, scale: float, with_stats: bool = False):
    """out, or with `with_stats` (out, the rows' statistics or None): the
    kernels on a CUDA tensor (statistics where a bf16 kernel ran), the plain
    version on the CPU (no statistics)."""
    if q.device.type == "cpu":
        out = scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
        return (out, None) if with_stats else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _flash_cuda(q, k, v, kv_mask, causal, scale, with_stats=with_stats)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: kernels on the card, the plain
    versions on the CPU (the JAX package's `_flash_attention` custom VJP).
    The rows' softmax statistics are saved with the inputs, so a recompute
    under `torch.utils.checkpoint` brings them back with the output."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, scale: float):
        out, stats = _flash_forward(q, k, v, kv_mask, causal, scale, with_stats=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, stats)
        ctx.causal, ctx.scale = causal, scale
        ctx.head_dim = q.shape[-1]  # read by launch censuses without unpacking the saved tensors
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, stats = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_chunked(q, k, v, kv_mask, out, g, ctx.causal, ctx.scale,
                                           need_dq=need_q, need_dkdv=need_k or need_v)
        else:
            dq, dk, dv = flash_bwd(q, k, v, kv_mask, out, g, ctx.causal, ctx.scale,
                                   need_dq=need_q, need_dkdv=need_k or need_v, stats=stats)
        return dq, dk if need_k else None, dv if need_v else None, None, None, None


def flash_attention(q, k, v, kv_mask=None, causal: bool = False, scale=None):
    """Flash attention on [B, H, S, D]; output in q's dtype. Recorded by
    autograd as `_FlashAttention` when an input requires grad."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        why = _bwd_refusal(q) if q.device.type == "cuda" else None
        if why:
            raise RuntimeError(f"flash_attention: an input requires grad, but there is {why}; "
                               "call it under torch.no_grad() or on detached tensors")
        return _FlashAttention.apply(q, k, v, kv_mask, causal, scale)
    return _flash_forward(q, k, v, kv_mask, causal, scale)


def multi_head_attention(q, k, v, kv_mask=None, causal: bool = False, scale=None):
    """Route between the flash path and the plain version, as the JAX
    package does (`adaface_tpu/ops/attention.py:484-522`)."""
    if q.shape[-2] >= 256:
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
    return scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                        scale=scale)
