"""Attention: plain PyTorch SDPA, the hand-written flash kernels, and routing.

Counterpart of `adaface_tpu/ops/attention.py`. Tensors are [B, H, S, D] as
there.

- `scaled_dot_product_attention` is the plain version: explicit matmuls and
  an fp32 softmax, the same math as the JAX reference (probabilities are cast
  to v's dtype before P·V, as there).
- `flash_attention` wraps the CUDA kernels that stand in for the two Pallas
  kernels. `flash_plan` picks the variant from dtype, shape, alignment and
  the card's SM count: bf16 at the UNet's head dims (40, 80, 160) with rows
  on 16-byte boundaries takes the wgmma kernel of `csrc/flash_attn_wgmma.cu`
  (64-key tiles, 64 or 128 query rows a block); every other bf16 tensor
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
  q, k, v, the mask and the output, and its backward is the three kernels
  of `csrc/flash_attn_bwd.cu` (`flash_bwd`, bf16, D 40/48, 80, 160) on the
  card, or `flash_bwd_chunked`, the JAX backward's query-chunk scan in plain
  PyTorch, on the CPU. It computes only the gradients autograd asks for: a
  cross-attention whose query has no grad launches no dq kernel. fp32 on
  the card has no backward kernel: such a call raises at the forward.
- `flash_attention_tiled` and `combine_partials` repeat the kernels'
  arithmetic in plain PyTorch (key tiles, log2 online softmax, P rounded to
  v's dtype, head-dim slices, split-keys partials), so that the CPU tests
  hold it against the plain version and the JAX package, and the combine
  kernel has a plain version to be held against on the card.
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
# the backward's three kernels (`csrc/flash_attn_bwd.cu`)
FLASH_BWD_PREP = "flash_bwd_prep"
FLASH_BWD_DKDV = "flash_bwd_dkdv"
FLASH_BWD_DQ = "flash_bwd_dq"
BWD_KSTEPS = (3, 5, 10)  # ceil(D / 16) of the backward kernel's instances

LOG2E = 1.4426950408889634
MAX_DIM = 512
WG_KSTEPS = (3, 5, 10)  # ceil(D / 16) of the wgmma kernel's instances: D = 40, 80, 160
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

    variant: str  # "wg" (bf16, D 40/80/160, aligned), "wide" (other bf16) or "fp32"
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
    # the wgmma kernel has instances for the UNet's head dims only, and
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


def flash_combine(o_part, m_part, l_part, dtype):
    """Merge split-keys partials (see `combine_partials`) into [B, H, Sq, D]
    of `dtype`, stored [B, Sq, H, D]; the combine kernel on CUDA tensors."""
    if o_part.device.type == "cpu":
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
    out = torch.empty((b, sq, h, d), dtype=dtype, device=o_part.device).transpose(1, 2)
    lib = _build.load_library()
    rc = lib.flash_combine(o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                           out.data_ptr(), (ctypes.c_int64 * 3)(*out.stride()[:3]),
                           nsplit, b, h, sq, d, int(dtype == torch.bfloat16),
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


def _flash_cuda(q, k, v, kv_mask, causal: bool, scale: float):
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

    out = out_ptr = None
    if plan.nsplit == 1:
        out = torch.empty_strided((b, h, sq, d), (sq * h * d, d, h * d, 1), dtype=dtype,
                                  device=device)
        out_ptr = out.data_ptr()
    args = (qp, kp, vp, mask_ptr, out_ptr, strides, b, h, sq, sk, d, int(causal), scale)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load_library()
    if plan.variant == "fp32":
        _build.check(lib.flash_fwd_fp32(*args, stream), "flash_fwd_fp32")
    elif plan.variant == "wg":
        _build.check(lib.flash_fwd_bf16_wg(*args, plan.block_rows, stream), "flash_fwd_bf16_wg")
    elif plan.nsplit == 1:
        _build.check(lib.flash_fwd_bf16_wide(*args, 1, None, None, None, stream),
                     "flash_fwd_bf16_wide")
    else:
        o_part = torch.empty((plan.nsplit, b, h, sq, d), dtype=torch.float32, device=device)
        m_part = torch.empty((plan.nsplit, b, h, sq), dtype=torch.float32, device=device)
        l_part = torch.empty_like(m_part)
        _build.check(lib.flash_fwd_bf16_wide(*args, plan.nsplit, o_part.data_ptr(),
                                             m_part.data_ptr(), l_part.data_ptr(), stream),
                     "flash_fwd_bf16_wide")
        _build.count(key)
        return flash_combine(o_part, m_part, l_part, dtype)
    _build.count(key)
    return out


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
                f"{BWD_KSTEPS}, D 40/48, 80, 160)")
    return None


def _grad_buffer(b: int, h: int, s: int, d: int, dtype, device):
    """[B, H, S, D] in [B, S, H, D] memory, as the forward writes `out`: the
    caller's merge of heads back into [B, S, H·D] is then a view."""
    return torch.empty_strided((b, h, s, d), (s * h * d, d, h * d, 1), dtype=dtype,
                               device=device)


def flash_bwd(q, k, v, kv_mask, out, g, causal: bool, scale: float,
              need_dq: bool = True, need_dkdv: bool = True):
    """The backward kernels of `csrc/flash_attn_bwd.cu` on bf16 CUDA tensors:
    `flash_bwd_prep` (the rows' softmax statistics and delta), then
    `flash_bwd_dkdv` and `flash_bwd_dq` as asked. → (dq, dk, dv), None for
    those not asked for; the same function as `flash_bwd_chunked`."""
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
    dq = _grad_buffer(b, h, sq, d, q.dtype, q.device) if need_dq else None
    dk = _grad_buffer(b, h, sk, d, k.dtype, q.device) if need_dkdv else None
    dv = _grad_buffer(b, h, sk, d, v.dtype, q.device) if need_dkdv else None
    stats = torch.empty((3, b, h, sq), dtype=torch.float32, device=q.device)
    none = (0, 0, 0)
    strides = (ctypes.c_int64 * 24)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *g.stride()[:3],
        *(dq.stride()[:3] if need_dq else none), *(dk.stride()[:3] if need_dkdv else none),
        *(dv.stride()[:3] if need_dkdv else none))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(), ptr(mask),
            ptr(dq), ptr(dk), ptr(dv), stats.data_ptr(), strides, b, h, sq, sk, d, int(causal),
            float(scale), torch.cuda.current_stream().cuda_stream)
    lib = _build.load_library()
    _build.check(lib.flash_bwd_prep(*args), FLASH_BWD_PREP)
    _build.count(FLASH_BWD_PREP)
    if need_dkdv:
        _build.check(lib.flash_bwd_dkdv(*args), FLASH_BWD_DKDV)
        _build.count(FLASH_BWD_DKDV)
    if need_dq:
        _build.check(lib.flash_bwd_dq(*args), FLASH_BWD_DQ)
        _build.count(FLASH_BWD_DQ)
    return dq, dk, dv


def _flash_forward(q, k, v, kv_mask, causal: bool, scale: float):
    if q.device.type == "cpu":
        return scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _flash_cuda(q, k, v, kv_mask, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: kernels on the card, the plain
    versions on the CPU (the JAX package's `_flash_attention` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, scale: float):
        out = _flash_forward(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        bwd = flash_bwd_chunked if q.device.type == "cpu" else flash_bwd
        dq, dk, dv = bwd(q, k, v, kv_mask, out, g, ctx.causal, ctx.scale,
                         need_dq=need_q, need_dkdv=need_k or need_v)
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
