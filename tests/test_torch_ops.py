"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs come from numpy seeds and go through the JAX function and its port
in fp32 (the root conftest sets JAX matmuls to "highest"). Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it. On the CPU the port's kernel wrappers take
their plain versions. Tolerance for ops: 1e-5 abs, fp32 rounding of sums
taken in another order.
"""

import dataclasses
import functools
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from adaface_tpu.ops import attention as jattn
from adaface_tpu.ops import fused_gn as jgn
from adaface_tpu.ops import fused_ln as jln
from adaface_tpu.ops import samplers as jsamp
from adaface_tpu.ops import schedules as jsched
from adaface_tpu_torch.ops import _build
from adaface_tpu_torch.ops import attention as tattn
from adaface_tpu_torch.ops import fused_gn as tgn
from adaface_tpu_torch.ops import fused_ln as tln
from adaface_tpu_torch.ops import fused_norm as tfn
from adaface_tpu_torch.ops import samplers as tsamp
from adaface_tpu_torch.ops import schedules as tsched

OP_ATOL = 1e-5


def _qkv(seed, b, h, sq, sk, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, sq, d).astype(np.float32),
            rs.randn(b, h, sk, d).astype(np.float32),
            rs.randn(b, h, sk, d).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("sq,sk,d,masked,causal", [
    (16, 24, 8, False, False),
    (8, 8, 4, False, True),
    # batch 1 masks keys 0..3: with causal, its rows 0..3 see only masked
    # keys and average V (logit -1e30 on every key), in both versions
    (12, 12, 16, True, True),
    (20, 77, 40, True, False),
])
def test_sdpa_matches_jax(sq, sk, d, masked, causal):
    q, k, v = _qkv(0, 2, 2, sq, sk, d)
    mask = None
    if masked:
        mask = np.ones((2, sk), np.float32)
        mask[1, :4] = 0.0
        mask[0, sk - 3:] = 0.0
    ref = jattn.scaled_dot_product_attention(
        q, k, v, kv_mask=None if mask is None else jnp.asarray(mask), causal=causal)
    out = tattn.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


@pytest.mark.parametrize("layout,sq,sk,d,masked,causal", [
    # `_flash_t_kernel`: D < 128, Sk = 77 pads the keys, which sets its mask pass
    ("transposed", 130, 77, 40, False, False),
    # `_flash_kernel`: D >= 128 with a key mask and the causal flag; batch 0
    # masks keys 0..7, so its rows 0..7 are fully masked
    ("standard", 128, 128, 160, True, True),
])
def test_flash_matches_pallas_interpret(layout, sq, sk, d, masked, causal):
    q, k, v = _qkv(1, 2, 2, sq, sk, d)
    mask = None
    if masked:
        mask = np.ones((2, sk), np.float32)
        mask[0, :8] = 0.0
        mask[1, 100:] = 0.0
    ref = jattn.flash_attention(
        q, k, v, kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        block_q=128, block_k=128, interpret=True)
    out = tattn.flash_attention(
        _t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


def _kv_mask(sk):
    mask = np.ones((2, sk), np.float32)
    mask[0, :8] = 0.0
    mask[1, sk - 20:] = 0.0
    return mask


@pytest.mark.parametrize("sq,sk,d,masked,causal,key_tile,d_slices,nsplit,pallas", [
    # the tensor-core kernels' tiling (64 keys): D = 40, a ragged Sq, Sk = 77
    # (a second tile of 13 keys), against `_flash_t_kernel` in interpret mode
    (130, 77, 40, False, False, 64, 1, 1, True),
    # causal with Sk < Sq: rows 0..22 see no key at all (every logit -1e30)
    # and average V; batch 0 also masks keys 0..7
    (100, 77, 64, True, True, 64, 1, 1, False),
    # the wide-head kernel's tiling (32 keys, O in 4 head-dim slices), D > 160
    (40, 77, 168, True, False, 32, 4, 1, False),
    # split keys, 2 and 3 partial results merged as the combine kernel does;
    # with causal and Sk != Sq the last split of some rows holds only
    # excluded keys
    (70, 177, 200, True, True, 32, 4, 2, False),
    (64, 96, 200, False, False, 32, 4, 3, False),
    (64, 128, 512, False, False, 32, 4, 2, False),
])
def test_flash_tiled_arithmetic_matches_plain_and_jax(sq, sk, d, masked, causal, key_tile,
                                                      d_slices, nsplit, pallas):
    """The CUDA kernels' arithmetic, repeated in plain PyTorch, against the
    plain version and the JAX package. fp32 throughout, so P is not rounded;
    1e-5 covers sums taken tile by tile and exp2 of log2-scaled logits in
    place of exp."""
    q, k, v = _qkv(6, 2, 2, sq, sk, d)
    mask = _kv_mask(sk) if masked else None
    out = tattn.flash_attention_tiled(
        _t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask), causal=causal,
        key_tile=key_tile, d_slices=d_slices, nsplit=nsplit)
    plain = tattn.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=OP_ATOL)
    jmask = None if mask is None else jnp.asarray(mask)
    if pallas:
        ref = jattn.flash_attention(q, k, v, kv_mask=jmask, causal=causal, block_q=128,
                                    block_k=128, interpret=True)
    else:
        ref = jattn.scaled_dot_product_attention(q, k, v, kv_mask=jmask, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


def test_flash_combine_on_cpu_is_its_plain_version():
    """A split whose rows saw only excluded keys (maximum -1e30) gets weight 0
    beside one that saw a real key, and equal weight beside another such."""
    rs = np.random.RandomState(7)
    o_part = _t(rs.randn(3, 1, 2, 5, 8).astype(np.float32))
    m_part = _t(rs.randn(3, 1, 2, 5).astype(np.float32))
    l_part = _t((np.abs(rs.randn(3, 1, 2, 5)) + 1.0).astype(np.float32))
    m_part[0, :, :, 0] = tattn.NEG_INF  # row 0: split 0 fully masked
    m_part[:, :, :, 1] = tattn.NEG_INF  # row 1: every split fully masked
    out = tattn.flash_combine(o_part, m_part, l_part, torch.float32)
    np.testing.assert_array_equal(out.numpy(),
                                  tattn.combine_partials(o_part, m_part, l_part).numpy())
    np.testing.assert_allclose(
        out[..., 1, :].numpy(), (o_part.sum(0) / l_part.sum(0)[..., None])[..., 1, :].numpy(),
        rtol=1e-6)
    w = torch.exp2(m_part[1:, ..., 0] - m_part[1:, ..., 0].max(0).values)
    want = ((w[..., None] * o_part[1:, ..., 0, :]).sum(0)
            / (w * l_part[1:, ..., 0]).sum(0)[..., None])
    np.testing.assert_allclose(out[..., 0, :].numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype,b,h,sq,sk,d,aligned,want", [
    # the serving path's shapes on a 132-SM card
    (torch.bfloat16, 2, 8, 4096, 4096, 40, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 2, 8, 4096, 77, 40, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 2, 8, 1024, 1024, 80, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 2, 8, 256, 256, 160, True, ("wg", 64, 64, 1, 1)),
    (torch.bfloat16, 2, 8, 256, 77, 160, True, ("wg", 64, 64, 1, 1)),
    (torch.bfloat16, 1, 1, 4096, 4096, 512, True, ("wide", 32, 64, 4, 2)),
    # the continuous batcher at 8 and 32 slots (UNet batch 16 and 64): the
    # grid fills the card with 128-row blocks at every level; a batch-32
    # decode needs no key split
    (torch.bfloat16, 16, 8, 4096, 4096, 40, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 16, 8, 1024, 77, 80, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 16, 8, 256, 256, 160, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 64, 8, 256, 77, 160, True, ("wg", 64, 128, 1, 1)),
    (torch.bfloat16, 32, 1, 4096, 4096, 512, True, ("wide", 32, 64, 4, 1)),
    # off the path: a head dim without a wgmma instance, rows off 16 bytes,
    # few query tiles and few key tiles, fp32
    (torch.bfloat16, 2, 8, 1024, 1024, 64, True, ("wide", 32, 64, 4, 1)),
    (torch.bfloat16, 2, 8, 1024, 1024, 40, False, ("wide", 32, 64, 4, 1)),
    (torch.bfloat16, 2, 2, 200, 177, 200, True, ("wide", 32, 64, 4, 6)),
    (torch.float32, 2, 8, 1024, 1024, 80, True, ("fp32", 32, 16, 1, 1)),
])
def test_flash_plan(dtype, b, h, sq, sk, d, aligned, want):
    plan = tattn.flash_plan(dtype, b, h, sq, sk, d, 132, aligned)
    assert dataclasses.astuple(plan) == want
    # every split holds at least one key tile, as the kernel requires
    ntiles = -(-sk // plan.key_tile)
    assert (plan.nsplit - 1) * -(-ntiles // plan.nsplit) < ntiles


@pytest.mark.parametrize("case", ["dtype", "head dim stride", "kv shape", "rank"])
def test_flash_cuda_route_rejects_what_the_kernels_do_not_take(case):
    """The checks the CUDA route makes before any launch read only the
    tensors' dtype, shape and strides, so they run here on CPU tensors."""
    q, k, v = (torch.zeros(2, 2, 16, 8) for _ in range(3))
    if case == "dtype":
        k = k.to(torch.bfloat16)
    elif case == "head dim stride":
        v = torch.zeros(2, 2, 8, 16).transpose(-1, -2)
    elif case == "kv shape":
        v = torch.zeros(2, 2, 12, 8)
    else:
        q = q[0]
    with pytest.raises(ValueError, match="flash_attention"):
        tattn._prepare(q, k, v, True)


@pytest.mark.parametrize("hw,c,silu", [
    ((4, 4), 256, True),
    ((4, 4), 256, False),
    ((7, 7), 128, True),  # 49 rows: not a multiple of the row block
    ((7, 7), 128, False),
])
def test_group_norm_matches_pallas_interpret(hw, c, silu):
    rs = np.random.RandomState(2)
    x = (rs.randn(2, *hw, c) * 2.0 + 0.5).astype(np.float32)  # NHWC, as JAX
    scale = (rs.randn(c) + 1.0).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    with mock.patch.object(jgn.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        ref = jgn.fused_group_norm_silu(x, scale, bias, 32, 1e-5, apply_silu=silu,
                                        use_pallas=True)
    out = tgn.group_norm_silu(_t(x.transpose(0, 3, 1, 2)).contiguous(), _t(scale),
                              _t(bias), 32, 1e-5, apply_silu=silu)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               atol=OP_ATOL)


def _gn_inputs(seed, hw, c, mean=0.5, std=2.0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(2, *hw, c) * std + mean).astype(np.float32),  # NHWC, as JAX
            (rs.randn(c) + 1.0).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32))


def _jax_group_norm(x, scale, bias, groups, eps, silu):
    with mock.patch.object(jgn.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        return np.asarray(jgn.fused_group_norm_silu(x, scale, bias, groups, eps,
                                                    apply_silu=silu, use_pallas=True))


def _nchw(x, fmt):
    """NHWC numpy → logical NCHW tensor in the memory format asked for."""
    t = _t(x).permute(0, 3, 1, 2)  # a channels-last view of the NHWC array
    assert t.permute(0, 2, 3, 1).is_contiguous()
    return t.contiguous() if fmt == "contiguous" else t


@pytest.mark.parametrize("fmt", ["contiguous", "channels_last"])
@pytest.mark.parametrize("hw,c,groups,silu", [
    ((4, 4), 256, 32, True),  # 8 channels a group: a pack is a group
    ((7, 7), 40, 4, True),  # 10 a group: a 16-byte pack straddles two groups; 49 rows
    ((7, 7), 120, 4, False),  # 30 a group
])
def test_group_norm_memory_formats_match_pallas_interpret(fmt, hw, c, groups, silu):
    """The input's memory format changes nothing: logical NCHW in, logical
    NCHW out, in the format it came in."""
    x, scale, bias = _gn_inputs(8, hw, c)
    ref = _jax_group_norm(x, scale, bias, groups, 1e-5, silu)
    xt = _nchw(x, fmt)
    out = tgn.group_norm_silu(xt, _t(scale), _t(bias), groups, 1e-5, apply_silu=silu)
    assert out.stride() == xt.stride()
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, atol=OP_ATOL)


@pytest.mark.parametrize("chunks", [1, 2, 3, 7])
@pytest.mark.parametrize("hw,c,groups,slab", [
    ((4, 4), 256, 32, 64),
    ((7, 7), 40, 4, 40),  # 49 rows: the last chunk is short at 2, 3 (17, 17, 15) and 7... chunks
    ((7, 7), 120, 4, 120),
])
def test_group_norm_chunked_arithmetic_matches_plain_and_jax(chunks, hw, c, groups, slab):
    """The CUDA kernels' arithmetic, repeated in plain PyTorch (per-channel
    sums around a pivot for each chunk of rows, channels folded into groups,
    chunks folded in a fixed form, then (x - mean)·(rstd·scale) + bias),
    against the plain version and the JAX package, on a channels-last map."""
    x, scale, bias = _gn_inputs(9, hw, c)
    xt = _nchw(x, "channels_last")
    out = tgn.gn_silu_chunked(xt, _t(scale), _t(bias), groups, 1e-5, True, slab=slab,
                              chunks=chunks)
    plain = tgn.gn_silu_plain(xt, _t(scale), _t(bias), groups, 1e-5, True)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=OP_ATOL)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1),
                               _jax_group_norm(x, scale, bias, groups, 1e-5, True), atol=OP_ATOL)
    # the statistics alone, as `gn_stats` + the fold leave them
    part, chunk_rows = tgn.gn_partials_chunked(xt, groups, slab, chunks)
    assert part.shape == (2, groups, -(-hw[0] * hw[1] // chunk_rows), 2)
    stats = tgn.gn_finalize_plain(part, hw[0] * hw[1], c // groups, chunk_rows, 1e-5)
    np.testing.assert_allclose(stats.numpy(), tgn.gn_stats_plain(xt, groups, 1e-5).numpy(),
                               atol=OP_ATOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunks", [1, 5])
def test_group_norm_chunked_statistics_survive_a_large_mean(dtype, chunks):
    """Mean 100, deviation 1 (mean²/variance = 1e4): the kernels' one-pass
    statistics keep rstd within 1e-3 of the fp64 value, where raw fp32
    E[x²] − mean² (the JAX kernel's form) is off by more."""
    x, _, _ = _gn_inputs(10, (16, 16), 40, mean=100.0, std=1.0)
    xt = _nchw(x, "channels_last").to(dtype)
    part, chunk_rows = tgn.gn_partials_chunked(xt, 4, 40, chunks)
    stats = tgn.gn_finalize_plain(part, 256, 10, chunk_rows, 1e-5).double()
    xd = xt.double().reshape(2 * 4, -1)
    want = torch.rsqrt(xd.var(dim=1, unbiased=False) + 1e-5)
    assert ((stats[:, 1] - want).abs() / want).max().item() <= 1e-3
    assert (stats[:, 0] - xd.mean(dim=1)).abs().max().item() <= 1e-3
    xf = xt.float().reshape(2 * 4, -1)
    raw = torch.rsqrt((xf * xf).mean(dim=1) - xf.mean(dim=1) ** 2 + 1e-5).double()
    assert ((stats[:, 1] - want).abs() < (raw - want).abs()).all()


# (B, C, rows) → (kernel, slab, chunks, threads) on a 132-SM card, bf16, 32 groups
GN_PLANS = [
    # the UNet at CFG batch 2: every map in one cluster launch
    ((2, 320, 4096), ("fused", 80, 8, 256)),
    ((2, 640, 4096), ("fused", 80, 8, 256)),
    ((2, 960, 4096), ("fused", 120, 16, 256)),
    ((2, 320, 1024), ("fused", 80, 8, 256)),
    ((2, 640, 1024), ("fused", 80, 4, 256)),
    ((2, 960, 1024), ("fused", 120, 4, 256)),
    ((2, 1280, 1024), ("fused", 80, 2, 256)),
    ((2, 1920, 1024), ("fused", 120, 4, 256)),
    ((2, 640, 256), ("fused", 80, 4, 160)),
    ((2, 1280, 256), ("fused", 80, 2, 256)),
    ((2, 1920, 256), ("fused", 120, 2, 256)),
    ((2, 2560, 256), ("fused", 80, 1, 256)),
    ((2, 1280, 64), ("fused", 80, 2, 128)),
    ((2, 2560, 64), ("fused", 80, 1, 160)),
    # the VAE decoder at batch 1: 64² fused, 128² to 512² the split pair
    ((1, 512, 4096), ("fused", 64, 8, 256)),
    ((1, 512, 16384), ("split", 128, 66, 512)),
    ((1, 512, 65536), ("split", 128, 66, 512)),
    ((1, 256, 65536), ("split", 128, 132, 512)),
    ((1, 256, 262144), ("split", 128, 132, 512)),
    ((1, 128, 262144), ("split", 128, 264, 512)),
    # the VAE encoder's two maps the decoder lacks
    ((1, 128, 65536), ("split", 128, 264, 512)),
    ((1, 256, 16384), ("split", 128, 132, 512)),
    # the UNet at batch 16 (the batcher at 8 slots): still one cluster launch
    # a map, smaller clusters where the batch alone fills the card
    ((16, 320, 4096), ("fused", 80, 8, 256)),
    ((16, 960, 4096), ("fused", 120, 16, 256)),
    ((16, 640, 1024), ("fused", 80, 2, 256)),
    ((16, 1920, 1024), ("fused", 120, 4, 256)),
    ((16, 1280, 256), ("fused", 80, 1, 256)),
    ((16, 2560, 64), ("fused", 80, 1, 160)),
    # batch 64 and a batch-32 decode: 2.1 GB maps, grids under 65535 in y
    ((64, 960, 4096), ("fused", 120, 16, 256)),
    ((32, 128, 262144), ("split", 128, 9, 512)),
    ((32, 512, 4096), ("fused", 64, 8, 256)),
]


@pytest.mark.parametrize("shape,want", GN_PLANS)
def test_gn_plan(shape, want):
    b, c, rows = shape
    plan = tgn.gn_plan(torch.bfloat16, b, c, rows, 32, 132)
    assert (plan.kernel, plan.slab, plan.chunks, plan.threads) == want
    cpg = c // 32
    # a slab is whole groups and whole 16-byte packs, a thread for each pack of a row
    assert c % plan.slab == 0 and plan.slab % cpg == 0 and plan.slab % 8 == 0
    assert plan.slab // 8 <= plan.threads <= 512 and plan.threads % 32 == 0
    # no empty chunk
    assert (plan.chunks - 1) * -(-rows // plan.chunks) < rows
    if plan.kernel == "fused":
        assert plan.chunks <= tgn.MAX_CLUSTER and plan.smem <= tgn.SMEM_BYTES
    else:
        assert plan.blocks(b, c) >= 2 * 132  # two waves at batch 1


def _jax_flash_vjp(q, k, v, mask, g, causal):
    """(dq, dk, dv) of the JAX package's flash attention (Pallas in
    interpret mode, its custom VJP `_flash_bwd`)."""
    fn = lambda q, k, v: jattn.flash_attention(q, k, v, kv_mask=mask, causal=causal,  # noqa: E731
                                               block_q=16, block_k=16, interpret=True)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


FLASH_BWD_CASES = [  # sq, sk, d, masked, causal, chunk
    (64, 64, 16, False, False, 16),
    (64, 48, 8, False, False, 64),
    (32, 40, 16, True, False, 8),
    (48, 48, 8, True, True, 16),  # batch 1 masks keys 0..3: its rows 0..3 see no key
    (32, 48, 8, False, True, 8),  # causal offset sk - sq
]


@pytest.mark.parametrize("sq,sk,d,masked,causal,chunk", FLASH_BWD_CASES)
def test_flash_bwd_chunked_matches_jax_vjp(monkeypatch, sq, sk, d, masked, causal, chunk):
    """`flash_bwd_chunked` against `jax.vjp` of the JAX flash attention,
    with the query-chunk scan forced to several chunks on both sides."""
    monkeypatch.setattr(jattn, "_pick_bwd_chunk", lambda b, h, sq, sk: chunk)
    monkeypatch.setattr(tattn, "_pick_bwd_chunk", lambda b, h, sq, sk: chunk)
    q, k, v = _qkv(11, 2, 2, sq, sk, d)
    g = np.random.RandomState(12).randn(2, 2, sq, d).astype(np.float32)
    mask = None
    if masked:
        mask = (np.random.RandomState(13).rand(2, sk) > 0.3).astype(np.float32)
        mask[1, :4] = 0.0
    ref = _jax_flash_vjp(q, k, v, mask, g, causal)
    tq, tk, tv = _t(q), _t(k), _t(v)
    scale = 1.0 / np.sqrt(d)
    out = tattn.scaled_dot_product_attention(tq, tk, tv, kv_mask=None if mask is None
                                             else _t(mask), causal=causal, scale=scale)
    got = tattn.flash_bwd_chunked(tq, tk, tv, None if mask is None else _t(mask), out, _t(g),
                                  causal, scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel(a.numpy(), r) <= 1e-5, name
    # only what is asked for
    dq, dk, dv = tattn.flash_bwd_chunked(tq, tk, tv, None, out, _t(g), causal, scale,
                                         need_dq=False)
    assert dq is None and dk is not None and dv is not None
    dq, dk, dv = tattn.flash_bwd_chunked(tq, tk, tv, None, out, _t(g), causal, scale,
                                         need_dkdv=False)
    assert dq is not None and dk is None and dv is None


@pytest.mark.parametrize("sq,sk,d,masked,causal,chunk", FLASH_BWD_CASES[::2])
def test_flash_function_gradients_match_jax_vjp(monkeypatch, sq, sk, d, masked, causal, chunk):
    """`flash_attention` on CPU tensors that require grad is `_FlashAttention`
    (plain forward, `flash_bwd_chunked` backward): autograd's gradients
    against `jax.vjp`; a q without grad gets none."""
    monkeypatch.setattr(jattn, "_pick_bwd_chunk", lambda b, h, sq, sk: chunk)
    monkeypatch.setattr(tattn, "_pick_bwd_chunk", lambda b, h, sq, sk: chunk)
    q, k, v = _qkv(21, 2, 2, sq, sk, d)
    g = np.random.RandomState(22).randn(2, 2, sq, d).astype(np.float32)
    mask = (np.random.RandomState(23).rand(2, sk) > 0.3).astype(np.float32) if masked else None
    ref = _jax_flash_vjp(q, k, v, mask, g, causal)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, None if mask is None else _t(mask), causal=causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(_t(g))
    for name, a, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), ref):
        assert _rel(a.numpy(), r) <= 1e-5, name
    # the cross-attention of a block whose input needs no grad: no dq
    tq2, tk2 = _t(q), _t(k).requires_grad_()
    calls = []
    real = tattn.flash_bwd_chunked
    monkeypatch.setattr(tattn, "flash_bwd_chunked",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    tattn.flash_attention(tq2, tk2, _t(v), causal=causal).backward(_t(g))
    assert calls == [dict(need_dq=False, need_dkdv=True)]
    assert tq2.grad is None and tk2.grad is not None


@pytest.mark.parametrize("fmt", ["contiguous", "channels_last"])
@pytest.mark.parametrize("hw,c,groups,silu", [
    ((4, 4), 64, 8, True),
    ((4, 4), 64, 8, False),
    ((7, 7), 40, 4, True),  # 49 rows, 10 channels a group
])
def test_group_norm_function_matches_jax_vjp(fmt, hw, c, groups, silu):
    """`group_norm_silu` on CPU tensors that require grad is
    `_GroupNormSiLU`, whose backward is `gn_silu_bwd_plain`, the closed-form
    VJP: dx, dγ, dβ against `jax.vjp` of `fused_group_norm_silu`."""
    x, scale, bias = _gn_inputs(31, hw, c)
    g = np.random.RandomState(32).randn(*x.shape).astype(np.float32)  # NHWC
    fn = lambda x, s, b_: jgn.fused_group_norm_silu(x, s, b_, groups, 1e-5,  # noqa: E731
                                                    apply_silu=silu, use_pallas=False)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, scale, bias)))
    ref_dx, ref_ds, ref_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx = _nchw(x, fmt).detach().requires_grad_()
    ts, tb = _t(scale).requires_grad_(), _t(bias).requires_grad_()
    y = tgn.group_norm_silu(tx, ts, tb, groups, 1e-5, apply_silu=silu)
    assert type(y.grad_fn).__name__ == "_GroupNormSiLUBackward"
    y.backward(_t(g).permute(0, 3, 1, 2))
    assert _rel(tx.grad.permute(0, 2, 3, 1).numpy(), ref_dx) <= 1e-5
    assert _rel(ts.grad.numpy(), ref_ds) <= 1e-5
    assert _rel(tb.grad.numpy(), ref_db) <= 1e-5
    # the closed form alone, on the same inputs
    dx, ds, db = tgn.gn_silu_bwd_plain(tx.detach(), ts.detach(), tb.detach(),
                                       _t(g).permute(0, 3, 1, 2), groups, 1e-5, silu)
    assert _rel(dx.permute(0, 2, 3, 1).numpy(), ref_dx) <= 1e-5
    assert _rel(ds.numpy(), ref_ds) <= 1e-5 and _rel(db.numpy(), ref_db) <= 1e-5


def _fake_cuda(shape, dtype, grad):
    return mock.Mock(device=torch.device("cuda", 0), shape=shape, dtype=dtype,
                     requires_grad=grad)


@pytest.mark.parametrize("op", ["flash_attention", "group_norm_silu"])
def test_kernel_functions_record_a_grad_fn(op):
    """Under grad mode an input that requires grad makes the wrapper's
    Function record a `grad_fn`; without grad mode or grad, the forward
    records none (stand-ins for CUDA tensors reach the Function's apply
    where they would on the card)."""
    if op == "flash_attention":
        q = torch.randn(1, 2, 32, 8)
        call = lambda grad: tattn.flash_attention(q, q.clone().requires_grad_(grad), q)  # noqa
        fn, name = "_FlashAttention", "_FlashAttentionBackward"
        cuda = lambda grad: tattn.flash_attention(  # noqa: E731
            _fake_cuda((1, 2, 256, 40), torch.bfloat16, False),
            _fake_cuda((1, 2, 256, 40), torch.bfloat16, grad),
            _fake_cuda((1, 2, 256, 40), torch.bfloat16, False))
        module = tattn
    else:
        x = torch.randn(2, 16, 4, 4)
        call = lambda grad: tgn.group_norm_silu(x, torch.ones(16).requires_grad_(grad),  # noqa
                                                torch.zeros(16), 4, 1e-5)
        fn, name = "_GroupNormSiLU", "_GroupNormSiLUBackward"
        cuda = lambda grad: tgn.group_norm_silu(  # noqa: E731
            _fake_cuda((2, 320, 8, 8), torch.bfloat16, False),
            _fake_cuda((320,), torch.bfloat16, grad), _fake_cuda((320,), torch.bfloat16, False),
            32, 1e-5)
        module = tgn
    assert type(call(True).grad_fn).__name__ == name
    assert call(False).grad_fn is None
    with torch.no_grad():
        assert call(True).grad_fn is None
    apply = mock.Mock(return_value="recorded")
    forward = "_flash_forward" if op == "flash_attention" else "_gn_forward"
    with mock.patch.object(getattr(module, fn), "apply", apply), \
            mock.patch.object(module, forward, mock.Mock(return_value="forward")):
        assert cuda(True) == "recorded" and cuda(False) == "forward"
        with torch.no_grad():
            assert cuda(True) == "forward"


def test_flash_backward_refusals():
    """A CUDA input that requires grad and that no backward kernel takes
    (fp32, or a head dim off the instances) raises at the forward, naming
    what is missing; the backward kernels' wrapper takes no CPU tensor (no
    fallback to the plain version) and neither does the GroupNorm one."""
    for dtype, d, what in ((torch.float32, 40, "fp32 flash backward"),
                           (torch.float16, 40, "torch.float16"),
                           (torch.bfloat16, 200, "head dim 200")):
        q = _fake_cuda((1, 2, 256, d), dtype, True)
        with pytest.raises(RuntimeError, match=what):
            tattn.flash_attention(q, q, q)
    with torch.no_grad():  # no grad: the forward kernels take fp32
        with mock.patch.object(tattn, "_flash_cuda", mock.Mock(return_value="fwd")):
            q = _fake_cuda((1, 2, 256, 40), torch.float32, True)
            assert tattn.flash_attention(q, q, q) == "fwd"
    q = torch.randn(1, 2, 16, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tattn.flash_bwd(q, q, q, None, q, q, False, 0.5)
    x = torch.randn(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        tgn.gn_silu_bwd(x, torch.ones(16), torch.zeros(16), x, 4, 1e-5)


def test_gn_plan_forced_fp32_and_what_it_refuses():
    # each kernel forced at a shape of the other's regime
    fused = tgn.gn_plan(torch.bfloat16, 1, 512, 16384, 32, 132, "fused")
    assert (fused.kernel, fused.chunks) == ("fused", 16) and fused.smem <= tgn.SMEM_BYTES
    assert tgn.gn_plan(torch.bfloat16, 2, 320, 4096, 32, 132, "split").kernel == "split"
    with pytest.raises(ValueError, match="does not fit"):
        tgn.gn_plan(torch.bfloat16, 1, 128, 262144, 32, 132, "fused")
    # fp32: packs of 4 channels, twice the bytes a row
    plan = tgn.gn_plan(torch.float32, 2, 320, 4096, 32, 132)
    assert plan.kernel == "fused" and plan.slab % 4 == 0 and plan.smem <= tgn.SMEM_BYTES
    # a narrow map takes all its channels; channels off a pack are refused
    assert tgn.gn_plan(torch.bfloat16, 2, 32, 64, 8, 132).slab == 32
    with pytest.raises(ValueError, match="multiple"):
        tgn.gn_plan(torch.bfloat16, 2, 36, 64, 4, 132)
    # fewer SMs, smaller clusters; the plan reads nothing but its arguments
    assert tgn.gn_plan(torch.bfloat16, 2, 640, 1024, 32, 64).chunks == 2


@pytest.mark.parametrize("case", ["nchw", "strided", "dtype", "rank", "groups", "cpu"])
def test_group_norm_kernels_reject_what_they_do_not_take(case):
    """The checks before any launch read only dtype, shape, strides and
    device, so they run here on CPU tensors. The kernels take channels-last
    memory only and copy nothing themselves."""
    x = torch.zeros(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    tgn._check(x, 4)
    match, check, groups = "channels-last", tgn._check, 4
    if case == "nchw":
        x = x.contiguous()
    elif case == "strided":
        x = torch.zeros(2, 32, 4, 4).contiguous(memory_format=torch.channels_last)[:, ::2]
    elif case == "dtype":
        x, match = x.to(torch.float16), "dtype"
    elif case == "rank":
        x = torch.zeros(2, 16, 8)
    elif case == "groups":
        groups, match = 3, "groups"
    else:
        check, match = tgn._check_cuda, "no kernel for device"
    with pytest.raises(ValueError, match=match):
        check(x, groups)


def _ln_inputs(seed, rows, c):
    rs = np.random.RandomState(seed)
    return ((rs.randn(rows, c) * 2.0 + 0.5).astype(np.float32),
            (rs.randn(c) + 1.0).astype(np.float32),
            (rs.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape", [
    (2, 16, 64),  # 32 rows
    (3, 7, 40),  # 21 rows: not a multiple of the row block
])
def test_layer_norm_matches_pallas_interpret(shape):
    x, scale, bias = _ln_inputs(4, int(np.prod(shape[:-1])), shape[-1])
    x = x.reshape(shape)
    with mock.patch.object(jln.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        ref = jln.fused_layer_norm(x, scale, bias, 1e-5, use_pallas=True)
    out = tln.fused_layer_norm(_t(x), _t(scale), _t(bias), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    module = tln.LayerNorm(shape[-1])
    with torch.no_grad():
        module.weight.copy_(_t(scale))
        module.bias.copy_(_t(bias))
    np.testing.assert_array_equal(module(_t(x)).detach().numpy(), out.numpy())


# (rows, C, dtype) → (packs a lane, lanes a row, warps a row, threads a block,
# blocks) on a 132-SM card: the UNet's LayerNorms at CFG batch 2, and widths
# off its path
LN_PLANS = [
    ((8192, 320, torch.bfloat16), (5, 8, 1, 128, 512)),
    ((2048, 640, torch.bfloat16), (5, 16, 1, 64, 512)),
    ((512, 1280, torch.bfloat16), (1, 32, 5, 160, 512)),  # few wide rows: a row over 5 warps
    ((128, 1280, torch.bfloat16), (1, 32, 5, 160, 128)),
    ((8192, 320, torch.float32), (5, 16, 1, 256, 512)),
    ((2048, 1280, torch.bfloat16), (5, 32, 1, 128, 512)),  # too many rows to split
    ((154, 768, torch.bfloat16), (1, 32, 3, 96, 154)),
    ((1101, 768, torch.bfloat16), (6, 16, 1, 64, 276)),
    ((100000, 1024, torch.bfloat16), (8, 16, 1, 256, 6250)),
    ((77, 64, torch.float32), (2, 8, 1, 32, 20)),
    ((300, 256, torch.float32), (1, 32, 2, 64, 300)),
    # no lane count holds the row in at most 8 whole packs each: the looped kernel
    ((1000, 77, torch.bfloat16), (0, 32, 1, 256, 125)),
    ((512, 1288, torch.float32), (0, 32, 1, 256, 64)),
    ((64, 4096, torch.bfloat16), (0, 32, 1, 256, 8)),
]


@pytest.mark.parametrize("shape,want", LN_PLANS)
def test_ln_plan(shape, want):
    rows, c, dtype = shape
    plan = tln.ln_plan(rows, c, dtype, 132)
    blocks = plan.blocks(rows)
    assert (plan.packs, plan.lanes, plan.warps, plan.threads, blocks) == want
    assert tln.ln_plan(rows, c, dtype, 132) is plan  # from the cache
    # within CUDA's limits and the source's
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    assert plan.threads % (plan.lanes * plan.warps) == 0
    assert 0 <= plan.packs <= tln.MAX_PACKS and 1 <= plan.warps <= tln.MAX_SPLIT
    assert 1 <= blocks <= 2 ** 31 - 1
    # every row in exactly one block, no block empty
    assert (blocks - 1) * plan.rows_per_block < rows <= blocks * plan.rows_per_block
    pack = 16 // torch.empty((), dtype=dtype).element_size()
    if plan.packs:  # every channel in exactly one pack of one lane
        assert plan.packs * plan.lanes * plan.warps * pack == c
    if plan.warps > 1:  # the split kernel: one row a block, one pack a lane
        assert (plan.packs, plan.lanes, plan.threads) == (1, 32, 32 * plan.warps)


def test_ln_plan_unaligned_pointers_and_other_cards():
    # a pointer off 16 bytes: the looped kernel, single channels
    assert tln.ln_plan(2048, 640, torch.bfloat16, 132, False).packs == 0
    # fewer SMs: the grid is full with larger blocks
    assert tln.ln_plan(2048, 640, torch.bfloat16, 16).threads == 256
    assert tln.ln_plan(2048, 1280, torch.bfloat16, 16).threads == 256
    # a pointer off 16 bytes is never split either
    assert tln.ln_plan(128, 1280, torch.bfloat16, 132, False).warps == 1


@pytest.mark.parametrize("case", ["cpu", "dtype", "strided", "weight shape", "bias dtype"])
def test_layer_norm_kernel_rejects_what_it_does_not_take(case):
    """The wrapper's checks before any launch; a CPU tensor is refused by the
    wrapper (only the Function sends it to the plain version)."""
    x, w, b = torch.zeros(4, 16), torch.ones(16), torch.zeros(16)
    match = {"cpu": "no kernel for device", "dtype": "dtype", "strided": "contiguous",
             "weight shape": "weight must be", "bias dtype": "bias must be"}[case]
    if case == "dtype":
        x = x.half()
    elif case == "strided":
        x = torch.zeros(4, 32)[:, ::2]
    elif case == "weight shape":
        w = torch.ones(8)
    elif case == "bias dtype":
        b = b.double()
    with pytest.raises(ValueError, match=match):
        tln.layer_norm(x, w, b, 1e-5)


def test_layer_norm_raises_on_a_strided_view():
    """The UNet's transformer input is a permuted map: the LayerNorm takes it
    only made contiguous, on the CPU as on the card, and copies nothing itself."""
    x = torch.randn(2, 8, 4, 4).permute(0, 2, 3, 1).reshape(2, 16, 8)
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tln.fused_layer_norm(x, torch.ones(8), torch.zeros(8))


def test_layer_norm_grad_matches_jax():
    """The Function's backward recomputes through the plain version, as
    `_ln_bwd` does through `_ln_ref`: x, weight and bias gradients."""
    x, scale, bias = _ln_inputs(5, 12, 32)
    ref = jax.grad(lambda x, s, b: (jln.fused_layer_norm(x, s, b, use_pallas=False) ** 3).sum(),
                   argnums=(0, 1, 2))(x, scale, bias)
    xt, st, bt = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    (tln.fused_layer_norm(xt, st, bt) ** 3).sum().backward()
    for out, r in zip((xt.grad, st.grad, bt.grad), ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_schedule_tables_match_jax():
    for kind in ("linear", "cosine", "sqrt_linear", "sqrt"):
        js, ts = jsched.DiffusionSchedule.create(kind), tsched.DiffusionSchedule.create(kind)
        np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
        np.testing.assert_array_equal(ts.betas, np.asarray(js.betas))
    for spacing in ("leading", "trailing", "uniform"):
        np.testing.assert_array_equal(tsched.ddim_timesteps(1000, 25, spacing=spacing),
                                      jsched.ddim_timesteps(1000, 25, spacing=spacing))
    cfg_j = jsamp.DDIMConfig(num_inference_steps=7, guidance_scale=6.0,
                             guidance_scale_min=1.0)
    cfg_t = tsamp.DDIMConfig(num_inference_steps=7, guidance_scale=6.0,
                             guidance_scale_min=1.0)
    for a, b in zip(jsamp._alpha_tables(jsched.DiffusionSchedule.create(), cfg_j),
                    tsamp._alpha_tables(tsched.DiffusionSchedule.create(), cfg_t)):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_allclose(tsamp.guidance_scales(cfg_t),
                               np.asarray(jsamp.guidance_scales(cfg_j)), atol=1e-6)


def test_ddim_sample_matches_jax():
    """A toy linear eps-model through both CFG DDIM loops (4 steps)."""
    rs = np.random.RandomState(3)
    x_T = rs.randn(2, 4, 8, 8).astype(np.float32)
    cond = rs.randn(2, 5, 4).astype(np.float32)
    uncond = rs.randn(2, 5, 4).astype(np.float32)
    w = rs.randn(4, 4).astype(np.float32) * 0.1

    def model_j(x, t, ctx):
        c = ctx.mean(axis=1)[:, :, None, None]
        return jnp.einsum("bchw,cd->bdhw", x, w) + c + t[:, None, None, None] * 1e-3

    def model_t(x, t, ctx):
        c = ctx.mean(dim=1)[:, :, None, None]
        return torch.einsum("bchw,cd->bdhw", x, _t(w)) + c + t[:, None, None, None] * 1e-3

    kw = dict(num_inference_steps=4, guidance_scale=5.0, guidance_scale_min=2.0)
    ref = jsamp.ddim_sample(model_j, jsched.DiffusionSchedule.create(), jnp.asarray(x_T),
                            jnp.asarray(cond), jnp.asarray(uncond), jsamp.DDIMConfig(**kw))
    out = tsamp.ddim_sample(model_t, tsched.DiffusionSchedule.create(), _t(x_T), _t(cond),
                            _t(uncond), tsamp.DDIMConfig(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_kernel_modules_run_plain_on_cpu_without_toolchain():
    """The kernel modules import and run with no nvcc, no triton and no card:
    CPU tensors take the plain versions, nothing is built, nothing counted."""
    _build.reset_launch_counts()
    q = torch.randn(1, 2, 256, 40)
    tattn.multi_head_attention(q, q, q)  # the flash route at q-length 256
    x = torch.randn(2, 64, 4, 4)
    tgn.group_norm_silu(x, torch.ones(64), torch.zeros(64), 8, 1e-5)
    tln.fused_layer_norm(torch.randn(8, 64), torch.ones(64), torch.zeros(64))
    xb = torch.randn(2, 4, 4, 64, requires_grad=True)
    tfn.fused_bn_act(xb, torch.ones(64), torch.zeros(64), slope=0.0).sum().backward()
    assert sum(_build.LAUNCHES.values()) == 0
    assert _build.load_library.cache_info().currsize == 0
    code = ("import sys; import adaface_tpu_torch.ops.attention, "
            "adaface_tpu_torch.ops.fused_gn, adaface_tpu_torch.ops.fused_ln, "
            "adaface_tpu_torch.ops.fused_norm, adaface_tpu_torch.ops._build; "
            "assert 'triton' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
