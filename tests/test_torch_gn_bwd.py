"""The GroupNorm backward's plain versions, Function and plan, on the CPU.

`gn_silu_bwd_tiled` (the backward kernels' arithmetic: the forward's
statistics taken as given, per-(sample, chunk) channel sums, the chunks'
γ-weighted group sums folded in order) against `gn_silu_bwd_plain` (the
closed form) and `jax.vjp` of the JAX package's GroupNorm, in fp32; the
statistics the forward keeps for the backward, also through non-reentrant
recompute; `_GroupNormSiLU` under every pattern of inputs that require grad;
`gn_bwd_plan` at every GroupNorm shape of the training paths; the checks that
refuse what the kernels do not take. The kernels themselves run only on the
card (`chip_smoke.check_gn_bwd`).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from adaface_tpu.ops import fused_gn as jgn
from adaface_tpu_torch.ops import fused_gn as tgn
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5  # fp32: the same function summed in another order
# at mean 100 and deviation 1, x itself carries fp32's 7.6e-6 of rounding
# against a deviation of 1, so x̂ (and dx) of two fp32 implementations that
# subtract the mean in another order differ by some 1e-5; against the closed
# form, which subtracts as the tiled version does, RTOL still holds
LARGE_MEAN_RTOL = 1e-4

# every GroupNorm map of the SD1.5 UNet at 512² (C, H = W) and of the VAE
# decoder; the UNet runs at batch 2-16 on the training paths (Stage 1: 4 x
# 2-4 teacher steps; recon: 2; Stage 2: 3 and 12), the decoder at 1-3
UNET_MAPS = [(320, 64), (640, 64), (960, 64), (320, 32), (640, 32), (960, 32), (1280, 32),
             (1920, 32), (640, 16), (1280, 16), (1920, 16), (2560, 16), (1280, 8), (2560, 8)]
UNET_BATCHES = (2, 3, 4, 8, 12, 16)
DECODER_MAPS = [(512, 64), (512, 128), (512, 256), (256, 256), (256, 512), (128, 512)]
DECODER_BATCHES = (1, 2, 3)
SMS = 132  # an H100's SMs: the plan reads nothing but its arguments


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _inputs(seed, hw, c, mean=0.5, std=2.0, b=2):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, *hw, c) * std + mean).astype(np.float32)  # NHWC, as JAX
    scale, bias = (rs.randn(c) + 1.0).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32)
    return x, scale, bias, rs.randn(*x.shape).astype(np.float32)


def _channels_last(a):
    """NHWC numpy → logical NCHW tensor in channels-last memory."""
    return _t(a).permute(0, 3, 1, 2)


def _jax_vjp(x, scale, bias, g, groups, eps, silu):
    fn = lambda x, s, b: jgn.fused_group_norm_silu(x, s, b, groups, eps,  # noqa: E731
                                                   apply_silu=silu, use_pallas=False)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, scale, bias)))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


# (H, W), C, groups, SiLU, eps, chunks, mean: 16 and 10 channels a
# group (10: a 16-byte pack straddles two groups), several chunkings with a
# short last chunk (49 rows), the transformer's 1e-6 and without SiLU, and a
# map with mean 100 and deviation 1
CASES = [
    ((4, 4), 64, 4, True, 1e-5, 1, 0.5),
    ((4, 4), 64, 4, False, 1e-6, 3, 0.5),
    ((7, 7), 40, 4, True, 1e-5, 7, 0.5),
    ((7, 7), 40, 4, False, 1e-5, 2, 0.5),
    ((7, 7), 40, 4, True, 1e-6, 5, 0.5),
    ((6, 5), 128, 8, True, 1e-6, 4, 0.5),
    ((8, 8), 64, 4, True, 1e-5, 16, 100.0),
    ((8, 8), 64, 4, False, 1e-6, 8, 100.0),
]


@pytest.mark.parametrize("hw,c,groups,silu,eps,chunks,mean", CASES)
def test_tiled_matches_plain_and_jax(hw, c, groups, silu, eps, chunks, mean):
    """`gn_silu_bwd_tiled` on the forward's statistics against the closed
    form and `jax.vjp`: dx, dγ, dβ within 1e-5 of scale in fp32."""
    x, scale, bias, g = _inputs(c * 100 + chunks * 10 + hw[0], hw, c,
                                mean=mean, std=1.0 if mean > 1 else 2.0)
    ref = _jax_vjp(x, scale, bias, g, groups, eps, silu)
    tx, tg = _channels_last(x), _channels_last(g)
    _, stats = tgn._gn_forward(tx, _t(scale), _t(bias), groups, eps, silu, with_stats=True)
    got = tgn.gn_silu_bwd_tiled(tx, _t(scale), _t(bias), tg, stats, groups, silu, chunks=chunks)
    plain = tgn.gn_silu_bwd_plain(tx, _t(scale), _t(bias), tg, groups, eps, silu)
    for name, a, p, r in zip(("dx", "dgamma", "dbeta"), got, plain, ref):
        if name == "dx":
            a, p = a.permute(0, 2, 3, 1), p.permute(0, 2, 3, 1)
        assert _rel(a.numpy(), r) <= (RTOL if mean < 1 else LARGE_MEAN_RTOL), name
        assert _rel(a.numpy(), p.numpy()) <= RTOL, name
    assert got[0].is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("fmt", ["contiguous", "channels_last"])
@pytest.mark.parametrize("silu", [True, False])
def test_forward_keeps_its_statistics(fmt, silu):
    """The Function saves [B, G, 2] (mean, rstd) from its own forward: equal
    to `gn_stats_plain`'s, and its output equal to the forward without them."""
    x, scale, bias, _ = _inputs(5, (7, 7), 40)
    tx = _channels_last(x)
    tx = (tx.contiguous() if fmt == "contiguous" else tx).requires_grad_()
    y = tgn.group_norm_silu(tx, _t(scale), _t(bias), 4, 1e-6, apply_silu=silu)
    saved_x, _, _, stats = y.grad_fn.saved_tensors
    assert stats.shape == (2, 4, 2) and stats.dtype == torch.float32
    assert torch.equal(stats.reshape(-1, 2), tgn.gn_stats_plain(tx.detach(), 4, 1e-6))
    assert torch.equal(y, tgn.group_norm_silu(tx.detach(), _t(scale), _t(bias), 4, 1e-6, silu))
    # what a launch census reads without unpacking the saved tensors
    assert y.grad_fn.shape == (2, 40, 7, 7) and y.grad_fn.bwd_kernel == "plain"


def test_statistics_through_recompute():
    """Under non-reentrant recompute (as the VAE decoder runs in training)
    the forward runs again in the backward and saves its statistics again:
    the gradients equal those without recompute, bit for bit."""
    x, scale, bias, g = _inputs(6, (6, 6), 64)
    conv = torch.nn.Conv2d(64, 64, 3, padding=1).to(memory_format=torch.channels_last)
    s1, b1 = _t(scale).requires_grad_(), _t(bias).requires_grad_()

    def block(t):
        h = tgn.group_norm_silu(t, s1, b1, 32, 1e-6)
        return tgn.group_norm_silu(conv(h), s1, b1, 32, 1e-6, apply_silu=False)

    grads = []
    for recompute in (False, True):
        tx = _channels_last(x).requires_grad_()
        out = checkpoint(block, tx, use_reentrant=False) if recompute else block(tx)
        grads.append(torch.autograd.grad(out, (tx, s1, b1), _channels_last(g)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pattern", [p for p in itertools.product((False, True), repeat=3)
                                     if any(p)])
def test_function_every_pattern_of_needs_input_grad(pattern):
    """`_GroupNormSiLU` with each of x, γ, β requiring grad or not: a
    gradient only where one is asked for, each against `jax.vjp`."""
    x, scale, bias, g = _inputs(7, (7, 7), 40)
    ref = _jax_vjp(x, scale, bias, g, 4, 1e-5, True)
    ts = [_channels_last(x), _t(scale), _t(bias)]
    ts = [t.requires_grad_(need) for t, need in zip(ts, pattern)]
    y = tgn.group_norm_silu(*ts, 4, 1e-5)
    assert type(y.grad_fn).__name__ == "_GroupNormSiLUBackward"
    assert y.grad_fn.needs_input_grad[:3] == pattern
    y.backward(_channels_last(g))
    for name, t, need, r in zip(("dx", "dgamma", "dbeta"), ts, pattern, ref):
        if not need:
            assert t.grad is None, name
            continue
        got = t.grad.permute(0, 2, 3, 1) if name == "dx" else t.grad
        assert _rel(got.numpy(), r) <= RTOL, name


def _check_plan(plan, dtype, b, c, rows):
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    cpg = c // 32
    # a slab is whole groups and whole 16-byte packs, a thread for each pack of a row
    assert c % plan.slab == 0 and plan.slab % cpg == 0 and plan.slab % vec == 0
    assert plan.slab // vec <= plan.threads <= tgn.MAX_THREADS and plan.threads % 32 == 0
    rows_per = -(-rows // plan.chunks)
    assert (plan.chunks - 1) * rows_per < rows  # no empty chunk
    if plan.kernel == "fused":
        assert plan.chunks <= tgn.MAX_CLUSTER and plan.chunks & (plan.chunks - 1) == 0
        assert plan.smem == tgn._bwd_fused_smem(rows_per, plan.slab, cpg, plan.threads,
                                                plan.stage_rows, itemsize)
        assert plan.smem <= tgn.SMEM_BYTES
        # stages of whole 8-row groups, each a tensor-map box of at most 256 a side
        assert 1 <= -(-rows_per // plan.stage_rows) <= tgn.BWD_MAX_STAGES
        assert plan.stage_rows % 8 == 0 and plan.stage_rows <= 256 and plan.slab <= 256
    else:
        assert plan.kernel == "split" and plan.smem == 0 and plan.stage_rows == 0
        blocks = b * (c // plan.slab) * plan.chunks
        assert blocks >= tgn.BWD_SPLIT_WAVES * SMS or rows_per <= tgn.SPLIT_MIN_ROWS
        # a map the split pair takes is one no cluster holds
        with pytest.raises(ValueError, match="does not fit"):
            tgn.gn_bwd_plan(dtype, b, c, rows, 32, SMS, "fused")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,hw", UNET_MAPS)
def test_gn_bwd_plan_at_the_unet_maps(c, hw, dtype):
    """Every UNet map at every training batch: in bf16 one cluster launch
    (`gn_bwd_fused`) within the shared memory and the cluster limit; in
    fp32, whose tiles are twice as large, whichever fits."""
    for b in UNET_BATCHES:
        plan = tgn.gn_bwd_plan(dtype, b, c, hw * hw, 32, SMS)
        _check_plan(plan, dtype, b, c, hw * hw)
        if dtype == torch.bfloat16:
            assert plan.kernel == "fused", (b, c, hw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,hw", DECODER_MAPS)
def test_gn_bwd_plan_at_the_decoder_maps(c, hw, dtype):
    """The VAE decoder's maps at batch 1-3: the 64² maps fused in bf16, the
    128²-512² maps (256 KB a block and more at 16 blocks a cluster) the
    split pair."""
    for b in DECODER_BATCHES:
        plan = tgn.gn_bwd_plan(dtype, b, c, hw * hw, 32, SMS)
        _check_plan(plan, dtype, b, c, hw * hw)
        if dtype == torch.bfloat16:
            assert plan.kernel == ("fused" if hw == 64 else "split"), (b, c, hw)


def test_gn_bwd_plan_forced_and_what_it_refuses():
    # each kernel forced where it can run
    split = tgn.gn_bwd_plan(torch.bfloat16, 16, 320, 4096, 32, SMS, "split")
    assert split.kernel == "split" and split.slab == 160
    with pytest.raises(ValueError, match="does not fit"):
        tgn.gn_bwd_plan(torch.bfloat16, 2, 128, 262144, 32, SMS, "fused")
    # channels off a pack, or off the groups, are refused
    with pytest.raises(ValueError, match="multiple"):
        tgn.gn_bwd_plan(torch.bfloat16, 2, 36, 64, 4, SMS)
    with pytest.raises(ValueError, match="multiple"):
        tgn.gn_bwd_plan(torch.float32, 2, 66, 64, 32, SMS)
    # fewer SMs, a smaller grid target: the plan reads nothing but its arguments
    assert (tgn.gn_bwd_plan(torch.bfloat16, 2, 1280, 64, 32, 64).chunks
            < tgn.gn_bwd_plan(torch.bfloat16, 2, 1280, 64, 32, SMS).chunks)


@pytest.mark.parametrize("case", ["g shape", "g dtype", "g nchw", "stats none", "stats shape",
                                  "stats dtype"])
def test_backward_checks_refuse_what_the_kernels_do_not_take(case):
    """The checks before a backward launch read only dtype, shape, strides
    and device, so they run here on CPU tensors; the kernels' wrappers take
    no CPU tensor (no fallback to the plain version)."""
    x = torch.zeros(2, 16, 4, 4).contiguous(memory_format=torch.channels_last)
    g, stats = torch.zeros_like(x), torch.zeros(2, 4, 2)
    tgn._check_bwd(x, g, stats, 4)
    match = "g must be like x"
    if case == "g shape":
        g = torch.zeros(2, 16, 4, 2).contiguous(memory_format=torch.channels_last)
    elif case == "g dtype":
        g = g.to(torch.bfloat16)
    elif case == "g nchw":
        g = g.contiguous()
    else:
        match = "statistics"
        stats = {"stats none": None, "stats shape": torch.zeros(2, 8, 2),
                 "stats dtype": stats.double()}[case]
    with pytest.raises(ValueError, match=match):
        tgn._check_bwd(x, g, stats, 4)
    one, zero = torch.ones(16), torch.zeros(16)
    for call in (lambda: tgn.gn_silu_bwd(x, one, zero, x, 4, stats),
                 lambda: tgn.gn_bwd_fused(x, x, stats, one, zero, 4, True),
                 lambda: tgn.gn_bwd_reduce(x, x, stats, one, zero, 4, True),
                 lambda: tgn.gn_bwd_dx(x, x, stats, stats, one, zero, 4, True)):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            call()


def _fake_kernels(monkeypatch):
    """The backward kernels' wrappers replaced by their arithmetic on CPU
    tensors, in the layouts the kernels write (dx; the channels' Σdz and
    Σdz·x̂ as planes [2, B, C], or [2, B, chunks, C] with the split pair's
    group sums), so that `gn_silu_bwd`'s own work (the plan's kernels, the
    sums over the batch, the casts, what `need` leaves out) runs here."""
    def planes(x, g, stats, scale, bias, groups, apply_silu, chunks):
        xhat, dz, _ = tgn._xhat_dz(x, scale, bias, g, stats.reshape(-1, 2), groups, apply_silu)
        b, c = x.shape[:2]
        rows = x[0, 0].numel()
        cut = lambda t: t.reshape(b, c, chunks, rows // chunks).sum(-1).transpose(1, 2)  # noqa
        return torch.stack([cut(dz), cut(dz * xhat)])  # [2, B, chunks, C]

    def dx_of(x, g, stats, scale, bias, groups, apply_silu):
        return tgn.gn_silu_bwd_tiled(x, scale, bias, g, stats, groups, apply_silu)[0]

    def fused(x, g, stats, scale, bias, groups, apply_silu, plan, channel_sums):
        sums = planes(x, g, stats, scale, bias, groups, apply_silu, 1)[:, :, 0]
        return dx_of(x, g, stats, scale, bias, groups, apply_silu), (
            sums if channel_sums else None)

    def reduce(x, g, stats, scale, bias, groups, apply_silu, plan, channel_sums):
        sums = planes(x, g, stats, scale, bias, groups, apply_silu, plan.chunks)
        return "group sums", sums if channel_sums else None

    def dx(x, g, stats, gpart, scale, bias, groups, apply_silu, plan):
        assert gpart == "group sums"
        return dx_of(x, g, stats, scale, bias, groups, apply_silu)

    calls = []
    for name, fn in (("gn_bwd_fused", fused), ("gn_bwd_reduce", reduce), ("gn_bwd_dx", dx)):
        monkeypatch.setattr(tgn, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    monkeypatch.setattr(tgn, "_check_cuda", lambda x, groups: None)
    return calls


@pytest.mark.parametrize("kernel", ["fused", "split"])
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True), (False, False)])
def test_backward_wrapper_sums_and_leaves_out(monkeypatch, kernel, need):
    """`gn_silu_bwd` launches what its plan names and no other kernel, sums
    the channels' planes over the batch (and the split pair's chunks) into
    dγ and dβ of γ's dtype, only those that `need` asks for, and copies an
    incoming gradient that is not channels-last (counted in `G_COPIES`)."""
    calls = _fake_kernels(monkeypatch)
    x, scale, bias, g = _inputs(9, (4, 4), 64)
    tx, ts, tb = _channels_last(x), _t(scale), _t(bias)
    tg = _t(g).permute(0, 3, 1, 2).contiguous()  # NCHW: the wrapper copies it
    stats = tgn._gn_forward(tx, ts, tb, 4, 1e-5, True, with_stats=True)[1]
    plan = tgn.GnBwdPlan(kernel, 64, 4, 256, 8 if kernel == "fused" else 0, 0)
    tgn.G_COPIES.clear()
    got = tgn.gn_silu_bwd(tx, ts, tb, tg, 4, stats, True, need=need, plan=plan)
    ref = tgn.gn_silu_bwd_plain(tx, ts, tb, tg, 4, 1e-5, True, stats)
    assert calls == (["gn_bwd_fused"] if kernel == "fused" else ["gn_bwd_reduce", "gn_bwd_dx"])
    assert dict(tgn.G_COPIES) == {(2, 64, 4, 4): 1}
    assert _rel(got[0].numpy(), ref[0].numpy()) <= RTOL
    for wanted, a, r in zip(need, got[1:], ref[1:]):
        assert (a is None) == (not wanted)
        if wanted:
            assert a.dtype == r.dtype and a.shape == r.shape
            assert _rel(a.numpy(), r.numpy()) <= RTOL
