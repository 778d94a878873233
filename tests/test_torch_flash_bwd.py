"""The wgmma flash backward's plain versions and plan, on the CPU.

`flash_stats_tiled` (the rows' m and 1/l the wgmma forward keeps) and
`flash_bwd_tiled` (the wgmma backward kernels' arithmetic: statistics from
the forward, 64-key by 64-query tiles, P and dS rounded where the kernels
round them, dq folded over key tiles in order) against `flash_bwd_chunked`
and `jax.vjp` of the JAX package's flash attention (Pallas in interpret
mode), in fp32; `flash_bwd_plan` at every shape of the training path; the
statistics through `_FlashAttention`. The kernels themselves run only on the
card (`chip_smoke.check_flash_bwd`, `check_flash_stats`).
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.ops import attention as jattn
from adaface_tpu_torch.ops import attention as tattn
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-4  # fp32: the same function summed in another order

# (sq, sk, d, masked, causal): the UNet's head dims with two or three tiles
# each way, lengths off the kernels' 64-row tiles, a key mask whose batch 1
# masks every key (its rows see only masked keys and average V), the causal
# rule with offset Sk - Sq. The JAX Pallas kernels pad lengths to their
# 16-row blocks, and at lengths off those blocks they differ from their own
# XLA backward formula (`_flash_bwd`, which `flash_bwd_chunked` repeats) in
# two places: a fully masked row averages V over the padded keys too (batch
# 1 of (100, 77, 40) moves by 4e-2), and the causal rule at D >= 128 and Sq
# 72 moves dq and dk by ~0.7. So the last three cases are held to
# `flash_bwd_chunked` alone, the first six also to `jax.vjp`.
CASES = [
    (128, 128, 40, False, False),
    (96, 80, 40, True, False),
    (96, 144, 80, True, True),
    (144, 80, 80, False, False),
    (80, 80, 160, False, True),
    (64, 112, 160, True, False),
    (100, 77, 40, True, False),
    (136, 72, 80, False, True),
    (72, 72, 160, True, True),
]


def _inputs(seed, sq, sk, d, masked, b=2, h=2):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, n, d).astype(np.float32) for n in (sq, sk, sk))
    g = rs.randn(b, h, sq, d).astype(np.float32)
    mask = None
    if masked:
        mask = (rs.rand(b, sk) > 0.3).astype(np.float32)
        mask[1] = 0.0
    return q, k, v, g, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_vjp(q, k, v, mask, g, causal):
    fn = lambda q, k, v: jattn.flash_attention(q, k, v, kv_mask=mask, causal=causal,  # noqa: E731
                                               block_q=16, block_k=16, interpret=True)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _implied_stats(q, k, mask, causal, scale):
    """The rows' statistics the plain softmax implies: m = the largest logit
    in log2 units, l = Σ 2^(x - m)."""
    sq, sk = q.shape[2], k.shape[2]
    x = torch.matmul(q, k.transpose(-1, -2)) * scale * tattn.LOG2E
    if mask is not None:
        x = torch.where(mask[:, None, None, :] > 0, x, tattn.NEG_INF)
    if causal:
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + (sk - sq)
        x = torch.where(keep, x, tattn.NEG_INF)
    m = x.max(dim=-1).values
    return m, 1.0 / torch.exp2(x - m[..., None]).sum(dim=-1)


@pytest.mark.parametrize("sq,sk,d,masked,causal", CASES)
def test_flash_bwd_tiled_matches_chunked_and_jax_vjp(sq, sk, d, masked, causal):
    q, k, v, g, mask = _inputs(31, sq, sk, d, masked)
    tq, tk, tv, tg, tm = map(_t, (q, k, v, g, mask))
    scale = 1.0 / np.sqrt(d)
    out = tattn.scaled_dot_product_attention(tq, tk, tv, kv_mask=tm, causal=causal, scale=scale)
    stats = tattn.flash_stats_tiled(tq, tk, tv, tm, causal, scale)
    got = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, causal, scale, stats)
    chunked = tattn.flash_bwd_chunked(tq, tk, tv, tm, out, tg, causal, scale)
    for name, a, c in zip(("dq", "dk", "dv"), got, chunked):
        assert _rel(a.numpy(), c.numpy()) <= RTOL, f"{name} against flash_bwd_chunked"
    if sq % 16 == 0 and sk % 16 == 0:
        for name, a, r in zip(("dq", "dk", "dv"), got, _jax_vjp(q, k, v, mask, g, causal)):
            assert _rel(a.numpy(), r) <= RTOL, f"{name} against jax.vjp"
    # only what is asked for, the same values
    dq, dk, dv = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, causal, scale, stats,
                                       need_dq=False)
    assert dq is None and torch.equal(dk, got[1]) and torch.equal(dv, got[2])
    dq, dk, dv = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, causal, scale, stats,
                                       need_dkdv=False)
    assert dk is None and dv is None and torch.equal(dq, got[0])


@pytest.mark.parametrize("sq,sk,d,masked,causal", CASES)
def test_flash_stats_tiled_match_the_softmax(sq, sk, d, masked, causal):
    """The tiled forward's m and 1/l (64-key tiles, online maximum) equal the
    statistics of the plain softmax that `flash_bwd_chunked` recomputes; a
    fully masked row keeps m = -1e30 and 1/l = 1/Sk."""
    q, k, v, _, mask = _inputs(41, sq, sk, d, masked)
    tq, tk, tv, tm = map(_t, (q, k, v, mask))
    scale = 1.0 / np.sqrt(d)
    stats = tattn.flash_stats_tiled(tq, tk, tv, tm, causal, scale)
    m, inv_l = _implied_stats(tq, tk, tm, causal, scale)
    assert stats.shape == (2, 2, 2, sq) and stats.dtype == torch.float32
    assert _rel(stats[0].numpy(), m.numpy()) <= 1e-6
    assert _rel(stats[1].numpy(), inv_l.numpy()) <= 1e-5
    if masked:
        assert torch.all(stats[0, 1] == tattn.NEG_INF)
        assert torch.allclose(stats[1, 1], torch.full((2, sq), 1.0 / sk), rtol=1e-6)


def test_flash_bwd_tiled_rounds_where_the_kernels_round():
    """In bf16 the tiled backward rounds P and dS before their products, so
    it differs from the fp32 chunked backward by about one bf16 rounding,
    not more; in fp32 the rounding is the identity."""
    q, k, v, g, mask = _inputs(51, 128, 96, 40, True)
    tq, tk, tv, tg = (_t(a).to(torch.bfloat16) for a in (q, k, v, g))
    tm = _t(mask)
    scale = 1.0 / np.sqrt(40)
    out = tattn.scaled_dot_product_attention(tq, tk, tv, kv_mask=tm, scale=scale)
    stats = tattn.flash_stats_tiled(tq, tk, tv, tm, False, scale)
    got = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, False, scale, stats)
    ref = tattn.flash_bwd_chunked(tq, tk, tv, tm, out, tg, False, scale)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16
        err = _rel(a.float().numpy(), r.float().numpy())
        assert 0 < err <= 1e-2


# every attention of the student UNet whose backward the training path runs:
# (Sq, Sk, D) at the UNet batches of Stage 1 (teacher buckets x batch 4),
# Stage 2 (12) and finetuning, H 8, on an H100's 132 SMs
PATH_SHAPES = [(4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80), (1024, 77, 80),
               (256, 256, 160), (256, 77, 160)]
PATH_BATCHES = (2, 4, 8, 12, 16)


# keys (queries) a dk/dv (dq) block owns as the chip sweep found them best
# (`chip_compare.py --flash-bwd-plans`, PERF.md §6 PR 12): 128, two
# warpgroups, where such blocks give the 132 SMs 0.7 blocks or more, else 64
ROWS = {  # (batch, length) -> rows; the self-attention lengths and Sk 77
    (2, 4096): 128, (2, 1024): 128, (2, 256): 64, (2, 77): 64,
    (4, 4096): 128, (4, 1024): 128, (4, 256): 64, (4, 77): 64,
    (8, 4096): 128, (8, 1024): 128, (8, 256): 128, (8, 77): 64,
    (12, 4096): 128, (12, 1024): 128, (12, 256): 128, (12, 77): 128,
    (16, 4096): 128, (16, 1024): 128, (16, 256): 128, (16, 77): 128,
}


@pytest.mark.parametrize("b", PATH_BATCHES)
def test_flash_bwd_plan_at_the_path_shapes(b):
    for sq, sk, d in PATH_SHAPES:
        plan = tattn.flash_bwd_plan(torch.bfloat16, b, 8, sq, sk, d, 132)
        assert plan == tattn.FlashBwdPlan("wg", ROWS[b, sk], ROWS[b, sq]), (b, sq, sk, d)
        assert plan.d_slices == 1
    # the VAE decoder's mid-block attention takes the cluster kernels
    assert tattn.flash_bwd_plan(torch.bfloat16, b, 1, 4096, 4096, 512, 132).variant == "cluster"
    with pytest.raises(ValueError, match="no backward kernel"):
        tattn.flash_bwd_plan(torch.float32, b, 8, 256, 256, 40, 132)
    with pytest.raises(ValueError, match="no backward kernel"):
        tattn.flash_bwd_plan(torch.bfloat16, b, 8, 256, 256, 200, 132)


def test_flash_bwd_plan_reads_only_its_arguments():
    # fewer SMs: two-warpgroup blocks where the grid fills them
    assert tattn.flash_bwd_plan(torch.bfloat16, 1, 8, 256, 256, 160, 16).key_block == 128
    assert tattn.flash_bwd_plan(torch.bfloat16, 1, 8, 256, 256, 160, 132).key_block == 64


def test_flash_function_saves_the_statistics():
    """`_FlashAttention` saves the rows' statistics its forward gives (on the
    card the wgmma kernel's; here the tiled plain version's, handed in) and
    its gradients stay those of `flash_bwd_chunked`, which `flash_bwd_tiled`
    reaches from the saved statistics."""
    q, k, v, g, mask = _inputs(61, 96, 80, 40, True)
    tm, tg = _t(mask), _t(g)
    scale = 1.0 / np.sqrt(40)

    def grads(patched):
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        real = tattn._flash_forward

        def forward(*a, with_stats=False):
            out, _ = real(*a, with_stats=True)
            return out, tattn.flash_stats_tiled(*(x.detach() for x in a[:3]), *a[3:])

        with mock.patch.object(tattn, "_flash_forward", forward if patched else real):
            out = tattn.flash_attention(tq, tk, tv, tm)
        saved = out.grad_fn.saved_tensors[-1]
        out.backward(tg)
        return saved, (tq.grad, tk.grad, tv.grad), out.detach()

    none, plain, _ = grads(False)
    stats, kept, out = grads(True)
    assert none is None
    want = tattn.flash_stats_tiled(*map(_t, (q, k, v)), tm, False, scale)
    assert torch.equal(stats, want)
    for a, b in zip(kept, plain):
        assert torch.equal(a, b)
    tiled = tattn.flash_bwd_tiled(*map(_t, (q, k, v)), tm, out, tg, False, scale, stats)
    for a, b in zip(tiled, plain):
        assert _rel(a.numpy(), b.numpy()) <= RTOL
