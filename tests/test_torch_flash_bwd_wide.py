"""The D 512 flash backward's plain versions and plan, on the CPU.

The VAE decoder's mid-block attention (head dim 512) runs its backward on
the cluster kernels of `csrc/flash_attn_bwd.cu`: the head dim split over the
blocks of a thread-block cluster, the partial S and dP of each slice added in
rank order. Here `flash_bwd_tiled` with `d_slices` (that arithmetic) against
`flash_bwd_chunked` and `jax.vjp` of the JAX package's flash attention
(Pallas in interpret mode), in fp32; the rows' statistics the wide forward
and `flash_combine` keep (`flash_partials_tiled` + `combine_stats`) against
`flash_stats_tiled`; `flash_bwd_plan` at D 512; the statistics through
`_FlashAttention`, also under non-reentrant recompute. The kernels
themselves run only on the card (`chip_smoke.check_flash_bwd`,
`check_flash_stats`).
"""

from __future__ import annotations

from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from adaface_tpu.ops import attention as jattn
from adaface_tpu_torch.ops import attention as tattn
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-4  # fp32: the same function summed in another order
D = 512

# (sq, sk, masked, causal, jax): lengths on and off the kernels' 64-row
# tiles; batch 1 of a masked case masks every key (its rows average V). The
# JAX Pallas kernel pads lengths to its blocks and then differs from its own
# XLA backward formula (see tests/test_torch_flash_bwd.py), so the ragged
# cases are held to `flash_bwd_chunked` alone.
CASES = [
    (256, 256, False, False, True),
    (256, 256, True, False, True),
    (256, 256, False, True, True),
    (200, 177, True, False, False),
    (200, 177, True, True, False),
]


def _inputs(seed, sq, sk, masked, b=2, h=1):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, n, D).astype(np.float32) for n in (sq, sk, sk))
    g = rs.randn(b, h, sq, D).astype(np.float32)
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
                                               block_q=64, block_k=64, interpret=True)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("sq,sk,masked,causal,with_jax", CASES)
def test_flash_bwd_tiled_d512_matches_chunked_and_jax_vjp(sq, sk, masked, causal, with_jax):
    """The cluster kernels' arithmetic (S and dP each the rank-ordered sum of
    the partial products of the cluster's head-dim slices) against the JAX
    backward and its plain PyTorch form; one slice is the D <= 160 kernels'
    own arithmetic, and the slices move the result by no more than fp32
    rounding."""
    q, k, v, g, mask = _inputs(71, sq, sk, masked)
    tq, tk, tv, tg, tm = map(_t, (q, k, v, g, mask))
    scale = 1.0 / np.sqrt(D)
    out = tattn.scaled_dot_product_attention(tq, tk, tv, kv_mask=tm, causal=causal, scale=scale)
    stats = tattn.flash_stats_tiled(tq, tk, tv, tm, causal, scale)
    chunked = tattn.flash_bwd_chunked(tq, tk, tv, tm, out, tg, causal, scale)
    ref = _jax_vjp(q, k, v, mask, g, causal) if with_jax else None
    one = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, causal, scale, stats)
    got = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, causal, scale, stats,
                                d_slices=tattn.BWD_CLUSTER)
    for name, a, c, o in zip(("dq", "dk", "dv"), got, chunked, one):
        assert _rel(a.numpy(), c.numpy()) <= RTOL, f"{name} against chunked"
        assert _rel(a.numpy(), o.numpy()) <= 1e-5, f"{name} against one slice"
    if ref is not None:
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            assert _rel(a.numpy(), r) <= RTOL, f"{name} against jax.vjp"
    if masked:  # batch 1 sees only masked keys: every row averages V
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()


def test_flash_bwd_tiled_rounds_at_d512():
    """In bf16 the sliced backward rounds P and dS where the kernels do: about
    one bf16 rounding from the fp32 chunked backward, not more."""
    q, k, v, g, mask = _inputs(72, 128, 96, True)
    tq, tk, tv, tg = (_t(a).to(torch.bfloat16) for a in (q, k, v, g))
    tm = _t(mask)
    scale = 1.0 / np.sqrt(D)
    out = tattn.scaled_dot_product_attention(tq, tk, tv, kv_mask=tm, scale=scale)
    stats = tattn.flash_stats_tiled(tq, tk, tv, tm, False, scale)
    got = tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, False, scale, stats, d_slices=2)
    ref = tattn.flash_bwd_chunked(tq, tk, tv, tm, out, tg, False, scale)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16
        assert 0 < _rel(a.float().numpy(), r.float().numpy()) <= 1e-2
    with pytest.raises(ValueError, match="equal slices"):
        tattn.flash_bwd_tiled(tq, tk, tv, tm, out, tg, False, scale, stats, d_slices=3)


# (sq, sk, masked, causal, nsplit): every split of the 8 or 6 key tiles of
# 32 that leaves no split empty, up to the plan's (8 at Sk 256, 6 at 177)
@pytest.mark.parametrize("sq,sk,masked,causal,nsplit",
                         [(256, 256, False, False, n) for n in (1, 2, 4, 8)]
                         + [(200, 177, True, True, n) for n in (1, 2, 3, 6)])
def test_wide_forward_statistics_match_the_tiled_ones(sq, sk, masked, causal, nsplit):
    """The m and 1/l the wide forward keeps (its 32-key tiles, O in four
    head-dim slices, the keys split over `nsplit` blocks and the partials'
    statistics merged by `flash_combine`) equal `flash_stats_tiled`'s to
    fp32 rounding; a fully masked row keeps m = -1e30, 1/l = 1/Sk. The
    combine's plain version writes them with zeros past Sq."""
    q, k, v, _, mask = _inputs(73, sq, sk, masked)
    tq, tk, tv, tm = map(_t, (q, k, v, mask))
    scale = 1.0 / np.sqrt(D)
    o_part, m_part, l_part = tattn.flash_partials_tiled(tq, tk, tv, tm, causal, scale,
                                                       key_tile=32, d_slices=4, nsplit=nsplit)
    got = tattn.combine_stats(m_part, l_part)
    want = tattn.flash_stats_tiled(tq, tk, tv, tm, causal, scale)
    assert got.shape == want.shape == (2, 2, 1, sq)
    assert _rel(got[0].numpy(), want[0].numpy()) <= 1e-6
    assert _rel(got[1].numpy(), want[1].numpy()) <= 1e-5
    if masked:
        assert torch.all(got[0, 1] == tattn.NEG_INF)
        assert torch.allclose(got[1, 1], torch.full((1, sq), 1.0 / sk), rtol=1e-6)
    sqp = -(-sq // tattn.STATS_ROWS) * tattn.STATS_ROWS
    stats = torch.full((2, 2, 1, sqp), float("nan"))
    out = tattn.flash_combine(o_part, m_part, l_part, torch.float32, stats)
    assert torch.equal(stats[..., :sq], got) and torch.all(stats[..., sq:] == 0)
    assert torch.equal(out, tattn.combine_partials(o_part, m_part, l_part))


# the VAE decoder's mid-block attention at the training batches (recon
# decodes at 2, comp decodes at 3) and at 1, on an H100's 132 SMs: 64 keys
# (queries) a cluster
@pytest.mark.parametrize("b", [1, 2, 3])
def test_flash_bwd_plan_at_d512(b):
    plan = tattn.flash_bwd_plan(torch.bfloat16, b, 1, 4096, 4096, 512, 132)
    assert plan == tattn.FlashBwdPlan("cluster", 64, 64)
    assert plan.d_slices == tattn.BWD_CLUSTER == 2
    # D 497..512 share the instance; the head dims between the two families
    # have none
    assert tattn.flash_bwd_plan(torch.bfloat16, b, 1, 200, 177, 504, 132).variant == "cluster"
    with pytest.raises(ValueError, match="no backward kernel"):
        tattn.flash_bwd_plan(torch.bfloat16, b, 1, 4096, 4096, 256, 132)


@pytest.mark.parametrize("recompute", [False, True])
def test_flash_function_keeps_the_d512_statistics(recompute):
    """`_FlashAttention` at D 512 saves the statistics its forward gives (on
    the card the wide kernel's; here the tiled plain version's, handed in),
    and under non-reentrant recompute (as the VAE decoder runs in training)
    the forward runs again and the backward gets the statistics of that
    second run. The backward reads the tensor `_FlashAttention.backward`
    unpacks from its saved tensors (`flash_bwd_tiled` with the cluster's
    slices in place of `flash_bwd_chunked`): the gradients equal those
    without recompute bit for bit, and those of `flash_bwd_chunked` to fp32
    rounding."""
    q, k, v, g, mask = _inputs(74, 128, 96, True)
    tm, tg = _t(mask), _t(g)
    scale = 1.0 / np.sqrt(D)
    handed, unpacked = [], []
    real = tattn._flash_forward
    real_backward = tattn._FlashAttention.backward

    def forward(*a, with_stats=False):
        out, _ = real(*a, with_stats=True)
        handed.append(tattn.flash_stats_tiled(*(x.detach() for x in a[:3]), *a[3:]))
        return out, handed[-1]

    def function_backward(ctx, g):
        # a saved tensor unpacks once under checkpoint: the real backward
        # gets what was unpacked here
        saved = ctx.saved_tensors
        unpacked.append(saved[-1])
        return real_backward(SimpleNamespace(saved_tensors=saved, causal=ctx.causal,
                                             scale=ctx.scale,
                                             needs_input_grad=ctx.needs_input_grad), g)

    def backward(q, k, v, kv_mask, out, g, causal, scale, need_dq=True, need_dkdv=True):
        return tattn.flash_bwd_tiled(q, k, v, kv_mask, out, g, causal, scale, unpacked[-1],
                                     need_dq, need_dkdv, d_slices=tattn.BWD_CLUSTER)

    def grads(recompute):
        tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
        handed.clear()
        unpacked.clear()
        fn = lambda q, k, v: tattn.flash_attention(q, k, v, tm)  # noqa: E731
        with mock.patch.object(tattn, "_flash_forward", forward), \
                mock.patch.object(tattn._FlashAttention, "backward",
                                  staticmethod(function_backward)), \
                mock.patch.object(tattn, "flash_bwd_chunked", backward):
            out = checkpoint(fn, tq, tk, tv, use_reentrant=False) if recompute else fn(tq, tk, tv)
            saved = None if recompute else out.grad_fn.saved_tensors[-1]
            out.backward(tg)
        # the backward read the last forward's statistics: the recompute's
        assert len(unpacked) == 1 and unpacked[0].data_ptr() == handed[-1].data_ptr()
        if recompute:
            assert handed[0].data_ptr() != handed[-1].data_ptr()
        return saved, len(handed), (tq.grad, tk.grad, tv.grad)

    want = tattn.flash_stats_tiled(*map(_t, (q, k, v)), tm, False, scale)
    saved, calls, got = grads(recompute)
    assert calls == (2 if recompute else 1)
    if not recompute:
        assert torch.equal(saved, want)
    _, _, plain = grads(False)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    out = tattn.scaled_dot_product_attention(*map(_t, (q, k, v)), kv_mask=tm, scale=scale)
    chunked = tattn.flash_bwd_chunked(*map(_t, (q, k, v)), tm, out, tg, False, scale)
    for a, b in zip(got, chunked):
        assert _rel(a.numpy(), b.numpy()) <= RTOL
