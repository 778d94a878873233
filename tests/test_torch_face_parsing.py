"""The face-parser training path of the PyTorch port against the JAX
package, on the CPU.

Inputs come from numpy seeds and go through both sides in fp32. Where the
JAX function reaches the Pallas BN kernels it runs them in interpret mode.
Tolerances:
- the BN op's forward: 1e-5 abs, fp32 sums taken in another order; the
  statistics kernel's arithmetic in plain PyTorch (`bn_stats_chunked`: chunk
  sums in fp32, the fixed fp64 fold) against the plain version: 1e-6 relative
  (mean to the largest mean, rstd to itself), against the Pallas kernel 1e-5;
- BN gradients: rtol 1e-3, atol 2e-4, as `tests/test_fused_norm.py`;
- BiSeNet outputs and losses: 1e-4 relative to the largest magnitude (fp32
  through ~20 conv layers and 31 BNs);
- parameters after train steps: 1e-4 relative L2 per tensor. A ReLU whose
  input lies within the two frameworks' rounding of 0 passes its gradient on
  one side only; at this size about one unit a step does, and its share of
  one channel's gradient is up to 6%, which a max-abs bound would report;
- the OHEM loss and its gradient: 1e-5 (one log-softmax and a mean);
- the schedule: rtol 1e-6 (both in fp32); augmentation: bit-equal.

The JAX side of a train step has `adaface_tpu.models.bisenet.fused_bn_act`
patched to the differentiable `_fused_bn_act_fwd_xla`: the JAX custom VJP
gives a wrong gradient at slope 0 (ReLU), and the port follows the
autodiff of the JAX forward instead.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from adaface_tpu.models import bisenet as jbisenet
from adaface_tpu.ops import fused_norm as jfn
from adaface_tpu.train import face_parsing_train as jtrain
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import bisenet as tbisenet
from adaface_tpu_torch.ops import fused_norm as tfn
from adaface_tpu_torch.train import face_parsing_train as ttrain
from tests.test_torch_models import assert_close_rel, numpy_params

OP_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-3, atol=2e-4)
# Batch 4: at batch 2 the train-mode BNs over the pooled [B, 1, 1, C]
# maps (`conv_avg`, both ARM attentions) take mean and variance over two
# values, some channel then has mean²/var above 1e5, and the reference's own
# fp32 E[x²] − mean² moves its outputs by up to 5e-4 under a 1e-7 change of
# the input. At batch 4 the same comparisons sit near 3e-5.
BATCH = 4
# a step size at which two updates move some tensor by more than 2e-3 in
# relative L2, twenty times the comparison's tolerance
STEP_CFG = dict(crop_size=64, batch_size=BATCH, lr0=2.5e-3, warmup_steps=2,
                warmup_start_lr=5e-4, max_iter=50)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_close_rel_l2(out, ref, rtol=1e-4):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30)
    assert err <= rtol, f"relative L2 error {err:.3e}"


def _bn_inputs(seed, shape):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    return ((rs.randn(*shape) * 2.0 + 0.5).astype(np.float32),
            (rs.randn(c) + 1.0).astype(np.float32),
            (rs.randn(c) * 0.5).astype(np.float32))


@pytest.mark.parametrize("shape,slope", [
    ((4, 5, 5, 8), 0.0),
    ((2, 25, 22, 64), 0.01),  # R = 1100: two row blocks of 1024, the last one ragged
    ((16, 1, 1, 128), 1.0),  # the attention maps' R = 16
])
def test_bn_act_matches_pallas_interpret(shape, slope):
    x, scale, bias = _bn_inputs(0, shape)
    with mock.patch.object(jfn.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        ref = jfn.fused_bn_act(x, scale, bias, slope=slope, use_pallas=True)
    out = tfn.fused_bn_act(_t(x), _t(scale), _t(bias), slope=slope)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    assert (out.numpy() < 0).any() == (slope != 0)


# (R, C, plan overrides): the face parser's (R, C) at reduced R on a 132-SM
# plan; an odd R; R smaller than a chunk's row lanes; the attention maps'
# R = 16 (one block, no partials); C = 96 (12 packs: a ragged second channel
# tile); C = 65 (single channels); small blocks and few SMs, for many
# ragged chunks at a small R
BN_CHUNKED_CASES = [
    (12544, 64, {}),
    (3136, 64, {}),
    (784, 128, {}),
    (1101, 256, {}),
    (196, 512, {}),
    (784, 256, {"threads": 512}),
    (5, 64, {"threads": 64}),
    (16, 128, {}),
    (777, 96, {"threads": 64, "min_rows": 2}),
    (333, 65, {"threads": 96, "min_rows": 1}),
    (1000, 512, {"threads": 128, "min_rows": 2, "tile_bytes": 256}),
    (2049, 128, {"threads": 32, "min_rows": 3, "waves": 4}),
]


@pytest.mark.parametrize("r,c,kwargs", BN_CHUNKED_CASES)
def test_bn_stats_chunked_matches_plain_and_pallas_interpret(r, c, kwargs):
    """The statistics kernel's arithmetic (`bn_stats_chunked` on `bn_plan`'s
    geometry) against the plain version and against the Pallas statistics
    kernel in interpret mode; two calls give the same bits."""
    x, scale, bias = _bn_inputs(3, (r, c))
    plan = tfn.bn_plan(r, c, torch.float32, 132, True, **kwargs)
    mean, rstd = tfn.bn_stats_chunked(_t(x), 1e-5, plan)
    again = tfn.bn_stats_chunked(_t(x), 1e-5, plan)
    assert torch.equal(mean, again[0]) and torch.equal(rstd, again[1])
    mean_p, rstd_p = tfn.bn_stats_plain(_t(x), 1e-5)
    assert ((mean - mean_p).abs().max() / mean_p.abs().max()).item() <= 1e-6
    if r >= 16:  # below, E[x²] − mean² cancels to a few digits in either order
        assert ((rstd - rstd_p).abs() / rstd_p).max().item() <= 1e-6
    with mock.patch.object(jfn.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        _, mean_j, rstd_j = jfn._fused_bn_act_fwd_tpu(jnp.asarray(x), jnp.asarray(scale),
                                                      jnp.asarray(bias), 0.0, 1e-5, None)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=OP_ATOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j), atol=OP_ATOL, rtol=OP_ATOL)


def test_bn_stats_chunked_fold_is_the_fp64_sum_in_a_fixed_order():
    """`bn_finalize_chunked` on given partials: every chunk counted once for
    any number of fold lanes, and mean and rstd from the fp64 sums."""
    rs = np.random.RandomState(4)
    psum = _t(rs.randn(37, 24).astype(np.float32) * 100.0)
    psq = _t((rs.rand(37, 24).astype(np.float32) + 1.0) * 1e4)
    want_mean = psum.double().sum(0) / 5000
    want_rstd = 1.0 / torch.sqrt(psq.double().sum(0) / 5000 - want_mean ** 2 + 1e-5)
    for klanes in (1, 2, 8, 64):
        mean, rstd = tfn.bn_finalize_chunked(psum, psq, 5000, 1e-5, klanes)
        assert mean.dtype == rstd.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), want_mean.numpy(), rtol=2e-7)
        np.testing.assert_allclose(rstd.numpy(), want_rstd.numpy(), rtol=2e-7)


# (R, C, dtype) → (vec, threads, lanes, chunks, channel tiles) on a 132-SM card:
# every train-mode BN of BiSeNet at batch 16, crop 448, and the bf16 case
BN_PLANS = [
    ((802816, 64, torch.float32), (4, 512, 8, 66, 2)),
    ((200704, 64, torch.float32), (4, 512, 8, 66, 2)),
    ((50176, 128, torch.float32), (4, 512, 8, 33, 4)),
    ((50176, 256, torch.float32), (4, 512, 8, 16, 8)),
    ((50176, 64, torch.float32), (4, 256, 8, 66, 2)),
    ((12544, 256, torch.float32), (4, 256, 8, 16, 8)),
    ((12544, 128, torch.float32), (4, 256, 8, 33, 4)),
    ((12544, 64, torch.float32), (4, 256, 8, 49, 2)),
    ((3136, 512, torch.float32), (4, 256, 8, 8, 16)),
    ((3136, 128, torch.float32), (4, 256, 8, 12, 4)),
    ((16, 128, torch.float32), (4, 128, 32, 1, 1)),
    ((200704, 64, torch.bfloat16), (8, 512, 8, 132, 1)),
]


@pytest.mark.parametrize("shape,want", BN_PLANS)
def test_bn_plan(shape, want):
    r, c, dtype = shape
    plan = tfn.bn_plan(r, c, dtype, 132)
    chunks, ctiles = plan.grid(c)
    assert (plan.vec, plan.threads, plan.lanes, chunks, ctiles) == want
    assert tfn.bn_plan(r, c, dtype, 132) is plan  # from the cache
    # within CUDA's limits and the source's
    assert 1 <= chunks <= 2 ** 31 - 1 and 1 <= ctiles <= 65535
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    assert 1 <= plan.lanes <= plan.threads and plan.row_lanes >= 1
    assert max(2 * plan.row_lanes * plan.tile * 4, 16 * plan.threads) <= 48 * 1024
    # every row in exactly one chunk, none empty; every channel in exactly one tile
    assert (chunks - 1) * plan.chunk_rows < r <= chunks * plan.chunk_rows
    assert c % plan.vec == 0 and (ctiles - 1) * plan.tile < c <= ctiles * plan.tile
    # the fold: a power of two of lanes a channel, within the block
    assert plan.klanes & (plan.klanes - 1) == 0
    assert plan.klanes * min(plan.tile, plan.threads) <= plan.threads


def test_bn_plan_scalar_instances_and_other_cards():
    # C off a pack, or a pointer off 16 bytes: single channels
    assert tfn.bn_plan(12545, 65, torch.float32, 132).vec == 1
    off = tfn.bn_plan(50176, 128, torch.float32, 132, False)
    assert off.vec == 1 and off.grid(128)[1] * off.tile >= 128
    # wider than a block's lanes: more channel tiles, still one pack a lane
    wide = tfn.bn_plan(1000, 1100, torch.float32, 132)
    assert wide.grid(1100) == (3, 35) and wide.tile == 32
    # fewer SMs, fewer chunks; the plan reads nothing but its arguments
    assert tfn.bn_plan(200704, 64, torch.float32, 16).grid(64) == (8, 2)
    # a forced block size is taken as it is
    assert tfn.bn_plan(12544, 256, torch.float32, 132, True, 128).threads == 128


@pytest.mark.parametrize("case", ["stats cpu", "norm cpu", "dtype", "rank", "strided",
                                  "vector shape", "vector dtype"])
def test_bn_kernels_reject_what_they_do_not_take(case):
    """The wrappers' checks before any launch. Dtype and layout are read
    before the device, so CPU tensors show them; a well-formed CPU tensor is
    refused too: only the Function sends it to the plain version."""
    x = torch.zeros(8, 16)
    vec = torch.zeros(16)
    if case == "stats cpu":
        with pytest.raises(ValueError, match="no kernel for device"):
            tfn.bn_stats(x, 1e-5)
    elif case == "norm cpu":
        with pytest.raises(ValueError, match="no kernel for device"):
            tfn.bn_norm_act(x, vec, vec, vec, vec, 0.0)
    elif case == "vector shape":
        with pytest.raises(ValueError, match="mean must be a contiguous"):
            tfn._check_channel_vector("mean", torch.zeros(8), 16, x.device)
    elif case == "vector dtype":
        with pytest.raises(ValueError, match="rstd must be a contiguous"):
            tfn._check_channel_vector("rstd", vec.double(), 16, x.device)
    else:
        bad, match = {"dtype": (x.half(), "dtype"), "rank": (torch.zeros(2, 4, 16), "contiguous"),
                      "strided": (x[:, ::2], "contiguous")}[case]
        with pytest.raises(ValueError, match=match):
            tfn.bn_stats(bad, 1e-5)


def _port_grads(x, scale, bias, slope):
    xt, st, bt = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    (tfn.fused_bn_act(xt, st, bt, slope=slope) ** 3).mean().backward()
    return xt.grad.numpy(), st.grad.numpy(), bt.grad.numpy()


@pytest.mark.parametrize("slope", [0.0, 0.01, 1.0])
def test_bn_act_grad_matches_jax_autodiff(slope):
    x, scale, bias = _bn_inputs(1, (4, 5, 5, 8))

    def loss(x, s, b):
        y = jfn._fused_bn_act_fwd_xla(x.reshape(-1, 8), s, b, slope, 1e-5, None)[0]
        return (y ** 3).mean()

    ref = jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)
    for out, r in zip(_port_grads(x, scale, bias, slope), ref):
        np.testing.assert_allclose(out, np.asarray(r), **GRAD_TOL)


def test_bn_act_grad_at_zero_preactivation_matches_jax_autodiff():
    """At slope 0 a pre-activation of exactly 0 passes its gradient, as the
    autodiff of `y >= 0` does: a constant channel at scale 1 and bias 0 has
    z = 0 in every row, and a loss linear in y has g != 0 there."""
    rs = np.random.RandomState(3)
    x = rs.randn(16, 4).astype(np.float32)
    x[:, 1] = 1.5  # a binary fraction: the mean is exact, x - mean is 0
    scale, bias = np.ones(4, np.float32), np.zeros(4, np.float32)
    w = rs.randn(16, 4).astype(np.float32)

    def loss(x, s, b):
        return (jfn._fused_bn_act_fwd_xla(x, s, b, 0.0, 1e-5, None)[0] * w).sum()

    ref = jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)
    xt, st, bt = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    (tfn.fused_bn_act(xt, st, bt, slope=0.0) * _t(w)).sum().backward()
    assert abs(float(ref[2][1])) > 0.1  # Σg over the constant channel
    for out, r in zip((xt.grad, st.grad, bt.grad), ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slope", [0.01, 1.0])
def test_bn_act_grad_matches_jax_custom_vjp(slope):
    """Where the activation inverts, the port's backward is `_fused_bwd`."""
    x, scale, bias = _bn_inputs(2, (4, 5, 5, 8))
    ref = jax.grad(lambda x, s, b: (jfn.fused_bn_act(x, s, b, slope=slope, use_pallas=False)
                                    ** 3).mean(), argnums=(0, 1, 2))(x, scale, bias)
    for out, r in zip(_port_grads(x, scale, bias, slope), ref):
        np.testing.assert_allclose(out, np.asarray(r), **GRAD_TOL)


def test_bn_act_raises_on_a_layout_it_does_not_view():
    x = torch.randn(2, 8, 4, 4)  # NCHW contiguous: its NHWC permute is no [R, C] view
    with pytest.raises(RuntimeError):
        tfn.fused_bn_act(x.permute(0, 2, 3, 1), torch.ones(8), torch.zeros(8))


def bisenet_params(seed):
    """BiSeNet params from numpy, BN `var` leaves moved to positive values."""
    params = numpy_params(jbisenet.init_bisenet_params, seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.abs(a) * 10.0 + 0.5 if path[-1].key == "var" else a, params)


def port_bisenet(params, train):
    model = bridge.load(tbisenet.BiSeNet(), params).to(memory_format=torch.channels_last)
    return model.requires_grad_(True).train(train)


@pytest.mark.parametrize("train", [False, True])
def test_bisenet_matches_jax(train):
    params = bisenet_params(0)
    x = np.random.RandomState(0).randn(BATCH, 3, 64, 64).astype(np.float32)
    ref = jax.jit(lambda p, x: jbisenet.bisenet_forward(p, x, train=train))(params, x)
    with torch.no_grad():
        out = port_bisenet(params, train)(_t(x))
    if not train:
        ref, out = (ref,), (out,)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert_close_rel(o.numpy(), r)


def _differentiable_bn(x, scale, bias, slope=0.01, eps=1e-5):
    y = jfn._fused_bn_act_fwd_xla(x.reshape(-1, x.shape[-1]), scale, bias, slope, eps, None)[0]
    return y.reshape(x.shape)


def test_train_steps_match_jax():
    cfg_j = jtrain.FaceParsingTrainConfig(**STEP_CFG)
    cfg_t = ttrain.FaceParsingTrainConfig(**STEP_CFG)
    params = bisenet_params(1)
    rs = np.random.RandomState(1)
    images = rs.randn(BATCH, 3, 64, 64).astype(np.float32)
    labels = rs.randint(0, 19, (BATCH, 64, 64)).astype(np.int32)
    labels[0, :8] = 255

    model = port_bisenet(params, True)
    step_t = ttrain.make_face_parsing_train_step(
        cfg_t, model, ttrain.make_face_parsing_optimizer(cfg_t, model))
    opt_j = jtrain.make_face_parsing_optimizer(cfg_j, params)
    step_j = jtrain.make_face_parsing_train_step(cfg_j, opt_j)
    opt_state = opt_j.init(params)
    start = bridge.state_dict(params)
    with mock.patch.object(jbisenet, "fused_bn_act", _differentiable_bn):
        for _ in range(2):
            params, opt_state, m_j = step_j(params, opt_state, images, labels)
            m_t = step_t(_t(images), _t(labels).long())
            for k in ("loss", "loss_main", "loss_aux16", "loss_aux32"):
                assert_close_rel(m_t[k].numpy(), m_j[k])
            ref = bridge.state_dict(params)
            for name, p in model.named_parameters():
                assert_close_rel_l2(p.detach().numpy(), ref[name])
    # the steps moved the parameters well beyond the comparison's tolerance
    moved = max(float((ref[n] - start[n]).norm() / start[n].norm()) for n in ref)
    assert moved > 2e-3


def test_running_stats_update_and_serve_eval():
    """Port only: train mode updates BN's running stats as torch's BatchNorm
    (momentum 0.1, unbiased variance), and eval mode then reads them."""
    model = tbisenet.build_bisenet("cpu", torch.Generator().manual_seed(0))
    seen = {}
    model.bn1.register_forward_pre_hook(lambda mod, inp: seen.update(x=inp[0]))
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        model(x)
    xin = seen["x"]
    mean = xin.mean((0, 2, 3))
    var = xin.var((0, 2, 3), unbiased=True)
    torch.testing.assert_close(model.bn1.running_mean, 0.1 * mean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(model.bn1.running_var, 0.9 + 0.1 * var, rtol=1e-4, atol=1e-5)
    model.eval()
    probe = torch.randn(1, 64, 8, 8)
    want = F.relu((probe - (0.1 * mean)[:, None, None])
                  / torch.sqrt(0.9 + 0.1 * var + 1e-5)[:, None, None])
    torch.testing.assert_close(model.bn1(probe), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale,n_min", [(1.0, 5), (6.0, 120)])
def test_ohem_loss_matches_jax(scale, n_min):
    rs = np.random.RandomState(3)
    logits = (rs.randn(2, 5, 8, 8) * scale).astype(np.float32)
    labels = rs.randint(0, 5, (2, 8, 8)).astype(np.int32)
    labels[0, :2] = 255
    # the first case keeps every pixel above -log(0.7), the second the top n_min
    m = logits.max(1, keepdims=True)
    logp = logits - m - np.log(np.exp(logits - m).sum(1, keepdims=True))
    nll = -np.take_along_axis(logp, (labels % 255)[:, None], 1)[:, 0]
    nll = np.where(labels != 255, nll, 0.0).reshape(-1)
    assert (np.sort(nll)[::-1][n_min - 1] > -np.log(0.7)) == (scale == 1.0)

    ref, gref = jax.value_and_grad(jtrain.ohem_ce_loss)(logits, labels, 0.7, n_min)
    lt = _t(logits).requires_grad_(True)
    out = ttrain.ohem_ce_loss(lt, _t(labels).long(), 0.7, n_min)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=OP_ATOL, atol=OP_ATOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gref), atol=OP_ATOL)
    np.testing.assert_allclose(
        ttrain.softmax_focal_loss(_t(logits), _t(labels).long()).item(),
        float(jtrain.softmax_focal_loss(logits, labels)), rtol=OP_ATOL)


def test_warmup_poly_lr_matches_jax():
    cfg = ttrain.FaceParsingTrainConfig()
    for step in (0, 1, 9, 500, 1000, 1001, 40_000, 79_999, 80_000, 90_000):
        np.testing.assert_allclose(cfg.lr(step), float(jtrain.warmup_poly_lr(step)),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_optimizer_groups_and_first_updates_match_optax():
    cfg_j = jtrain.FaceParsingTrainConfig(**STEP_CFG)
    cfg_t = ttrain.FaceParsingTrainConfig(**STEP_CFG)
    params = bisenet_params(2)
    model = port_bisenet(params, True)
    opt_t = ttrain.make_face_parsing_optimizer(cfg_t, model)

    # the groups: weight decay on conv `w` only, lr_mul 10 on ffm and heads
    group_of = {id(p): g for g in opt_t.param_groups for p in g["params"]}
    paths = {}
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path)
        paths[bridge._leaf(name, a)[0]] = path
    names = [name for name, _ in model.named_parameters()]
    assert sorted(names) == sorted(n for n, path in paths.items()
                                   if path[-1].key not in ("mean", "var"))
    for name, p in model.named_parameters():
        g, path = group_of[id(p)], paths[name]
        assert g["lr_mul"] == (10.0 if jtrain._is_lr_mul(path) else 1.0), name
        assert (g["weight_decay"] > 0) == (not jtrain._is_no_wd(path, None)), name
    assert len(names) == sum(len(g["params"]) for g in opt_t.param_groups)

    # three updates from the same gradients (a seed apart from the params')
    opt_j = jtrain.make_face_parsing_optimizer(cfg_j, params)
    state = opt_j.init(params)
    rs = np.random.RandomState(12)
    for k in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), params)
        upd, state = opt_j.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        gsd = bridge.state_dict(grads)
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        for g in opt_t.param_groups:
            g["lr"] = cfg_t.lr(k) * g["lr_mul"]
        opt_t.step()
        ref = bridge.state_dict(params)
        for name, p in model.named_parameters():
            assert_close_rel(p.detach().numpy(), ref[name])


def test_augmentation_and_metrics_match_jax():
    rs = np.random.RandomState(4)
    for shape in ((100, 120), (300, 280)):  # padded crop, and plain crop
        img = rs.randint(0, 255, (*shape, 3)).astype(np.uint8)
        lbl = rs.randint(0, 19, shape).astype(np.uint8)
        a = ttrain.augment_face_parsing(img, lbl, np.random.default_rng(7), crop_size=128)
        b = jtrain.augment_face_parsing(img, lbl, np.random.default_rng(7), crop_size=128)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    pred = rs.randint(0, 19, (2, 16, 16))
    label = rs.randint(0, 20, (2, 16, 16))  # 19 is no class: dropped, as 255
    label[0, 0, :3] = 255
    cm = ttrain.confusion_matrix(pred, label)
    np.testing.assert_array_equal(cm, jtrain.confusion_matrix(pred, label))
    m_t, m_j = ttrain.miou_from_confusion(cm), jtrain.miou_from_confusion(cm)
    np.testing.assert_array_equal(m_t["per_class_iou"], m_j["per_class_iou"])
    assert (m_t["miou"], m_t["pixel_acc"]) == (m_j["miou"], m_j["pixel_acc"])
    np.testing.assert_array_equal(tbisenet.parsing_to_face_mask(pred[0]),
                                  jbisenet.parsing_to_face_mask(pred[0]))


def test_main_trains_saves_and_evaluates(tmp_path):
    """The entry point on a synthetic dataset: 2 steps at batch 2, crop 64,
    a checkpoint that loads into a BiSeNet, and its evaluation."""
    from PIL import Image

    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    rs = np.random.RandomState(5)
    for i in range(3):
        Image.fromarray(rs.randint(0, 255, (72, 80, 3)).astype(np.uint8)).save(
            tmp_path / "images" / f"{i}.jpg")
        Image.fromarray(rs.randint(0, 19, (72, 80)).astype(np.uint8)).save(
            tmp_path / "labels" / f"{i}.png")
    out = tmp_path / "ckpt.pt"
    ttrain.main(["--data_root", str(tmp_path), "--max_iter", "2", "--batch_size", "2",
                 "--crop_size", "64", "--log_every", "1", "--out", str(out),
                 "--device", "cpu"])
    model = tbisenet.BiSeNet()
    model.load_state_dict(torch.load(out, weights_only=True))
    assert float(model.bn1.running_var.sub(1.0).abs().max()) > 0  # trained stats saved
    ds = ttrain.FaceMaskDataset(str(tmp_path), crop_size=64)
    m = ttrain.evaluate_face_parsing(model, ds, batch_size=2)
    assert m["per_class_iou"].shape == (19,)
    assert 0.0 <= m["miou"] <= 1.0 and 0.0 <= m["pixel_acc"] <= 1.0
    assert model.training
